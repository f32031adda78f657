"""Checksum: source/target data validation (the port's copy of
``transferia_tpu/tasks/checksum.py``, after pkg/worker/tasks/checksum.go).

Reference-depth compare between a transfer's source storage and a
storage view of the destination:

- schema + primary-key comparison up front;
- size-gated strategy: small tables are fully compared, big ones by
  top/bottom + random key samples (`SampleableStorage`);
- the full compare streams with bounded memory: source rows are pulled
  in chunks and matched against the target through `load_sample_by_set`;
- type-aware comparators (`try_compare`): floats rounded to 12
  significant digits, temporal normalization, NULL == NULL, bytes/str
  unification, arrays element-wise, pg interval/geometry text
  normalization, json string-compare;
- an error map with per-kind counts and capped samples, and per-table
  compare retries;
- `method="fingerprint"`: both tables stream through the
  order-independent table fingerprint (`ops/rowhash.TableFingerprinter`:
  K10, and `trt_var_accumulators` for dictionary pools, on the card with
  `fingerprint_backend="device"`; the host library's lanes with "host";
  the measured choice with "auto"), and on a mismatch the row-level
  strategy runs as the diagnostic pass.

The `device` argument of `checksum` and `compare_checksum` is where a
non-host fingerprint runs (CUDA unless "cpu"; without a card it raises,
and the table fails).  The CLI's `checksum` command
waits on the port's CLI (ROADMAP.md A5).
"""

from __future__ import annotations

import datetime as _dt
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from transferia_tpu_torch.abstract.interfaces import (
    SampleableStorage,
    Storage,
    is_columnar,
)
from transferia_tpu_torch.abstract.schema import ColSchema, TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops.rowhash import TableFingerprinter
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats.registry import Metrics

logger = logging.getLogger(__name__)

ROUNDING_DIGITS = 12                       # checksum.go:44 roundingConst
DEFAULT_TABLE_SIZE_THRESHOLD = 20 << 20    # checksum.go:36 (20 MiB)
COMPARE_RETRIES = 3                        # checksum.go:37
MAX_ERROR_SAMPLES = 3                      # checksum.go:38
KEYSET_CHUNK = 512                         # streaming-compare chunk (keys)

GENERIC_ERROR = "generic"
SCHEMA_MISMATCH_ERROR = "table schema mismatch"
MISSED_KEY_ERROR = "missed key"

# priority comparator signature (checksum.go:49 ChecksumComparator):
# (lval, lschema, rval, rschema, into_array) -> (comparable, equal)
Comparator = Callable[[Any, ColSchema, Any, ColSchema, bool],
                      tuple[bool, bool]]


class ComparisonError(Exception):
    """A value pair could not be compared (parser failure etc.)."""


@dataclass
class ChecksumParameters:
    """Knobs for the checksum task (checksum.go:120 ChecksumParameters)."""

    table_size_threshold: int = DEFAULT_TABLE_SIZE_THRESHOLD
    tables: list[TableID] = field(default_factory=list)
    priority_comparators: list[Comparator] = field(default_factory=list)
    keyset_chunk: int = KEYSET_CHUNK
    # cap on rows compared per table in the full strategy (0 = whole
    # table); the quick `check` command sets this from sample_rows
    max_rows: int = 0
    # "compare" (the reference's row-by-row strategies) or "fingerprint":
    # stream both tables through the order-independent device-reducible
    # digest (ops/rowhash.py) and compare aggregates — O(1) memory per
    # table, exact-representation semantics; on mismatch the row-level
    # strategy runs for that table as the diagnostic pass
    method: str = "compare"
    # fingerprint backend: auto | host | device (ops/rowhash.py)
    fingerprint_backend: str = "auto"


# ---------------------------------------------------------------------------
# error map (checksum.go errorMap)


@dataclass
class _ErrorEntry:
    count: int = 0
    samples: list[str] = field(default_factory=list)


class ErrorMap:
    def __init__(self):
        self._by_table: dict[str, dict[str, _ErrorEntry]] = {}

    def add(self, fqtn: str, kind: str, description: str) -> None:
        entry = self._by_table.setdefault(fqtn, {}).setdefault(
            kind, _ErrorEntry())
        entry.count += 1
        if len(entry.samples) < MAX_ERROR_SAMPLES:
            entry.samples.append(description)
        logger.debug("table %s, %s error: %s", fqtn, kind, description)

    def clear_table(self, fqtn: str) -> None:
        self._by_table[fqtn] = {}

    def table_errors(self, fqtn: str) -> list[str]:
        out = []
        for kind, entry in self._by_table.get(fqtn, {}).items():
            for i, s in enumerate(entry.samples):
                out.append(f"{kind} ({i + 1} of {entry.count}): {s}")
        return out

    def total(self) -> int:
        return sum(e.count for kinds in self._by_table.values()
                   for e in kinds.values())


# ---------------------------------------------------------------------------
# report


@dataclass
class TableChecksum:
    table: TableID
    source_rows: int = 0
    target_rows: int = 0
    compared_rows: int = 0
    # "full" | "sample" | "fingerprint" | "fingerprint+{full,sample}"
    strategy: str = "full"
    mismatches: list[str] = field(default_factory=list)
    # non-failing observations (e.g. exact-representation fingerprint
    # drift that the tolerant row comparators then cleared)
    notes: list[str] = field(default_factory=list)
    source_fingerprint: str = ""
    target_fingerprint: str = ""

    @property
    def ok(self) -> bool:
        return self.source_rows == self.target_rows and not self.mismatches

    def fqtn(self) -> str:
        return self.table.fqtn()


@dataclass
class ChecksumReport:
    tables: list[TableChecksum] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(t.ok for t in self.tables)

    def summary(self) -> str:
        lines = []
        for t in self.tables:
            status = "OK" if t.ok else "MISMATCH"
            lines.append(
                f"{t.table}: {status} [{t.strategy}] (src={t.source_rows} "
                f"dst={t.target_rows} compared={t.compared_rows} "
                f"diffs={len(t.mismatches)})"
            )
            for m in t.mismatches[:MAX_ERROR_SAMPLES * 4]:
                lines.append(f"  - {m}")
            for m in t.notes[:MAX_ERROR_SAMPLES]:
                lines.append(f"  ~ note: {m}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# type-aware comparators (checksum.go:861 tryCompare and friends)


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _extract_double(v: Any) -> float:
    if isinstance(v, bool):
        raise ComparisonError(f"cannot treat bool {v!r} as double")
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError as e:
            raise ComparisonError(f"cannot parse {v!r} as double") from e
    raise ComparisonError(f"cannot convert {type(v).__name__} to double")


def _round12(x: float) -> str:
    """Fixed 12-decimal rounding (checksum.go rounded())."""
    return f"{x:.{ROUNDING_DIGITS}f}"


_TEMPORAL_FORMATS = (
    "%Y-%m-%d %H:%M:%S.%f%z", "%Y-%m-%d %H:%M:%S%z",
    "%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d",
)


def _parse_temporal(v: Any) -> Optional[_dt.datetime]:
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, _dt.date):
        return _dt.datetime(v.year, v.month, v.day)
    if not isinstance(v, str) or not v:
        return None
    s = v.strip()
    # normalize short tz offsets ("+00" -> "+0000") for strptime
    if len(s) > 3 and s[-3] in "+-" and s[-2:].isdigit():
        s = s + "00"
    try:
        return _dt.datetime.fromisoformat(v.strip())
    except ValueError:
        pass
    for fmt in _TEMPORAL_FORMATS:
        try:
            return _dt.datetime.strptime(s, fmt)
        except ValueError:
            continue
    return None


def _as_utc(t: _dt.datetime) -> _dt.datetime:
    if t.tzinfo is None:
        return t.replace(tzinfo=_dt.timezone.utc)
    return t.astimezone(_dt.timezone.utc)


def _original(schema: Optional[ColSchema]) -> str:
    return (schema.original_type or "") if schema is not None else ""


def _pg_type(schema: Optional[ColSchema]) -> str:
    ot = _original(schema)
    if not ot.startswith("pg:"):
        return ""
    # "pg:numeric(10,2)[]" -> "numeric"
    t = ot[3:].split("(")[0].rstrip("[]").strip().lower()
    return t


def _looks_temporal(schema: Optional[ColSchema]) -> bool:
    ot = _original(schema).lower()
    return any(k in ot for k in ("timestamp", "datetime", "date", "time"))


def compare_pg_interval(a: str, b: str) -> bool:
    """Textual interval compare ignoring trailing zero fields
    (checksum.go comparePGInterval)."""
    a = a.replace("days", "day")
    b = b.replace("days", "day")
    if len(a) > len(b):
        a, b = b, a
    if b[:len(a)] != a:
        return False
    return all(ch in "0.: " for ch in b[len(a):])


def _parse_points(s: str) -> list[float]:
    """All floats in a pg geometry literal, rounded to 12 decimals."""
    out: list[float] = []
    num = ""
    for ch in s:
        if ch.isdigit() or ch in ".-+eE":
            num += ch
        else:
            if num:
                try:
                    out.append(float(_round12(float(num))))
                except ValueError as e:
                    raise ComparisonError(
                        f"bad geometry literal {s!r}") from e
                num = ""
    if num:
        try:
            out.append(float(_round12(float(num))))
        except ValueError as e:
            raise ComparisonError(f"bad geometry literal {s!r}") from e
    return out


def compare_pg_geometry(a: str, b: str) -> bool:
    """Box/circle/polygon/point compare by rounded coordinate lists
    (checksum.go parseBox/parseCircle/parsePolygon)."""
    return _parse_points(a) == _parse_points(b)


def compare_pg_lseg(a: str, b: str) -> bool:
    """Segment compare after bracket normalization
    (checksum.go compareSegments)."""
    def norm(s: str) -> str:
        for src, dst in (("[(", "("), (")]", ")"), ("((", "("), ("))", ")")):
            s = s.replace(src, dst)
        return s
    return norm(a) == norm(b)


def try_compare(lval: Any, lschema: Optional[ColSchema],
                rval: Any, rschema: Optional[ColSchema],
                priority_comparators: Sequence[Comparator] = (),
                into_array: bool = False) -> bool:
    """Type-aware value equality (checksum.go:861 tryCompare).

    Raises ComparisonError when the pair cannot be compared at all.
    """
    # fast path: identical textual representation
    if str(lval) == str(rval):
        return True

    for pc in priority_comparators:
        comparable, equal = pc(lval, lschema, rval, rschema, into_array)
        if comparable:
            return equal

    # NULLs
    if lval is None or rval is None:
        return lval is None and rval is None

    # bools before numbers (bool is an int subtype in Python)
    if isinstance(lval, bool) or isinstance(rval, bool):
        def as_bool(v):
            if isinstance(v, bool):
                return v
            if isinstance(v, (int, float)):
                return v != 0
            if isinstance(v, str):
                return v.lower() in ("t", "true", "1")
            raise ComparisonError(f"cannot treat {v!r} as bool")
        return as_bool(lval) == as_bool(rval)

    # arrays: element-wise with the element schema
    if isinstance(lval, (list, tuple)) and isinstance(rval, (list, tuple)):
        if len(lval) != len(rval):
            return False
        return all(
            try_compare(a, lschema, b, rschema, priority_comparators, True)
            for a, b in zip(lval, rval)
        )

    # temporal normalization
    if (_looks_temporal(lschema) or _looks_temporal(rschema)
            or isinstance(lval, (_dt.datetime, _dt.date))
            or isinstance(rval, (_dt.datetime, _dt.date))):
        lt, rt = _parse_temporal(lval), _parse_temporal(rval)
        if lt is not None and rt is not None:
            return _as_utc(lt) == _as_utc(rt)

    # pg text-normalized types
    lpg, rpg = _pg_type(lschema), _pg_type(rschema)
    if "interval" in (lpg, rpg) and isinstance(lval, str) \
            and isinstance(rval, str):
        return compare_pg_interval(lval, rval)
    if "lseg" in (lpg, rpg) and isinstance(lval, str) \
            and isinstance(rval, str):
        return compare_pg_lseg(lval, rval)
    if any(t in ("box", "circle", "polygon", "point", "path")
           for t in (lpg, rpg)) \
            and isinstance(lval, str) and isinstance(rval, str):
        return compare_pg_geometry(lval, rval)

    # bytes vs str
    if isinstance(lval, (bytes, bytearray)) or \
            isinstance(rval, (bytes, bytearray)):
        def as_bytes(v):
            if isinstance(v, (bytes, bytearray)):
                return bytes(v)
            if isinstance(v, str):
                if v.startswith("\\x"):
                    try:
                        return bytes.fromhex(v[2:])
                    except ValueError:
                        pass
                return v.encode()
            raise ComparisonError(f"cannot treat {v!r} as bytes")
        return as_bytes(lval) == as_bytes(rval)

    # json columns: string compare of the canonical repr
    lot, rot = _original(lschema).lower(), _original(rschema).lower()
    if any(t.endswith((":json", ":jsonb")) for t in (lot, rot)):
        return str(lval) == str(rval)

    # floats: exact first, then 12-significant-digit rounding
    if isinstance(lval, float) or isinstance(rval, float) or (
            _is_number(lval) and _is_number(rval)):
        try:
            lf, rf = _extract_double(lval), _extract_double(rval)
        except ComparisonError:
            return lval == rval
        if math.isnan(lf) and math.isnan(rf):
            return True
        if lf == rf:
            return True
        return f"{lf:.{ROUNDING_DIGITS}g}" == f"{rf:.{ROUNDING_DIGITS}g}"

    # numeric strings ("1.50" vs 1.5) when either side declares a number
    if isinstance(lval, str) or isinstance(rval, str):
        try:
            return _extract_double(lval) == _extract_double(rval)
        except ComparisonError:
            pass

    return lval == rval


def values_equal(a: Any, b: Any,
                 a_schema: Optional[ColSchema] = None,
                 b_schema: Optional[ColSchema] = None) -> bool:
    """Back-compat wrapper over try_compare."""
    try:
        return try_compare(a, a_schema, b, b_schema)
    except ComparisonError:
        return False


# ---------------------------------------------------------------------------
# row collection helpers


def _iter_rows(batch) -> list:
    items = batch.to_rows() if hasattr(batch, "to_rows") else batch
    return [it for it in items
            if getattr(it, "is_row_event", lambda: False)()]


def _row_key(row: dict, keys: Sequence[str]) -> tuple:
    return tuple(row.get(k) for k in keys)


def _collect_keyed(storage: Storage, loader: str, td: TableDescription,
                   keys: Sequence[str], *args) -> dict[tuple, dict]:
    """Run a sample loader and key the resulting rows by primary key."""
    out: dict[tuple, dict] = {}

    def pusher(batch):
        for it in _iter_rows(batch):
            d = it.as_dict()
            out[_row_key(d, keys)] = d

    getattr(storage, loader)(td, *args, pusher)
    return out


def _schema_maps(storage: Storage, tid: TableID):
    schema = storage.table_schema(tid)
    cols = {c.name: c for c in schema} if schema else {}
    keys = [c.name for c in schema.key_columns()] if schema else []
    return schema, cols, keys


def _table_size(storage: Storage, tid: TableID) -> int:
    fn = getattr(storage, "table_size_in_bytes", None)
    if fn is None:
        return 0
    try:
        return int(fn(tid) or 0)
    except Exception as e:
        logger.debug("table_size_in_bytes failed for %s: %s", tid, e)
        return 0


# ---------------------------------------------------------------------------
# per-table comparison strategies


def _compare_rows(tc: TableChecksum,
                  lrow: dict, rrow: dict, key: tuple,
                  lcols: dict[str, ColSchema], rcols: dict[str, ColSchema],
                  comparators: Sequence[Comparator]) -> None:
    tc.compared_rows += 1
    for col, lv in lrow.items():
        if col not in rrow:
            continue
        try:
            equal = try_compare(lv, lcols.get(col), rrow[col],
                                rcols.get(col), comparators)
        except ComparisonError as e:
            tc.mismatches.append(f"row {key} col {col}: {e}")
            continue
        if not equal:
            tc.mismatches.append(
                f"row {key} col {col}: {lv!r} != {rrow[col]!r}")


def _stream_full_compare(tc: TableChecksum, errors: ErrorMap,
                         src: Storage, dst: Storage, td: TableDescription,
                         keys: Sequence[str],
                         lcols: dict, rcols: dict,
                         params: ChecksumParameters) -> None:
    """Bounded-memory full compare: pull source rows in chunks, match each
    chunk against the target via LoadSampleBySet.

    Falls back to a one-shot target load when the target storage has no
    sampling capability (memory/test storages)."""
    comparators = params.priority_comparators
    dst_sampleable = isinstance(dst, SampleableStorage)

    dst_all: dict[tuple, dict] = {}
    if not dst_sampleable:
        def dst_pusher(batch):
            for it in _iter_rows(batch):
                d = it.as_dict()
                dst_all[_row_key(d, keys)] = d
        dst.load_table(td, dst_pusher)

    pending: list[dict] = []
    seen = [0]

    def flush():
        if not pending:
            return
        if dst_sampleable:
            key_set = [{k: r.get(k) for k in keys} for r in pending]
            found = _collect_keyed(dst, "load_sample_by_set", td, keys,
                                   key_set)
        else:
            found = dst_all
        for lrow in pending:
            key = _row_key(lrow, keys)
            rrow = found.get(key)
            if rrow is None:
                tc.mismatches.append(f"row {key} missing in target")
                continue
            _compare_rows(tc, lrow, rrow, key, lcols, rcols,
                          comparators)
        pending.clear()

    def src_pusher(batch):
        for it in _iter_rows(batch):
            if params.max_rows and seen[0] >= params.max_rows:
                return
            pending.append(it.as_dict())
            seen[0] += 1
            if len(pending) >= params.keyset_chunk:
                flush()

    src.load_table(td, src_pusher)
    flush()


def _sampled_compare(tc: TableChecksum, errors: ErrorMap,
                     src: SampleableStorage, dst: Storage,
                     td: TableDescription, keys: Sequence[str],
                     lcols: dict, rcols: dict,
                     params: ChecksumParameters) -> None:
    """Big-table compare (checksum.go:238-337): top/bottom sample with
    retries, then a random keyset verified via LoadSampleBySet."""
    comparators = params.priority_comparators
    dst_sampleable = isinstance(dst, SampleableStorage)

    def match_keyed(left: dict[tuple, dict], right: dict[tuple, dict],
                    count_missing_right: bool = False) -> int:
        before = len(tc.mismatches)
        for key, lrow in left.items():
            rrow = right.get(key)
            if rrow is None:
                tc.mismatches.append(f"row {key} missing in target")
                continue
            _compare_rows(tc, lrow, rrow, key, lcols, rcols,
                          comparators)
        if count_missing_right:
            for key in right:
                if key not in left:
                    tc.mismatches.append(f"row {key} missing in source")
        return len(tc.mismatches) - before

    # top/bottom sample, retried (compareRetryThreshold)
    matched = False
    for attempt in range(COMPARE_RETRIES):
        saved = list(tc.mismatches)
        saved_compared = tc.compared_rows
        left = _collect_keyed(src, "load_top_bottom_sample", td, keys)
        if dst_sampleable:
            right = _collect_keyed(dst, "load_top_bottom_sample", td, keys)
        else:
            right = {}
            def dst_pusher(batch):
                for it in _iter_rows(batch):
                    d = it.as_dict()
                    right[_row_key(d, keys)] = d
            dst.load_table(td, dst_pusher)
        # when both sides sample identical top/bottom windows, an extra
        # key in the target is as much a defect as a missing one; the
        # full-load fallback right side legitimately holds extra keys
        if match_keyed(left, right,
                       count_missing_right=dst_sampleable) == 0:
            matched = True
            errors.clear_table(tc.fqtn())
            break
        logger.warning("top-bottom sample for %s mismatched, retrying "
                       "(%d/%d)", tc.fqtn(), attempt + 1, COMPARE_RETRIES)
        tc.mismatches = saved
        tc.compared_rows = saved_compared
        time.sleep(attempt * 0.2)
    if not matched:
        # re-run once more to leave the mismatch details in the report
        left = _collect_keyed(src, "load_top_bottom_sample", td, keys)
        right = (_collect_keyed(dst, "load_top_bottom_sample", td, keys)
                 if dst_sampleable else right)
        match_keyed(left, right, count_missing_right=dst_sampleable)
        return

    # random keyset probe (checksum.go:306-337)
    left = _collect_keyed(src, "load_random_sample", td, keys)
    if not left:
        return
    key_set = [dict(zip(keys, k)) for k in left]
    if dst_sampleable:
        right = _collect_keyed(dst, "load_sample_by_set", td, keys, key_set)
    else:
        right = {}
        def dst_pusher(batch):
            for it in _iter_rows(batch):
                d = it.as_dict()
                k = _row_key(d, keys)
                if k in left:
                    right[k] = d
        dst.load_table(td, dst_pusher)
    match_keyed(left, right)


# ---------------------------------------------------------------------------
# schema comparison (checksum.go compareSchema / comparePrimaryKeys)


def _compare_schemas(tc: TableChecksum, errors: ErrorMap,
                     lcols: dict[str, ColSchema],
                     rcols: dict[str, ColSchema],
                     lkeys: Sequence[str], rkeys: Sequence[str],
                     equal_data_types: Callable[[str, str], bool]) -> bool:
    ok = True
    for name in set(lcols) | set(rcols):
        if name not in lcols:
            errors.add(tc.fqtn(), SCHEMA_MISMATCH_ERROR,
                       f"column '{name}' not found in source table")
            ok = False
        elif name not in rcols:
            errors.add(tc.fqtn(), SCHEMA_MISMATCH_ERROR,
                       f"column '{name}' not found in target table")
            ok = False
        elif not equal_data_types(lcols[name].data_type.value,
                                  rcols[name].data_type.value):
            errors.add(tc.fqtn(), SCHEMA_MISMATCH_ERROR,
                       f"column types differ for column '{name}': "
                       f"(source) {lcols[name].data_type} != "
                       f"{rcols[name].data_type} (target)")
            ok = False
    if list(lkeys) != list(rkeys):
        errors.add(tc.fqtn(), SCHEMA_MISMATCH_ERROR,
                   f"primary keys differ: (source) {list(lkeys)} != "
                   f"{list(rkeys)} (target)")
        ok = False
    if not ok:
        tc.mismatches.extend(errors.table_errors(tc.fqtn()))
    return ok


_TYPE_FAMILIES = (
    {"int8", "int16", "int32", "int64",
     "uint8", "uint16", "uint32", "uint64"},
    {"float", "double"},
    {"date", "datetime", "timestamp"},
    # heterogeneous sinks without native decimal/json store them as text
    {"string", "utf8", "any", "decimal"},
    {"interval", "int64"},
)


def heterogeneous_data_types(a: str, b: str) -> bool:
    """Data-type equality for cross-provider checksums: exact match or the
    same family after target-rule widening (e.g. pg text -> CH String,
    pg numeric -> CH String)."""
    a, b = a.lower(), b.lower()
    if a == b:
        return True
    return any(a in fam and b in fam for fam in _TYPE_FAMILIES)


# ---------------------------------------------------------------------------
# entry points


def compare_checksum(src: Storage, dst: Storage,
                     tables: Optional[list[TableID]] = None,
                     params: Optional[ChecksumParameters] = None,
                     equal_data_types: Callable[[str, str], bool] =
                     lambda a, b: a == b,
                     metrics: Optional[Metrics] = None,
                     device: DeviceLike = None) -> ChecksumReport:
    """Compare src and dst storages table by table (CompareChecksum).
    `device` is where a non-host fingerprint runs."""
    params = params or ChecksumParameters()
    errors = ErrorMap()
    report = ChecksumReport()
    want = tables or params.tables or None
    src_tables = src.table_list(
        [TableID(t.namespace, t.name) for t in want] if want else None)
    for tid in src_tables:
        tc = TableChecksum(table=tid)
        report.tables.append(tc)
        try:
            tc.source_rows = src.exact_table_rows_count(tid)
            tc.target_rows = dst.exact_table_rows_count(tid)
        except Exception as e:
            errors.add(tc.fqtn(), GENERIC_ERROR, f"row count failed: {e}")
            tc.mismatches.append(f"row count failed: {e}")
            continue
        if tc.source_rows != tc.target_rows:
            tc.mismatches.append(
                f"row counts differ: src={tc.source_rows} "
                f"dst={tc.target_rows}")

        _, lcols, lkeys = _schema_maps(src, tid)
        _, rcols, rkeys = _schema_maps(dst, tid)
        if not _compare_schemas(tc, errors, lcols, rcols, lkeys, rkeys,
                                equal_data_types):
            continue

        td = TableDescription(id=tid)
        if params.method == "fingerprint" and \
                tc.source_rows == tc.target_rows:
            # differing row counts are already a verdict — skip the
            # full-scan digest and go straight to row-level diagnosis
            matched = _fingerprint_compare(tc, errors, src, dst, td,
                                           params, device)
            if matched:
                continue
            # aggregate mismatch: fall through to the row-level strategy
            # below so the report pinpoints rows, not just the table
        size = _table_size(src, tid)
        sampled = (size > params.table_size_threshold
                   and isinstance(src, SampleableStorage)
                   and bool(lkeys))
        tc.strategy = ("fingerprint+sample" if params.method ==
                       "fingerprint" else "sample") if sampled else \
            ("fingerprint+full" if params.method == "fingerprint"
             else "full")
        pre_row_mismatches = len(tc.mismatches)
        try:
            if sampled:
                _sampled_compare(tc, errors, src, dst, td, lkeys,
                                 lcols, rcols, params)
            elif lkeys:
                _stream_full_compare(tc, errors, src, dst, td, lkeys,
                                     lcols, rcols, params)
            else:
                _positional_compare(tc, errors, src, dst, td,
                                    lcols, rcols, params)
        except Exception as e:
            errors.add(tc.fqtn(), GENERIC_ERROR, f"compare failed: {e}")
            tc.mismatches.append(f"compare failed: {e}")
        if (not sampled
                and len(tc.mismatches) == pre_row_mismatches
                and tc.mismatches
                and all(m.startswith("fingerprints differ")
                        for m in tc.mismatches)):
            # the exact-representation digest flagged drift but the
            # (family-level, tolerant) row comparators found zero row
            # differences across a FULL-coverage pass: that is encoding
            # drift, not a data mismatch — report it without failing the
            # table.  Under fingerprint+sample the row compare only saw a
            # sample, so the digest mismatch stands (the difference may
            # live in unsampled rows).
            tc.notes.extend(
                m + " (representation-only: row-level compare found "
                    "no differences)" for m in tc.mismatches)
            tc.mismatches.clear()
        if len(tc.mismatches) > 50:
            tc.mismatches = tc.mismatches[:50] + ["...truncated"]
    return report


def _fingerprint_compare(tc: TableChecksum, errors: ErrorMap,
                         src: Storage, dst: Storage,
                         td: TableDescription,
                         params: ChecksumParameters,
                         device: DeviceLike) -> bool:
    """Order-independent digest compare (ops/rowhash.py).

    Streams both tables through TableFingerprinter (device-reduced when
    the link profile makes that profitable) and compares the aggregates.
    Returns True when the table matched — the caller skips the row-level
    pass; False on mismatch/error so row-level diagnosis runs.
    """
    def run(storage: Storage):
        fp = TableFingerprinter(backend=params.fingerprint_backend,
                                device=device)

        def pusher(batch):
            if is_columnar(batch):
                fp.push(batch)
                return
            rows = [it for it in _iter_rows(batch)]
            if rows:
                fp.push(ColumnBatch.from_rows(rows))

        storage.load_table(td, pusher)
        return fp.result()

    try:
        left = run(src)
        right = run(dst)
    except Exception as e:
        # the reference records a failed fingerprint in the error map only
        # and lets the row-level pass decide; the port fails the table, so
        # a kernel that did not build or launch, or a read that raised,
        # never passes behind a row-level verdict (sampled on a large
        # table).  The row-level pass still runs, as the diagnosis
        errors.add(tc.fqtn(), GENERIC_ERROR, f"fingerprint failed: {e}")
        tc.mismatches.append(f"fingerprint failed: {e}")
        return False
    tc.source_fingerprint = left.digest()
    tc.target_fingerprint = right.digest()
    if left == right:
        tc.strategy = "fingerprint"
        return True
    tc.mismatches.append(
        f"fingerprints differ: src={left.digest()} dst={right.digest()}")
    return False


def _positional_compare(tc: TableChecksum, errors: ErrorMap,
                        src: Storage, dst: Storage, td: TableDescription,
                        lcols: dict, rcols: dict,
                        params: ChecksumParameters) -> None:
    """Keyless tables: compare by position (best-effort)."""
    lrows: list[dict] = []
    rrows: list[dict] = []

    def lp(batch):
        lrows.extend(it.as_dict() for it in _iter_rows(batch))

    def rp(batch):
        rrows.extend(it.as_dict() for it in _iter_rows(batch))

    src.load_table(td, lp)
    dst.load_table(td, rp)
    if params.max_rows:
        lrows = lrows[:params.max_rows]
        rrows = rrows[:params.max_rows]
    for i, (a, b) in enumerate(zip(lrows, rrows)):
        _compare_rows(tc, a, b, (i,), lcols, rcols,
                      params.priority_comparators)


def checksum(source_storage: Storage, target_storage: Storage,
             tables: Optional[list[TableID]] = None,
             sample_rows: int = 1000,
             metrics: Optional[Metrics] = None,
             params: Optional[ChecksumParameters] = None,
             device: DeviceLike = None) -> ChecksumReport:
    """Back-compat entry point (Checksum at checksum.go:140).

    Uses family-level type equality so heterogeneous pairs compare out
    of the box, and honors sample_rows as the per-table compare cap.
    `device` is where a non-host fingerprint runs."""
    if params is None:
        params = ChecksumParameters(max_rows=sample_rows)
    return compare_checksum(source_storage, target_storage, tables,
                            params, equal_data_types=heterogeneous_data_types,
                            metrics=metrics, device=device)
