"""ColumnBatch: Arrow-style columnar block (the port's copy of what it uses).

Copied from ``transferia_tpu/columnar/batch.py`` down to what the fused
mask+filter path, the table fingerprint and the rename and lambda
transformers use: flat columns, dictionary encodings (`DictPool` with
its memo, `DictEnc`, lazy dict columns), the row-count buckets, the
offsets guard and the renames (`Column.renamed`,
`ColumnBatch.rename_table`), and the row view: CDC kinds, LSNs,
commit times and row sidecars on `ColumnBatch`, the `ChangeItem` pivot
(`from_rows`/`to_rows`) and the shared-pool `concat` that keeps a
dictionary column encoded.  Pool interning (`intern_pool`) and Arrow
interop are not ported yet (ROADMAP.md).

- Fixed-width canonical types map 1:1 to numpy dtypes
  (`CanonicalType.np_dtype`).
- Variable-width types (string/utf8/any/decimal) are a flat uint8 byte
  buffer plus (n_rows+1) int32 offsets.
- NULLs are a boolean validity array (True = valid), matching Arrow.
- A dictionary-encoded column keeps int32 codes into a shared `DictPool`;
  its flat (data, offsets) materialize only when a consumer asks, and
  every such flattening is counted (`flat_materializations`): the
  code-native paths (the fingerprint) must keep that count at 0.
- `bucket_rows` pads batches to a few standard sizes, so the device
  program sees a handful of shapes instead of one per batch.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

import numpy as np

from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import CODE_KINDS, KIND_CODES, Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)

_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
_INT32_MAX = 2**31 - 1


def _offsets_from_lengths(lengths) -> np.ndarray:
    """Build int32 offsets from per-row byte lengths, guarding overflow.

    Device kernels index with int32; a single batch's var-width column must
    stay under 2 GiB — fail loudly rather than let numpy wrap the cumsum.
    """
    off64 = np.zeros(len(lengths) + 1, dtype=np.int64)
    if len(lengths):
        np.cumsum(lengths, dtype=np.int64, out=off64[1:])
    if off64[-1] > _INT32_MAX:
        raise ValueError(
            f"variable-width column exceeds 2GiB in one batch "
            f"({int(off64[-1])} bytes); split the batch"
        )
    return off64.astype(np.int32)


def _gather_indices(indices, n: int) -> np.ndarray:
    """Gather indices as contiguous int64, numpy's semantics checked up
    front (the host library's loops are unchecked): a negative index
    counts from the end, any other out-of-range one raises IndexError."""
    idx = np.asarray(indices)
    if idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    if idx.dtype.kind not in "iu":
        raise IndexError("arrays used as indices must be of integer type")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    lo, hi = int(idx.min()), int(idx.max())
    if lo < -n or hi >= n:
        bad = lo if lo < -n else hi
        raise IndexError(f"index {bad} is out of bounds for axis 0 with "
                         f"size {n}")
    if lo < 0:
        idx = np.where(idx < 0, idx + n, idx)
    return idx


def _gather_varwidth(data: np.ndarray, offsets: np.ndarray,
                     indices) -> tuple[np.ndarray, np.ndarray]:
    """Gather var-width rows by index in two host-library passes: the
    lengths fold into offsets (`gather_var_offsets`), then one memcpy
    loop (`gather_var_bytes`)."""
    idx = _gather_indices(indices, len(offsets) - 1)
    n = len(idx)
    src_off = np.ascontiguousarray(offsets, dtype=np.int32)
    out_offsets = np.empty(n + 1, dtype=np.int32)
    cdll = native.lib()
    total = cdll.gather_var_offsets(src_off, idx, n, out_offsets)
    if total > _INT32_MAX:
        raise ValueError(
            f"variable-width column exceeds 2GiB in one batch "
            f"({int(total)} bytes); split the batch"
        )
    out = np.empty(int(total), dtype=np.uint8)
    if total:
        cdll.gather_var_bytes(np.ascontiguousarray(data), src_off, idx, n,
                              out_offsets, out)
    return out, out_offsets


def _gather_varwidth_plain(data: np.ndarray, offsets: np.ndarray,
                           indices: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """_gather_varwidth in vectorized numpy."""
    lens = (offsets[1:] - offsets[:-1])[indices].astype(np.int64)
    new_offsets = _offsets_from_lengths(lens)  # guards the 2GiB limit
    total = int(new_offsets[-1])
    starts = offsets[:-1][indices].astype(np.int64)
    intra = np.arange(total, dtype=np.int64) - np.repeat(
        new_offsets[:-1].astype(np.int64), lens)
    src = np.repeat(starts, lens) + intra
    out = data[src] if total else np.zeros(0, dtype=np.uint8)
    return out, new_offsets


def _contiguous_span(indices) -> Optional[tuple[int, int]]:
    """[lo, hi) when indices is exactly lo, lo+1, ..., hi-1; else None."""
    n = len(indices)
    if n == 0 or not isinstance(indices, np.ndarray) \
            or indices.dtype.kind not in "iu":
        return None
    lo = int(indices[0])
    hi = int(indices[-1]) + 1
    if hi - lo != n or lo < 0:
        return None
    if n > 1 and not bool((np.diff(indices) == 1).all()):
        return None
    return lo, hi


def _gather_fixed(data: np.ndarray, indices) -> np.ndarray:
    """Fixed-width gather in the host library's width-specialized loop
    (numpy semantics: out-of-range raises)."""
    idx = _gather_indices(indices, len(data))
    out = np.empty(len(idx), dtype=data.dtype)
    if len(idx):
        native.lib().gather_fixed(np.ascontiguousarray(data).view(np.uint8),
                                  idx, len(idx), data.dtype.itemsize,
                                  out.view(np.uint8))
    return out


def flat_materializations() -> int:
    """How many dictionary columns were flattened since the last reset:
    `TELEMETRY`'s dict_flat_materializations."""
    from transferia_tpu_torch.stats.trace import TELEMETRY

    return TELEMETRY.dict_flat_materializations


def reset_flat_materializations() -> None:
    from transferia_tpu_torch.stats.trace import TELEMETRY

    TELEMETRY.reset_dict_materializations()


class DictPool:
    """The value pool of a dictionary encoding, shareable across batches.

    values_data/values_offsets: the pool as flat uint8 bytes + (k+1) int32.
    null_code: index of the designated empty-bytes sentinel entry, if one
    was appended (nulls materialize as empty bytes, the canonical null
    representation of the flat path).
    memos: per-pool computation cache (e.g. the fingerprint's per-entry
    accumulators): a pool shared by many batches is hashed once.
    """

    __slots__ = ("values_data", "values_offsets", "null_code", "_memos")

    def __init__(self, values_data: np.ndarray, values_offsets: np.ndarray,
                 null_code: Optional[int] = None):
        self.values_data = values_data
        self.values_offsets = values_offsets
        self.null_code = null_code
        self._memos: dict = {}

    @property
    def n_values(self) -> int:
        return len(self.values_offsets) - 1

    def nbytes(self) -> int:
        return self.values_data.nbytes + self.values_offsets.nbytes

    def value_bytes(self, code: int) -> bytes:
        return bytes(self.values_data[
            self.values_offsets[code]:self.values_offsets[code + 1]])

    def memo_get(self, key):
        return self._memos.get(key)

    def memo_set(self, key, value) -> None:
        self._memos[key] = value


class DictEnc:
    """Dictionary encoding of a variable-width column.

    indices: (n,) int32 codes into the shared value pool.  Flat (data,
    offsets) materialize lazily the first time a consumer asks, so
    correctness never depends on a consumer knowing the encoding.
    """

    __slots__ = ("indices", "pool")

    def __init__(self, indices: np.ndarray, pool: DictPool):
        self.indices = indices
        self.pool = pool

    def nbytes(self) -> int:
        return self.indices.nbytes + self.pool.nbytes()

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        """Flatten to (data, offsets): a gather of the pool by codes."""
        return _gather_varwidth(self.pool.values_data,
                                self.pool.values_offsets,
                                self.indices.astype(np.int64))


def bucket_rows(n: int) -> int:
    """Smallest standard bucket >= n."""
    for b in _BUCKETS:
        if n <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it
    top = _BUCKETS[-1]
    return ((n + top - 1) // top) * top


class Column:
    """One column of a batch.

    data: fixed-width -> (n,) array of ctype.np_dtype
          variable-width -> (total_bytes,) uint8 buffer
    offsets: (n+1,) int32 — only for variable-width columns
    validity: (n,) bool (True = present) or None meaning all-valid
    dict_enc: optional dictionary encoding (var-width only); when set with
          data=None the flat buffers materialize lazily on first access
    """

    __slots__ = ("name", "ctype", "_data", "_offsets", "validity",
                 "dict_enc")

    def __init__(self, name: str, ctype: CanonicalType,
                 data: Optional[np.ndarray] = None,
                 offsets: Optional[np.ndarray] = None,
                 validity: Optional[np.ndarray] = None,
                 dict_enc: Optional[DictEnc] = None):
        if ctype.is_variable_width:
            if offsets is None and dict_enc is None:
                raise ValueError(f"column {name}: var-width requires offsets")
        elif data is None:
            raise ValueError(f"column {name}: fixed-width requires data")
        self.name = name
        self.ctype = ctype
        self._data = data
        self._offsets = offsets
        self.validity = validity
        self.dict_enc = dict_enc

    def _materialize(self) -> None:
        if self._data is None:
            # counted: every flatten of a dict column is a defeat of the
            # code-native pipeline — the dict_flat_materializations /
            # lazy_dict_preserved pair makes regressions visible
            from transferia_tpu_torch.stats.trace import TELEMETRY

            TELEMETRY.record_dict_materialize()
            self._data, self._offsets = self.dict_enc.materialize()

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._materialize()
        return self._data

    @data.setter
    def data(self, v: np.ndarray) -> None:
        self._data = v

    @property
    def offsets(self) -> Optional[np.ndarray]:
        if self._offsets is None and self.dict_enc is not None:
            self._materialize()
        return self._offsets

    @offsets.setter
    def offsets(self, v: Optional[np.ndarray]) -> None:
        self._offsets = v

    @property
    def is_lazy_dict(self) -> bool:
        """True while dictionary-encoded with no flat copy materialized."""
        return self.dict_enc is not None and self._data is None

    @property
    def n_rows(self) -> int:
        if self.dict_enc is not None and self._offsets is None:
            return len(self.dict_enc.indices)
        if self._offsets is not None:
            return len(self._offsets) - 1
        return len(self._data)

    def nbytes(self) -> int:
        if self.is_lazy_dict:
            n = self.dict_enc.nbytes()
        else:
            n = self._data.nbytes
            if self._offsets is not None:
                n += self._offsets.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def is_valid(self, i: int) -> bool:
        return self.validity is None or bool(self.validity[i])

    def value(self, i: int) -> Any:
        """Python value at row i (None when invalid)."""
        if not self.is_valid(i):
            return None
        if self.is_lazy_dict:
            raw = self.dict_enc.pool.value_bytes(
                int(self.dict_enc.indices[i]))
            return _decode_varwidth(self.ctype, raw)
        if self.offsets is not None:
            raw = bytes(self.data[self.offsets[i]:self.offsets[i + 1]])
            return _decode_varwidth(self.ctype, raw)
        v = self.data[i]
        if self.ctype == CanonicalType.BOOLEAN:
            return bool(v)
        if self.ctype.is_integer or self.ctype in (
            CanonicalType.DATE, CanonicalType.DATETIME,
            CanonicalType.TIMESTAMP, CanonicalType.INTERVAL,
        ):
            return int(v)
        return float(v)

    def to_pylist(self) -> list[Any]:
        return [self.value(i) for i in range(self.n_rows)]

    def renamed(self, name: str) -> "Column":
        """Copy under a new name, buffers and encoding shared (the JAX
        package's `Column.renamed`, columnar/batch.py:529)."""
        return Column(name, self.ctype, self._data, self._offsets,
                      self.validity, self.dict_enc)

    def take(self, indices: np.ndarray) -> "Column":
        """Gather rows; a contiguous ascending range returns views, and a
        lazy dict column gathers only its codes (the pool stays shared)."""
        span = _contiguous_span(indices)
        if span is not None and span[1] <= self.n_rows:
            return self._take_contiguous(*span)
        validity = (_gather_fixed(self.validity, indices)
                    if self.validity is not None else None)
        if self.is_lazy_dict:
            enc = self.dict_enc
            return Column(
                self.name, self.ctype, validity=validity,
                dict_enc=DictEnc(_gather_fixed(enc.indices, indices),
                                 pool=enc.pool))
        if self.offsets is None:
            return Column(self.name, self.ctype,
                          _gather_fixed(self.data, indices), None, validity)
        out, new_offsets = _gather_varwidth(
            self.data, self.offsets,
            np.ascontiguousarray(indices, dtype=np.int64))
        return Column(self.name, self.ctype, out, new_offsets, validity)

    def _take_contiguous(self, lo: int, hi: int) -> "Column":
        """take() of [lo, hi) as views over the existing buffers."""
        validity = self.validity[lo:hi] if self.validity is not None else None
        if self.is_lazy_dict:
            enc = self.dict_enc
            return Column(
                self.name, self.ctype, validity=validity,
                dict_enc=DictEnc(enc.indices[lo:hi], pool=enc.pool))
        if self.offsets is None:
            return Column(self.name, self.ctype, self.data[lo:hi], None,
                          validity)
        off = self.offsets[lo:hi + 1]
        if off[0] == 0:
            return Column(self.name, self.ctype, self.data[:off[-1]], off,
                          validity)
        return Column(self.name, self.ctype, self.data[off[0]:off[-1]],
                      off - off[0], validity)

    @staticmethod
    def from_pylist(name: str, ctype: CanonicalType,
                    values: Sequence[Any]) -> "Column":
        n = len(values)
        validity = np.fromiter(
            (v is not None for v in values), dtype=np.bool_, count=n
        )
        all_valid = bool(validity.all()) if n else True
        if ctype.is_variable_width:
            bufs = [
                _encode_varwidth(ctype, v) if v is not None else b""
                for v in values
            ]
            offsets = _offsets_from_lengths([len(b) for b in bufs])
            data = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy() \
                if bufs else np.zeros(0, dtype=np.uint8)
            return Column(name, ctype, data, offsets,
                          None if all_valid else validity)
        data = np.zeros(n, dtype=ctype.np_dtype)
        for i, v in enumerate(values):
            if v is not None:
                data[i] = v
        return Column(name, ctype, data, None, None if all_valid else validity)


def _encode_varwidth(ctype: CanonicalType, v: Any) -> bytes:
    if ctype == CanonicalType.STRING:
        if isinstance(v, bytes):
            return v
        return str(v).encode()
    if ctype in (CanonicalType.UTF8, CanonicalType.DECIMAL):
        return v.encode() if isinstance(v, str) else str(v).encode()
    # ANY: canonical JSON bytes
    if isinstance(v, bytes):
        return v
    return json.dumps(v, separators=(",", ":"), default=str).encode()


def _decode_varwidth(ctype: CanonicalType, raw: bytes) -> Any:
    if ctype == CanonicalType.STRING:
        return raw
    if ctype in (CanonicalType.UTF8, CanonicalType.DECIMAL):
        return raw.decode("utf-8", errors="replace")
    try:
        return json.loads(raw) if raw else None
    except (ValueError, UnicodeDecodeError):
        return raw


class ColumnBatch:
    """A columnar block of rows for one table.

    kinds is None for pure-insert (snapshot) blocks; otherwise an int8
    array of KIND_CODES for mixed CDC blocks.  lsns/commit_times are
    optional per-row metadata carried through the pipeline.  old_keys/
    txn_ids are host-side per-row sidecars (never staged to the device)
    that keep CDC row identity across the pivot.
    """

    __slots__ = ("table_id", "schema", "columns", "kinds", "lsns",
                 "commit_times", "part_id", "read_bytes", "old_keys",
                 "txn_ids")

    def __init__(self, table_id: TableID, schema: TableSchema,
                 columns: dict[str, Column],
                 kinds: Optional[np.ndarray] = None,
                 lsns: Optional[np.ndarray] = None,
                 commit_times: Optional[np.ndarray] = None,
                 part_id: str = "", read_bytes: int = 0,
                 old_keys: Optional[list[OldKeys]] = None,
                 txn_ids: Optional[list[str]] = None):
        self.table_id = table_id
        self.schema = schema
        self.columns = columns
        self.kinds = kinds
        self.lsns = lsns
        self.commit_times = commit_times
        self.part_id = part_id
        self.read_bytes = read_bytes
        self.old_keys = old_keys
        self.txn_ids = txn_ids
        n = self.n_rows
        for c in columns.values():
            if c.n_rows != n:
                raise ValueError(
                    f"ragged batch: column {c.name} has {c.n_rows} rows, "
                    f"expected {n}"
                )

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0 if self.kinds is None else len(self.kinds)
        return next(iter(self.columns.values())).n_rows

    def __len__(self) -> int:
        return self.n_rows

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns.values())

    def kind_at(self, i: int) -> Kind:
        if self.kinds is None:
            return Kind.INSERT
        return CODE_KINDS[int(self.kinds[i])]

    def column(self, name: str) -> Column:
        return self.columns[name]

    def _meta(self) -> dict:
        """The per-batch metadata every derived batch carries over."""
        return dict(kinds=self.kinds, lsns=self.lsns,
                    commit_times=self.commit_times, part_id=self.part_id,
                    read_bytes=self.read_bytes, old_keys=self.old_keys,
                    txn_ids=self.txn_ids)

    @staticmethod
    def from_pydict(table_id: TableID, schema: TableSchema,
                    data: dict[str, Sequence[Any]], **kw) -> "ColumnBatch":
        cols = {}
        for cs in schema:
            if cs.name in data:
                cols[cs.name] = Column.from_pylist(
                    cs.name, cs.data_type, data[cs.name]
                )
        return ColumnBatch(table_id, schema, cols, **kw)

    @staticmethod
    def from_rows(items: Sequence[ChangeItem]) -> "ColumnBatch":
        """Pivot a uniform-table row batch into a columnar block.

        All items must share table_id and table_schema; mixed kinds are
        captured in the kinds array.
        """
        from transferia_tpu_torch.stats import trace

        sp = trace.span("pivot")
        if sp:
            sp.add(rows=len(items), direction="rows_to_columns")
        with sp:
            return ColumnBatch._from_rows_impl(items)

    @staticmethod
    def _from_rows_impl(items: Sequence[ChangeItem]) -> "ColumnBatch":
        if not items:
            raise ValueError("from_rows: empty batch")
        first = items[0]
        if first.table_schema is None:
            raise ValueError("from_rows: items must carry table_schema")
        schema = first.table_schema
        tid = first.table_id
        n = len(items)
        per_col: dict[str, list[Any]] = {c.name: [None] * n for c in schema}
        kinds = np.zeros(n, dtype=np.int8)
        lsns = np.zeros(n, dtype=np.int64)
        commit_times = np.zeros(n, dtype=np.int64)
        mixed = False
        old_keys: Optional[list[OldKeys]] = None
        txn_ids: Optional[list[str]] = None
        for i, it in enumerate(items):
            if it.table_id != tid:
                raise ValueError("from_rows: mixed tables in batch")
            if it.table_schema is not schema and it.table_schema != schema:
                raise ValueError(
                    "from_rows: mixed table schemas in batch (schema changed "
                    "mid-stream?) — split the batch on schema boundaries"
                )
            code = KIND_CODES.get(it.kind)
            if code is None:
                raise ValueError(f"from_rows: non-row kind {it.kind}")
            kinds[i] = code
            mixed = mixed or code != 0
            lsns[i] = it.lsn
            commit_times[i] = it.commit_time_ns
            if it.old_keys.key_names:
                if old_keys is None:
                    old_keys = [OldKeys()] * n
                old_keys[i] = it.old_keys
            if it.txn_id:
                if txn_ids is None:
                    txn_ids = [""] * n
                txn_ids[i] = it.txn_id
            for name, value in zip(it.column_names, it.column_values):
                if name in per_col:
                    per_col[name][i] = value
        cols = {
            c.name: Column.from_pylist(c.name, c.data_type, per_col[c.name])
            for c in schema
        }
        return ColumnBatch(
            tid, schema, cols,
            kinds=kinds if mixed else None,
            lsns=lsns if lsns.any() else None,
            commit_times=commit_times if commit_times.any() else None,
            part_id=first.part_id,
            read_bytes=sum(it.size_bytes for it in items),
            old_keys=old_keys,
            txn_ids=txn_ids,
        )

    def to_rows(self) -> list[ChangeItem]:
        """Unpivot to ChangeItems (row-oriented edges only)."""
        from transferia_tpu_torch.stats import trace

        sp = trace.span("pivot")
        if sp:
            sp.add(rows=self.n_rows, direction="columns_to_rows")
        with sp:
            return self._to_rows_impl()

    def _to_rows_impl(self) -> list[ChangeItem]:
        names = tuple(self.columns.keys())
        cols = list(self.columns.values())
        out = []
        for i in range(self.n_rows):
            out.append(ChangeItem(
                kind=self.kind_at(i),
                schema=self.table_id.namespace,
                table=self.table_id.name,
                column_names=names,
                column_values=tuple(c.value(i) for c in cols),
                table_schema=self.schema,
                lsn=int(self.lsns[i]) if self.lsns is not None else 0,
                commit_time_ns=int(self.commit_times[i])
                if self.commit_times is not None else 0,
                part_id=self.part_id,
                old_keys=self.old_keys[i] if self.old_keys is not None
                else OldKeys(),
                txn_id=self.txn_ids[i] if self.txn_ids is not None else "",
            ))
        return out

    def to_pydict(self) -> dict[str, list[Any]]:
        return {name: c.to_pylist() for name, c in self.columns.items()}

    def with_columns(self, columns: dict[str, Column],
                     schema: Optional[TableSchema] = None) -> "ColumnBatch":
        return ColumnBatch(self.table_id, schema or self.schema, columns,
                           **self._meta())

    def rename_table(self, table_id: TableID) -> "ColumnBatch":
        """The same columns under another table id (the JAX package's
        `ColumnBatch.rename_table`, columnar/batch.py:838)."""
        return ColumnBatch(table_id, self.schema, self.columns,
                           **self._meta())

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return self.take(np.nonzero(np.asarray(mask))[0])

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        meta = self._meta()
        for attr in ("kinds", "lsns", "commit_times"):
            if meta[attr] is not None:
                meta[attr] = meta[attr][indices]
        for attr in ("old_keys", "txn_ids"):
            if meta[attr] is not None:
                meta[attr] = [meta[attr][int(i)] for i in indices]
        return ColumnBatch(self.table_id, self.schema,
                           {n: c.take(indices)
                            for n, c in self.columns.items()}, **meta)

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        return self.take(np.arange(start, min(stop, self.n_rows)))

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        """Row-wise concatenation.  A dictionary column whose parts all
        share one pool (slices of one source batch, or batches of a
        source with one pool per column) stays encoded: its codes
        concatenate; any other column concatenates flat."""
        if not batches:
            raise ValueError("concat: empty")
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        cols = {}
        for name, c0 in first.columns.items():
            parts = [b.columns[name] for b in batches]
            validity = None
            if any(p.validity is not None for p in parts):
                validity = np.concatenate([
                    p.validity if p.validity is not None
                    else np.ones(p.n_rows, dtype=np.bool_)
                    for p in parts
                ])
            if (c0.is_lazy_dict and all(p.is_lazy_dict for p in parts)
                    and all(p.dict_enc.pool is c0.dict_enc.pool
                            for p in parts)):
                # slices of one row group share one DictPool: a pure
                # code concat, the column stays encoded end to end
                from transferia_tpu_torch.stats.trace import TELEMETRY

                TELEMETRY.record_dict_preserved()
                cols[name] = Column(
                    name, c0.ctype, validity=validity,
                    dict_enc=DictEnc(
                        np.concatenate([p.dict_enc.indices
                                        for p in parts]),
                        pool=c0.dict_enc.pool))
                continue
            data = np.concatenate([p.data for p in parts])
            offsets = None
            if c0.offsets is not None:
                offsets = _offsets_from_lengths(np.concatenate([
                    p.offsets[1:] - p.offsets[:-1] for p in parts
                ]))
            cols[name] = Column(name, c0.ctype, data, offsets, validity)

        def cat(attr, fill_dtype):
            arrs = [getattr(b, attr) for b in batches]
            if all(a is None for a in arrs):
                return None
            return np.concatenate([
                a if a is not None else np.zeros(b.n_rows, dtype=fill_dtype)
                for a, b in zip(arrs, batches)
            ])

        def cat_list(attr, fill):
            vals = [getattr(b, attr) for b in batches]
            if all(v is None for v in vals):
                return None
            out = []
            for v, b in zip(vals, batches):
                out.extend(v if v is not None else [fill] * b.n_rows)
            return out

        return ColumnBatch(
            first.table_id, first.schema, cols,
            kinds=cat("kinds", np.int8),
            lsns=cat("lsns", np.int64),
            commit_times=cat("commit_times", np.int64),
            part_id=first.part_id,
            read_bytes=sum(b.read_bytes for b in batches),
            old_keys=cat_list("old_keys", OldKeys()),
            txn_ids=cat_list("txn_ids", ""),
        )
