"""ColumnBatch: Arrow-style columnar block (the port's copy of what it uses).

Copied from ``transferia_tpu/columnar/batch.py`` down to what the fused
mask+filter path, the table fingerprint and the rename and lambda
transformers use: flat columns, dictionary encodings (`DictPool` with
its memo, `DictEnc`, lazy dict columns), the row-count buckets, the
offsets guard and the renames (`Column.renamed`,
`ColumnBatch.rename_table`).  Pool interning (`intern_pool`),
Arrow interop and `ChangeItem` rows are not ported yet (ROADMAP.md).

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
import threading
from typing import Any, Optional, Sequence

import numpy as np

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


def _gather_varwidth(data: np.ndarray, offsets: np.ndarray,
                     indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather var-width rows by index (vectorized numpy)."""
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


def _gather_fixed(data: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Fixed-width gather (numpy semantics: out-of-range raises)."""
    return data[indices]


_materialize_lock = threading.Lock()
_materializations = 0


def flat_materializations() -> int:
    """How many dictionary columns were flattened since the last reset
    (the counterpart of the JAX package's dict_flat_materializations)."""
    return _materializations


def reset_flat_materializations() -> None:
    global _materializations
    with _materialize_lock:
        _materializations = 0


def _count_materialization() -> None:
    global _materializations
    with _materialize_lock:
        _materializations += 1


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
            _count_materialization()
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
    """A columnar block of rows for one table (insert-only: CDC kinds,
    LSNs and row sidecars are not ported yet)."""

    __slots__ = ("table_id", "schema", "columns")

    def __init__(self, table_id: TableID, schema: TableSchema,
                 columns: dict[str, Column]):
        self.table_id = table_id
        self.schema = schema
        self.columns = columns
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
            return 0
        return next(iter(self.columns.values())).n_rows

    def column(self, name: str) -> Column:
        return self.columns[name]

    @staticmethod
    def from_pydict(table_id: TableID, schema: TableSchema,
                    data: dict[str, Sequence[Any]]) -> "ColumnBatch":
        cols = {}
        for cs in schema:
            if cs.name in data:
                cols[cs.name] = Column.from_pylist(
                    cs.name, cs.data_type, data[cs.name]
                )
        return ColumnBatch(table_id, schema, cols)

    def to_pydict(self) -> dict[str, list[Any]]:
        return {name: c.to_pylist() for name, c in self.columns.items()}

    def with_columns(self, columns: dict[str, Column],
                     schema: Optional[TableSchema] = None) -> "ColumnBatch":
        return ColumnBatch(self.table_id, schema or self.schema, columns)

    def rename_table(self, table_id: TableID) -> "ColumnBatch":
        """The same columns under another table id (the JAX package's
        `ColumnBatch.rename_table`, columnar/batch.py:838)."""
        return ColumnBatch(table_id, self.schema, self.columns)

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return self.take(np.nonzero(np.asarray(mask))[0])

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.table_id, self.schema,
                           {n: c.take(indices)
                            for n, c in self.columns.items()})

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        return self.take(np.arange(start, min(stop, self.n_rows)))

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
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
            data = np.concatenate([p.data for p in parts])
            offsets = None
            if c0.offsets is not None:
                offsets = _offsets_from_lengths(np.concatenate([
                    p.offsets[1:] - p.offsets[:-1] for p in parts
                ]))
            cols[name] = Column(name, c0.ctype, data, offsets, validity)
        return ColumnBatch(first.table_id, first.schema, cols)
