"""PII masking transformer: HMAC-SHA256 field hashing
(reference: pkg/transformer/registry/mask/hmac_hasher.go).

The host path hashes a column in one call into the host library
(`hmac_sha256_hex`, from the key's ipad/opad states `sha256_block_state`
gives), as in the JAX package; `_host_hmac_hex_py` hashes each value with
`hmac`/`hashlib`, the spec tests hold it to.  The fused device
step (transform/fused.py) hashes whole columns with kernel K-A and must
give the same bytes (tests pin equality).  A dictionary-encoded column
hashes its value pool once (`mask_dict_column`) and keeps its codes: the
masked column stays dictionary-encoded.  The reference's hash-backend
hook (`set_hash_backend`) is not ported.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
from typing import Optional

import numpy as np

from transferia_tpu_torch import native
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    DictEnc,
    DictPool,
    _gather_varwidth,
    _offsets_from_lengths,
)
from transferia_tpu_torch.columnar.hexcol import hex_to_varwidth
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


def hmac_key_states(key: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The key's ipad/opad SHA-256 states (uint32 x 8 each), from the
    host library's one-block compression (hashlib exposes no mid-state);
    memoized per key."""
    states = _key_states.get(key)
    if states is None:
        k = hashlib.sha256(key).digest() if len(key) > 64 else key
        block = np.zeros(64, dtype=np.uint8)
        block[:len(k)] = np.frombuffer(k, dtype=np.uint8)
        inner = np.empty(8, dtype=np.uint32)
        outer = np.empty(8, dtype=np.uint32)
        cdll = native.lib()
        cdll.sha256_block_state(np.ascontiguousarray(block ^ 0x36), inner)
        cdll.sha256_block_state(np.ascontiguousarray(block ^ 0x5C), outer)
        states = _key_states.setdefault(key, (inner, outer))
    return states


_key_states: dict[bytes, tuple[np.ndarray, np.ndarray]] = {}


def _host_hmac_hex(key: bytes, data: np.ndarray, offsets: np.ndarray,
                   validity: Optional[np.ndarray]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """64-char hex HMAC-SHA256 per valid row, empty bytes per null row:
    one host-library call (it releases the GIL)."""
    n = len(offsets) - 1
    inner, outer = hmac_key_states(key)
    out_hex = np.empty((n, 64), dtype=np.uint8)
    valid_u8 = (np.ascontiguousarray(validity, dtype=np.uint8)
                if validity is not None else None)
    native.lib().hmac_sha256_hex(
        np.ascontiguousarray(data),
        np.ascontiguousarray(offsets, dtype=np.int32), n, inner, outer,
        valid_u8.ctypes.data if valid_u8 is not None else None, out_hex)
    return hex_to_varwidth(out_hex, validity)


def _host_hmac_hex_py(key: bytes, data: np.ndarray, offsets: np.ndarray,
                      validity: Optional[np.ndarray]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """_host_hmac_hex with Python's `hmac`, value by value."""
    n = len(offsets) - 1
    # zero-copy row slices (memoryview over the column buffer — hmac
    # takes any buffer) and hoisted per-row int conversions
    raw = memoryview(np.ascontiguousarray(data))
    off = offsets.tolist()
    valid = validity.tolist() if validity is not None else None
    outs = []
    for i in range(n):
        if valid is not None and not valid[i]:
            outs.append(b"")
            continue
        msg = raw[off[i]:off[i + 1]]
        outs.append(
            hmac_mod.new(key, msg, hashlib.sha256).hexdigest().encode()
        )
    out_offsets = _offsets_from_lengths([len(o) for o in outs])
    out_data = np.frombuffer(b"".join(outs), dtype=np.uint8).copy() \
        if outs else np.zeros(0, dtype=np.uint8)
    return out_data, out_offsets


def _hexed_pool(pool_hex: np.ndarray, pool_hex_off: np.ndarray,
                null_code: Optional[int]) -> DictPool:
    """Flat per-value hex digests -> a hexed DictPool with the null
    sentinel's slot emptied (null rows materialize as empty bytes, not
    HMAC of empty)."""
    if null_code is not None:
        lens = np.diff(pool_hex_off).astype(np.int64)
        lens[null_code] = 0
        new_off = _offsets_from_lengths(lens)
        keep_mask = np.ones(len(pool_hex), dtype=bool)
        s, e = (int(pool_hex_off[null_code]),
                int(pool_hex_off[null_code + 1]))
        keep_mask[s:e] = False
        pool_hex = pool_hex[keep_mask]
        pool_hex_off = new_off
    return DictPool(pool_hex, pool_hex_off, null_code=null_code)


def hexed_pool_from_flat(pool: DictPool, pool_hex: np.ndarray,
                         pool_hex_off: np.ndarray) -> DictPool:
    """Flat per-value hex digests -> the hexed DictPool, with the null
    sentinel's slot emptied.  Shared by the host hash path
    (mask_dict_column) and the device one (ops/dispatch
    .device_hmac_dict_pool): both must give identical pools for the memo
    they share to be sound."""
    return _hexed_pool(pool_hex, pool_hex_off, pool.null_code)


def dict_hex_column(col: Column, hexed: DictPool) -> Column:
    """Rebind a dict column's codes to its hexed pool: the masked output
    column, still dictionary-encoded, codes untouched unless a null
    sentinel has to be appended for a sentinel-less pool.  Every mask
    route that keeps the encoding ends here, so this is where the
    lazy_dict_preserved counter ticks."""
    from transferia_tpu_torch.stats.trace import TELEMETRY

    TELEMETRY.record_dict_preserved()
    codes = col.dict_enc.indices
    if (hexed.null_code is None and col.validity is not None
            and not col.validity.all()):
        # a pool built without a sentinel: append one now
        data = hexed.values_data
        off = np.append(hexed.values_offsets,
                        hexed.values_offsets[-1]).astype(np.int32)
        hexed = DictPool(data, off, null_code=hexed.n_values)
        codes = np.where(col.validity, codes,
                         hexed.null_code).astype(np.int32)
    return Column(col.name, CanonicalType.UTF8, validity=col.validity,
                  dict_enc=DictEnc(codes, pool=hexed))


def _mask_dict_subset(key: bytes, col: Column) -> Column:
    """HMAC only the pool values this batch references (a pool much
    larger than the batch is not hashed whole, and the rows never
    flatten into per-row HMAC input).  The column stays dict-encoded
    over a fresh subset pool; output bytes equal the flat path's."""
    enc = col.dict_enc
    pool = enc.pool
    uniq, ranks = np.unique(enc.indices, return_inverse=True)
    sub_data, sub_off = _gather_varwidth(
        pool.values_data,
        np.ascontiguousarray(pool.values_offsets, dtype=np.int32),
        uniq.astype(np.int64))
    hex_data, hex_off = _host_hmac_hex(key, sub_data, sub_off, None)
    sub_null = None
    if pool.null_code is not None:
        pos = int(np.searchsorted(uniq, pool.null_code))
        if pos < len(uniq) and int(uniq[pos]) == pool.null_code:
            sub_null = pos
    sub = _hexed_pool(hex_data, hex_off, sub_null)
    codes = ranks.astype(np.int32)
    return dict_hex_column(
        Column(col.name, col.ctype, validity=col.validity,
               dict_enc=DictEnc(codes, pool=sub)),
        sub)


def mask_dict_column(key: bytes, col: Column) -> Column:
    """HMAC a dictionary-encoded column by hashing its value pool once
    and keeping the row codes: O(unique) hashes instead of O(rows), and
    the hexed pool memoizes on the shared DictPool (key ("hmac_hex",
    key)), so batches slicing one dictionary hash it once.  Valid rows
    get the 64-char hex of their value, null rows empty bytes.  When the
    pool is much larger than the batch and not memoized, only the
    referenced subset hashes; the column never flattens either way."""
    enc = col.dict_enc
    pool = enc.pool
    memo_key = ("hmac_hex", key)
    hexed = pool.memo_get(memo_key)
    if hexed is None:
        # a pool bigger than ~2 batches of rows does not pay for itself
        # unless shared (the memo then amortizes it); 2x covers the
        # filtered-batch case
        if pool.n_values > 2 * max(col.n_rows, 1):
            return _mask_dict_subset(key, col)
        pool_hex, pool_hex_off = _host_hmac_hex(
            key, pool.values_data, pool.values_offsets, None)
        hexed = hexed_pool_from_flat(pool, pool_hex, pool_hex_off)
        pool.memo_set(memo_key, hexed)
    return dict_hex_column(col, hexed)


@register_transformer("mask_field")
class MaskField(Transformer):
    """Replace column values with HMAC-SHA256(salt, value) hex digests.

    config: columns: [...], salt: "secret", tables: optional include list.
    Masked columns become utf8 (64-char hex).  Fixed-width columns are
    stringified first (so the digest matches the reference's string-repr
    hashing).
    """

    def __init__(self, columns: list[str], salt: str = "",
                 tables: Optional[list[str]] = None):
        self.columns = columns
        self.key = salt.encode()
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        if self.tables is not None and not any(
                table.include_matches(p) for p in self.tables):
            return False
        return any(schema.find(c) is not None for c in self.columns)

    def result_schema(self, schema: TableSchema) -> TableSchema:
        return schema.with_types({
            c: CanonicalType.UTF8
            for c in self.columns if schema.find(c) is not None
        })

    def _mask_column(self, col: Column) -> Column:
        if col.is_lazy_dict:
            return mask_dict_column(self.key, col)
        if col.offsets is None:
            # stringify fixed-width values, then hash
            bufs = [
                b"" if not col.is_valid(i) else str(col.value(i)).encode()
                for i in range(col.n_rows)
            ]
            offsets = _offsets_from_lengths([len(b) for b in bufs])
            data = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy() \
                if bufs else np.zeros(0, dtype=np.uint8)
        else:
            data, offsets = col.data, col.offsets
        out_data, out_offsets = _host_hmac_hex(self.key, data, offsets,
                                               col.validity)
        return Column(col.name, CanonicalType.UTF8, out_data, out_offsets,
                      col.validity)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = dict(batch.columns)
        for name in self.columns:
            if name in cols:
                cols[name] = self._mask_column(cols[name])
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )
