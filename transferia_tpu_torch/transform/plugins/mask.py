"""PII masking transformer: HMAC-SHA256 field hashing
(reference: pkg/transformer/registry/mask/hmac_hasher.go).

The host path hashes each value with `hmac`/`hashlib`; the fused device
step (transform/fused.py) hashes whole columns with kernel K-A and must
give the same bytes (tests pin equality).
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    _offsets_from_lengths,
)
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


def _host_hmac_hex(key: bytes, data: np.ndarray, offsets: np.ndarray,
                   validity: Optional[np.ndarray]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """64-char hex HMAC-SHA256 per valid row, empty bytes per null row."""
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
