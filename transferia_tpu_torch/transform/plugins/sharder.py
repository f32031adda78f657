"""Row -> shard mapping (the port's copy of `hash_column_to_shards` from
``transferia_tpu/transform/plugins/sharder.py``), which the Kafka sink's
`partition_by` uses.  The `sharder` and `table_splitter` transformers
wait (ROADMAP.md A10).

FNV-1a wraps uint64 on purpose, so the hash stays numpy: torch on the
CPU has no uint64 multiply.
"""

from __future__ import annotations

import numpy as np

from transferia_tpu_torch.columnar.batch import Column


def hash_column_to_shards(col: Column, n_shards: int) -> np.ndarray:
    """Deterministic row -> shard mapping (FNV-1a over value bytes).

    Vectorized for fixed-width columns; var-width uses the flat buffer
    with per-row reduction."""
    FNV_OFFSET = np.uint64(14695981039346656037)
    FNV_PRIME = np.uint64(1099511628211)
    n = col.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if col.offsets is None:
        raw = np.ascontiguousarray(col.data).view(np.uint8).reshape(n, -1)
        h = np.full(n, FNV_OFFSET, dtype=np.uint64)
        for j in range(raw.shape[1]):
            h = (h ^ raw[:, j].astype(np.uint64)) * FNV_PRIME
    else:
        h = np.full(n, FNV_OFFSET, dtype=np.uint64)
        data, offsets = col.data, col.offsets
        lens = offsets[1:] - offsets[:-1]
        max_len = int(lens.max()) if n else 0
        for j in range(max_len):
            active = lens > j
            idx = offsets[:-1][active] + j
            b = np.zeros(n, dtype=np.uint64)
            b[active] = data[idx].astype(np.uint64)
            h = np.where(active, (h ^ b) * FNV_PRIME, h)
    return (h % np.uint64(n_shards)).astype(np.int32)
