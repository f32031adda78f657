"""MVCC columnar staging store (the port's copy of ``transferia_tpu/mvcc/``).

Snapshot parts land as immutable encoded BASE versions while CDC deltas
accumulate as LSN-ordered DELTA layers; point-in-time reads merge both
at a watermark, and the snapshot->replication cutover is one fenced
coordinator decision.  PK identity is `batch_row_keys`, kernel K10 on a
card.  The reference's spill (`mvcc/spill.py`) needs pyarrow: the port
keeps every layer in memory, as the reference does without pyarrow.
"""

from transferia_tpu_torch.mvcc.store import (  # noqa: F401
    BaseVersion,
    DeltaLayer,
    MvccStore,
    OversizeLayerError,
    register_store,
    resolve_store,
    unregister_store,
)
