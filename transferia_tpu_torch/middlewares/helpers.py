"""Batch introspection helpers shared by middlewares and sinks."""

from __future__ import annotations

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar


def batch_len(batch: Batch) -> int:
    if is_columnar(batch):
        return batch.n_rows
    return len(batch)


def batch_bytes(batch: Batch) -> int:
    if is_columnar(batch):
        return batch.nbytes()
    return sum(max(it.size_bytes, 64) for it in batch)


def is_control_batch(batch: Batch) -> bool:
    """True if the batch contains any non-row (control/DDL) items."""
    if is_columnar(batch):
        return False
    return any(not it.is_row_event() for it in batch)


def split_rows_controls(batch: Batch) -> list[Batch]:
    """Split a row-item batch into maximal homogeneous runs: row-only
    runs stay together; each non-row item becomes its own single-item
    batch.  Columnar batches pass through unchanged; order is kept."""
    if is_columnar(batch) or not is_control_batch(batch):
        return [batch]
    out: list[Batch] = []
    run: list[ChangeItem] = []
    for it in batch:
        if it.is_row_event():
            run.append(it)
        else:
            if run:
                out.append(run)
                run = []
            out.append([it])
    if run:
        out.append(run)
    return out
