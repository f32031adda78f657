"""Transfer maintenance operations (the port's copy of
``transferia_tpu/tasks/operations.py``): reupload (cleanup per policy,
then a full snapshot), add_tables (load only the new tables, then widen
the include list and persist it through the coordinator) and
remove_tables (narrow the include list; target data is left in place).
Any storage-capable source qualifies; the include list lives on the
Transfer (DataObjects).

`device` is where the snapshot's device work runs (None means CUDA,
which must be present; "cpu" runs the kernels' plain versions).
"""

from __future__ import annotations

import logging
from typing import Optional

from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.coordinator.interface import Coordinator, TransferStatus
from transferia_tpu_torch.factories import new_storage
from transferia_tpu_torch.models import CleanupPolicy
from transferia_tpu_torch.models.endpoint import capability
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

logger = logging.getLogger(__name__)

INCLUDE_STATE_KEY = "include_object_ids"


def reupload(transfer, coordinator: Coordinator,
             metrics: Optional[Metrics] = None,
             operation_id: Optional[str] = None,
             device: DeviceLike = None) -> None:
    """Full re-snapshot of an activated transfer.

    Forbidden for append-only sources: wiping the target of a
    queue-backed transfer would lose history the source no longer holds.
    """
    if capability(transfer.src, "is_append_only", False):
        raise ValueError("reupload from an append-only source is not "
                         "allowed (reupload.go:13)")
    device = resolve_device(device)
    metrics = metrics or Metrics()
    coordinator.set_status(transfer.id, TransferStatus.ACTIVATING)
    try:
        loader = SnapshotLoader(transfer, coordinator, metrics=metrics,
                                operation_id=operation_id, device=device)
        storage = new_storage(transfer, metrics)
        try:
            tables = loader.filtered_table_list(storage)
        finally:
            storage.close()
        if transfer.dst.cleanup_policy != CleanupPolicy.DISABLED:
            dst_provider = get_provider(transfer.dst_provider(), transfer,
                                        metrics, device=device)
            logger.info("reupload cleanup (%s): %d tables",
                        transfer.dst.cleanup_policy.value, len(tables))
            dst_provider.cleanup(tables)
        loader.upload_tables(tables)
        coordinator.set_status(transfer.id, TransferStatus.ACTIVATED)
    except BaseException as e:
        coordinator.set_status(transfer.id, TransferStatus.FAILED)
        coordinator.open_status_message(transfer.id, "reupload", str(e))
        raise


def add_tables(transfer, coordinator: Coordinator, tables: list[str],
               metrics: Optional[Metrics] = None,
               operation_id: Optional[str] = None,
               device: DeviceLike = None) -> None:
    """Snapshot-load new tables into a live transfer, then widen its
    include list.

    Only the added tables are loaded — existing target data is untouched
    (no cleanup pass: the new tables' schema and data move before the
    include list changes).
    """
    if not tables:
        raise ValueError("add_tables: explicit table list required")
    current = set(transfer.data_objects.include_object_ids)
    if not current:
        raise ValueError(
            "add_tables requires a transfer with an explicit include "
            "list (a transfer without one already moves every table)")
    new = [t for t in tables if t not in current]
    if not new:
        logger.info("add_tables: all requested tables already included")
        return
    metrics = metrics or Metrics()
    from transferia_tpu_torch.abstract.table import TableDescription

    loader = SnapshotLoader(transfer, coordinator, metrics=metrics,
                            operation_id=operation_id, device=device)
    loader.upload_tables([
        TableDescription(id=TableID.parse(t)) for t in new
    ])
    transfer.data_objects.include_object_ids.extend(new)
    _persist_include_list(transfer, coordinator)
    logger.info("add_tables: loaded and registered %d tables", len(new))


def remove_tables(transfer, coordinator: Coordinator,
                  tables: list[str],
                  metrics: Optional[Metrics] = None) -> None:
    """Narrow the include list.  Target data for the removed tables
    stays in place."""
    if not tables:
        raise ValueError("remove_tables: explicit table list required")
    current = transfer.data_objects.include_object_ids
    if not current:
        raise ValueError(
            "remove_tables requires a transfer with an explicit include "
            "list")
    drop = set(tables)
    kept = [t for t in current if t not in drop]
    missing = drop - set(current)
    if missing:
        raise ValueError(f"remove_tables: not in the include list: "
                         f"{sorted(missing)}")
    if not kept:
        raise ValueError("remove_tables: refusing to empty the include "
                         "list (deactivate the transfer instead)")
    transfer.data_objects.include_object_ids = kept
    _persist_include_list(transfer, coordinator)
    logger.info("remove_tables: %d tables remain", len(kept))


def _persist_include_list(transfer, coordinator: Coordinator) -> None:
    """Store the effective include list in the transfer state so
    restarted workers see the updated table set (the include list is the
    transfer's DataObjects, so it rides the transfer-state KV)."""
    state = coordinator.get_transfer_state(transfer.id)
    state[INCLUDE_STATE_KEY] = list(transfer.data_objects.include_object_ids)
    coordinator.set_transfer_state(transfer.id, state)


def apply_persisted_include_list(transfer, coordinator: Coordinator) -> None:
    """Merge a previously persisted include list back onto the transfer
    (called by the replicate/activate entry points on restart)."""
    state = coordinator.get_transfer_state(transfer.id)
    stored = state.get(INCLUDE_STATE_KEY)
    if stored:
        transfer.data_objects.include_object_ids = list(stored)
