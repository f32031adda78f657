"""Activation (the port's copy of ``transferia_tpu/tasks/activate.py``).

Flow: list tables -> primary-key checks -> destination cleanup per policy
-> the source provider's activate hook (or the default cleanup + upload)
-> the post-upload DDL hook -> mark activated.  A failed activation
marks the transfer FAILED, opens a status message and runs the
rollbacks a provider hook registered.

SNAPSHOT_AND_INCREMENT runs the source's activate hook first (slot
creation only: changes committed during the snapshot are replayable
only if the slot already pins the pre-snapshot position), then the
cleanup, then the consistent cutover through the MVCC staging store
(`mvcc/runner.py`) when the coordinator supports it and the source has
no event-model snapshot capability, else the plain upload.  The upload
of a source with that capability (`snapshot_provider`, the Delta Lake
source) runs through the event pipeline (`tasks/snapshot_v2.py`), in
either transfer type.

`device` is where the snapshot's device work runs (None means CUDA,
which must be present; "cpu" runs the kernels' plain versions).

A configured `dbt` step (`transform/plugins/dbt.py`) runs against the
target after the upload, on the main worker only.
"""

from __future__ import annotations

import logging
from typing import Optional

from transferia_tpu_torch.abstract.errors import AbortTransferError
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    TransferStatus,
)
from transferia_tpu_torch.factories import new_storage
from transferia_tpu_torch.models import CleanupPolicy, TransferType
from transferia_tpu_torch.models.endpoint import capability
from transferia_tpu_torch.providers.registry import (
    ActivateCallbacks,
    get_provider,
)
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
from transferia_tpu_torch.utils.rollbacks import Rollbacks

logger = logging.getLogger(__name__)


def activate_delivery(transfer, coordinator: Coordinator,
                      metrics: Optional[Metrics] = None,
                      operation_id: Optional[str] = None,
                      device: DeviceLike = None) -> None:
    """Activate a transfer: for a snapshot, clean the destination and
    upload every table through SnapshotLoader on `device`."""
    device = resolve_device(device)
    metrics = metrics or Metrics()
    ttype = TransferType(transfer.type)
    coordinator.set_status(transfer.id, TransferStatus.ACTIVATING)
    rollbacks = Rollbacks()
    try:
        loader = SnapshotLoader(transfer, coordinator,
                                operation_id=operation_id, metrics=metrics,
                                device=device)
        tables = None
        if ttype.has_snapshot:
            storage = new_storage(transfer, metrics)
            try:
                tables = loader.filtered_table_list(storage)
                if not tables:
                    raise AbortTransferError(
                        "no tables match the transfer's include list")
                _check_primary_keys(transfer, ttype, storage, tables)
            finally:
                storage.close()

        dst_provider = get_provider(transfer.dst_provider(), transfer,
                                    metrics, device=device)
        src_provider = get_provider(transfer.src_provider(), transfer,
                                    metrics, device=device)

        def cleanup_cb(tbls):
            if transfer.dst.cleanup_policy != CleanupPolicy.DISABLED:
                logger.info("cleanup (%s): %d tables",
                            transfer.dst.cleanup_policy.value,
                            len(tbls or []))
                dst_provider.cleanup(tbls or [])

        def upload_cb(tbls):
            # event-model sources snapshot through the event pipeline
            sp = src_provider.snapshot_provider()
            if sp is not None:
                from transferia_tpu_torch.tasks.snapshot_v2 import upload_v2

                upload_v2(transfer, coordinator, sp, metrics, device=device)
                return
            loader.upload_tables(tbls)

        if ttype == TransferType.SNAPSHOT_AND_INCREMENT:
            # the slot first (the hook gets no-op callbacks: cleanup and
            # the load follow explicitly)
            if src_provider.supports_activate():
                src_provider.activate(ActivateCallbacks(
                    lambda _t: None, lambda _t: None, rollbacks))
            cleanup_cb(tables)
            if coordinator.supports_mvcc() and \
                    src_provider.snapshot_provider() is None:
                # snapshot parts land as base versions, deltas captured
                # during the load stack as layers, and the sealed
                # watermark is where replication resumes
                from transferia_tpu_torch.mvcc.runner import (
                    activate_snapshot_and_increment,
                )

                activate_snapshot_and_increment(
                    transfer, coordinator, metrics, tables, device=device)
            else:
                upload_cb(tables)
        elif ttype.has_snapshot:
            if src_provider.supports_activate():
                src_provider.activate(ActivateCallbacks(
                    cleanup_cb, upload_cb, rollbacks))
            else:
                cleanup_cb(tables)
                upload_cb(tables)
        elif src_provider.supports_activate():
            # replication-only: the provider hook creates its slot or
            # changefeed
            src_provider.activate(
                ActivateCallbacks(cleanup_cb, lambda _t: None, rollbacks))
        # DDL objects (indexes/views/sequences) move to the target after
        # the rows land
        if ttype != TransferType.INCREMENT_ONLY and \
                hasattr(src_provider, "transfer_ddl_objects"):
            src_provider.transfer_ddl_objects(transfer.dst)
        # dbt steps run against the target once the snapshot landed (main
        # worker only) — never for replication-only transfers where no
        # snapshot exists to transform
        if ttype != TransferType.INCREMENT_ONLY:
            from transferia_tpu_torch.transform.plugins.dbt import (
                run_dbt_transformations,
            )

            run_dbt_transformations(transfer, coordinator)
        rollbacks.cancel()
        coordinator.set_status(transfer.id, TransferStatus.ACTIVATED)
        coordinator.set_transfer_state(transfer.id, {"status": "activated"})
    except BaseException as e:
        coordinator.set_status(transfer.id, TransferStatus.FAILED)
        coordinator.open_status_message(transfer.id, "activate", str(e))
        try:
            rollbacks.run()
        except Exception:
            logger.exception("activation rollback errors")
        raise


def _check_primary_keys(transfer, ttype: TransferType, storage,
                        tables) -> None:
    """Warn on key-less tables; abort when replication needs keys."""
    requires_pk = capability(transfer.dst, "requires_primary_key", False) \
        or ttype.has_replication
    for td in tables:
        schema = storage.table_schema(td.id)
        if schema is not None and not schema.has_primary_key():
            msg = f"table {td.id} has no primary key"
            if requires_pk and ttype.has_replication:
                raise AbortTransferError(
                    msg + " — replication requires primary keys")
            logger.warning("%s — updates/deletes cannot be matched", msg)
