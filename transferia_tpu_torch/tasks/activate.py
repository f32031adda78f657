"""Activation (the port's copy of ``transferia_tpu/tasks/activate.py``).

Flow: list tables -> primary-key checks -> destination cleanup per policy
-> the source provider's activate hook (or the default cleanup + upload)
-> the post-upload DDL hook -> mark activated.  A failed activation
marks the transfer FAILED, opens a status message and runs the
rollbacks a provider hook registered.

`device` is where the snapshot's device work runs (None means CUDA,
which must be present; "cpu" runs the kernels' plain versions).

Left out, each raising NotImplementedError naming itself (ROADMAP.md
A6): the SNAPSHOT_AND_INCREMENT activation (the slot-first order and the
MVCC cutover) and a configured `dbt` step.  No port provider has an
event-model snapshot capability, so the reference's `snapshot_v2`
upload has no branch here.
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


def _left_out(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to transferia_tpu_torch yet (ROADMAP.md A6, "
        f"activate_delivery's left-out branches)")


def _dbt_steps(transfer) -> list:
    cfg = getattr(transfer, "transformation", None) or {}
    return [t for t in (cfg.get("transformers") or []) if "dbt" in t]


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
        if ttype == TransferType.SNAPSHOT_AND_INCREMENT:
            raise _left_out("the SNAPSHOT_AND_INCREMENT activation "
                            "(replication slot first, then the MVCC "
                            "cutover, which waits on A10's mvcc/)")
        if ttype != TransferType.INCREMENT_ONLY and _dbt_steps(transfer):
            raise _left_out("the dbt post-upload step")
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

        if ttype.has_snapshot:
            if src_provider.supports_activate():
                src_provider.activate(ActivateCallbacks(
                    cleanup_cb, loader.upload_tables, rollbacks))
            else:
                cleanup_cb(tables)
                loader.upload_tables(tables)
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
