"""SNAPSHOT_AND_INCREMENT orchestration through the MVCC store (the port's
copy of ``transferia_tpu/mvcc/runner.py``).

The consistent-cutover flow:

1. The replication slot/changefeed exists FIRST (tasks/activate.py runs
   the source's activate hook before any snapshot row is read), so every
   change that lands during the snapshot is captured from the
   pre-snapshot position.
2. Snapshot parts land as immutable base versions (`put_base`), each
   landing optionally gated by the coordinator's `commit_part` grant
   (`land_snapshot_part`).
3. Replication batches that arrive meanwhile are appended as delta
   layers (`MvccStore.append_delta`), by an `MvccPump` for a queue-shaped
   source.
4. The cutover seals (delta LSN high-watermark, staged-commit epoch,
   source offsets) atomically; the merged point-in-time image at that
   watermark is published to the destination through the sink pipeline
   (the transformer chain, then the staged commit where the sink has
   one); replication resumes FROM the sealed watermark (`resume_state`).

`device` is where the store's keys and the sink's transform run (CUDA
unless the caller passes "cpu").
"""

from __future__ import annotations

import logging
from typing import Optional

from transferia_tpu_torch.abstract.commit import find_staged_sink
from transferia_tpu_torch.abstract.interfaces import (
    PositionalStorage,
    SnapshotableStorage,
)
from transferia_tpu_torch.abstract.table import (
    OperationTablePart,
    TableDescription,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.factories import make_sinker, new_storage
from transferia_tpu_torch.mvcc.store import MvccStore
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import Metrics

logger = logging.getLogger(__name__)

# transfer-state keys (Coordinator.set_transfer_state merges keys, so
# these coexist with provider checkpoints like pg_wal_lsn)
STATE_WATERMARK = "mvcc_watermark"
STATE_EPOCH = "mvcc_epoch"
STATE_OFFSETS = "mvcc_offsets"


def store_scope(transfer_id: str) -> str:
    return f"mvcc/{transfer_id}"


def land_snapshot_part(store: MvccStore, coordinator,
                       operation_id: str,
                       part: OperationTablePart,
                       batches: list[ColumnBatch]) -> bool:
    """Fenced landing of one snapshot part: the `commit_part` grant first
    (False = the part was reclaimed since this worker's claim: discard),
    then `put_base` at the part's assignment epoch.  True when the part
    landed."""
    if coordinator is not None:
        granted = coordinator.commit_part(operation_id, part)
        if granted is False:
            logger.warning("mvcc: part %s fenced at commit_part "
                           "(epoch %d), discarding", part.key(),
                           part.assignment_epoch)
            return False
    store.put_base(str(part.table_id), f"part-{part.part_index}",
                   max(1, int(part.assignment_epoch)), batches)
    return True


def snapshot_into_store(transfer, store: MvccStore,
                        metrics: Optional[Metrics] = None,
                        tables=None, coordinator=None) -> list[str]:
    """Read the source snapshot into base versions: one part per table
    description, epoch 1.

    A storage that pins a consistent read (`SnapshotableStorage`:
    Oracle's flashback SCN) is pinned for the whole load, and where it
    was pinned lands in the transfer state as `snapshot_position`, as
    the snapshot loader records it, so the replication source resumes
    there.  The reference reads such a storage unpinned on this route and
    records no position, so its LogMiner tail starts at the current SCN
    and loses the changes committed during the load (ROADMAP.md C8)."""
    metrics = metrics or Metrics()
    storage = new_storage(transfer, metrics)
    pinned = isinstance(storage, SnapshotableStorage)
    try:
        if pinned:
            storage.begin_snapshot()
            if isinstance(storage, PositionalStorage):
                pos = storage.position()
                if pos and coordinator is not None:
                    coordinator.set_transfer_state(
                        transfer.id, {"snapshot_position": pos})
        if tables is None:
            tables = [TableDescription(id=tid)
                      for tid in storage.table_list()]
        landed = []
        for i, td in enumerate(tables):
            batches: list[ColumnBatch] = []
            storage.load_table(td, batches.append)
            store.put_base(str(td.id), f"part-{i}", 1, batches)
            landed.append(str(td.id))
        return landed
    finally:
        try:
            if pinned:
                storage.end_snapshot()
        finally:
            storage.close()


def publish_merged(store: MvccStore, transfer,
                   metrics: Optional[Metrics] = None,
                   watermark: Optional[int] = None) -> int:
    """Publish the point-in-time merged image of every table to the
    destination sink, on the store's device.  A staged-commit sink gets
    the fenced begin/publish lifecycle per table (part key
    `mvcc/<table>`, the sealed epoch); others get direct pushes."""
    metrics = metrics or Metrics()
    sealed = store.sealed()
    epoch = sealed[1] if sealed is not None else 1
    sink = make_sinker(transfer, metrics, snapshot_stage=True,
                       device=store.device)
    staged = find_staged_sink(sink)
    sp = trace.span("mvcc_publish", tables=len(store.tables()))
    rows = 0
    with sp:
        try:
            for table in store.tables():
                merged = store.read_at(table, watermark=watermark)
                if staged is not None:
                    key = f"mvcc/{table}"
                    staged.begin_part(key, epoch)
                    try:
                        for b in merged:
                            sink.push(b)
                        rows += staged.publish_part(key, epoch)
                    except BaseException:
                        staged.abort_part(key)
                        raise
                else:
                    for b in merged:
                        sink.push(b)
                        rows += b.n_rows
        finally:
            close = getattr(sink, "close", None)
            if close:
                close()
        if sp:
            sp.add(rows=rows)
    return rows


def resume_state(coordinator, transfer_id: str) -> Optional[dict]:
    """The sealed cutover decision a resuming replication lane reads:
    `{"watermark": W, "epoch": E}` (and `"offsets"` when a pump fed the
    activation), or None before a cutover."""
    state = coordinator.get_transfer_state(transfer_id)
    if STATE_WATERMARK not in state:
        return None
    out = {"watermark": int(state[STATE_WATERMARK]),
           "epoch": int(state.get(STATE_EPOCH, 1))}
    offsets = state.get(STATE_OFFSETS)
    if offsets:
        out["offsets"] = {str(k): int(v) for k, v in offsets.items()}
    return out


def activate_snapshot_and_increment(
        transfer, coordinator,
        metrics: Optional[Metrics] = None,
        tables=None,
        store: Optional[MvccStore] = None,
        epoch: int = 1,
        pump=None,
        device: DeviceLike = None) -> MvccStore:
    """The activation-time S&I pipeline over the MVCC store.

    `pump` is the entry for concurrently arriving replication: an
    `MvccPump` (or `pump=True` to build one from the transfer's source
    via `MvccPump.from_transfer`) runs alongside the snapshot read; the
    cutover seals the pump's covered offsets inside the same decision as
    the watermark and epoch, and ONLY the sealed offsets commit back to
    the source.  The reference's deprecated `deltas=` hook, which the
    pump replaced, is not ported.  `device` applies when no `store` is given (a
    given store keys on its own device)."""
    metrics = metrics or Metrics()
    st = store or MvccStore(store_scope(transfer.id), coordinator,
                            metrics, device=device)
    if pump is True:
        from transferia_tpu_torch.mvcc.pump import MvccPump

        pump = MvccPump.from_transfer(transfer, st, metrics)
    sp = trace.span("mvcc_activate", transfer=transfer.id)
    with sp:
        if pump is not None:
            pump.start()
        try:
            snapshot_into_store(transfer, st, metrics, tables,
                                coordinator=coordinator)
            offsets = None
            if pump is not None:
                pump.drain()
                offsets = pump.offsets()
            decision = st.cutover(epoch, offsets=offsets)
        except BaseException:
            if pump is not None:
                pump.stop()
            raise
        if not decision.get("granted"):
            # another activation already sealed: adopt its decision
            logger.info("mvcc: cutover fenced, adopting sealed "
                        "(watermark=%s epoch=%s)",
                        decision.get("watermark"), decision.get("epoch"))
        w, e = st.sealed()
        if pump is not None:
            # the offset fence: the source learns its offsets ONLY from
            # the sealed decision
            pump.commit_sealed_offsets()
        publish_merged(st, transfer, metrics, watermark=w)
        state = {STATE_WATERMARK: w, STATE_EPOCH: e}
        sealed_offs = st.sealed_offsets()
        if sealed_offs:
            state[STATE_OFFSETS] = sealed_offs
        coordinator.set_transfer_state(transfer.id, state)
        if sp:
            sp.add(watermark=w, epoch=e)
    return st
