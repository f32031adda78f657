"""Event-model-v2 snapshot upload (the port's copy of
``transferia_tpu/tasks/snapshot_v2.py``).

Drives an event-model SnapshotProvider part by part into an
EventTarget: the destination's native target when it has one
(ClickHouse's, `providers/clickhouse/a2.py`) and the transfer has no
transformation, else the v1 sink pipeline built at the snapshot stage
behind EventTargetOverAsyncSink, so the whole middleware stack (the
transformer chain with its fused device steps, the Bufferer, retries,
stats) applies to event-model flows too.

`device` is where that stack's device work runs (None means CUDA, which
must be present; "cpu" runs the kernels' plain versions).
"""

from __future__ import annotations

import logging
from typing import Optional

from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.events.model import TableLoadEvent
from transferia_tpu_torch.events.pipeline import (
    EventTarget,
    EventTargetOverAsyncSink,
    SnapshotProvider,
)
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats.registry import Metrics

logger = logging.getLogger(__name__)


def make_event_target(transfer, metrics: Optional[Metrics] = None,
                      device: DeviceLike = None) -> EventTarget:
    """The native target when the destination has one AND the transfer
    carries no transformation chain: a native target writes events
    directly, so a configured transformer routes through the v1
    middleware stack behind the bridge instead of being skipped.  The
    bridged sink is built at the snapshot stage (retries and dedicated
    snapshot sinkers), as the v1 loader builds it."""
    from transferia_tpu_torch.factories import make_async_sink
    from transferia_tpu_torch.providers.registry import get_provider

    device = resolve_device(device)
    if not transfer.transformation:
        native = get_provider(transfer.dst_provider(), transfer, metrics,
                              device=device).event_target()
        if native is not None:
            logger.info("a2 upload: native %s event target",
                        transfer.dst_provider())
            return native
    return EventTargetOverAsyncSink(
        make_async_sink(transfer, metrics, snapshot_stage=True,
                        device=device))


def upload_v2(transfer, coordinator: Coordinator,
              provider: SnapshotProvider,
              metrics: Optional[Metrics] = None,
              device: DeviceLike = None) -> int:
    """Snapshot every data-object part through typed events; returns the
    rows moved.  Init/Done TableLoadEvents frame each table the way the
    v1 loader frames Storage loads."""
    device = resolve_device(device)
    metrics = metrics or Metrics()
    provider.init()
    provider.begin_snapshot()
    total_rows = 0
    target = make_event_target(transfer, metrics, device)
    try:
        include = transfer.include_ids() or None
        objects = provider.data_objects(include)
        if not objects:
            raise ValueError(
                "a2 snapshot: no data objects match the include list")
        for tid, parts in objects.items():
            schema = provider.table_schema(parts[0]) if parts else None
            target.async_push([TableLoadEvent(
                tid, Kind.INIT_TABLE_LOAD, schema=schema)]).result()
            for part in parts:
                source = provider.create_snapshot_source(part)
                source.start(target)
                progress = source.progress()
                if not progress.done:
                    raise RuntimeError(
                        f"a2 snapshot source for {part} stopped at "
                        f"{progress.current}/{progress.total}")
                total_rows += progress.current
                logger.info("a2 part %s: %d rows", part.part_key or tid,
                            progress.current)
            target.async_push([TableLoadEvent(
                tid, Kind.DONE_TABLE_LOAD, schema=schema)]).result()
        provider.end_snapshot()
    finally:
        target.close()
        provider.close()
    return total_rows
