"""Event model v2 (the port's copy of ``transferia_tpu/events/``).

A second, event-typed dataplane (Event/EventBatch, EventSource/
EventTarget, Snapshot/ReplicationProvider) as a thin, typed veneer over
the primary currency: columnar batches ARE the event batches, so
event-model providers (the Delta Lake source, ClickHouse's native
target) plug in without a parallel pipeline:

  InsertBatchEvent        one ColumnBatch of inserts
  RowEvents               heterogeneous ChangeItem runs
  TableLoadEvent          Init/Done control markers
  EventSource/EventTarget pipeline contracts (pipeline.py) with v1
                          bridges both ways, Snapshot/Replication
                          providers, progressable sources
"""

from transferia_tpu_torch.events.model import (
    Event,
    EventBatch,
    InsertBatchEvent,
    RawItems,
    RowEvents,
    TableLoadEvent,
    batch_to_events,
    events_to_batches,
)
from transferia_tpu_torch.events.pipeline import (
    AsyncSinkOverEventTarget,
    DataObjectPart,
    DataProvider,
    EventSource,
    EventSourceProgress,
    EventTarget,
    EventTargetOverAsyncSink,
    LogPosition,
    ProgressableEventSource,
    ReplicationProvider,
    SnapshotProvider,
    StorageSnapshotSource,
)

__all__ = [
    "AsyncSinkOverEventTarget",
    "DataObjectPart",
    "DataProvider",
    "Event",
    "EventSource",
    "EventSourceProgress",
    "EventTarget",
    "EventTargetOverAsyncSink",
    "LogPosition",
    "ProgressableEventSource",
    "ReplicationProvider",
    "SnapshotProvider",
    "StorageSnapshotSource",
    "EventBatch",
    "InsertBatchEvent",
    "RawItems",
    "RowEvents",
    "TableLoadEvent",
    "batch_to_events",
    "events_to_batches",
]
