"""Event-model-v2 pipeline contracts: sources, targets, data providers
(the port's copy of ``transferia_tpu/events/pipeline.py``).

- EventSource / ProgressableEventSource / EventSourceProgress,
- EventTarget (the event-model sink),
- DataProvider / SnapshotProvider / ReplicationProvider,
- DataObjectPart and its round trip to the v1 table part.

Both directions bridge to the v1 dataplane so every middleware, sink and
storage composes with event-model components:
`EventTargetOverAsyncSink` makes any v1 sink pipeline an event target
(the transformer chain, on its device, runs behind it), and
`AsyncSinkOverEventTarget` mounts a native event target at the end of
the v1 middleware stack.
"""

from __future__ import annotations

import abc
import concurrent.futures
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.interfaces import AsyncSink, resolve_all
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.events.model import (
    Event,
    InsertBatchEvent,
    RawItems,
    RowEvents,
    batch_to_events,
    events_to_batches,
)


def _event_rows(ev: Event) -> int:
    """Row count of one event, across all event shapes."""
    if isinstance(ev, InsertBatchEvent):
        return ev.row_count()
    if isinstance(ev, (RowEvents, RawItems)):
        return sum(1 for it in ev.items if it.is_row_event())
    return 0


@dataclass(frozen=True)
class LogPosition:
    """Comparable replication position (`lsn`, with a display label)."""

    lsn: int = 0
    label: str = ""

    def __str__(self) -> str:
        return self.label or str(self.lsn)

    def compare(self, other: "LogPosition") -> int:
        return (self.lsn > other.lsn) - (self.lsn < other.lsn)


@dataclass
class EventSourceProgress:
    done: bool = False
    current: int = 0
    total: int = 0


class EventTarget(abc.ABC):
    """Event-model sink: async push of typed event batches."""

    @abc.abstractmethod
    def async_push(self, events: Sequence[Event]
                   ) -> "concurrent.futures.Future[None]":
        ...

    def close(self) -> None:
        ...


class EventSource(abc.ABC):
    """A running producer feeding one EventTarget."""

    @abc.abstractmethod
    def start(self, target: EventTarget) -> None:
        """Run to completion (snapshot) or until stop() (replication)."""

    def stop(self) -> None:
        ...

    def running(self) -> bool:
        return False


class ProgressableEventSource(EventSource):
    """A finite source that reports its progress."""

    @abc.abstractmethod
    def progress(self) -> EventSourceProgress:
        ...


@dataclass(frozen=True)
class DataObjectPart:
    """One loadable slice of a data object (a file, a shard, a range).

    `to_table_part` is the legacy bridge (part -> v1 TableDescription);
    the `filter` carries the part identity so the reverse mapping
    (table_part_to_data_object_part) is lossless."""

    table: TableID
    part_key: str = ""
    eta_rows: int = 0

    def to_table_part(self) -> TableDescription:
        return TableDescription(id=self.table, filter=self.part_key,
                                eta_rows=self.eta_rows)


class DataProvider(abc.ABC):
    def init(self) -> None:
        ...

    def ping(self) -> None:
        ...

    def close(self) -> None:
        ...


class SnapshotProvider(DataProvider):
    """Snapshot through data objects and a source a part."""

    def begin_snapshot(self) -> None:
        ...

    @abc.abstractmethod
    def data_objects(self, include: Optional[list[TableID]] = None
                     ) -> dict[TableID, list[DataObjectPart]]:
        ...

    @abc.abstractmethod
    def table_schema(self, part: DataObjectPart) -> TableSchema:
        ...

    @abc.abstractmethod
    def create_snapshot_source(self, part: DataObjectPart
                               ) -> ProgressableEventSource:
        ...

    def end_snapshot(self) -> None:
        ...

    # -- legacy bridges ----------------------------------------------------
    def data_objects_to_table_parts(
            self, include: Optional[list[TableID]] = None
    ) -> list[TableDescription]:
        return [
            part.to_table_part()
            for parts in self.data_objects(include).values()
            for part in parts
        ]

    def table_part_to_data_object_part(
            self, td: TableDescription) -> DataObjectPart:
        return DataObjectPart(table=td.id, part_key=td.filter,
                              eta_rows=td.eta_rows)


class ReplicationProvider(DataProvider):
    @abc.abstractmethod
    def create_replication_source(self) -> EventSource:
        ...


# ---------------------------------------------------------------------------
# v1 <-> v2 bridges


class EventTargetOverAsyncSink(EventTarget):
    """Any v1 async sink pipeline as an event target: events lower to
    the primary batch currency in order, one future resolves them all.

    A single shared waiter thread services every push: a waiter thread a
    push would pile up against buffered sinks whose futures only resolve
    at flush."""

    def __init__(self, sink: AsyncSink):
        self.sink = sink
        self._waiter = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="a2-bridge-wait")

    def async_push(self, events: Sequence[Event]
                   ) -> "concurrent.futures.Future[None]":
        futures = [self.sink.async_push(b)
                   for b in events_to_batches(events)]
        if not futures:
            done: concurrent.futures.Future = concurrent.futures.Future()
            done.set_result(None)
            return done
        if len(futures) == 1:
            return futures[0]
        return self._waiter.submit(resolve_all, futures)

    def close(self) -> None:
        try:
            self.sink.close()
        finally:
            self._waiter.shutdown(wait=True)


class AsyncSinkOverEventTarget(AsyncSink):
    """A native event target mounted at the end of the v1 middleware
    stack: batches lift to typed events."""

    def __init__(self, target: EventTarget):
        self.target = target

    def async_push(self, batch):
        return self.target.async_push(batch_to_events(batch))

    def close(self) -> None:
        self.target.close()


class StorageSnapshotSource(ProgressableEventSource):
    """A v1 Storage part read as a ProgressableEventSource: the default
    snapshot source for providers whose native currency is the v1
    Storage contract."""

    def __init__(self, storage, part: DataObjectPart,
                 total_rows: int = 0):
        self.storage = storage
        self.part = part
        self._progress = EventSourceProgress(
            total=total_rows or part.eta_rows)
        self._running = False
        self._stop = threading.Event()

    def start(self, target: EventTarget) -> None:
        self._running = True
        futures = []
        try:
            def pusher(batch):
                if self._stop.is_set():
                    raise RuntimeError("snapshot source stopped")
                events = batch_to_events(batch)
                futures.append(target.async_push(events))
                self._progress.current += sum(
                    _event_rows(e) for e in events)

            self.storage.load_table(self.part.to_table_part(), pusher)
            resolve_all(futures)
            self._progress.done = True
        finally:
            self._running = False

    def stop(self) -> None:
        self._stop.set()

    def running(self) -> bool:
        return self._running

    def progress(self) -> EventSourceProgress:
        return self._progress
