"""Event-typed veneer over the columnar dataplane (the port's copy of
``transferia_tpu/events/model.py``)."""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

from transferia_tpu_torch.abstract.change_item import ChangeItem, _control
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch


class Event(abc.ABC):
    """One typed dataplane event."""

    @abc.abstractmethod
    def table(self) -> TableID:
        ...


@dataclass
class InsertBatchEvent(Event):
    """A columnar block of inserts: the snapshot hot-path event."""

    batch: ColumnBatch

    def table(self) -> TableID:
        return self.batch.table_id

    def row_count(self) -> int:
        return self.batch.n_rows


@dataclass
class RowEvents(Event):
    """Heterogeneous CDC rows sharing a table."""

    items: list[ChangeItem]

    def table(self) -> TableID:
        return self.items[0].table_id if self.items else TableID("", "")


@dataclass
class TableLoadEvent(Event):
    """Init/Done table-load control marker (carries the table schema so
    sinks can create tables from Init events)."""

    table_id: TableID
    kind: Kind
    part_id: str = ""
    schema: object = None  # Optional[TableSchema]

    def table(self) -> TableID:
        return self.table_id

    @property
    def is_done(self) -> bool:
        return self.kind in (Kind.DONE_TABLE_LOAD,
                             Kind.DONE_SHARDED_TABLE_LOAD)


@dataclass
class RawItems(Event):
    """Non-row, non-control items (DDL/truncate/provider-specific kinds),
    passed through verbatim so the veneer round trip is lossless."""

    items: list[ChangeItem]

    def table(self) -> TableID:
        return self.items[0].table_id if self.items else TableID("", "")


# an ordered sequence of events
EventBatch = Sequence[Event]


def batch_to_events(batch: Batch) -> list[Event]:
    """Primary-currency batch -> typed events."""
    if is_columnar(batch):
        return [InsertBatchEvent(batch)]
    out: list[Event] = []
    run: list[ChangeItem] = []
    for it in batch:
        if it.is_row_event():
            run.append(it)
            continue
        if run:
            out.append(RowEvents(run))
            run = []
        if it.kind.is_control:
            out.append(TableLoadEvent(it.table_id, it.kind, it.part_id,
                                      it.table_schema))
        else:
            # DDL/truncate/provider kinds: lossless passthrough
            out.append(RawItems([it]))
    if run:
        out.append(RowEvents(run))
    return out


def events_to_batches(events: Iterable[Event]) -> Iterator[Batch]:
    """Typed events -> pushable batches (order preserved)."""
    for ev in events:
        if isinstance(ev, InsertBatchEvent):
            yield ev.batch
        elif isinstance(ev, (RowEvents, RawItems)):
            yield ev.items
        elif isinstance(ev, TableLoadEvent):
            yield [_control(ev.kind, ev.table_id, ev.schema, ev.part_id)]
        else:
            raise TypeError(f"unknown event {type(ev).__name__}")
