"""Core dataplane contracts (the port's copy of
``transferia_tpu/abstract/interfaces.py``).

The unit flowing through pushers and sinks is a **batch**: a list of
row-view ChangeItems or one columnar `ColumnBatch`.  Control events
always travel as ChangeItem lists, so their order relative to data
blocks is kept by the single serialized push path.  The optional
`Storage` capabilities are the ones the snapshot loader tests for.
"""

from __future__ import annotations

import abc
import concurrent.futures
from typing import (TYPE_CHECKING, Any, Callable, Iterable, Optional,
                    Sequence, Union)

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.abstract.table import TableDescription

if TYPE_CHECKING:
    from transferia_tpu_torch.columnar.batch import ColumnBatch

# A push unit: row items or one columnar block.
Batch = Union[Sequence[ChangeItem], "ColumnBatch"]

# Synchronous pusher: raises on error.
Pusher = Callable[[Batch], None]


def is_columnar(batch: Batch) -> bool:
    return hasattr(batch, "columns") and hasattr(batch, "n_rows")


class Source(abc.ABC):
    """Replication source: runs until stop() or a fatal error."""

    @abc.abstractmethod
    def run(self, sink: "AsyncSink") -> None:
        """Block, pushing batches into sink until stop() is called."""

    @abc.abstractmethod
    def stop(self) -> None:
        ...


class Sinker(abc.ABC):
    """Synchronous, non-concurrent sink."""

    @abc.abstractmethod
    def push(self, batch: Batch) -> None:
        ...

    def close(self) -> None:
        ...


class AsyncSink(abc.ABC):
    """Asynchronous sink: async_push returns a Future resolved when the
    batch is durably delivered; callers ack upstream only after it
    resolves (at-least-once)."""

    @abc.abstractmethod
    def async_push(self, batch: Batch) -> "concurrent.futures.Future[None]":
        ...

    def close(self) -> None:
        ...


class SyncAsAsyncSink(AsyncSink):
    """Adapter: a synchronous Sinker as an AsyncSink (resolved inline)."""

    def __init__(self, sinker: Sinker):
        self._sinker = sinker

    def async_push(self, batch: Batch) -> "concurrent.futures.Future[None]":
        fut: concurrent.futures.Future[None] = concurrent.futures.Future()
        try:
            self._sinker.push(batch)
            fut.set_result(None)
        except BaseException as e:  # propagate through the future
            fut.set_exception(e)
        return fut

    def close(self) -> None:
        self._sinker.close()


def resolve_all(futures: Iterable["concurrent.futures.Future[None]"]
                ) -> None:
    """Wait for pushes; re-raise the first error."""
    for f in futures:
        f.result()


class TableInfo:
    """Table listing entry."""

    __slots__ = ("eta_rows", "is_view", "schema")

    def __init__(self, eta_rows: int = 0, is_view: bool = False,
                 schema: Optional[TableSchema] = None):
        self.eta_rows = eta_rows
        self.is_view = is_view
        self.schema = schema


class Storage(abc.ABC):
    """Snapshot source."""

    @abc.abstractmethod
    def table_list(self, include: Optional[list[TableID]] = None
                   ) -> dict[TableID, TableInfo]:
        ...

    @abc.abstractmethod
    def table_schema(self, table: TableID) -> TableSchema:
        ...

    @abc.abstractmethod
    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        """Stream the table (or slice) into the pusher as batches."""

    def exact_table_rows_count(self, table: TableID) -> int:
        return self.estimate_table_rows_count(table)

    def estimate_table_rows_count(self, table: TableID) -> int:
        return 0

    def close(self) -> None:
        ...


# -- optional storage capabilities -------------------------------------------

class PositionalStorage(abc.ABC):
    """Exposes the log position at snapshot start."""

    @abc.abstractmethod
    def position(self) -> dict[str, Any]:
        ...


class ShardingStorage(abc.ABC):
    """Splits one table into parallel-loadable parts."""

    @abc.abstractmethod
    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        ...


class AsyncPartDiscovery(abc.ABC):
    """Streams a table's parts while upload is already running."""

    @abc.abstractmethod
    def iter_table_parts(self, table: TableDescription):
        """Yield TableDescription parts lazily."""


class ShardedStateStorage(abc.ABC):
    """Consistent-point handoff from the main worker's storage to the
    secondaries'."""

    @abc.abstractmethod
    def sharded_state(self) -> dict:
        ...

    @abc.abstractmethod
    def set_sharded_state(self, state: dict) -> None:
        ...


class SnapshotableStorage(abc.ABC):
    """Transactionally consistent snapshot bracket."""

    def begin_snapshot(self) -> None:
        ...

    def end_snapshot(self) -> None:
        ...


class IncrementalStorage(abc.ABC):
    """Cursor-based incremental snapshots."""

    @abc.abstractmethod
    def get_increment_state(self, tables: list, state: dict[str, Any]
                            ) -> list[TableDescription]:
        """Table descriptions filtered to rows past each stored cursor."""

    @abc.abstractmethod
    def next_increment_state(self, tables: list) -> dict[str, Any]:
        """Cursor values (str(table_id) -> value) to persist on success."""


class SampleableStorage(abc.ABC):
    """Checksum sampling."""

    @abc.abstractmethod
    def load_random_sample(self, table: TableDescription,
                           pusher: Pusher) -> None:
        ...

    @abc.abstractmethod
    def load_top_bottom_sample(self, table: TableDescription,
                               pusher: Pusher) -> None:
        ...

    @abc.abstractmethod
    def load_sample_by_set(self, table: TableDescription,
                           key_set: Sequence[dict], pusher: Pusher) -> None:
        """Load exactly the rows whose primary keys appear in key_set
        (each entry maps key column name -> value)."""

    def table_accessible(self, table: TableDescription) -> bool:
        return True


class ScanPredicateStorage(abc.ABC):
    """Scan-predicate pushdown: a storage that accepts a predicate
    pre-filters rows during the scan.  Advisory: the chain re-applies
    the predicate, so a storage may filter partially or not at all."""

    @abc.abstractmethod
    def set_scan_predicate(self, table: TableID, node) -> bool:
        """Install a predicate AST (predicate/ast.py) for scans of the
        table; returns True when the storage will use it."""
