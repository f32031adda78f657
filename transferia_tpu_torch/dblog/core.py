"""DBLog watermark snapshot engine (the port's copy of
``transferia_tpu/dblog/core.py``): watermark-fenced chunk windows over a
live CDC stream, and the dedup of the keys that stream touches inside a
window.  Host code: the chunks and the CDC batches reach the target
through the replication pipeline's transformer chain, which runs the
fused device step.  A chunk deduplicated against live events stays
columnar where its key is one column (the reference emits its rows as
ChangeItems): the same rows in the same order."""

from __future__ import annotations

import abc
import enum
import logging
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.columnar.batch import ColumnBatch

logger = logging.getLogger(__name__)


class WatermarkKind(str, enum.Enum):
    LOW = "low"
    HIGH = "high"
    SUCCESS = "success"   # snapshot finished
    BAD = "bad"           # snapshot aborted


@dataclass(frozen=True)
class Watermark:
    id: str
    kind: WatermarkKind


class SignalTable(abc.ABC):
    """Writes watermarks into the source so they appear in its CDC stream
    (dblog/signal_table.go:32).  The caller generates the Watermark (and
    registers it as expected) BEFORE the write — a fast CDC echo must not
    race the registration."""

    @abc.abstractmethod
    def write_watermark(self, wm: Watermark) -> None:
        ...

    @abc.abstractmethod
    def is_watermark(self, item: ChangeItem) -> Optional[Watermark]:
        """Recognize a CDC event as one of our watermarks."""


class ChunkIterator(abc.ABC):
    """PK-ordered chunk reader (dblog/incremental_iterator.go:209-320)."""

    @abc.abstractmethod
    def next_chunk(self) -> Optional[ColumnBatch]:
        """Next chunk past the internal cursor; None when exhausted."""


class DBLogSnapshot:
    """Drives chunked snapshot concurrent with a replication stream.

    The replication pipeline pushes through `filter_cdc`; the snapshot
    loop calls `run`.  Between a LOW and HIGH watermark pair, primary keys
    seen in CDC events mark chunk rows stale (the live event supersedes the
    chunk copy) — dblog/incremental_async_sink.go:14-207.

    ALL data (chunks included) reaches the target through the CDC
    pipeline's pushes of `filter_cdc` output: each chunk is emitted inline
    at its HIGH watermark's stream position, so a chunk row can never
    trail a newer CDC event for the same key into an arrival-ordered sink.
    The snapshot thread itself pushes nothing.
    """

    def __init__(self, signal: SignalTable, chunks: ChunkIterator,
                 key_columns: Sequence[str]):
        self.signal = signal
        self.chunks = chunks
        self.key_columns = list(key_columns)
        self._lock = threading.Lock()
        self._window_open = False
        self._touched: set[tuple] = set()
        self._expected: dict[str, WatermarkKind] = {}
        self._pending_chunk: Optional[ColumnBatch] = None
        self._emitted_rows = 0
        self._events = {
            WatermarkKind.LOW: threading.Event(),
            WatermarkKind.HIGH: threading.Event(),
        }

    # -- CDC side -----------------------------------------------------------
    def filter_cdc(self, batch: Batch) -> Batch:
        """Intercept the replication stream: consume watermarks, record
        touched PKs while a chunk window is open.  Returns the batch minus
        watermark rows, PLUS the deduped pending chunk emitted inline at
        the HIGH watermark's stream position — chunk rows must never trail
        a newer CDC event for the same key into an arrival-ordered sink
        (reference: incremental_async_sink.go:167 serializes exactly so)."""
        items = batch.to_rows() if is_columnar(batch) else list(batch)
        # fast path: a lone HIGH watermark with an untouched chunk (the
        # common quiet-table case) passes the chunk through columnar
        if len(items) == 1 and items[0].is_row_event():
            wm = self.signal.is_watermark(items[0])
            if wm is not None:
                emit = self._on_watermark(wm)
                return emit if emit is not None else []
        modified = False
        out = []
        for it in items:
            wm = self.signal.is_watermark(it) if it.is_row_event() else None
            if wm is not None:
                modified = True  # watermark removed (and maybe chunk added)
                emit = self._on_watermark(wm)
                if emit is None:
                    continue
                out.extend(emit.to_rows() if is_columnar(emit) else emit)
                continue
            with self._lock:
                if self._window_open and it.is_row_event():
                    self._touched.add(
                        (it.table_id, it.effective_key())
                    )
            out.append(it)
        if is_columnar(batch) and not modified:
            return batch  # untouched: keep columnar
        return out

    def _on_watermark(self, wm: Watermark):
        """Consume a watermark; on HIGH, return the pending chunk (deduped
        against keys touched inside the window) for the caller to emit
        inline at this stream position.  Returns None (nothing to emit),
        a ColumnBatch (an untouched chunk, or a deduplicated one with a
        one-column key), or a list of ChangeItems (the deduplicated rows
        of a chunk with a compound key)."""
        expected = self._expected.pop(wm.id, None)
        if expected is None or expected != wm.kind:
            logger.warning("unexpected watermark %s", wm)
            return None
        emit = None
        with self._lock:
            if wm.kind == WatermarkKind.LOW:
                self._window_open = True
                self._touched.clear()
            elif wm.kind == WatermarkKind.HIGH:
                self._window_open = False
                chunk = self._pending_chunk
                self._pending_chunk = None
                if chunk is not None and chunk.n_rows:
                    if not self._touched:
                        emit = chunk  # columnar, no per-row work
                        self._emitted_rows = chunk.n_rows
                    else:
                        emit, kept = self._dedup(chunk)
                        if kept < chunk.n_rows:
                            logger.info(
                                "dblog chunk: %d rows deduped against "
                                "live events", chunk.n_rows - kept,
                            )
                        self._emitted_rows = kept
                else:
                    self._emitted_rows = 0
        self._events[wm.kind].set()
        return emit

    def _dedup(self, chunk: ColumnBatch):
        """The chunk without the rows whose key a live event touched in
        the window, and how many rows stay.  A one-column key keeps the
        chunk columnar (its rows in their order, as the reference's list
        of ChangeItems holds them); a compound key goes row by row."""
        keys = [c.name for c in chunk.schema.key_columns()]
        if len(keys) != 1:
            rows = chunk.to_rows()
            emit = [it for it in rows
                    if (it.table_id, it.effective_key()) not in self._touched]
            return emit, len(emit)
        tid, col = chunk.table_id, chunk.column(keys[0])
        keep = np.fromiter(
            ((tid, (col.value(i),)) not in self._touched
             for i in range(chunk.n_rows)), dtype=bool, count=chunk.n_rows)
        kept = int(keep.sum())
        return (chunk if kept == chunk.n_rows else chunk.filter(keep)), kept

    # -- snapshot side ------------------------------------------------------
    def _write_and_wait(self, kind: WatermarkKind,
                        timeout: float = 30.0) -> None:
        self._events[kind].clear()
        wm = Watermark(id=uuid.uuid4().hex, kind=kind)
        self._expected[wm.id] = kind   # register BEFORE writing
        self.signal.write_watermark(wm)
        if not self._events[kind].wait(timeout):
            raise TimeoutError(
                f"{kind.value} watermark {wm.id} not observed in the CDC "
                f"stream within {timeout}s — is replication running?"
            )

    def run(self, chunk_timeout: float = 30.0) -> int:
        """Snapshot all chunks; returns rows pushed.

        Chunks are not pushed from this thread: each chunk is parked as
        pending BEFORE its HIGH watermark is written, and the CDC pipeline
        emits it inline when it consumes that watermark (filter_cdc) —
        serializing chunk rows against newer live events."""
        total = 0
        try:
            while True:
                self._write_and_wait(WatermarkKind.LOW, chunk_timeout)
                chunk = self.chunks.next_chunk()
                with self._lock:
                    self._pending_chunk = chunk
                self._write_and_wait(WatermarkKind.HIGH, chunk_timeout)
                if chunk is None or chunk.n_rows == 0:
                    break
                with self._lock:
                    total += self._emitted_rows
            self.signal.write_watermark(
                Watermark(uuid.uuid4().hex, WatermarkKind.SUCCESS)
            )
            return total
        except BaseException:
            self.signal.write_watermark(
                Watermark(uuid.uuid4().hex, WatermarkKind.BAD)
            )
            raise


# ---------------------------------------------------------------------------
# Generic implementations
# ---------------------------------------------------------------------------

SIGNAL_TABLE = TableID("", "__transferia_signal")


class StorageSignalTable(SignalTable):
    """Signal table over a writer callback (DB providers supply an INSERT
    into their __transferia_signal table; the CDC stream echoes it)."""

    def __init__(self, write_fn: Callable[[str, str], None],
                 table: TableID = SIGNAL_TABLE):
        self.write_fn = write_fn
        self.table = table

    def write_watermark(self, wm: Watermark) -> None:
        self.write_fn(wm.id, wm.kind.value)

    def is_watermark(self, item: ChangeItem) -> Optional[Watermark]:
        if item.table_id != self.table:
            return None
        vals = item.as_dict()
        try:
            return Watermark(id=vals["mark_id"],
                             kind=WatermarkKind(vals["kind"]))
        except (KeyError, ValueError):
            return None


class PagedChunkIterator(ChunkIterator):
    """Cursor-paged chunks over a load callback.

    load_fn(last_key or None, limit) -> ColumnBatch (PK-ordered).
    """

    def __init__(self, load_fn, key_column: str, chunk_rows: int = 10_000):
        self.load_fn = load_fn
        self.key_column = key_column
        self.chunk_rows = chunk_rows
        self._cursor: Optional[Any] = None
        self._done = False

    def next_chunk(self) -> Optional[ColumnBatch]:
        if self._done:
            return None
        chunk = self.load_fn(self._cursor, self.chunk_rows)
        if chunk is None or chunk.n_rows == 0:
            self._done = True
            return None
        col = chunk.column(self.key_column)
        self._cursor = col.value(chunk.n_rows - 1)
        if chunk.n_rows < self.chunk_rows:
            self._done = True
        return chunk
