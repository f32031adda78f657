"""Batch-serializer machinery (the port's copy of
``transferia_tpu/serializers/batch.py``): the buffer pool, the
concurrency threshold and ordered parallel chunking.

Chunked thread concurrency pays off for encoders that leave the GIL
(zlib, bytes joins) and for the Debezium emitter's per-row packing;
pure-Python json loops gain little but keep the same ordered-merge
semantics.  Each call is one `serialize` span, as in the reference.
"""

from __future__ import annotations

import io
import logging
import os
import queue as _queue
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.interfaces import Batch
from transferia_tpu_torch.serializers.formats import (
    BatchSerializer,
    QueueSerializer,
    _rows_of,
)
from transferia_tpu_torch.stats import trace

logger = logging.getLogger(__name__)

DEFAULT_THRESHOLD = 25_000   # rows below which a call stays on one thread


class BufferPool:
    """Bounded pool of reusable byte buffers."""

    def __init__(self, size: int = 1):
        size = max(1, size)
        self._pool: _queue.Queue[io.BytesIO] = _queue.Queue(maxsize=size)
        for _ in range(size):
            self._pool.put(io.BytesIO())

    def get(self) -> io.BytesIO:
        buf = self._pool.get()
        buf.seek(0)
        buf.truncate(0)
        return buf

    def put(self, buf: io.BytesIO) -> None:
        self._pool.put(buf)


def split_rows(rows: Sequence[ChangeItem], chunk: int
               ) -> list[Sequence[ChangeItem]]:
    """Order-preserving chunking."""
    if chunk <= 0:
        return [rows]
    return [rows[i:i + chunk] for i in range(0, len(rows), chunk)]


class ConcurrentBatchSerializer(BatchSerializer):
    """Wraps a row-shaped serializer with threshold-gated parallel
    chunking and ordered reassembly.

    Only valid for formats whose outputs concatenate (json lines, csv
    without header, raw)."""

    def __init__(self, inner: BatchSerializer,
                 concurrency: int = 0,
                 threshold: int = DEFAULT_THRESHOLD,
                 separator: bytes = b""):
        self.inner = inner
        self.concurrency = concurrency or (os.cpu_count() or 1)
        self.threshold = threshold
        self.separator = separator
        self._buffers = BufferPool(self.concurrency)

    def serialize(self, batch: Batch) -> bytes:
        rows = _rows_of(batch)
        sp = trace.span("serialize")
        if sp:
            sp.add(rows=len(rows))
        with sp:
            return self._serialize_rows(rows)

    def _serialize_rows(self, rows) -> bytes:
        if self.concurrency < 2 or len(rows) <= self.threshold:
            return self.inner.serialize(rows)
        chunk = (len(rows) + self.concurrency - 1) // self.concurrency
        parts = split_rows(rows, chunk)
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            encoded = list(pool.map(self.inner.serialize, parts))
        buf = self._buffers.get()
        try:
            first = True
            for piece in encoded:
                if not piece:
                    continue
                if not first and self.separator:
                    buf.write(self.separator)
                buf.write(piece)
                first = False
            return buf.getvalue()
        finally:
            self._buffers.put(buf)


class ConcurrentQueueSerializer(QueueSerializer):
    """Ordered parallel (key, value) serialization for brokers: split,
    a worker pool, merge back in order.

    `make_inner` builds one single-thread serializer per worker so inner
    state (schema-registry sessions, packers) is never shared across
    threads."""

    def __init__(self, make_inner: Callable[[], QueueSerializer],
                 concurrency: int = 0,
                 threshold: int = DEFAULT_THRESHOLD):
        self.make_inner = make_inner
        self.concurrency = concurrency or (os.cpu_count() or 1)
        self.threshold = threshold
        # persistent per-worker serializers: emitter state (SR schema-id
        # caches, packers) survives across pushes, and worker i is the
        # only user of _inners[i] within a call
        self._inners: list[QueueSerializer] = []

    def _inner(self, i: int) -> QueueSerializer:
        while len(self._inners) <= i:
            self._inners.append(self.make_inner())
        return self._inners[i]

    def serialize_messages(self, batch: Batch):
        rows = _rows_of(batch)
        sp = trace.span("serialize")
        if sp:
            sp.add(rows=len(rows))
        with sp:
            return self._serialize_rows(rows)

    def _serialize_rows(self, rows):
        if self.concurrency < 2 or len(rows) <= self.threshold:
            return self._inner(0).serialize_messages(rows)
        chunk = (len(rows) + self.concurrency - 1) // self.concurrency
        parts = split_rows(rows, chunk)
        for i in range(len(parts)):
            self._inner(i)  # build outside the pool: no lazy-append race

        def work(args):
            i, part = args
            return self._inners[i].serialize_messages(part)

        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            merged = []
            for out in pool.map(work, enumerate(parts)):  # ordered merge
                merged.extend(out)
            return merged


class RawColumnQueueSerializer(QueueSerializer):
    """One message per row: the named column's raw bytes, no key."""

    def __init__(self, column: str):
        self.column = column

    def serialize_messages(self, batch: Batch):
        out = []
        skipped = 0
        last_error: Optional[str] = None
        for it in _rows_of(batch):
            if self.column not in it.column_names:
                skipped += 1
                last_error = f"column {self.column!r} not found"
                continue
            v = it.value(self.column)
            if v is None:
                out.append((None, b""))
                continue
            if isinstance(v, str):
                v = v.encode()
            elif not isinstance(v, (bytes, bytearray)):
                v = str(v).encode()
            out.append((None, bytes(v)))
        if skipped:
            if not out:
                # every row lacked the column: almost certainly a
                # misconfigured column name; fail loudly instead of
                # silently acking dropped data
                raise KeyError(
                    f"raw_column: no row carried column "
                    f"{self.column!r} ({skipped} rows dropped)")
            logger.warning("raw_column: %d rows skipped (last error: %s)",
                           skipped, last_error)
        return out
