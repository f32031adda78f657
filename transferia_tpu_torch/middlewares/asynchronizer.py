"""Asynchronous middlewares (wrap/produce AsyncSink): the port's copy of
``transferia_tpu/middlewares/asynchronizer.py``.

The Bufferer is where the chain's batch sizes are born: it accumulates
small pushes until a row/byte/interval trigger fires, merging adjacent
compatible units into large ColumnBatches so the transform kernels see
large blocks.  Control events flush the buffer and pass through
standalone, keeping the Init/DoneTableLoad ordering contract.  Each
push runs under its submitter's contextvars, so the trace and ledger
scopes follow the work onto the Asynchronizer's thread and the
Bufferer's flushing thread.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import logging
import queue
import threading
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import (
    AsyncSink,
    Batch,
    Sinker,
    SyncAsAsyncSink,
    is_columnar,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.middlewares.helpers import (
    batch_bytes,
    batch_len,
    is_control_batch,
)
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import BuffererStats

logger = logging.getLogger(__name__)

Future = concurrent.futures.Future


class Synchronizer(SyncAsAsyncSink):
    """Sync sinker as AsyncSink with inline resolution
    (middlewares/synchronizer)."""


class Asynchronizer(AsyncSink):
    """Order-preserving async adapter: single worker thread drains a queue
    (middlewares/asynchronizer.go).  Lets the source continue reading while
    the sink writes."""

    def __init__(self, inner: Sinker, max_queue: int = 16):
        self.inner = inner
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._closed = threading.Event()
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="asynchronizer", daemon=True
        )
        self._worker.start()

    def _push_one(self, batch, fut) -> None:
        try:
            with trace.span("sink_push"):
                self.inner.push(batch)
            fut.set_result(None)
        except BaseException as e:
            fut.set_exception(e)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch, fut, cvctx = item
            # run under the SUBMITTER's contextvars snapshot: the
            # sink_push span parents to the submitting span (part /
            # batch) and the push's resource events bill the
            # submitter's ledger scope, even though this is the
            # asynchronizer's own thread
            if cvctx is not None:
                cvctx.run(self._push_one, batch, fut)
            else:
                self._push_one(batch, fut)

    def async_push(self, batch: Batch) -> "Future[None]":
        fut: Future = Future()
        # closed-check + enqueue must be atomic with close()'s shutdown, or
        # a racing push can land behind the sentinel with no worker left
        with self._close_lock:
            if self._closed.is_set():
                fut.set_exception(RuntimeError("asynchronizer closed"))
                return fut
            self._q.put((batch, fut, contextvars.copy_context()))
        return fut

    def close(self) -> None:
        with self._close_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            self._q.put(None)
        self._worker.join(timeout=60)
        self.inner.close()


class ErrorTracker(AsyncSink):
    """Latches the first push error; subsequent pushes fail fast
    (middlewares/error_tracker.go).  The replication loop reads
    `failure` to decide restart vs fatal."""

    def __init__(self, inner: AsyncSink):
        self.inner = inner
        self._lock = threading.Lock()
        self.failure: Optional[BaseException] = None

    def _latch(self, fut: "Future[None]") -> None:
        err = fut.exception()
        if err is not None:
            with self._lock:
                if self.failure is None:
                    self.failure = err

    def async_push(self, batch: Batch) -> "Future[None]":
        with self._lock:
            if self.failure is not None:
                fut: Future = Future()
                fut.set_exception(self.failure)
                return fut
        fut = self.inner.async_push(batch)
        fut.add_done_callback(self._latch)
        return fut

    def close(self) -> None:
        self.inner.close()


class MemThrottler(AsyncSink):
    """Bounds in-flight buffered bytes (middlewares/memthrottle).

    async_push blocks while outstanding (pushed-but-unresolved) bytes exceed
    the limit — backpressure for fast sources / slow sinks.
    """

    def __init__(self, inner: AsyncSink, limit_bytes: int = 512 << 20):
        self.inner = inner
        self.limit = limit_bytes
        self._outstanding = 0
        self._cv = threading.Condition()

    def async_push(self, batch: Batch) -> "Future[None]":
        nbytes = batch_bytes(batch)
        with self._cv:
            while self._outstanding > 0 and \
                    self._outstanding + nbytes > self.limit:
                self._cv.wait(timeout=1.0)
            self._outstanding += nbytes
        fut = self.inner.async_push(batch)

        def release(_f):
            with self._cv:
                self._outstanding -= nbytes
                self._cv.notify_all()

        fut.add_done_callback(release)
        return fut

    def close(self) -> None:
        self.inner.close()


class BuffererConfig:
    """Flush triggers (synchronizer/bufferer/bufferer.go:15-33)."""

    def __init__(self, trigger_rows: int = 100_000,
                 trigger_bytes: int = 64 << 20,
                 trigger_interval: float = 1.0):
        self.trigger_rows = trigger_rows
        self.trigger_bytes = trigger_bytes
        self.trigger_interval = trigger_interval


class Bufferer(AsyncSink):
    """Accumulate pushes, flush on count/size/interval/non-row/close.

    Futures resolve when the flush containing their batch completes (or
    fails).  Control/system batches flush pending data first, then push
    standalone — never reordered relative to surrounding data.
    """

    def __init__(self, inner: Sinker, cfg: Optional[BuffererConfig] = None,
                 stats: Optional[BuffererStats] = None):
        self.inner = inner
        self.cfg = cfg or BuffererConfig()
        self.stats = stats or BuffererStats()
        self._lock = threading.RLock()
        self._buf: list[tuple] = []  # (batch, future, contextvars ctx)
        self._rows = 0
        self._bytes = 0
        self._closed = False
        self._ticker: Optional[threading.Thread] = None
        self._wake = threading.Event()
        if self.cfg.trigger_interval > 0:
            self._ticker = threading.Thread(
                target=self._tick, name="bufferer-ticker", daemon=True
            )
            self._ticker.start()

    # -- internals ----------------------------------------------------------
    def _tick(self):
        while not self._closed:
            self._wake.wait(timeout=self.cfg.trigger_interval)
            self._wake.clear()
            if self._closed:
                return
            with self._lock:
                if self._buf:
                    self._flush_locked()

    @staticmethod
    def _mergeable(a: Batch, b: Batch) -> bool:
        if is_columnar(a) and is_columnar(b):
            return (
                a.table_id == b.table_id
                and a.schema.fingerprint() == b.schema.fingerprint()
                and a.part_id == b.part_id
            )
        return not is_columnar(a) and not is_columnar(b)

    def _flush_locked(self) -> None:
        buf, self._buf = self._buf, []
        rows, self._rows = self._rows, 0
        nbytes, self._bytes = self._bytes, 0
        self.stats.buffered_rows.set(0)
        self.stats.buffered_bytes.set(0)
        if not buf:
            return
        sp = trace.span("bufferer_flush")
        if sp:
            sp.add(rows=rows, bytes=nbytes, units=len(buf))
        with sp:
            self._flush_groups(buf)

    def _flush_groups(self, buf: list[tuple]) -> None:
        # merge adjacent compatible units into big pushes
        groups: list[tuple[list[Batch], list[Future], object]] = []
        for batch, fut, cvctx in buf:
            if groups and self._mergeable(groups[-1][0][-1], batch):
                groups[-1][0].append(batch)
                groups[-1][1].append(fut)
            else:
                groups.append(([batch], [fut], cvctx))
        failed: Optional[BaseException] = None
        for batches, futs, cvctx in groups:
            if failed is not None:
                for f in futs:
                    f.set_exception(failed)
                continue
            try:
                if len(batches) == 1:
                    merged = batches[0]
                elif is_columnar(batches[0]):
                    merged = ColumnBatch.concat(batches)
                else:
                    merged = [it for b in batches for it in b]
                # a flush may run on the ticker thread or a later
                # pusher's thread: push under the contextvars snapshot
                # of the group's FIRST submitter so the merged write
                # bills/links to the pipeline that buffered it
                if cvctx is not None:
                    cvctx.run(self.inner.push, merged)
                else:
                    self.inner.push(merged)
                for f in futs:
                    f.set_result(None)
                self.stats.flush_count.inc()
                self.stats.flush_rows.inc(batch_len(merged))
            except BaseException as e:
                failed = e
                for f in futs:
                    f.set_exception(e)

    # -- AsyncSink ----------------------------------------------------------
    def async_push(self, batch: Batch) -> "Future[None]":
        fut: Future = Future()
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("bufferer closed"))
                return fut
            if is_control_batch(batch):
                # flush pending data, then push the control batch standalone
                self._flush_locked()
                try:
                    self.inner.push(batch)
                    fut.set_result(None)
                except BaseException as e:
                    fut.set_exception(e)
                return fut
            self._buf.append((batch, fut, contextvars.copy_context()))
            self._rows += batch_len(batch)
            self._bytes += batch_bytes(batch)
            self.stats.buffered_rows.set(self._rows)
            self.stats.buffered_bytes.set(self._bytes)
            if (self._rows >= self.cfg.trigger_rows
                    or self._bytes >= self.cfg.trigger_bytes):
                self._flush_locked()
        return fut

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
        self._wake.set()
        if self._ticker:
            self._ticker.join(timeout=5)
        self.inner.close()
