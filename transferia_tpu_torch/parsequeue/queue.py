"""Parse -> push -> ack pipeline (the port's copy of
``transferia_tpu/parsequeue/queue.py``, with its `parsequeue.parse`
failpoint and its `source_decode` and `sink_wait` spans).

A unit's trace context rides with it from `add` onto the parse worker
and the pusher, so both spans parent to the span that added the unit
(the replication attempt)."""

from __future__ import annotations

import concurrent.futures
import logging
import threading
from typing import Any, Callable, Generic, Optional, TypeVar

from transferia_tpu_torch.abstract.interfaces import AsyncSink
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.stats import trace

logger = logging.getLogger(__name__)

T = TypeVar("T")

# parse_fn(raw) -> Batch|list[Batch]; ack_fn(raw, error: Exception|None)
ParseFn = Callable[[Any], Any]
AckFn = Callable[[Any, Optional[BaseException]], None]

MAX_INFLIGHT = 64  # units added but not yet acked


class ParseQueue(Generic[T]):
    """N-worker parse stage feeding an AsyncSink with ordered pushes.

    Parsing overlaps pushing and acking, but the sink sees batches in
    exactly add() order and acks fire only after the corresponding push
    resolves: the at-least-once ordering contract queue sources rely on
    to commit offsets.
    """

    def __init__(self, parallelism: int, sink: AsyncSink,
                 parse_fn: ParseFn, ack_fn: AckFn):
        self.sink = sink
        self.parse_fn = parse_fn
        self.ack_fn = ack_fn
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, parallelism), thread_name_prefix="parse"
        )
        self._pusher = threading.Thread(
            target=self._push_loop, name="parsequeue-push", daemon=True
        )
        self._cv = threading.Condition()
        self._queue: list[tuple] = []
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._inflight = threading.Semaphore(MAX_INFLIGHT)
        self._outstanding = 0  # added but not yet acked (guarded by _cv)
        self._pusher.start()

    # -- public -------------------------------------------------------------
    def add(self, raw: T) -> None:
        """Enqueue one unit; raises immediately if the queue has failed."""
        if self._failure is not None:
            raise self._failure
        if self._closed:
            raise RuntimeError("parsequeue closed")
        self._inflight.acquire()
        ctx = trace.current_context()
        parse_fut = self._pool.submit(self._safe_parse, raw, ctx)
        with self._cv:
            self._queue.append((raw, parse_fut, ctx))
            self._outstanding += 1
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify()
        self._pusher.join(timeout=60)
        self._pool.shutdown(wait=False, cancel_futures=True)

    @property
    def failure(self) -> Optional[BaseException]:
        return self._failure

    # -- internals ----------------------------------------------------------
    def _safe_parse(self, raw: T, ctx):
        # the parser layer runs here (parse workers): decode raw broker
        # messages into batches — the source_decode stage of the timeline
        failpoint("parsequeue.parse")
        with trace.adopted(ctx), trace.span("source_decode"):
            return self.parse_fn(raw)

    def _push_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(timeout=0.5)
                if not self._queue:
                    if self._closed:
                        return
                    continue
                raw, parse_fut, ctx = self._queue.pop(0)
            err: Optional[BaseException] = self._failure
            if err is None:
                # once failed, drain without pushing: pushing N+1 after N
                # failed would break the in-order delivery contract
                try:
                    parsed = parse_fut.result()
                    batches = parsed if isinstance(parsed, list) \
                        else [parsed]
                    # "sink_wait", not "sink_push": the actual push
                    # executes (and is spanned) inside the async sink's
                    # own worker — this span is the ordered-delivery
                    # wait, and naming them apart keeps the stage
                    # summary from double-counting the push
                    with trace.adopted(ctx), trace.span("sink_wait"):
                        futs = []
                        for b in batches:
                            if b is not None and _batch_len(b):
                                futs.append(self.sink.async_push(b))
                        for f in futs:
                            f.result()
                except BaseException as e:
                    err = e
            try:
                self.ack_fn(raw, err)
            except BaseException as ack_err:
                err = err or ack_err
            if err is not None and self._failure is None:
                self._failure = err
                logger.error("parsequeue failed: %s", err)
            with self._cv:
                self._outstanding -= 1
                self._cv.notify_all()
            self._inflight.release()

    def wait(self) -> None:
        """Block until everything added so far is pushed and acked."""
        with self._cv:
            while self._outstanding > 0:
                self._cv.wait(timeout=0.5)
        if self._failure is not None:
            raise self._failure


def _batch_len(b) -> int:
    try:
        return b.n_rows if hasattr(b, "n_rows") else len(b)
    except TypeError:
        return 1
