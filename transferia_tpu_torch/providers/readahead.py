"""Row-group decode readahead: overlap host decode with the downstream
pipeline (the port's copy of ``transferia_tpu/providers/readahead.py``).

The decode calls release the GIL (ctypes into the host library's Parquet
decoder), so one background thread decoding row group g+1 while g's
batches flow through the chain and the sink buys genuine overlap without
processes.

`RowGroupReadahead` is that bounded prefetcher:

- one worker thread decodes groups IN ORDER; the consumer iterates
  `(group, item)` pairs in the same order (batch ordering downstream is
  unchanged);
- bounded in-flight: at most `max_groups` decoded groups exist at once
  (the one the consumer holds + the queue + the one being decoded
  counts toward the cap), and optionally at most `max_bytes` of decoded
  payload;
- a worker exception is re-raised to the consumer on its next pull (so
  it propagates to the `upload_tables` caller exactly like a serial
  decode error would);
- a consumer/pusher error cancels outstanding prefetches: `close()`
  (the context-manager exit) stops the worker before its next decode
  and drops queued groups;
- `max_groups <= 1` (or a single group) degrades to inline decode on
  the caller's thread — zero new threads, exactly the serial behavior.

Observability: each prefetch decode runs inside a `decode_readahead`
trace span on the worker thread, which adopts the submitter's trace
context and ledger scope; consumer stalls are accounted as a
`decode_wait` stage and ledger seconds; queue depth and in-flight
decoded bytes feed optional gauges (stats/registry.py DeviceStats).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional


class RowGroupReadahead:
    """Bounded background decode of an ordered group list.

    with RowGroupReadahead(groups, decode, max_groups=2) as ra:
        for g, item in ra:
            ...push item's batches downstream...

    `decode(g)` runs on the worker thread (it must release the GIL to
    be useful, as the native parquet decoder does);
    `nbytes(item)` sizes an item for the byte cap and the gauges.
    `gauges` is an optional (depth_gauge, bytes_gauge) pair with
    inc/dec semantics (inc/dec compose across concurrent prefetchers
    where set() would fight).
    """

    def __init__(self, groups: Iterable, decode: Callable,
                 *, max_groups: int = 2,
                 max_bytes: Optional[int] = None,
                 nbytes: Optional[Callable] = None,
                 gauges: Optional[tuple] = None):
        self._groups = list(groups)
        self._decode = decode
        self._max_groups = max_groups
        self._max_bytes = max_bytes
        self._nbytes = nbytes
        self._gauges = gauges
        self._cond = threading.Condition()
        self._queue: deque = deque()  # (group, item, nbytes)
        self._inflight_bytes = 0
        self._handed: Optional[tuple] = None  # (group, nbytes) at consumer
        self._error: Optional[BaseException] = None
        self._closed = False
        self._done = False
        self._pos = 0  # inline-mode cursor
        self._thread: Optional[threading.Thread] = None
        # causal hop: the worker thread's decode spans must parent to
        # the span that SUBMITTED the prefetch (the part span), and its
        # resource events must bill the same (transfer, tenant, part)
        # — capture both here, adopt them in _run
        from transferia_tpu_torch.stats import trace as _trace
        from transferia_tpu_torch.stats.ledger import LEDGER as _ledger

        self._trace_ctx = _trace.current_context()
        self._ledger_key = _ledger.current_key()
        # max_groups=1 can never overlap (the cap counts the group the
        # consumer holds, stalling the worker whenever the consumer is
        # busy) — inline serial decode is strictly better there too
        if max_groups > 1 and len(self._groups) > 1:
            self._thread = threading.Thread(target=self._run,
                                            name="decode-readahead",
                                            daemon=True)
            self._thread.start()

    # -- worker ------------------------------------------------------------
    def _stalled_locked(self) -> bool:
        """Caller holds self._cond.  True while decoding one more group
        would bust a cap.  A lone group always proceeds (a single group
        larger than max_bytes must still decode, or nothing ever
        flows)."""
        inflight = len(self._queue) + (1 if self._handed is not None else 0)
        if inflight == 0:
            return False
        if inflight + 1 > self._max_groups:
            return True
        return (self._max_bytes is not None
                and self._inflight_bytes >= self._max_bytes)

    def _run(self) -> None:
        from transferia_tpu_torch.chaos.failpoints import failpoint
        from transferia_tpu_torch.stats import trace
        from transferia_tpu_torch.stats.ledger import LEDGER

        with trace.adopted(self._trace_ctx), \
                LEDGER.adopted(self._ledger_key):
            self._run_adopted(failpoint, trace)

    def _run_adopted(self, failpoint, trace) -> None:
        try:
            for g in self._groups:
                with self._cond:
                    while not self._closed and self._stalled_locked():
                        self._cond.wait()
                    if self._closed:
                        return
                failpoint("decode.readahead.worker")
                sp = trace.span("decode_readahead")
                if sp:
                    sp.add(group=g)
                with sp:
                    item = self._decode(g)
                nb = int(self._nbytes(item)) if self._nbytes else 0
                with self._cond:
                    if self._closed:
                        return  # consumer bailed mid-decode: drop
                    self._queue.append((g, item, nb))
                    self._inflight_bytes += nb
                    self._account_enqueue_locked(nb)
                    self._cond.notify_all()
        except BaseException as e:  # re-raised on the consumer thread
            with self._cond:
                self._error = e
                self._cond.notify_all()
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def _account_enqueue_locked(self, nb: int) -> None:
        if self._gauges is not None:
            self._gauges[0].inc()
            if nb:
                self._gauges[1].inc(nb)

    # -- consumer ----------------------------------------------------------
    def _release_handed_locked(self) -> None:
        if self._handed is None:
            return
        _, nb = self._handed
        self._handed = None
        self._inflight_bytes -= nb
        if self._gauges is not None and nb:
            self._gauges[1].dec(nb)

    def __iter__(self) -> "RowGroupReadahead":
        return self

    def __next__(self) -> tuple:
        if self._thread is None:
            return self._next_inline()
        waited = 0.0
        try:
            with self._cond:
                self._release_handed_locked()
                self._cond.notify_all()
                while True:
                    if self._queue:
                        g, item, nb = self._queue.popleft()
                        self._handed = (g, nb)
                        if self._gauges is not None:
                            self._gauges[0].dec()
                        break
                    if self._error is not None:
                        raise self._error
                    if self._done:
                        raise StopIteration
                    t0 = time.perf_counter()
                    self._cond.wait()
                    waited += time.perf_counter() - t0
        finally:
            if waited:
                from transferia_tpu_torch.stats import stagetimer
                from transferia_tpu_torch.stats.ledger import LEDGER

                stagetimer.add("decode_wait", waited)
                LEDGER.add(decode_wait_seconds=waited)
        return g, item

    def _next_inline(self) -> tuple:
        # serial fallback: no worker, no queue — decode on demand.  The
        # error/cancel semantics hold trivially (decode raises in place;
        # close() just ends iteration).
        if self._closed or self._pos >= len(self._groups):
            raise StopIteration
        g = self._groups[self._pos]
        self._pos += 1
        return g, self._decode(g)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Cancel outstanding prefetches and join the worker.  Called by
        the context-manager exit — a pusher error inside the consumer
        loop lands here, so the worker stops before its next decode."""
        t = self._thread
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if t is not None:
            t.join()
        with self._cond:
            self._release_handed_locked()
            while self._queue:
                _g, _item, nb = self._queue.popleft()
                self._inflight_bytes -= nb
                if self._gauges is not None:
                    self._gauges[0].dec()
                    if nb:
                        self._gauges[1].dec(nb)

    def __enter__(self) -> "RowGroupReadahead":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
