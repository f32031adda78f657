"""Synchronous middlewares (wrap Sinker): the port's copy of
``transferia_tpu/middlewares/sync.py``.

Reference parity: pkg/middlewares/{statistician,filter,nonrow_separator,
fallback,retrier}.go, the Measurer and the Transformation middleware,
with the reference's telemetry: the `sink` and `transform` spans, the
`sink.push`/`sink.push.torn`/`transform.chain` failpoints, the ledger's
rows_out/bytes_out, the publish watermark, and the Transformation's
`stagetimer.stage("transform")` window (where the replication path's
transform latency is read).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import weakref
from typing import Callable, Optional, Sequence

from transferia_tpu_torch.abstract.errors import is_retriable
from transferia_tpu_torch.abstract.interfaces import Batch, Sinker, is_columnar
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.chaos.failpoints import (
    TornWriteError,
    failpoint,
    torn_rows,
)
from transferia_tpu_torch.middlewares.helpers import (
    batch_bytes,
    batch_len,
    split_rows_controls,
)
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import SinkerStats
from transferia_tpu_torch.stats.watermark import WATERMARKS
from transferia_tpu_torch.utils.backoff import retry_with_backoff

logger = logging.getLogger(__name__)

# snapshot-stage sink-push retry knobs
RETRY_BASE_DELAY = 0.5
SINK_PUSH_ATTEMPTS = 3


class _Wrap(Sinker):
    def __init__(self, inner: Sinker):
        self.inner = inner

    def push(self, batch: Batch) -> None:
        self.inner.push(batch)

    def close(self) -> None:
        self.inner.close()


class Statistician(_Wrap):
    """Counts pushed rows/bytes per table."""

    def __init__(self, inner: Sinker, stats: SinkerStats,
                 transfer_id: str = ""):
        super().__init__(inner)
        self.stats = stats
        # explicit identity (not a contextvar): pushes arrive on
        # parsequeue/asynchronizer threads that never saw the
        # submitting thread's context
        self.transfer_id = transfer_id

    @staticmethod
    def _prefix(batch: Batch, k: int) -> Batch:
        return batch.slice(0, k) if is_columnar(batch) else batch[:k]

    def push(self, batch: Batch) -> None:
        n = batch_len(batch)
        nbytes = batch_bytes(batch)
        self.stats.inflight_rows.inc(n)
        sp = trace.span("sink")
        if sp:
            sp.add(rows=n, bytes=nbytes)
        t0 = time.monotonic()
        try:
            with sp:
                failpoint("sink.push")
                torn = torn_rows("sink.push.torn", n)
                if torn is not None:
                    # torn write: land a prefix, then fail — the
                    # at-least-once duplicate generator for chaos runs
                    self.inner.push(self._prefix(batch, torn))
                    raise TornWriteError("sink.push.torn", torn, n)
                self.inner.push(batch)
        except BaseException:
            self.stats.errors.inc()
            raise
        finally:
            self.stats.inflight_rows.dec(n)
        self.stats.push_time.observe(time.monotonic() - t0)
        self.stats.rows.inc(n)
        self.stats.bytes.inc(nbytes)
        # ledger attribution: delivered ROW events bill the ambient
        # (transfer, tenant, part) scope — control items (Init/Done
        # table loads) are delivery protocol, not tenant work, so they
        # stay out of rows_out even though SinkerStats counts them; the
        # asynchronizer/bufferer carried the submitter's contextvars
        n_rows = n if is_columnar(batch) else sum(
            1 for it in batch if it.is_row_event())
        LEDGER.add(rows_out=n_rows, bytes_out=nbytes)
        if is_columnar(batch):
            self.stats.record_table(str(batch.table_id), n)
        else:
            for it in batch:
                if it.is_row_event():
                    self.stats.record_table(str(it.table_id), 1)
        if self.transfer_id and n_rows:
            # freshness: the batch has durably reached the sink — the
            # publish-watermark advance + end-to-end lag sample
            WATERMARKS.observe_publish(self.transfer_id, batch)


class Filter(_Wrap):
    """Excludes configured tables (system tables)."""

    def __init__(self, inner: Sinker,
                 exclude: Callable[[TableID], bool]):
        super().__init__(inner)
        self.exclude = exclude

    def push(self, batch: Batch) -> None:
        if is_columnar(batch):
            if self.exclude(batch.table_id):
                return
            self.inner.push(batch)
            return
        kept = [it for it in batch if not self.exclude(it.table_id)]
        if kept:
            self.inner.push(kept)


class NonRowSeparator(_Wrap):
    """Ensures inner pushes are homogeneous: row runs or single control
    items."""

    def push(self, batch: Batch) -> None:
        for part in split_rows_controls(batch):
            self.inner.push(part)


class TypeFallbacks(_Wrap):
    """Applies versioned typesystem fallbacks to columnar batches."""

    def __init__(self, inner: Sinker, fallbacks: Sequence):
        super().__init__(inner)
        self.fallbacks = list(fallbacks)

    def push(self, batch: Batch) -> None:
        if self.fallbacks and is_columnar(batch):
            for fb in self.fallbacks:
                batch = fb.apply(batch)
        self.inner.push(batch)


class Retrier(_Wrap):
    """Retries non-fatal push errors with exponential backoff
    (snapshot stage only)."""

    def __init__(self, inner: Sinker, attempts: int = SINK_PUSH_ATTEMPTS,
                 base_delay: Optional[float] = None):
        super().__init__(inner)
        self.attempts = attempts
        self.base_delay = base_delay

    def _on_retry(self, i: int, e: BaseException) -> None:
        logger.warning(
            "sink push retry %d/%d after error: %s", i, self.attempts, e)
        # a staged-commit sink: the re-push may replay a torn batch whose
        # prefix already staged — arm the stage's dedup window so that
        # prefix is dropped, not doubled
        from transferia_tpu_torch.abstract.commit import find_staged_sink

        staged = find_staged_sink(self.inner)
        if staged is not None:
            staged.note_push_retry()

    def push(self, batch: Batch) -> None:
        retry_with_backoff(
            lambda: self.inner.push(batch),
            attempts=self.attempts,
            base_delay=self.base_delay if self.base_delay is not None
            else RETRY_BASE_DELAY,
            retriable=is_retriable,
            on_retry=self._on_retry,
        )


class Measurer(_Wrap):
    """Logs slow pushes and keeps a push-latency window.

    The window (bounded ring of recent push durations) backs quantile
    reads: a near-minute push hiding inside an otherwise-green run is
    invisible to averages."""

    WINDOW = 4096
    # weak registry of live instances: every pipeline's Measurer, so a
    # stall in any of them is visible; weak refs so a stopped
    # transfer's sink chain is not pinned in memory
    _instances: "weakref.WeakSet[Measurer]" = weakref.WeakSet()
    _registry_lock = threading.Lock()

    def __init__(self, inner: Sinker, warn_seconds: float = 30.0):
        super().__init__(inner)
        self.warn_seconds = warn_seconds
        self._lat = collections.deque(maxlen=self.WINDOW)
        self._lock = threading.Lock()
        with Measurer._registry_lock:
            Measurer._instances.add(self)

    def push(self, batch: Batch) -> None:
        t0 = time.monotonic()
        self.inner.push(batch)
        dt = time.monotonic() - t0
        with self._lock:
            self._lat.append(dt)
        if dt > self.warn_seconds:
            logger.warning("slow sink push: %d rows took %.1fs",
                           batch_len(batch), dt)

    def quantile(self, q: float) -> float:
        """Push-latency quantile (seconds) over the recent window; 0.0
        before any push."""
        with self._lock:
            lat = sorted(self._lat)
        if not lat:
            return 0.0
        idx = min(len(lat) - 1, int(q * len(lat)))
        return lat[idx]

    @classmethod
    def global_quantile(cls, q: float) -> float:
        """Quantile over every live pipeline's recent window."""
        lat: list[float] = []
        with cls._registry_lock:
            instances = list(cls._instances)
        for inst in instances:
            with inst._lock:
                lat.extend(inst._lat)
        if not lat:
            return 0.0
        lat.sort()
        idx = min(len(lat) - 1, int(q * len(lat)))
        return lat[idx]


class Transformation(_Wrap):
    """Applies the transformer chain (a transform.Transformation)."""

    def __init__(self, inner: Sinker, chain):
        super().__init__(inner)
        self.chain = chain

    def push(self, batch: Batch) -> None:
        sp = trace.span("transform")
        if sp:
            sp.add(rows=batch_len(batch))
        with stagetimer.stage("transform"), sp:
            failpoint("transform.chain")
            out = self.chain.apply(batch)
        if batch_len(out) or not batch_len(batch):
            self.inner.push(out)
