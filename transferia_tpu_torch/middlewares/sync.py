"""Synchronous middlewares (wrap Sinker): the port's copy of
``transferia_tpu/middlewares/sync.py``.

Reference parity: pkg/middlewares/{statistician,filter,nonrow_separator,
fallback,retrier}.go, the Measurer and the Transformation middleware.
The reference's trace spans, failpoints, torn-write injection, ledger and
freshness watermarks are telemetry and are not ported (ROADMAP.md A5);
the Transformation's `stagetimer.stage("transform")` window is ported:
the replication path's transform latency is read from it.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

from transferia_tpu_torch.abstract.errors import is_retriable
from transferia_tpu_torch.abstract.interfaces import Batch, Sinker, is_columnar
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.middlewares.helpers import (
    batch_bytes,
    batch_len,
    split_rows_controls,
)
from transferia_tpu_torch.stats import stagetimer
from transferia_tpu_torch.stats.registry import SinkerStats
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

    def __init__(self, inner: Sinker, stats: SinkerStats):
        super().__init__(inner)
        self.stats = stats

    def push(self, batch: Batch) -> None:
        n = batch_len(batch)
        nbytes = batch_bytes(batch)
        self.stats.inflight_rows.inc(n)
        t0 = time.monotonic()
        try:
            self.inner.push(batch)
        except BaseException:
            self.stats.errors.inc()
            raise
        finally:
            self.stats.inflight_rows.dec(n)
        self.stats.push_time.observe(time.monotonic() - t0)
        self.stats.rows.inc(n)
        self.stats.bytes.inc(nbytes)
        if is_columnar(batch):
            self.stats.record_table(str(batch.table_id), n)
        else:
            for it in batch:
                if it.is_row_event():
                    self.stats.record_table(str(it.table_id), 1)


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
    """Logs slow pushes.  The reference's push-latency window and its
    quantile reads come with the telemetry slice."""

    def __init__(self, inner: Sinker, warn_seconds: float = 30.0):
        super().__init__(inner)
        self.warn_seconds = warn_seconds

    def push(self, batch: Batch) -> None:
        t0 = time.monotonic()
        self.inner.push(batch)
        dt = time.monotonic() - t0
        if dt > self.warn_seconds:
            logger.warning("slow sink push: %d rows took %.1fs",
                           batch_len(batch), dt)


class Transformation(_Wrap):
    """Applies the transformer chain (a transform.Transformation)."""

    def __init__(self, inner: Sinker, chain):
        super().__init__(inner)
        self.chain = chain

    def push(self, batch: Batch) -> None:
        with stagetimer.stage("transform"):
            out = self.chain.apply(batch)
        if batch_len(out) or not batch_len(batch):
            self.inner.push(out)
