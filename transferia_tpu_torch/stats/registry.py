"""Metrics facade + typed stat bundles (the port's copy of the bundles
of ``transferia_tpu/stats/registry.py`` that the snapshot transfer and
replication use).

The JAX package registers its metrics with prometheus_client when that
package is present and falls back to local counters otherwise; the port
keeps only the local counters, under the same metric names, so a
bundle's readings (`Metrics.value`) compare one to one with the
reference's.  The telemetry bundles (device, interchange, fleet, SLO,
MVCC) come with the telemetry slice.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class _Metric:
    """A counter, gauge or histogram sum: one float under a lock (the
    loader's upload threads share one registry)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = value

    def observe(self, value: float) -> None:
        self.inc(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class Metrics:
    """Per-pipeline metric registry; `value()` reads a metric back for
    tests and progress reporting."""

    def __init__(self, labels: Optional[dict[str, str]] = None):
        self.labels = labels or {}
        self._metrics: dict[str, _Metric] = {}
        # get-or-create is atomic: one Metrics is shared by a loader's
        # parallel part-upload threads
        self._get_lock = threading.Lock()

    def _get(self, name: str) -> _Metric:
        with self._get_lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = _Metric(name)
            return m

    def counter(self, name: str, doc: str = "") -> _Metric:
        return self._get(name)

    def gauge(self, name: str, doc: str = "") -> _Metric:
        return self._get(name)

    def histogram(self, name: str, doc: str = "") -> _Metric:
        return self._get(name)

    def value(self, name: str) -> float:
        m = self._metrics.get(name)
        return 0.0 if m is None else m.get()


class _Bundle:
    def __init__(self, metrics: Optional[Metrics] = None):
        self.m = metrics or Metrics()


class SourceStats(_Bundle):
    """publisher.data.*"""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.changeitems = self.m.counter("publisher_data_changeitems")
        self.parsed_rows = self.m.counter("publisher_data_parsed_rows")
        self.unparsed_rows = self.m.counter("publisher_data_unparsed_rows")
        self.read_bytes = self.m.counter("publisher_data_read_bytes")
        self.decode_time = self.m.histogram("publisher_time_decode")
        self.push_time = self.m.histogram("publisher_time_push")
        self.usage_lag = self.m.gauge("publisher_lag_seconds")


class SinkerStats(_Bundle):
    """sinker.*"""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.inflight_rows = self.m.gauge("sinker_inflight_rows")
        self.rows = self.m.counter("sinker_pushed_rows")
        self.bytes = self.m.counter("sinker_pushed_bytes")
        self.errors = self.m.counter("sinker_push_errors")
        self.push_time = self.m.histogram("sinker_time_push")
        self.table_rows: dict[str, int] = {}
        self._table_lock = threading.Lock()

    def record_table(self, table: str, rows: int) -> None:
        with self._table_lock:
            self.table_rows[table] = self.table_rows.get(table, 0) + rows


class BuffererStats(_Bundle):
    """Bufferer flush metrics."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.flush_count = self.m.counter("bufferer_flushes")
        self.flush_rows = self.m.counter("bufferer_flush_rows")
        self.buffered_rows = self.m.gauge("bufferer_buffered_rows")
        self.buffered_bytes = self.m.gauge("bufferer_buffered_bytes")
        self.flush_time = self.m.histogram("bufferer_time_flush")


class ReplicationStats(_Bundle):
    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.running = self.m.gauge("replication_running")
        self.restarts = self.m.counter("replication_restarts")
        self.fatal_errors = self.m.counter("replication_fatal_errors")


class TransformStats(_Bundle):
    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.rows_in = self.m.counter("transform_rows_in")
        self.rows_out = self.m.counter("transform_rows_out")
        self.errors = self.m.counter("transform_error_rows")
        self.time = self.m.histogram("transform_time")
        self.compiles = self.m.counter("transform_plan_compiles")


class LeaseStats(_Bundle):
    """Worker-liveness counters (coordinator leases + epoch fencing):
    a nonzero `fence_rejected` means a worker tried to complete a part
    after its lease expired and the part was reclaimed."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.renewals = self.m.counter("lease_renewals")
        self.steals = self.m.counter("lease_steals")
        self.heartbeat_failures = self.m.counter(
            "lease_heartbeat_failures")
        self.fence_rejected = self.m.counter("fence_rejected")


class CommitStats(_Bundle):
    """Staged two-phase sink commit counters (abstract/commit.py)."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.staged_parts = self.m.counter("commit_staged_parts")
        self.published_parts = self.m.counter("commit_published_parts")
        self.aborted_parts = self.m.counter("commit_aborted_parts")
        self.commit_granted = self.m.counter("commit_granted")
        self.commit_fenced = self.m.counter("commit_fenced")
        self.publish_stale_rejected = self.m.counter(
            "publish_stale_rejected")
        self.dedup_rows_dropped = self.m.counter(
            "commit_dedup_rows_dropped")


class TableStats(_Bundle):
    """Per-table snapshot progress."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.completed_parts = self.m.counter("snapshot_completed_parts")
        self.completed_rows = self.m.counter("snapshot_completed_rows")
        self.total_parts = self.m.gauge("snapshot_total_parts")
        self.eta_rows = self.m.gauge("snapshot_eta_rows")


class Timer:
    """Context manager feeding a histogram."""

    def __init__(self, hist):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.monotonic() - self.t0)
        return False
