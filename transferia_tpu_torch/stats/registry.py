"""Metrics facade + typed stat bundles (the port's copy of the bundles
of ``transferia_tpu/stats/registry.py`` that the snapshot transfer and
replication use).

The JAX package registers its metrics with prometheus_client when that
package is present and falls back to local counters otherwise; the port
keeps only the local counters, under the same metric names, so a
bundle's readings (`Metrics.value`) compare one to one with the
reference's.  `DeviceStats` and `ChaosStats` are the telemetry
plane's bundles, `MvccStats` the MVCC staging store's, `FleetStats`
and `DistributedFleetStats` the fleet's and `SloStats` the SLO plane's;
the interchange bundle comes with that module.
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


class SloStats(_Bundle):
    """SLO plane gauges (stats/slo.py fold_verdicts): the latest
    burn-rate evaluation."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.objectives = self.m.gauge("slo_objectives")
        self.burning = self.m.gauge("slo_burning")
        self.worst_burn_fast = self.m.gauge("slo_worst_burn_fast")
        self.worst_burn_slow = self.m.gauge("slo_worst_burn_slow")
        self.worst_lag_ms = self.m.gauge("slo_worst_replication_lag_ms")
        self.evaluations = self.m.counter("slo_evaluations")


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


class DeviceStats(_Bundle):
    """Device-link counters (stats/trace.py DeviceTelemetry folds its
    deltas in here: H2D/D2H bytes and transfer counts, launches, kernel
    builds, kernel wall time).  The metric names are the reference's,
    `device_xla_compiles` included, so the two registries read alike;
    in the port a "compile" is one `nvcc` kernel build."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.h2d_bytes = self.m.counter("device_h2d_bytes")
        self.h2d_transfers = self.m.counter("device_h2d_transfers")
        self.d2h_bytes = self.m.counter("device_d2h_bytes")
        self.d2h_transfers = self.m.counter("device_d2h_transfers")
        self.launches = self.m.counter("device_launches")
        self.compiles = self.m.counter("device_xla_compiles")
        self.compile_seconds = self.m.counter("device_xla_compile_seconds")
        self.kernel_seconds = self.m.counter("device_kernel_seconds")
        # decode-pipeline readahead (providers/readahead.py): prefetch
        # queue depth and in-flight decoded bytes — host-side gauges,
        # but they live with the link physics because overlapping host
        # decode with device dispatch is what the prefetcher buys
        self.readahead_depth = self.m.gauge("decode_readahead_depth")
        self.readahead_bytes = self.m.gauge(
            "decode_readahead_inflight_bytes")
        # compressed dispatch plane (ops/dispatch.py): encoded vs
        # raw-equivalent H2D bytes — the ratio gauge IS the plane's
        # honesty metric (a "compressed" wire showing ~1.0 is shipping
        # flat buffers after all) — plus dict-pool residency counters
        self.h2d_encoded_bytes = self.m.counter("h2d_encoded_bytes")
        self.h2d_raw_equiv_bytes = self.m.counter("h2d_raw_equiv_bytes")
        self.compression_ratio = self.m.gauge(
            "dispatch_compression_ratio")
        self.dict_pool_hits = self.m.counter("dict_pool_device_hits")
        self.dict_pool_uploads = self.m.counter(
            "dict_pool_device_uploads")
        # pool interning + decode-buffer economics (columnar/batch
        # intern_pool, parquet_native._finish_bytearray): content-hit
        # pool reuse across row groups/parts, and bytes a kept pool
        # view pins vs bytes copied out to free the decode buffer
        self.dict_pool_share_hits = self.m.counter("dict_pool_share_hits")
        self.dict_pool_pinned_bytes = self.m.counter(
            "dict_pool_pinned_bytes")
        self.dict_pool_copied_bytes = self.m.counter(
            "dict_pool_copied_bytes")
        # dict-native reduction plane (ops/rowhash.py, mask fast paths):
        # columns that crossed a stage still code-encoded vs columns a
        # consumer flattened — nonzero flat materializations on a
        # dict-heavy pipeline mean a code-aware fast path leaked
        self.lazy_dict_preserved = self.m.counter("lazy_dict_preserved")
        self.dict_flat_materializations = self.m.counter(
            "dict_flat_materializations")
        # concurrency sentinel (runtime/lockwatch.py fold_into): lock
        # acquisitions observed under the armed watch, plus the three
        # finding classes — any nonzero inversion count is a potential
        # deadlock witnessed at runtime
        self.lockwatch_acquisitions = self.m.counter(
            "lockwatch_acquisitions")
        self.lockwatch_inversions = self.m.counter("lockwatch_inversions")
        self.lockwatch_long_holds = self.m.counter("lockwatch_long_holds")
        self.lockwatch_blocking_in_lock = self.m.counter(
            "lockwatch_blocking_in_lock")


class ChaosStats(_Bundle):
    """Fault-injection counters (chaos/).  Per-site fire counts land as
    `chaos_fires_<site with dots -> underscores>` so a chaos soak's
    injection activity is visible beside the delivery counters it
    perturbs."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.fires = self.m.counter("chaos_fires")
        self.trials = self.m.counter("chaos_trials")
        self.invariant_failures = self.m.counter(
            "chaos_invariant_failures")
        self.duplicates_absorbed = self.m.counter(
            "chaos_duplicates_absorbed")
        self.restarts = self.m.counter("chaos_restarts")

    @staticmethod
    def site_counter_name(site: str) -> str:
        """chaos/failpoints.fold_into shares this naming — keep single."""
        return "chaos_fires_" + site.replace(".", "_")

    def record_site(self, site: str, fires: int) -> None:
        if fires <= 0:
            return
        self.m.counter(self.site_counter_name(site),
                       f"chaos fires at {site}").inc(fires)
        self.fires.inc(fires)


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


class FleetStats(_Bundle):
    """Fleet control plane counters (fleet/scheduler.py).  A fleet that
    sheds while `desired_workers` exceeds the live workers asks for
    capacity; one that sheds with idle workers is backpressured by the
    data plane (fleet/backpressure.py)."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.admitted = self.m.counter("fleet_admitted")
        self.shed = self.m.counter("fleet_shed")
        self.completed = self.m.counter("fleet_completed")
        self.failed = self.m.counter("fleet_failed")
        self.rebalanced = self.m.counter("fleet_rebalanced")
        self.worker_deaths = self.m.counter("fleet_worker_deaths")
        self.queue_depth = self.m.gauge("fleet_queue_depth")
        self.inflight = self.m.gauge("fleet_inflight")
        self.desired_workers = self.m.gauge("fleet_desired_workers")
        self.tenant_debt_max = self.m.gauge("fleet_tenant_debt_max")
        self.dispatch_time = self.m.histogram("fleet_time_dispatch")


class DistributedFleetStats(_Bundle):
    """Distributed fleet counters (fleet/distributed.py, fleet/worker.py,
    fleet/autoscaler.py).  `ticket_fences` are zombies whose completions
    were rejected after a reclaim or a revoke; fences with no steals or
    preemptions mean a lease TTL shorter than the part cadence."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.enqueued = self.m.counter("fleet_tickets_enqueued")
        self.claimed = self.m.counter("fleet_tickets_claimed")
        self.completed = self.m.counter("fleet_tickets_completed")
        self.failed = self.m.counter("fleet_tickets_failed")
        self.released = self.m.counter("fleet_tickets_released")
        self.fenced = self.m.counter("fleet_ticket_fences")
        self.steals = self.m.counter("fleet_ticket_steals")
        self.shed = self.m.counter("fleet_tickets_shed")
        self.preemptions = self.m.counter("fleet_preemptions")
        self.preempt_yields = self.m.counter("fleet_preempt_yields")
        self.worker_spawns = self.m.counter("fleet_worker_spawns")
        self.worker_exits = self.m.counter("fleet_worker_exits")
        self.autoscale_ups = self.m.counter("fleet_autoscale_ups")
        self.autoscale_downs = self.m.counter("fleet_autoscale_downs")
        self.gc_pruned = self.m.counter("fleet_tickets_gc_pruned")
        self.queued = self.m.gauge("fleet_dist_queued")
        self.inflight = self.m.gauge("fleet_dist_inflight")
        self.desired_workers = self.m.gauge("fleet_dist_desired_workers")
        self.live_workers = self.m.gauge("fleet_dist_live_workers")


class MvccStats(_Bundle):
    """MVCC staging-store counters (mvcc/).  The pair to watch is
    `layers_fenced` vs `cutovers`: nonzero fences mean zombie
    snapshot/delta workers published after the cutover sealed and were
    stopped at the coordinator.  `watermark_lag` is the distance between
    the newest delta LSN seen and the sealed cutover watermark."""

    def __init__(self, metrics: Optional[Metrics] = None):
        super().__init__(metrics)
        self.base_versions = self.m.counter("mvcc_base_versions")
        self.base_rows = self.m.counter("mvcc_base_rows")
        self.delta_layers = self.m.counter("mvcc_delta_layers")
        self.delta_rows = self.m.counter("mvcc_delta_rows")
        self.layers_replaced = self.m.counter("mvcc_layers_replaced")
        self.layers_fenced = self.m.counter("mvcc_layers_fenced")
        self.merged_reads = self.m.counter("mvcc_merged_reads")
        self.merged_rows = self.m.counter("mvcc_merged_rows")
        self.cutovers = self.m.counter("mvcc_cutovers")
        self.cutover_fenced = self.m.counter("mvcc_cutover_fenced")
        self.compactions = self.m.counter("mvcc_compactions")
        self.compacted_rows = self.m.counter("mvcc_compacted_rows")
        self.spill_blobs = self.m.counter("mvcc_spill_blobs")
        self.spill_bytes = self.m.counter("mvcc_spill_bytes")
        self.rebuilds = self.m.counter("mvcc_rebuilds")
        self.rebuilt_layers = self.m.counter("mvcc_rebuilt_layers")
        self.pump_rows = self.m.counter("mvcc_pump_rows")
        self.pump_layers = self.m.counter("mvcc_pump_layers")
        self.offset_commits = self.m.counter("mvcc_offset_commits")
        self.live_layers = self.m.gauge("mvcc_live_layers")
        self.watermark_lag = self.m.gauge("mvcc_watermark_lag")


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
