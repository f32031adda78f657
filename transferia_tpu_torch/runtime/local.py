"""Local replication runtime (the port's copy of
``transferia_tpu/runtime/local.py``): one replication attempt
(`LocalWorker`: source -> async sink pump) inside the retry loop
(`run_replication`: fatal errors fail the transfer, retriable ones
restart after a fixed backoff) with a heartbeat, and the cron-driven
regular snapshot (`run_regular_snapshot`).

`device` is where the sink pipeline's device work runs (the chain's
fused steps): None means CUDA, which must be present; "cpu" runs the
kernels' plain versions.  Kafka -> object storage (`fs`) runs the
partitioned strategy (`PartitionedWorker`): one source and sink pipeline
a topic partition, each on its own pump thread, where a failure in one
stops them all and fails the attempt.  An attempt is one
`replication_attempt` root span; the heartbeat folds the device
counters and the ledger into the pipeline's metrics and, on a
coordinator that keeps obs segments, exports this process's segment
(stats/fleetobs.py) and folds the SLO verdicts (stats/slo.py) into them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from transferia_tpu_torch.abstract.errors import is_fatal
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    TransferStatus,
)
from transferia_tpu_torch.factories import make_async_sink, new_source
from transferia_tpu_torch.middlewares.asynchronizer import ErrorTracker
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import Metrics, ReplicationStats

logger = logging.getLogger(__name__)

RETRY_BACKOFF_SECONDS = 10.0   # sleep between attempts
HEARTBEAT_SECONDS = 60.0

class LocalWorker:
    """One replication attempt: build source + sink, pump until stop or
    error."""

    def __init__(self, transfer, coordinator: Coordinator,
                 metrics: Optional[Metrics] = None,
                 device: DeviceLike = None):
        self.transfer = transfer
        self.cp = coordinator
        self.metrics = metrics or Metrics()
        self.device = resolve_device(device)
        self.source = None
        self.sink: Optional[ErrorTracker] = None

    def run(self) -> None:
        """Blocks until the source stops or fails."""
        self.sink = make_async_sink(self.transfer, self.metrics,
                                    snapshot_stage=False,
                                    device=self.device)
        # root span for the whole attempt: per-batch spans recorded by
        # parsequeue / middlewares on worker threads share its timeline
        sp = trace.span("replication_attempt")
        if sp:
            sp.add(transfer_id=self.transfer.id)
        try:
            self.source = new_source(self.transfer, self.metrics,
                                     coordinator=self.cp)
            with sp:
                self.source.run(self.sink)
            # surface sink-side failures latched by the error tracker
            if isinstance(self.sink, ErrorTracker) and self.sink.failure:
                raise self.sink.failure
        finally:
            self.sink.close()

    def stop(self) -> None:
        if self.source is not None:
            self.source.stop()


def is_partitioned_replication(transfer) -> bool:
    """Queue -> object-storage replication runs one pipeline per
    partition in the reference."""
    src_p = getattr(transfer.src, "PROVIDER", "")
    dst_p = getattr(transfer.dst, "PROVIDER", "")
    return src_p in ("kafka", "eventhub") and dst_p in ("s3", "fs")


class PartitionedWorker:
    """One independent source and sink pipeline a topic partition: a slow
    object flush on one partition never holds back the others, and each
    partition's files get clean offset ranges."""

    def __init__(self, transfer, coordinator: Coordinator,
                 metrics: Optional[Metrics] = None,
                 device: DeviceLike = None):
        self.transfer = transfer
        self.cp = coordinator
        self.metrics = metrics or Metrics()
        self.device = resolve_device(device)
        self._pipelines: list = []  # (source, sink)
        self._stopped = threading.Event()
        self._plock = threading.Lock()  # guards pipelines vs stop()
        # every pump-thread failure (run, latched sink, close) lands
        # here; run() re-raises the first one.  Readable after stop()
        self.failures: list[BaseException] = []
        self._err_lock = threading.Lock()

    def run(self) -> None:
        from transferia_tpu_torch.providers.kafka.provider import (
            _KafkaQueueClient,
            topic_partitions,
        )
        from transferia_tpu_torch.providers.queue_common import QueueSource

        params = self.transfer.src
        partitions = topic_partitions(params)
        if not partitions:
            raise RuntimeError(f"topic {params.topic!r} has no partitions")
        logger.info("partitioned replication: %d pipelines (%s)",
                    len(partitions), partitions)
        threads = []
        for p in partitions:
            if self._stopped.is_set():
                break  # stop() fired while pipelines were being built
            client = _KafkaQueueClient(params, self.transfer.id,
                                       self.cp, partitions=[p])
            source = QueueSource(
                client, params.parser,
                parallelism=max(1, params.parallelism // len(partitions)),
                metrics=self.metrics, transfer_id=self.transfer.id)
            sink = make_async_sink(self.transfer, self.metrics,
                                   snapshot_stage=False,
                                   device=self.device)
            with self._plock:
                self._pipelines.append((source, sink))
                if self._stopped.is_set():
                    # stop() already swept: this source would be missed
                    source.stop()

            def pump(src=source, snk=sink, part=p):
                try:
                    src.run(snk)
                    if isinstance(snk, ErrorTracker) and snk.failure:
                        raise snk.failure
                except BaseException as e:
                    self._record_failure(part, e)
                    self.stop()  # one failure restarts the attempt
                finally:
                    # a close() error (a flush of buffered rows, a broken
                    # connection) must surface on run() like any pump
                    # error
                    try:
                        snk.close()
                    except BaseException as e:
                        self._record_failure(part, e)
                        self.stop()

            t = threading.Thread(target=pump, daemon=True,
                                 name=f"partition-{p}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        if self.failures:
            raise self.failures[0]

    def _record_failure(self, partition: int, err: BaseException) -> None:
        with self._err_lock:
            self.failures.append(err)
        logger.warning("partition %d pipeline failed: %s", partition, err)

    @property
    def failure(self) -> Optional[BaseException]:
        """The first pump failure, if any (readable after stop())."""
        with self._err_lock:
            return self.failures[0] if self.failures else None

    def stop(self) -> None:
        self._stopped.set()
        with self._plock:
            for source, _sink in self._pipelines:
                source.stop()


def run_replication(transfer, coordinator: Coordinator,
                    metrics: Optional[Metrics] = None,
                    stop_event: Optional[threading.Event] = None,
                    max_attempts: int = 0,
                    backoff: float = RETRY_BACKOFF_SECONDS,
                    device: DeviceLike = None) -> None:
    """The retry loop.

    Restarts the worker on retriable errors with a fixed backoff; a
    fatal error fails the transfer and raises.  stop_event ends the loop
    cleanly.  max_attempts=0 means retry forever.
    """
    device = resolve_device(device)
    metrics = metrics or Metrics()
    stats = ReplicationStats(metrics)
    stop_event = stop_event or threading.Event()
    attempt = 0
    while not stop_event.is_set():
        attempt += 1
        worker = (PartitionedWorker(transfer, coordinator, metrics,
                                    device=device)
                  if is_partitioned_replication(transfer)
                  else LocalWorker(transfer, coordinator, metrics,
                                   device=device))
        coordinator.set_status(transfer.id, TransferStatus.RUNNING)
        stats.running.set(1)

        stopper = threading.Thread(
            target=_stop_on_event, args=(stop_event, worker), daemon=True
        )
        stopper.start()
        heartbeat = threading.Thread(
            target=_heartbeat_loop,
            args=(stop_event, coordinator, transfer.id, metrics),
            daemon=True,
        )
        heartbeat.start()
        try:
            worker.run()
            if stop_event.is_set():
                logger.info("replication stopped by request")
                return
            # the source returned without stop: a retriable interruption
            raise ConnectionError("source terminated unexpectedly")
        except BaseException as e:
            stats.running.set(0)
            if stop_event.is_set():
                logger.info("replication stopped during error: %s", e)
                return
            # a part of the port that is left out fails like a fatal
            # error: a retry would run into it again
            if is_fatal(e) or isinstance(e, NotImplementedError):
                stats.fatal_errors.inc()
                logger.error("fatal replication error: %s", e)
                coordinator.fail_replication(transfer.id, str(e))
                raise
            stats.restarts.inc()
            logger.warning("replication attempt %d failed, retrying in "
                           "%.0fs: %s", attempt, backoff, e)
            if max_attempts and attempt >= max_attempts:
                coordinator.fail_replication(transfer.id, str(e))
                raise
            stop_event.wait(backoff)


def run_regular_snapshot(transfer, coordinator: Coordinator,
                         metrics: Optional[Metrics] = None,
                         stop_event: Optional[threading.Event] = None,
                         max_runs: int = 0,
                         device: DeviceLike = None) -> None:
    """The cron-driven re-snapshot loop.  Each tick runs an
    incremental-aware upload of every table on `device`; the cursors
    persist through the coordinator.  max_runs=0 runs until stop_event."""
    from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
    from transferia_tpu_torch.utils.cron import parse_cron

    rs = transfer.regular_snapshot
    if not rs.enabled or not rs.cron:
        raise ValueError("transfer has no regular_snapshot cron configured")
    device = resolve_device(device)
    spec = parse_cron(rs.cron)
    stop_event = stop_event or threading.Event()
    runs = 0
    while not stop_event.is_set():
        next_t = spec.next_after()
        wait = max(0.0, next_t - time.time())
        logger.info("regular snapshot: next run in %.0fs", wait)
        if stop_event.wait(wait):
            return
        loader = SnapshotLoader(
            transfer, coordinator,
            operation_id=f"op-{transfer.id}-{int(next_t)}",
            metrics=metrics, device=device,
        )
        loader.upload_tables()
        runs += 1
        if max_runs and runs >= max_runs:
            return


def _stop_on_event(stop_event: threading.Event, worker: LocalWorker) -> None:
    stop_event.wait()
    worker.stop()


def _heartbeat_loop(stop_event: threading.Event, cp: Coordinator,
                    transfer_id: str, metrics: Metrics) -> None:
    from transferia_tpu_torch.stats import fleetobs, slo

    exporter = None
    if cp.supports_obs_segments():
        exporter = fleetobs.exporter_for(cp, f"repl-{transfer_id}")
    while not stop_event.wait(HEARTBEAT_SECONDS):
        cp.transfer_health(transfer_id, healthy=True)
        # device counters ride the heartbeat onto this pipeline's
        # metrics so long replications expose them; the attribution
        # ledger folds on the same heartbeat
        trace.TELEMETRY.fold_into(metrics)
        LEDGER.fold_into(metrics)
        if exporter is not None:
            # obs segments (spans, histograms, watermarks) ride the same
            # beat, and the SLO burn rates get their window edges
            exporter.export("periodic")
            slo.fold_verdicts(metrics, slo.debug_slo())
    if exporter is not None:
        exporter.export("final")
