"""Local replication runtime (the port's copy of
``transferia_tpu/runtime/local.py``): one replication attempt
(`LocalWorker`: source -> async sink pump) inside the retry loop
(`run_replication`: fatal errors fail the transfer, retriable ones
restart after a fixed backoff) with a heartbeat.

`device` is where the sink pipeline's device work runs (the chain's
fused steps): None means CUDA, which must be present; "cpu" runs the
kernels' plain versions.  The partitioned strategy (Kafka -> object
storage, one pipeline a partition) and the cron-driven regular snapshot
raise NotImplementedError (ROADMAP.md A9).  An attempt is one
`replication_attempt` root span; the heartbeat folds the device
counters and the ledger into the pipeline's metrics.  The reference's
observability-segment export and SLO verdicts on the heartbeat wait for
the coordinator's segments (ROADMAP.md A5, A9).
"""

from __future__ import annotations

import logging
import threading
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

NOT_PORTED = "not ported yet (ROADMAP.md A9: the partitioned " \
             "replication strategy and the regular snapshot)"


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
    """The reference's one-pipeline-per-partition strategy: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"PartitionedWorker: {NOT_PORTED}")


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
        worker = (PartitionedWorker(transfer, coordinator, metrics)
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


def run_regular_snapshot(*args, **kwargs) -> None:
    """The reference's cron-driven re-snapshot loop: not ported."""
    raise NotImplementedError(f"run_regular_snapshot: {NOT_PORTED}")


def _stop_on_event(stop_event: threading.Event, worker: LocalWorker) -> None:
    stop_event.wait()
    worker.stop()


def _heartbeat_loop(stop_event: threading.Event, cp: Coordinator,
                    transfer_id: str, metrics: Metrics) -> None:
    while not stop_event.wait(HEARTBEAT_SECONDS):
        cp.transfer_health(transfer_id, healthy=True)
        # device counters ride the heartbeat onto this pipeline's
        # metrics so long replications expose them; the attribution
        # ledger folds on the same heartbeat
        trace.TELEMETRY.fold_into(metrics)
        LEDGER.fold_into(metrics)
