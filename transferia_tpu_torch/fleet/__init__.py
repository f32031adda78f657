"""Fleet control plane: schedule N tenants x M transfers over a
bounded worker pool, in-process or distributed (the port's copy of
``transferia_tpu/fleet/``).

- `scheduler.py` — in-process plane: admission control (tenant queue
  quotas + backpressure shed), weighted deficit-round-robin fair share
  with per-transfer QoS classes, bounded in-flight dispatch onto worker
  slots, kill/rebalance recovery, autoscaling hints.
- `distributed.py` — the durable plane: the admission queue lives in
  the COORDINATOR (memory/filestore/s3 tickets with lease + epoch
  fencing), schedulers fail over and never double-admit, and QoS
  priorities preempt via lease revocation.
- `worker.py` — `trtpu worker`: a supervised worker process claiming
  tickets (WDRR), heartbeating its lease, draining on SIGTERM; plus
  the `WorkerSupervisor` (thread/process modes).
- `autoscaler.py` — the elastic loop consuming `desired_workers` with
  hysteresis: sustained-demand scale-up, idle-drain scale-down.
- `backpressure.py` — hysteresis gate over the data-plane load gauges
  (readahead bytes/depth, sink in-flight rows, dispatch compression
  ratio, fleet queue depth).
- `bench.py` — `trtpu fleet bench`: 100+
  concurrent sample->memory transfers; p50/p99 dispatch latency and
  the Jain fairness index are tracked bench metrics.

Live schedulers (and autoscalers) register here so the health port can
serve `/debug/fleet` without the CLI holding a reference.
"""

from __future__ import annotations

import threading

from transferia_tpu_torch.fleet.backpressure import (  # noqa: F401
    BackpressureController,
    SignalSpec,
)
from transferia_tpu_torch.fleet.scheduler import (  # noqa: F401
    FleetScheduler,
    FleetTransfer,
    QosClass,
)

_registry_lock = threading.Lock()
_SCHEDULERS: list = []
_AUTOSCALERS: list = []


def register_scheduler(sched) -> None:
    with _registry_lock:
        if sched not in _SCHEDULERS:
            _SCHEDULERS.append(sched)


def unregister_scheduler(sched) -> None:
    with _registry_lock:
        if sched in _SCHEDULERS:
            _SCHEDULERS.remove(sched)


def register_autoscaler(scaler) -> None:
    with _registry_lock:
        if scaler not in _AUTOSCALERS:
            _AUTOSCALERS.append(scaler)


def unregister_autoscaler(scaler) -> None:
    with _registry_lock:
        if scaler in _AUTOSCALERS:
            _AUTOSCALERS.remove(scaler)


def _commit_rollup() -> dict:
    """The staged-commit ledger totals the fleet operator watches next
    to the queue state: granted publishes, fenced zombie publishes, and
    rows the dedup window dropped pre-publish (stats/ledger.py; full
    per-transfer detail stays on /debug/ledger)."""
    from transferia_tpu_torch.stats.ledger import LEDGER

    totals = LEDGER.snapshot()["totals"]
    return {
        "commit_parts": totals["commits"],
        "commit_fences": totals["commit_fences"],
        "dedup_rows_dropped": totals["dedup_rows_dropped"],
    }


def debug_snapshot() -> dict:
    """The `/debug/fleet` payload: every live scheduler's and
    autoscaler's snapshot, the commit-ledger rollup, and — when an obs
    runtime is registered (`trtpu worker`, tests) — per-worker
    heartbeat liveness ages from `get_operation_health`, so an
    operator sees a stale worker long before its lease expires."""
    from transferia_tpu_torch.stats import fleetobs

    with _registry_lock:
        scheds = list(_SCHEDULERS)
        scalers = list(_AUTOSCALERS)
    out = {
        "schedulers": [s.snapshot() for s in scheds],
        "autoscalers": [a.snapshot() for a in scalers],
        "commits": _commit_rollup(),
    }
    liveness = fleetobs.worker_liveness()
    if liveness is not None:
        out["workers"] = liveness
    return out
