"""`trtpu fleet bench`: the scheduler under load (the port's copy of
``transferia_tpu/fleet/bench.py``).

Drives 100+ concurrent sample->memory snapshot transfers through
FleetScheduler with a deliberately skewed tenant mix (one tenant
submits ~10x the others) and reports:

- p50/p99 scheduler dispatch latency (admission -> dispatch decision)
  plus the raw pick overhead (time inside the DRR decision);
- the Jain fairness index over weighted per-tenant service during the
  contention window (the dispatch prefix in which EVERY tenant still
  has queued work — after a light tenant drains, the heavy tenant
  rightfully takes the slack, so post-drain service is excluded);
- delivery invariants: every transfer completes, every target store
  holds exactly the expected rows, no transfer is lost, shed without
  reason, or double-admitted.

Each transfer runs the REAL engine (SnapshotLoader against one shared
MemoryCoordinator, so 100+ operations hammer the per-operation part
locks concurrently) — the scheduler never shortcuts the data path.
The transfers run on `device` (None means CUDA; "cpu" the plain
versions).
"""

from __future__ import annotations

import logging
import random
import time

from transferia_tpu_torch.coordinator.memory import MemoryCoordinator
from transferia_tpu_torch.fleet.scheduler import (
    FleetScheduler,
    FleetTransfer,
    QosClass,
    percentile,
)
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import hdr, watermark
from transferia_tpu_torch.stats.registry import Metrics

logger = logging.getLogger(__name__)

# submission skew: tenant-a floods, the rest trickle (10:1); weights
# are EQUAL, so fair share during contention is equal service — which
# is exactly what the Jain index then measures.  Every bench ticket is
# BATCH class: uniform deficit charge keeps the fairness signal clean
# (QoS priority effects are pinned by tests/test_torch_fleet.py).
TENANT_SKEW = {"tenant-a": 10, "tenant-b": 1, "tenant-c": 1,
               "tenant-d": 1}


def tenant_mix(transfers: int, seed: int) -> list[tuple[str, QosClass]]:
    """Deterministic (tenant, qos) assignment for `transfers` tickets:
    counts proportional to TENANT_SKEW (light tenants floored at 4 so
    the contention window has statistics even at smoke sizes), order
    seed-shuffled (the same seed + mix must yield the identical
    admission order — pinned by tests/test_torch_fleet.py)."""
    total_share = sum(TENANT_SKEW.values())
    out: list[tuple[str, QosClass]] = []
    counts: dict[str, int] = {}
    for name, share in sorted(TENANT_SKEW.items()):
        counts[name] = max(4, (transfers * share) // total_share)
    # pad/trim to the exact requested count, heavy tenant absorbs
    heavy = max(TENANT_SKEW, key=lambda k: TENANT_SKEW[k])
    counts[heavy] = max(4, counts[heavy]
                        + transfers - sum(counts.values()))
    for name in sorted(counts):
        for _ in range(counts[name]):
            out.append((name, QosClass.BATCH))
    random.Random(seed).shuffle(out)
    return out


def _bench_transfer(idx: int, rows: int, sink_id: str) -> Transfer:
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.sample import SampleSourceParams

    t = Transfer(
        id=f"fleet-t{idx:04d}",
        type=TransferType.SNAPSHOT_ONLY,
        src=SampleSourceParams(preset="iot", table="events", rows=rows,
                               batch_rows=max(64, rows)),
        dst=MemoryTargetParams(sink_id=sink_id),
    )
    t.runtime.sharding.process_count = 1
    return t


def jain_index(shares: list[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly proportional shares."""
    if not shares:
        return 1.0
    s = sum(shares)
    sq = sum(x * x for x in shares)
    if sq <= 0:
        return 1.0
    return (s * s) / (len(shares) * sq)


def contention_fairness(sched: FleetScheduler,
                        tickets: dict[str, FleetTransfer]) -> float:
    """Jain over weighted per-tenant service across the dispatch
    prefix where every tenant still had undispatched tickets."""
    remaining: dict[str, int] = {}
    for t in tickets.values():
        remaining[t.tenant] = remaining.get(t.tenant, 0) + 1
    service: dict[str, float] = {name: 0.0 for name in remaining}
    weights = {name: sched._tenants[name].weight
               for name in remaining if name in sched._tenants}
    seen: set[str] = set()
    for tid in sched.dispatch_log:
        if any(v <= 0 for v in remaining.values()):
            break
        t = tickets.get(tid)
        if t is None:
            continue
        service[t.tenant] += t.charged_cost
        if tid not in seen:  # rebalance re-dispatches don't drain
            seen.add(tid)
            remaining[t.tenant] -= 1
    shares = [service[name] / max(weights.get(name, 1.0), 1e-9)
              for name in sorted(service)]
    return jain_index(shares)


def run_fleet_bench(transfers: int = 120, workers: int = 8,
                    lanes: int = 2, rows: int = 256,
                    seed: int = 7, device: DeviceLike = None) -> dict:
    from transferia_tpu_torch.providers.memory import get_store

    device = resolve_device(device)

    mix = tenant_mix(transfers, seed)
    transfers = len(mix)  # light-tenant floors can round up tiny runs
    cp = MemoryCoordinator()
    metrics = Metrics()
    # backpressure=True: the controller shares the scheduler's metrics
    # registry, so the fleet_queue_depth signal is live (the lax
    # default watermark of 4096 never trips at bench sizes — the wiring
    # is what this exercises, not a shed)
    sched = FleetScheduler(workers=workers,
                           max_inflight_per_worker=lanes,
                           tenant_queue_quota=max(transfers, 1024),
                           backpressure=True,
                           metrics=metrics, name="fleet-bench")
    tickets: dict[str, FleetTransfer] = {}
    sink_ids: dict[str, str] = {}
    for i, (tenant, qos) in enumerate(mix):
        sink_id = f"fleet-bench-{i:04d}"
        get_store(sink_id).clear()
        transfer = _bench_transfer(i, rows, sink_id)

        def run(t=transfer):
            from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

            SnapshotLoader(t, cp, metrics=Metrics(),
                           device=device).upload_tables()

        ticket = FleetTransfer(transfer_id=transfer.id, tenant=tenant,
                               run=run, qos=qos)
        tickets[ticket.transfer_id] = ticket
        sink_ids[ticket.transfer_id] = sink_id
    # pre-load the queue, THEN start the workers: fairness is a
    # property of the scheduler's picks under contention, and a cold
    # pool draining tickets in arrival order before the backlog forms
    # would measure submission timing instead
    for tid in sorted(tickets):
        decision = sched.submit(tickets[tid])
        if decision != "admitted":
            logger.error("fleet bench: %s not admitted: %s",
                         tid, decision)
    # baseline for the mergeable dispatch-latency histogram
    # (stats/hdr.py): the registry is process-global, so the bench
    # carves its own window out of it with a bucket-wise diff
    h0 = hdr.STAGES.get("fleet_dispatch")
    l0 = hdr.STAGES.get(watermark.STAGE_LAG)
    t0 = time.perf_counter()
    sched.start()
    try:
        drained = sched.drain(timeout=600.0)
        wall = time.perf_counter() - t0
    finally:
        sched.shutdown()
    hwin = hdr.STAGES.get("fleet_dispatch").diff(h0)
    hdr_summary = hwin.summary()
    lag_summary = hdr.STAGES.get(watermark.STAGE_LAG).diff(l0).summary()

    # -- delivery audit ------------------------------------------------------
    lost: list[str] = []
    bad_rows: list[str] = []
    for tid, t in tickets.items():
        if t.state != "done":
            lost.append(f"{tid}:{t.state}")
            continue
        got = get_store(sink_ids[tid]).row_count()
        if got != rows:
            bad_rows.append(f"{tid}:{got}/{rows}")
    for sink_id in sink_ids.values():
        get_store(sink_id).clear()

    lats_ms = [v * 1000.0 for v in sched.dispatch_latencies]
    picks_us = [v * 1e6 for v in sched.pick_seconds if v > 0]
    fairness = contention_fairness(sched, tickets)
    counts = sched.counts()
    ok = (drained and not lost and not bad_rows
          and not sched.double_admissions and fairness >= 0.9)
    return {
        "metric": "fleet_transfers_per_sec",
        "unit": "transfers/sec",
        "value": round(transfers / max(wall, 1e-9), 1),
        "ok": ok,
        "transfers": transfers,
        "workers": workers,
        "lanes_per_worker": lanes,
        "rows_per_transfer": rows,
        "seed": seed,
        "wall_seconds": round(wall, 3),
        "completed": counts.get("done", 0),
        "failed": counts.get("failed", 0),
        "shed": counts.get("shed", 0),
        "lost": lost,
        "row_mismatches": bad_rows,
        "double_admissions": len(sched.double_admissions),
        "jain_fairness": round(fairness, 4),
        "dispatch_p50_ms": round(percentile(lats_ms, 0.50), 3),
        "dispatch_p99_ms": round(percentile(lats_ms, 0.99), 3),
        # the mergeable-histogram view of the same tail (stats/hdr.py
        # — what the fleet obs segments export and the panes merge):
        # p999 exists only here, scalar percentiles stop at p99
        "dispatch_hdr_p50_ms": hdr_summary["p50_ms"],
        "dispatch_hdr_p99_ms": hdr_summary["p99_ms"],
        "dispatch_hdr_p999_ms": hdr_summary["p999_ms"],
        "dispatch_hdr_count": hdr_summary["count"],
        "dispatch_hdr_max_trace": hdr_summary["max_trace"],
        # end-to-end freshness tail over the same run window: sample
        # batches carry event time, the sink-side Statistician feeds
        # publish lag into the mergeable replication_lag histogram
        "replication_lag_p99_ms": lag_summary["p99_ms"],
        "replication_lag_count": lag_summary["count"],
        "pick_p50_us": round(percentile(picks_us, 0.50), 1),
        "pick_p99_us": round(percentile(picks_us, 0.99), 1),
        "desired_workers_final": sched.desired_workers(),
        "tenants": {
            name: TENANT_SKEW[name] for name in sorted(TENANT_SKEW)
        },
    }


def format_report(report: dict) -> str:
    lines = [
        f"fleet bench: {report['transfers']} transfers x "
        f"{report['rows_per_transfer']} rows over "
        f"{report['workers']}x{report['lanes_per_worker']} worker "
        f"lanes in {report['wall_seconds']}s "
        f"({report['value']} transfers/s)",
        f"  dispatch latency p50={report['dispatch_p50_ms']}ms "
        f"p99={report['dispatch_p99_ms']}ms  (pick overhead "
        f"p50={report['pick_p50_us']}us p99={report['pick_p99_us']}us)",
        f"  dispatch hdr (mergeable): "
        f"p50={report['dispatch_hdr_p50_ms']}ms "
        f"p99={report['dispatch_hdr_p99_ms']}ms "
        f"p999={report['dispatch_hdr_p999_ms']}ms "
        f"n={report['dispatch_hdr_count']}",
        f"  replication lag (mergeable): "
        f"p99={report['replication_lag_p99_ms']}ms "
        f"n={report['replication_lag_count']}",
        f"  jain fairness (contention window, skew 10:1): "
        f"{report['jain_fairness']}",
        f"  completed={report['completed']} failed={report['failed']} "
        f"shed={report['shed']} double_admitted="
        f"{report['double_admissions']}",
    ]
    if report["lost"]:
        lines.append(f"  LOST: {report['lost']}")
    if report["row_mismatches"]:
        lines.append(f"  ROW MISMATCHES: {report['row_mismatches']}")
    lines.append("fleet bench verdict: "
                 + ("PASS" if report["ok"] else "FAIL"))
    return "\n".join(lines)
