"""The in-process fleet control plane (the port's `fleet/scheduler.py`,
`fleet/backpressure.py`, `fleet/autoscaler.py` and `fleet/bench.py`)
against the JAX package's, on the CPU.

Each scenario runs through both packages on equal inputs: the tenant
mixes of `fleet/bench.py::tenant_mix` for several seeds, fixed gauge
series, fixed demand series.  Held equal, exactly: admission decisions
and shed reasons, the dispatch order (a pure function of the queue's
content: every decision is made under the scheduler's lock in a fixed
tenant rotation), the rebalance after a `WorkerKilledError`, the Jain
index over the contention window, `desired_workers`, the backpressure
latches and the autoscaler's actions.  No assertion reads a wall clock:
threads are joined through `drain` with an explicit limit.
"""

import importlib
from types import SimpleNamespace

import pytest

JOIN_S = 60.0


def pkg(name: str) -> SimpleNamespace:
    """The modules a scenario needs, from the JAX package ("jax") or the
    port ("port")."""
    root = "transferia_tpu" if name == "jax" else "transferia_tpu_torch"

    def m(path):
        return importlib.import_module(f"{root}.{path}")

    return SimpleNamespace(
        name=name, sched=m("fleet.scheduler"), bp=m("fleet.backpressure"),
        bench=m("fleet.bench"), dist=m("fleet.distributed"),
        scaler=m("fleet.autoscaler"), fleet=m("fleet"),
        failpoints=m("chaos.failpoints"), registry=m("stats.registry"),
        memory=m("coordinator.memory"), ticket=m("abstract.ticket"),
        kw={"device": "cpu"} if name == "port" else {})


def both(fn):
    got = fn(pkg("port"))
    want = fn(pkg("jax"))
    assert got == want
    return got


def _ticket(p, i, tenant, qos="batch", run=None, cost=1):
    return p.sched.FleetTransfer(
        transfer_id=f"t{i:03d}", tenant=tenant, qos=p.sched.QosClass(qos),
        cost=cost, run=run if run is not None else (lambda: None))


def _run(sched):
    sched.start()
    try:
        assert sched.drain(timeout=JOIN_S), "fleet did not drain"
    finally:
        sched.shutdown()


@pytest.mark.parametrize("seed", [1, 7, 11, 23])
@pytest.mark.parametrize("n", [16, 40, 120])
def test_tenant_mix_equals_jax(seed, n):
    both(lambda p: [(t, q.value) for t, q in p.bench.tenant_mix(n, seed)])


@pytest.mark.parametrize("seed,n,workers,lanes", [
    (7, 40, 3, 1), (11, 40, 2, 2), (3, 64, 4, 2), (23, 24, 1, 1)])
def test_dispatch_order_and_fairness_equal_jax(seed, n, workers, lanes):
    """The mix of `tenant_mix` through the scheduler: the same
    admissions, the same desired_workers before the start, the same
    dispatch order and the same Jain index over the contention window."""
    def run(p):
        sched = p.sched.FleetScheduler(
            workers=workers, max_inflight_per_worker=lanes,
            metrics=p.registry.Metrics(), name="test")
        tickets = {}
        decisions = []
        for i, (tenant, qos) in enumerate(p.bench.tenant_mix(n, seed)):
            t = _ticket(p, i, tenant, qos.value)
            tickets[t.transfer_id] = t
            decisions.append(sched.submit(t))
        desired = sched.desired_workers()
        _run(sched)
        return (decisions, desired, list(sched.dispatch_log),
                p.bench.contention_fairness(sched, tickets),
                sched.counts(), sched.desired_workers(),
                [(tid, sched._tickets[tid].charged_cost)
                 for tid in sorted(sched._tickets)])

    got = both(run)
    assert len(got[2]) == len(got[0])


def test_qos_and_weights_equal_jax():
    """QoS classes within a tenant and 3:1 weights across tenants."""
    def run(p):
        sched = p.sched.FleetScheduler(
            workers=1, max_inflight_per_worker=1,
            tenant_weights={"gold": 3.0, "bronze": 1.0},
            metrics=p.registry.Metrics(), name="test")
        qos = ["scavenger", "interactive", "batch"]
        for i in range(36):
            sched.submit(_ticket(p, i, "gold" if i % 2 else "bronze",
                                 qos[i % 3], cost=1 + i % 2))
        _run(sched)
        return list(sched.dispatch_log), sched.snapshot()["tenants"]

    both(run)


def test_shed_reasons_equal_jax():
    """Tenant quota and backpressure sheds, with the gauge series
    crossing the high and low watermarks."""
    def run(p):
        gauges = {"decode_readahead_inflight_bytes": 0.0}
        bp = p.bp.BackpressureController(
            signals=(p.bp.SignalSpec("ra", "decode_readahead_inflight_bytes",
                                     high=100.0, low=50.0),),
            probe=lambda name: gauges.get(name, 0.0))
        sched = p.sched.FleetScheduler(
            workers=1, tenant_queue_quota=3, backpressure=bp,
            metrics=p.registry.Metrics(), name="test")
        out = []
        series = [0, 0, 150, 75, 10, 10, 10, 10, 99, 101, 51, 49]
        for i, g in enumerate(series):
            gauges["decode_readahead_inflight_bytes"] = float(g)
            out.append(sched.submit(_ticket(p, i, f"t{i % 2}")))
        out.append(sched.counts())
        _run(sched)
        out += [sched.counts(), list(sched.dispatch_log),
                sched.metrics.value("fleet_shed"),
                sched.metrics.value("fleet_admitted")]
        return out

    got = both(run)
    assert "shed-backpressure" in got and "shed-tenant-quota" in got


@pytest.mark.parametrize("spec,n,workers", [
    ("fleet.dispatch=after:2,times:1,raise:WorkerKilledError", 8, 2),
    ("fleet.dispatch=after:0,times:1,raise:WorkerKilledError", 4, 1),
    ("fleet.dispatch=after:1,times:1,raise:WorkerKilledError;"
     "fleet.rebalance=after:0,times:1,raise:ChaosInjectedError", 6, 2),
])
def test_kill_rebalance_equals_jax(spec, n, workers):
    """A WorkerKilledError at a fixed dispatch: the same victim ticket,
    the same rebalance, the same dispatch order after it, nothing lost
    and nothing double-admitted.  (Which lane thread held the fatal
    dispatch is the OS's choice: the kill and rebalance logs are
    compared without the worker index.)"""
    def run(p):
        ran = []
        with p.failpoints.active(spec, seed=1):
            sched = p.sched.FleetScheduler(
                workers=workers, max_inflight_per_worker=1,
                metrics=p.registry.Metrics(), name="test")
            for i in range(n):
                sched.submit(_ticket(p, i, f"t{i % 2}",
                                     run=lambda i=i: ran.append(i)))
            _run(sched)
        return (list(sched.dispatch_log),
                [tid for _, tid in sched.kill_log],
                [(tid, attempts) for tid, _, attempts
                 in sched.rebalance_log],
                sched.counts(), sched.double_admissions, sorted(ran),
                sched.metrics.value("fleet_worker_deaths"),
                sched.metrics.value("fleet_rebalanced"),
                sched.live_workers())

    got = both(run)
    assert got[3]["done"] == n and len(got[1]) == 1


def test_failing_ticket_retries_equal_jax():
    def run(p):
        attempts = []

        def boom():
            attempts.append(1)
            raise ValueError("nope")

        sched = p.sched.FleetScheduler(
            workers=1, max_inflight_per_worker=1,
            metrics=p.registry.Metrics(), max_attempts=3, name="test")
        sched.submit(_ticket(p, 0, "t", run=boom))
        sched.submit(_ticket(p, 1, "t"))
        _run(sched)
        return (sched.counts(), len(attempts), list(sched.dispatch_log),
                sched.metrics.value("fleet_failed"))

    both(run)


@pytest.mark.parametrize("pending,workers,lanes", [
    (0, 2, 2), (12, 2, 2), (7, 3, 1), (33, 4, 4)])
def test_desired_workers_equal_jax(pending, workers, lanes):
    def run(p):
        sched = p.sched.FleetScheduler(
            workers=workers, max_inflight_per_worker=lanes,
            metrics=p.registry.Metrics(), name="test")
        for i in range(pending):
            sched.submit(_ticket(p, i, f"t{i % 3}"))
        snap = sched.snapshot()
        return (sched.desired_workers(), snap["desired_workers"],
                {k: v["queued"] for k, v in snap["tenants"].items()})

    both(run)


def test_backpressure_hysteresis_equals_jax():
    """A fixed gauge series through three signals (one inverted and
    gated on activity): the same latch decision at every step."""
    series = [
        (0, 0.0, 0, 0), (120, 0.0, 0, 0), (80, 0.0, 0, 0), (40, 0.0, 0, 0),
        (40, 1.0, 5000, 0), (40, 1.2, 5000, 0), (40, 2.0, 5000, 0),
        (0, 2.0, 5000, 900), (0, 2.0, 5000, 500), (0, 2.0, 5000, 100),
        (200, 1.0, 5000, 900), (10, 3.0, 5000, 10), (0, 0.5, 10, 0)]

    def run(p):
        gauges = {}
        bp = p.bp.BackpressureController(
            signals=(
                p.bp.SignalSpec("ra", "decode_readahead_inflight_bytes",
                                high=100.0, low=50.0),
                p.bp.SignalSpec("ratio", "dispatch_compression_ratio",
                                high=1.05, low=1.5, inverted=True,
                                activity_metric="h2d_encoded_bytes",
                                min_activity=1000.0),
                p.bp.SignalSpec("sink", "sinker_inflight_rows",
                                high=800.0, low=200.0)),
            probe=lambda name: gauges.get(name, 0.0))
        out = []
        for ra, ratio, act, sink in series:
            gauges.update({"decode_readahead_inflight_bytes": float(ra),
                           "dispatch_compression_ratio": ratio,
                           "h2d_encoded_bytes": float(act),
                           "sinker_inflight_rows": float(sink)})
            out.append((bp.overloaded(), bp.latched_signals()))
        bp.latch_external("slo", "burn")
        out.append((bp.overloaded(), bp.latched_signals()))
        bp.clear_external("slo")
        out.append((bp.overloaded(), bp.latched_signals()))
        snap = bp.snapshot()
        out.append(sorted(snap))
        return out

    got = both(run)
    assert any(o for o, _ in got[:-1]) and not all(o for o, _ in got[:-1])


class _FakeSupervisor:
    def __init__(self, live):
        self.live = live
        self.actions = []

    def reap(self):
        return 0

    def live_workers(self):
        return self.live

    def draining_workers(self):
        return 0

    def scale_to(self, n):
        self.actions.append(("scale_to", n))
        self.live = n

    def retire_one(self):
        self.actions.append(("retire", self.live - 1))
        self.live -= 1
        return self.live


def test_autoscaler_steps_equal_jax():
    """The real distributed scheduler over a memory queue whose demand
    follows a fixed series (tickets enqueued, then claimed and completed
    out of band), stepped by the autoscaler: the same target and action
    at every step."""
    demand = [0, 3, 3, 3, 1, 1, 1, 1, 1, 1, 9, 9, 0, 0, 0, 0, 0, 0, 0]

    def run(p):
        cp = p.memory.MemoryCoordinator()
        sched = p.dist.DistributedFleetScheduler(cp, queue="q",
                                                 capacity=lambda: 1)
        sup = _FakeSupervisor(live=1)
        scaler = p.scaler.FleetAutoscaler(
            sched, sup, min_workers=1, max_workers=4, scale_up_after=2,
            scale_down_after=3)
        seq = [0]
        out = []
        for want in demand:
            queued = [t for t in cp.list_tickets("q") if t.state == "queued"]
            for t in queued[want:]:
                won = cp.claim_ticket("q", t.ticket_id, "w0")
                cp.complete_ticket("q", won)
            for _ in range(max(0, want - len(queued))):
                sched.submit(p.ticket.FleetTicket(
                    ticket_id=f"t{seq[0]}", tenant="a",
                    payload={"kind": "noop"}))
                seq[0] += 1
            rec = scaler.step()
            out.append((rec["action"], scaler.target(), sup.live))
        snap = scaler.snapshot()
        out.append((sup.actions, snap["scale_ups"], snap["scale_downs"],
                    snap["steps"]))
        return out

    got = both(run)
    assert any(a.startswith("up") for a, _, _ in got[:-1])
    assert any(a.startswith("down") for a, _, _ in got[:-1])


def test_fleet_bench_report_equals_jax():
    """`run_fleet_bench` at a small shape: every field of the report but
    the timings and the lag histogram's count equal; the delivery audit
    clean and Jain >= 0.9."""
    timing = ("value", "wall_seconds", "dispatch_p50_ms", "dispatch_p99_ms",
              "dispatch_hdr_p50_ms", "dispatch_hdr_p99_ms",
              "dispatch_hdr_p999_ms", "dispatch_hdr_max_trace",
              "replication_lag_p99_ms", "pick_p50_us", "pick_p99_us",
              # a process-wide histogram's window: another test's thread
              # may publish into it
              "replication_lag_count")

    def run(p):
        report = p.bench.run_fleet_bench(transfers=24, workers=4, lanes=2,
                                         rows=64, seed=7, **p.kw)
        return {k: v for k, v in report.items() if k not in timing}

    got = both(run)
    assert got["ok"] and got["completed"] == 24 and not got["lost"]
    assert got["jain_fairness"] >= 0.9


def test_debug_snapshot_equals_jax():
    """`/debug/fleet`'s payload for one registered scheduler: the same
    keys, queue state and commit rollup shape."""
    def run(p):
        sched = p.sched.FleetScheduler(workers=1, metrics=p.registry.Metrics(),
                                       name="debug-test")
        for i in range(3):
            sched.submit(_ticket(p, i, "t"))
        snap = p.fleet.debug_snapshot()
        mine = [s for s in snap["schedulers"] if s.get("name") == "debug-test"]
        _run(sched)
        after = [s for s in p.fleet.debug_snapshot()["schedulers"]
                 if s.get("name") == "debug-test"]
        strip = ("dispatch_p50_ms", "dispatch_p99_ms", "pick_p99_us",
                 "pick_p50_us")
        return (sorted(snap), sorted(snap["commits"]),
                [{k: v for k, v in s.items() if k not in strip}
                 for s in mine], len(after))

    both(run)
