"""The distributed fleet (the port's `fleet/distributed.py`,
`fleet/leader.py`, `fleet/worker.py`, the snapshot loader's preemption
and resume, and the MVCC compaction ticket) against the JAX package's,
on the CPU.

Every scenario runs through both packages on the same inputs, each on
its own coordinator of one kind (memory, or filestore in a tmp dir);
the port's workers run with `device="cpu"`.  Held equal, exactly: WDRR
pick sequences; the tickets and their states after submit, dedupe,
quota shed, revoke and `preempt_if_needed`; `LeaderLease` takeover on an
injected clock; the memory sinks of `sample_snapshot` tickets through
the README chain (mask + filter); a preemption fired at a fixed part
boundary (claim order, the resumed ticket, rows delivered once); and
the compaction ticket (its id, the dedupe on enqueue, the base it
installs).  Wall-clock fields of a ticket (`enqueued_at`,
`lease_expires_at`, `completed_at`) and the admission trace's ids are
left out of the comparison; no assertion reads a clock.  Workers exit
on `max_tickets` or a drain; `idle_exit_seconds` is only the backstop
that ends a worker whose queue has nothing left to claim.
"""

import importlib
import random
import time
from types import SimpleNamespace

import pytest

# a worker with nothing left to claim exits after this long
IDLE_S = 20.0

README_CHAIN = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s"}},
    {"filter_rows": {"filter": "age >= 21"}},
]}


def pkg(name: str, kind: str, root_dir) -> SimpleNamespace:
    root = "transferia_tpu" if name == "jax" else "transferia_tpu_torch"

    def m(path):
        return importlib.import_module(f"{root}.{path}")

    coord = m("coordinator")
    if kind == "memory":
        def new_cp(**kw):
            return coord.MemoryCoordinator(**kw)
    else:
        def new_cp(**kw):
            return coord.FileStoreCoordinator(
                root=str(root_dir / f"{name}-cp"), **kw)
    return SimpleNamespace(
        name=name, new_cp=new_cp, dist=m("fleet.distributed"),
        leader=m("fleet.leader"), worker=m("fleet.worker"),
        ticket=m("abstract.ticket"), errors=m("abstract.errors"),
        memory=m("providers.memory"), compact=m("mvcc.compact"),
        store=m("mvcc.store"),
        kw={"device": "cpu"} if name == "port" else {})


@pytest.fixture(params=["memory", "filestore"])
def both(request, tmp_path):
    def run(fn):
        got = fn(pkg("port", request.param, tmp_path))
        want = fn(pkg("jax", request.param, tmp_path))
        assert got == want
        return got
    return run


_CLOCK_FIELDS = ("enqueued_at", "lease_expires_at", "completed_at")


def state(tickets) -> list[dict]:
    """Tickets in queue order, without their wall-clock stamps and the
    admission trace's random ids."""
    out = []
    for t in tickets:
        d = {k: v for k, v in t.to_json().items() if k not in _CLOCK_FIELDS}
        d["payload"] = {k: v for k, v in d["payload"].items()
                        if not k.startswith("_")}
        out.append(d)
    return out


def noop(p, i, tenant="a", qos="batch", cost=1):
    return p.ticket.FleetTicket(ticket_id=f"t{i}", transfer_id=f"tr{i}",
                                tenant=tenant, qos=qos, cost=cost,
                                payload={"kind": "noop"})


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_wdrr_pick_sequences_equal_jax(seed, tmp_path):
    """Random pools (tenants, QoS classes, costs, weights) drained by
    the worker-side WDRR pick: the same sequence."""
    rng = random.Random(seed)
    specs = [(f"tn{rng.randrange(4)}",
              rng.choice(["interactive", "batch", "scavenger"]),
              rng.randrange(1, 4)) for _ in range(40)]
    weights = {f"tn{i}": float(rng.randrange(1, 4)) for i in range(4)}
    quantum = rng.choice([0.5, 1.0, 2.0])

    def run(p):
        picker = p.dist.WdrrPicker(weights, quantum)
        pool = []
        for i, (tn, qos, cost) in enumerate(specs):
            t = noop(p, i, tn, qos, cost)
            t.seq = i
            pool.append(t)
        order = []
        while pool:
            got = picker.pick(pool)
            picker.charge(got)
            order.append(got.ticket_id)
            pool.remove(got)
        return order, [p.dist.charged_cost(noop(p, 0, qos=q, cost=c))
                       for q in ("interactive", "batch", "scavenger",
                                 "bogus") for c in (1, 3)]

    got = run(pkg("port", "memory", tmp_path))
    assert got == run(pkg("jax", "memory", tmp_path))
    assert sorted(got[0]) == sorted(f"t{i}" for i in range(40))


def test_submit_dedupe_shed_failover_equal_jax(both):
    def run(p):
        cp = p.new_cp()
        a = p.dist.DistributedFleetScheduler(cp, queue="q", name="a",
                                             tenant_queue_quota=3)
        out = [a.submit(noop(p, i, tenant="a" if i < 5 else "b"))
               for i in range(7)]
        out.append(a.submit(noop(p, 0)))          # idempotent re-submit
        out += [list(a.admission_log), list(a.shed_log), a.counts(),
                a.desired_workers()]
        b = p.dist.DistributedFleetScheduler(cp, queue="q", name="b")
        out += [b.resume(), b.submit(noop(p, 1)), state(cp.list_tickets("q")),
                a.metrics.value("fleet_tickets_enqueued"),
                a.metrics.value("fleet_tickets_shed")]
        return out

    both(run)


def test_revoke_and_preempt_equal_jax(both):
    """Claims, a revoke, and `preempt_if_needed` picking its victim:
    lowest priority first, no preemption with a free lane or at the
    same rank."""
    def run(p):
        cp = p.new_cp()
        s = p.dist.DistributedFleetScheduler(cp, queue="q",
                                             capacity=lambda: 2)
        for i, qos in enumerate(["batch", "scavenger", "scavenger"]):
            s.submit(noop(p, i, qos=qos))
        out = [s.preempt_if_needed()]              # nothing claimed
        cp.claim_ticket("q", "t0", "w0")
        out.append(s.preempt_if_needed())          # a lane is free
        cp.claim_ticket("q", "t1", "w1")
        out.append(s.preempt_if_needed())          # same rank: none
        s.submit(noop(p, 10, qos="interactive"))
        out.append(s.preempt_if_needed())          # the scavenger goes
        out += [list(s.preempt_log), state(cp.list_tickets("q"))]
        revoked = cp.revoke_ticket("q", "t0")
        out.append(state([revoked]))
        out.append(cp.revoke_ticket("q", "t0"))    # nothing to preempt
        won = cp.claim_ticket("q", "t10", "w2")
        out.append(cp.complete_ticket("q", won))
        out.append(cp.complete_ticket("q", won))   # idempotent retry
        stale = p.ticket.FleetTicket.from_json(won.to_json())
        stale.claim_epoch -= 1
        out.append(cp.release_ticket("q", stale))  # fenced zombie
        s.tick()
        out += [state(cp.list_tickets("q")), s.counts()]
        return out

    got = both(run)
    assert got[3] == "t1"


def test_leader_lease_takeover_equal_jax(both, monkeypatch):
    """Two replicas on a clock the test moves: the first leads, the
    second stands by, takes over once the first's lease has expired,
    and the first demotes itself; a graceful release hands over at
    once."""
    clock = [1_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])

    def run(p):
        clock[0] = 1_000.0
        cp = p.new_cp(lease_seconds=5.0)
        a = p.leader.LeaderLease(cp, queue="q", replica_id="ra")
        b = p.leader.LeaderLease(cp, queue="q", replica_id="rb")
        out = [a.ensure(), b.ensure(), a.leader_id()]
        clock[0] += 3.0
        out += [a.ensure(), b.ensure()]           # a renews
        clock[0] += 6.0                           # a stops beating
        out += [b.ensure(), b.leader_id(), a.ensure(), a.is_leader()]
        b.release()
        out += [a.ensure(), a.leader_id(), b.ensure()]
        out.append(state(cp.list_tickets("q.leader")))
        return out

    got = both(run)
    assert got[:3] == [True, False, "ra"]


def wait_for(cond, limit_s: float = 30.0) -> None:
    deadline = time.monotonic() + limit_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def sample_ticket(p, i, tenant, qos, rows, parts=4, sink_prefix="tfd"):
    sink = f"{sink_prefix}-{i}"
    p.memory.get_store(sink).clear()
    return p.ticket.FleetTicket(
        ticket_id=f"t{i}", transfer_id=f"tr{i}", tenant=tenant, qos=qos,
        payload={"kind": "sample_snapshot", "rows": rows, "preset": "users",
                 "table": "users", "shard_parts": parts, "sink_id": sink,
                 "operation_id": f"op-tfd-{i}",
                 "transformation": README_CHAIN})


def sink_image(p, sink):
    """The sink's row values, sorted (rows are delivered part by part,
    in the order the worker ran them)."""
    store = p.memory.get_store(sink)
    rows = [tuple(v.item() if hasattr(v, "item") else v
                  for v in it.column_values) for it in store.rows()]
    return sorted(rows, key=repr)


def test_worker_runs_sample_tickets_equal_jax(both):
    """One worker drains five `sample_snapshot` tickets of three tenants
    through the README chain: the same claim order, the same ticket
    states and the same sink rows."""
    mix = [("a", "batch"), ("b", "scavenger"), ("a", "interactive"),
           ("c", "batch"), ("b", "batch")]

    def run(p):
        cp = p.new_cp()
        s = p.dist.DistributedFleetScheduler(cp, queue="q")
        for i, (tenant, qos) in enumerate(mix):
            s.submit(sample_ticket(p, i, tenant, qos, rows=600 + 100 * i))
        w = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                 max_tickets=len(mix),
                                 heartbeat_interval=0.05, idle_exit_seconds=IDLE_S, **p.kw)
        w.run()
        out = [list(w.claim_log), w.tickets_run,
               state(cp.list_tickets("q"))]
        out += [sink_image(p, f"tfd-{i}") for i in range(len(mix))]
        for i in range(len(mix)):
            p.memory.get_store(f"tfd-{i}").clear()
        return out

    got = both(run)
    assert all(t["state"] == "done" for t in got[2])
    assert all(got[3:]) and len(got[3]) < 600


def test_preemption_at_a_fixed_part_equal_jax(both):
    """A BATCH ticket revoked at its third part boundary by an
    INTERACTIVE arrival: the arrival runs first, the BATCH ticket
    resumes from its committed parts, and every row lands once."""
    def run(p):
        cp = p.new_cp(lease_seconds=30)
        s = p.dist.DistributedFleetScheduler(cp, queue="q",
                                             capacity=lambda: 1)
        s.submit(sample_ticket(p, 0, "a", "batch", rows=2_000, parts=6,
                               sink_prefix="pre"))
        fired = []
        holder = {}

        def hook(ticket, boundary):
            if ticket.ticket_id == "t0" and boundary == 3 and not fired:
                fired.append(boundary)
                s.submit(sample_ticket(p, 1, "b", "interactive", rows=500,
                                       sink_prefix="pre"))
                s.preempt_if_needed()
                # the worker learns of the revoke from its heartbeat's
                # renewal; hold the boundary until it has, so the yield
                # lands at this boundary in both packages
                wait_for(lambda: holder["w"]._revoked)

        w = holder["w"] = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                 max_tickets=2, part_boundary_hook=hook,
                                 heartbeat_interval=0.05, idle_exit_seconds=IDLE_S, **p.kw)
        w.run()
        parts = sorted((pt.key(), pt.completed, pt.assignment_epoch)
                       for pt in cp.operation_parts("op-tfd-0"))
        out = [list(w.claim_log), list(s.preempt_log),
               state(cp.list_tickets("q")), parts,
               w.metrics.value("fleet_preempt_yields"),
               sink_image(p, "pre-0"),
               sink_image(p, "pre-1")]
        for i in range(2):
            p.memory.get_store(f"pre-{i}").clear()
        return out

    got = both(run)
    assert [c[0] for c in got[0]] == ["t0", "t1", "t0"]
    tickets = {t["ticket_id"]: t for t in got[2]}
    assert tickets["t0"]["preemptions"] == 1
    assert tickets["t0"]["state"] == tickets["t1"]["state"] == "done"
    rows = got[5]
    assert len(rows) == len(set(rows)) > 0      # each row once


def test_drain_yields_and_releases_equal_jax(both):
    """A drain requested at a fixed part boundary: the ticket goes back
    to the queue with its committed parts, and a second worker finishes
    it from there."""
    def run(p):
        cp = p.new_cp(lease_seconds=30)
        s = p.dist.DistributedFleetScheduler(cp, queue="q")
        s.submit(sample_ticket(p, 0, "a", "batch", rows=1_500, parts=5,
                               sink_prefix="drn"))
        holder = {}

        def hook(ticket, boundary):
            if boundary == 2:
                holder["w"].request_drain()

        w0 = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                  part_boundary_hook=hook,
                                  heartbeat_interval=0.05, idle_exit_seconds=IDLE_S, **p.kw)
        holder["w"] = w0
        w0.run()
        mid = state(cp.list_tickets("q"))
        done_mid = sum(pt.completed for pt in cp.operation_parts("op-tfd-0"))
        w1 = p.worker.FleetWorker(cp, queue="q", worker_index=1,
                                  max_tickets=1, heartbeat_interval=0.05, idle_exit_seconds=IDLE_S,
                                  **p.kw)
        w1.run()
        out = [mid, done_mid, list(w1.claim_log),
               state(cp.list_tickets("q")), sink_image(p, "drn-0")]
        p.memory.get_store("drn-0").clear()
        return out

    got = both(run)
    assert got[0][0]["state"] == "queued" and got[1] == 1
    assert len(got[4]) == len(set(got[4]))


def test_ticket_retry_and_resume_flags_equal_jax(both):
    """A runner that fails, yields and succeeds: the same attempts,
    failures, resume flags and final states (yields do not burn the
    retry budget)."""
    def run(p):
        cp = p.new_cp()
        for i in range(2):
            cp.enqueue_ticket("q", noop(p, i))
        seen = []

        def script(t, ctx):
            seen.append((t.ticket_id, t.attempts, t.failures, ctx.resume))
            n = len(seen)
            if n in (1, 2):
                raise p.errors.TransferPreemptedError("yield")
            if n == 3:
                raise ConnectionError("one transient blip")
            if t.ticket_id == "t1":
                raise ValueError("always")

        w = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                 runners={"noop": script}, max_attempts=2,
                                 heartbeat_interval=0.05,
                                 idle_exit_seconds=0.5, **p.kw)
        w.run()
        return seen, state(cp.list_tickets("q"))

    got = both(run)
    assert [t["state"] for t in got[1]] == ["done", "failed"]


def test_compaction_ticket_equal_jax(both, monkeypatch):
    """An MVCC store with three delta layers: the same deterministic
    ticket id for (scope, table, watermark), a second enqueue deduped,
    and a fleet worker running the ticket installs the same compacted
    base (the merged read unchanged)."""
    from tests.test_torch_mvcc import PKG as MVCC
    from tests.test_torch_mvcc import TABLE, image, layered

    monkeypatch.setenv("TRANSFERIA_TPU_MVCC_SPILL", "0")
    monkeypatch.setenv("TRANSFERIA_TPU_MVCC_COMPACT_MIN_LAYERS", "3")

    def run(p):
        m = MVCC[p.name]
        cp = p.new_cp()
        st = layered(m)
        p.store.register_store(st)
        before = image(st.read_at(TABLE))
        t1 = p.compact.enqueue_compaction(cp, "q", st, TABLE, "tr-x")
        t2 = p.compact.enqueue_compaction(cp, "q", st, TABLE, "tr-x")
        w = p.worker.FleetWorker(cp, queue="q", worker_index=0,
                                 max_tickets=1, heartbeat_interval=0.05, idle_exit_seconds=IDLE_S,
                                 **p.kw)
        w.run()
        after = image(st.read_at(TABLE))
        assert after == before
        out = [state([t1]), state([t2]), state(cp.list_tickets("q")),
               st.layer_count(TABLE), after,
               p.compact.enqueue_compaction(cp, "q", st, TABLE)]
        p.store.unregister_store(st.scope)
        return out

    got = both(run)
    assert got[0][0]["ticket_id"] == f"mvcc-compact/mvcc/test/{'s.t'}@120"
    assert got[2][0]["state"] == "done" and got[3] == 0
