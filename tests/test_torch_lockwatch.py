"""The port's lock-order sentinel (`transferia_tpu_torch/runtime/
lockwatch.py`) against the JAX package's `runtime/lockwatch.py`.

The JAX package's lockwatch cases run on both packages (`pkg`): arming
(a disarmed `named_lock` is the plain primitive; the armed watch patches
`time.sleep` and disarming restores it), inversion detection over
one- and two-thread schedules, the learned order DAG, reentrant locks,
long holds, blocking calls under a lock, `threading.Condition` over a
watched lock, and the metric fold.  The parity case runs one schedule
of acquisitions through each package and compares the findings: the
same kinds, locks, orders and sites.

Both packages patch `time.sleep` while armed: a test arms one package
at a time and disarms it in `finally` (the `watch` fixture), so the two
patches never stack.
"""

import threading
import time

import pytest

from transferia_tpu.runtime import lockwatch as ref_lockwatch
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu_torch.runtime import lockwatch as port_lockwatch
from transferia_tpu_torch.stats.registry import Metrics

LW = {"jax": ref_lockwatch, "torch": port_lockwatch}
METRICS = {"jax": RefMetrics, "torch": Metrics}
REAL_SLEEP = time.sleep


@pytest.fixture(autouse=True)
def disarmed():
    for lw in LW.values():
        lw.disarm()
    assert time.sleep is REAL_SLEEP
    yield
    for lw in LW.values():
        lw.disarm()
    assert time.sleep is REAL_SLEEP


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return request.param


@pytest.fixture
def watch(pkg):
    lw = LW[pkg]
    w = lw.arm()
    try:
        yield lw, w
    finally:
        lw.disarm()


# -- arming -------------------------------------------------------------------

def test_disarmed_named_lock_is_plain_primitive(pkg, monkeypatch):
    lw = LW[pkg]
    monkeypatch.delenv(lw.ENV_LOCKWATCH, raising=False)
    lk = lw.named_lock("t.plain")
    assert not isinstance(lk, lw.WatchedLock)
    assert not isinstance(lw.named_lock("t.r", kind="rlock"),
                          lw.WatchedLock)
    with lk:
        pass


def test_env_knob_arms_on_first_lock(pkg, monkeypatch):
    lw = LW[pkg]
    monkeypatch.setenv(lw.ENV_LOCKWATCH, "1")
    try:
        assert isinstance(lw.named_lock("t.env"), lw.WatchedLock)
        assert lw.is_armed()
    finally:
        lw.disarm()


def test_armed_lock_falls_back_to_delegation_after_disarm(watch):
    lw, w = watch
    lk = lw.named_lock("t.fallback")
    lw.disarm()
    with lk:
        pass
    assert w.counters()["acquisitions"] == 0


def test_disarm_restores_time_sleep(pkg):
    lw = LW[pkg]
    try:
        lw.arm()
        assert time.sleep is not REAL_SLEEP
    finally:
        lw.disarm()
    assert time.sleep is REAL_SLEEP


# -- inversions ---------------------------------------------------------------

def test_single_thread_abba_inversion(watch):
    lw, w = watch
    a, b = lw.named_lock("t.a"), lw.named_lock("t.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert w.counters()["inversions"] == 1
    (inv,) = w.inversions()
    assert inv["locks"] == ["t.a", "t.b"]
    assert inv["first"]["order"] == ["t.a", "t.b"]
    assert inv["second"]["order"] == ["t.b", "t.a"]
    assert inv["second"]["acquire_site"].startswith(
        "test_torch_lockwatch.py:")
    assert inv["stack"]


def test_two_thread_schedule_inversion(watch):
    lw, w = watch
    a, b = lw.named_lock("t2.a"), lw.named_lock("t2.b")

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    for fn in (fwd, rev):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        t.join()
    assert w.counters()["inversions"] == 1
    assert w.inversions()[0]["locks"] == ["t2.a", "t2.b"]


def test_inversion_deduplicated_and_consistent_order_clean(watch):
    lw, w = watch
    a, b = lw.named_lock("t3.a"), lw.named_lock("t3.b")
    c, d = lw.named_lock("t4.c"), lw.named_lock("t4.d")
    with a:
        with b:
            pass
    for _ in range(3):
        with b:
            with a:
                pass
    for _ in range(10):
        with c:
            with d:
                pass
    assert w.counters()["inversions"] == 1
    assert len(w.inversions()) == 1


# -- the DAG ----------------------------------------------------------------

def test_edges_and_reentrant_locks(watch):
    lw, w = watch
    a, b, c = (lw.named_lock(f"d.{x}") for x in "abc")
    with a:
        with b:
            with c:
                pass
    assert w.edge_count() == 3 and w.snapshot()["order_edges"] == 3
    r = lw.named_lock("d.r", kind="rlock")
    with r:
        with r:
            assert w.held_names() == ["d.r"]
    assert w.held_names() == []
    assert w.edge_count() == 3
    assert w.counters()["acquisitions"] == 4


# -- holds and blocking -------------------------------------------------------

def test_long_hold_flagged_at_release(pkg):
    lw = LW[pkg]
    try:
        w = lw.arm(hold_ms=1.0)
        a = lw.named_lock("h.slow")
        with a:
            REAL_SLEEP(0.02)
        assert w.counters()["long_holds"] == 1
        (f,) = w.findings("long_hold")
        assert f["lock"] == "h.slow"
        assert f["held_ms"] > f["threshold_ms"] == 1.0
    finally:
        lw.disarm()


def test_sleep_under_lock_is_blocking_finding(watch):
    lw, w = watch
    time.sleep(0)
    assert w.counters()["blocking_in_lock"] == 0
    a = lw.named_lock("h.blk")
    with a:
        time.sleep(0)
    with a:
        lw.note_blocking("socket.recv")
    assert w.counters()["blocking_in_lock"] == 2
    calls = sorted(f["call"] for f in w.findings("blocking_in_lock"))
    assert calls == ["socket.recv", "time.sleep"]
    assert all(f["locks_held"] == ["h.blk"]
               for f in w.findings("blocking_in_lock"))


# -- Condition over a watched lock -------------------------------------------

def test_condition_wait_releases_the_held_stack(watch):
    lw, w = watch
    lk, other = lw.named_lock("c.lock"), lw.named_lock("c.other")
    cond = threading.Condition(lk)
    ready = threading.Event()
    state = {}

    def waiter():
        with cond:
            ready.set()
            cond.wait(timeout=5.0)
            state["held"] = list(w.held_names())

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert ready.wait(5.0)
    with other:
        with cond:
            cond.notify()
    t.join(5.0)
    assert state["held"] == ["c.lock"]
    assert w.held_names() == []
    assert w.counters()["inversions"] == 0


# -- fold and snapshot --------------------------------------------------------

def test_fold_into_metrics_publishes_deltas_once(watch):
    lw, w = watch
    metrics = METRICS["torch" if lw is port_lockwatch else "jax"]()
    a, b = lw.named_lock("f.a"), lw.named_lock("f.b")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    d1 = w.fold_into(metrics)
    assert d1["acquisitions"] == 4 and d1["inversions"] == 1
    assert all(v == 0 for v in w.fold_into(metrics).values())
    assert metrics.value("lockwatch_acquisitions") == 4
    assert metrics.value("lockwatch_inversions") == 1
    snap = w.snapshot()
    assert set(snap) == {"counters", "order_edges", "findings"}
    assert snap["findings"][0]["stack"] is None


def test_module_fold_noop_when_disarmed(pkg):
    assert LW[pkg].fold_into(METRICS[pkg]()) == {}


def test_finding_cap_bounds_memory(pkg):
    lw = LW[pkg]
    try:
        w = lw.arm(hold_ms=-1.0)
        for i in range(lw.MAX_FINDINGS + 50):
            with lw.named_lock(f"cap.{i}"):
                pass
        assert len(w.findings()) <= lw.MAX_FINDINGS
    finally:
        lw.disarm()


# -- parity: one schedule, the same findings ---------------------------------

def schedule(lw):
    """Three locks in two orders on two threads, a reentrant lock, a
    sleep and an explicit blocking call under locks; returns the watch's
    counters, edge count and findings (stack and thread names aside)."""
    w = lw.arm(hold_ms=10_000.0)
    try:
        a, b, c = (lw.named_lock(f"p.{x}") for x in "abc")
        r = lw.named_lock("p.r", kind="rlock")

        def first():
            with a:
                with b:
                    with c:
                        pass

        def second():
            with c:
                with a:
                    time.sleep(0)
            with r:
                with r:
                    with b:
                        lw.note_blocking("socket.recv")

        for fn in (first, second):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            t.join()
        findings = [{k: v for k, v in f.items()
                     if k not in ("stack", "thread")}
                    for f in w.findings()]
        return w.counters(), w.edge_count(), findings
    finally:
        lw.disarm()


def test_schedule_findings_equal_jax():
    got, want = schedule(port_lockwatch), schedule(ref_lockwatch)
    assert got == want
    counters, edges, findings = got
    assert counters["inversions"] == 1 and edges == 5
    assert sorted(f["kind"] for f in findings) == [
        "blocking_in_lock", "blocking_in_lock", "lock_order_inversion"]
