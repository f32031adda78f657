"""The chaos runner and the delivery auditor (the port's
`chaos/{runner,invariants}.py`) against the JAX package's, on the CPU.

- The schedule functions give the JAX package's spec strings, letter for
  letter, for seeds 7 and 11 and trials 0-2.
- The invariants (`DeliveryReference`, `audit_delivery`,
  `fencing_violations`, `MonotonicityTracker`, `AuditingCoordinator`)
  give the JAX verdicts on the same batches; the row keys (K10's plain
  version with `device="cpu"`) are the JAX keys bit for bit, and
  `keys_fingerprint` is `fingerprint_host` over the distinct rows.
- A snapshot trial at seed 7 gives the JAX spec, fire log, restarts,
  verdict and reference digest, with the fused step forced to its device
  placement in both packages (so `device.dispatch` is on the path), and
  `run_trials(mode="snapshot")` gives the JAX report.
- worker_crash passes with the JAX package's fire and steal logs, as
  the reference's own tests hold them fixed (scheduler_kill and
  lock_order: tests/test_torch_chaos_fleet.py).
- The auditor, and the whole harness, detect lost, invented and
  unbounded-duplicate rows.
- Without a card and not asked for the CPU, `run_trials` raises.
"""

from collections import Counter

import pytest
import torch

from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import OperationTablePart as RefPart
from transferia_tpu.chaos import failpoints as ref_fp
from transferia_tpu.chaos import invariants as ref_inv
from transferia_tpu.chaos import runner as ref_runner
from transferia_tpu.coordinator.memory import (
    MemoryCoordinator as RefCoordinator,
)
from transferia_tpu.ops.rowhash import fingerprint_host as ref_fp_host
from transferia_tpu.ops.rowhash import prep_batch as ref_prep
from transferia_tpu.providers.memory import MemorySinker as RefSinker
from transferia_tpu.providers.sample import make_batch as ref_make_batch
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.chaos import failpoints as port_fp
from transferia_tpu_torch.chaos import invariants as port_inv
from transferia_tpu_torch.chaos import runner as port_runner
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator
from transferia_tpu_torch.ops.rowhash import fingerprint_host, prep_batch
from transferia_tpu_torch.providers.memory import MemorySinker
from transferia_tpu_torch.providers.sample import make_batch
from tests.torch_chaos_common import CPU, both_trials, trial_view


@pytest.fixture(autouse=True)
def _clean_failpoints():
    port_fp.reset()
    ref_fp.reset()
    yield
    port_fp.reset()
    ref_fp.reset()


# -- schedules ---------------------------------------------------------------

SCHEDULES = {
    "default_snapshot": lambda r, t, s: r.default_schedule(
        "snapshot", t, s),
    "default_snapshot_no_device": lambda r, t, s: r.default_schedule(
        "snapshot", t, s, device_ok=False),
    "default_replication": lambda r, t, s: r.default_schedule(
        "replication", t, s),
    "default_arrow_ipc": lambda r, t, s: r.default_schedule(
        "arrow_ipc", t, s),
    "worker_crash": lambda r, t, s: r.worker_crash_schedule(t, s),
    "exactly_once": lambda r, t, s: [
        r.exactly_once_schedule(t, s, b) for b in r.EXACTLY_ONCE_BACKENDS],
    "scheduler_kill": lambda r, t, s: r.scheduler_kill_schedule(t, s),
    "fleet_distributed": lambda r, t, s: r.fleet_distributed_schedule(
        t, s),
    "snapshot_and_increment": lambda r, t, s:
        r.snapshot_and_increment_schedule(t, s),
}


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_strings_equal_jax(name, seed):
    fn = SCHEDULES[name]
    for trial in range(3):
        got = fn(port_runner, trial, seed)
        assert got == fn(ref_runner, trial, seed)
        assert got  # every schedule arms at least one site
        for spec in got if isinstance(got, list) else [got]:
            # the port's catalog accepts every reference spec
            port_fp.parse_spec(spec)


def test_mode_constants_equal_jax():
    for name in ("SNAPSHOT_ROWS", "REPLICATION_MESSAGES", "TRIAL_TIMEOUT",
                 "MAX_SNAPSHOT_RUNS", "TRIAL_LEASE_SECONDS",
                 "TRIAL_HEARTBEAT_INTERVAL", "SNAPSHOT_SITES",
                 "REPLICATION_SITES", "ARROW_IPC_SITES",
                 "EXACTLY_ONCE_BACKENDS", "_EO_PUBLISH_SITES",
                 "SCHEDULER_TRANSFERS", "SCHEDULER_WORKERS",
                 "FLEET_DIST_TICKETS", "FLEET_DIST_ROWS", "SAI_SITES",
                 "SAI_ROWS", "SAI_PARTS", "SAI_ATTEMPTS"):
        assert getattr(port_runner, name) == getattr(ref_runner, name), name


# -- invariants --------------------------------------------------------------

def batches(pkg: str, *spans) -> list:
    """Sample `users` batches of [start, start+n) spans; a span of three
    values (start, n, k) is the first k rows of that batch."""
    out = []
    for span in spans:
        start, n = span[:2]
        if pkg == "port":
            b = make_batch("users", TableID("sample", "users"), start, n, 3)
        else:
            b = ref_make_batch("users", RefTableID("sample", "users"),
                               start, n, 3)
        out.append(b.slice(0, span[2]) if len(span) == 3 else b)
    return out


def verdict_of(v) -> tuple:
    return (v.passed, [str(x) for x in v.violations], v.delivered_rows,
            v.distinct_rows, v.duplicate_rows, v.max_multiplicity,
            v.summary())


AUDIT_CASES = {
    # name: (reference spans, observed spans, max_multiplicity, exactly)
    "exact": ([(0, 64)], [(0, 64)], 1, False),
    "bounded_duplicates": ([(0, 64)], [(0, 64), (0, 64, 16)], 2, False),
    "lost_rows": ([(0, 64)], [(0, 64, 60)], 3, False),
    "unbounded_duplicates": ([(0, 64)],
                             [(0, 64), (0, 64, 8), (0, 64, 8), (0, 64, 8)],
                             2, False),
    "reference_multiplicity": ([(0, 32), (0, 32)], [(0, 32), (0, 32)], 1,
                               False),
    "over_reference_multiplicity": ([(0, 32), (0, 32)], [(0, 32)] * 4, 1,
                                    False),
    "invented_rows": ([(0, 64)], [(0, 64), (1000, 4)], 3, False),
    "exactly_once_exact": ([(0, 64)], [(0, 64)], 1, True),
    "exactly_once_duplicate": ([(0, 64)], [(0, 64), (0, 64, 1)], 4, True),
    "exactly_once_lost_copy": ([(0, 64), (0, 64, 4)], [(0, 64)], 4, True),
    "empty_observed": ([(0, 16)], [], 1, False),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_verdicts_equal_jax(case):
    ref_spans, obs_spans, bound, exactly = AUDIT_CASES[case]
    got = {}
    for pkg, inv, kw in (("port", port_inv, CPU), ("jax", ref_inv, {})):
        ref = inv.DeliveryReference.from_batches(
            batches(pkg, *ref_spans), **kw)
        v = inv.audit_delivery(ref, batches(pkg, *obs_spans), bound,
                               exactly_once=exactly, **kw)
        got[pkg] = (ref.keys, ref.fingerprint, ref.rows, verdict_of(v))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("n", [1, 100, 513])
def test_row_keys_and_keys_fingerprint_equal_jax(n):
    """The auditor's row keys are the JAX keys bit for bit, and the
    dedup-then-reduce digest is `fingerprint_host` over the rows."""
    b, rb = batches("port", (0, n))[0], batches("jax", (0, n))[0]
    keys = port_inv.batch_row_keys(b, device="cpu")
    ref_keys = ref_inv.batch_row_keys(rb)
    assert keys.dtype == ref_keys.dtype and (keys == ref_keys).all()
    agg = port_inv.keys_fingerprint(Counter(keys.tolist()))
    assert agg == fingerprint_host(*prep_batch(b))
    assert agg.digest() == ref_inv.keys_fingerprint(
        Counter(ref_keys.tolist())).digest() == ref_fp_host(
            *ref_prep(rb)).digest()


def test_change_item_batches_key_as_jax():
    """A ChangeItem list pivots into homogeneous runs before keying."""
    got = {}
    for pkg, inv, kw in (("port", port_inv, CPU), ("jax", ref_inv, {})):
        items = batches(pkg, (0, 12))[0].to_rows() + \
            batches(pkg, (40, 5))[0].to_rows()
        got[pkg] = inv._batches_to_counter([items, []], **kw)
    assert got["port"] == got["jax"] and sum(got["port"].values()) == 17


def test_fencing_violations_equal_jax():
    logs = ([("op/t/0", 1, 1), ("op/t/1", 2, 2), ("op/t/0", 1, 1)],
            [("op/t/0", 1, 1), ("op/t/0", 2, 2)],
            [("a", 1, 0), ("b", 1, 0), ("a", 3, 2), ("b", 2, 1)])
    for log in logs:
        assert [str(v) for v in port_inv.fencing_violations(log)] == \
            [str(v) for v in ref_inv.fencing_violations(log)]
    assert len(port_inv.fencing_violations(logs[2])) == 2


def test_monotonicity_tracker_equal_jax():
    got = {}
    for pkg, inv, kw in (("port", port_inv, CPU), ("jax", ref_inv, {})):
        tr = inv.MonotonicityTracker()
        for name, value in (("c:0", 5), ("c:0", 5), ("c:0", 9), ("c:0", 3),
                            ("c:1", 1), ("c:1", 0)):
            tr.record(name, value)
        tr.reset_mark("c:0")
        tr.record("c:0", 0)
        ref = inv.DeliveryReference.from_batches(batches(pkg, (0, 8)),
                                                 **kw)
        v = inv.audit_delivery(ref, batches(pkg, (0, 8)), 1,
                               checkpoints=tr, **kw)
        got[pkg] = (list(tr.violations), verdict_of(v))
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 2 and not got["port"][1][0]


def test_auditing_coordinator_equal_jax():
    """Completions, fence rejections, the commit log, state writes and
    the monotonicity marks through each package's coordinator proxy."""
    got = {}
    for pkg, inv, cp_cls, part_cls, tid in (
            ("port", port_inv, MemoryCoordinator, OperationTablePart,
             TableID("a", "b")),
            ("jax", ref_inv, RefCoordinator, RefPart, RefTableID("a", "b"))):
        cp = inv.AuditingCoordinator(cp_cls(lease_seconds=30))
        cp.set_transfer_state("t", {"k": 1})
        parts = [part_cls(operation_id="op", table_id=tid, part_index=i,
                          parts_count=3) for i in range(3)]
        cp.create_operation_parts("op", parts)
        got0 = cp.assign_operation_part("op", 0)
        got0.completed = True
        got0.completed_rows = 5
        first = cp.update_operation_parts("op", [got0])
        stale = part_cls.from_json(got0.to_json())
        stale.assignment_epoch = 0
        second = cp.update_operation_parts("op", [stale])
        got1 = cp.assign_operation_part("op", 1)
        granted = cp.commit_part("op", got1)
        zombie = part_cls.from_json(got1.to_json())
        zombie.assignment_epoch = 0
        denied = cp.commit_part("op", zombie)
        got[pkg] = (first, second, list(cp.completions),
                    cp.fence_rejections, list(cp.commit_log), granted,
                    denied, cp.state_writes, cp.get_transfer_state("t"),
                    cp.operation_progress("op").completed_parts,
                    list(cp.tracker.violations),
                    [str(v) for v in inv.fencing_violations(
                        cp.completions)])
    assert got["port"] == got["jax"]
    assert got["port"][3] == 1 and got["port"][5] is True


# -- trials --------------------------------------------------------------------

@pytest.mark.parametrize("rows,trial", [(512, 0), (512, 1), (4096, 0)])
def test_snapshot_trial_equals_jax(rows, trial):
    def run(runner, kw):
        ref = runner._snapshot_reference(rows, **kw)
        r = runner.run_snapshot_trial(trial, 7, rows, ref, **kw)
        return ref.fingerprint, ref.rows, ref.keys, trial_view(r)

    got = both_trials(run)
    assert got["port"] == got["jax"]
    view = got["port"][3]
    assert view[4], view  # passed
    assert view[6].get("device.dispatch"), view  # the fused step fired


def test_snapshot_run_trials_report_equals_jax():
    got = {}
    for pkg, runner, kw in (("port", port_runner, CPU),
                            ("jax", ref_runner, {})):
        report = runner.run_trials(trials=2, seed=7, mode="snapshot", **kw)
        d = report.to_dict()
        for r in d["results"]:
            r.pop("seconds")
            r.pop("skipped", None)
        d.pop("skipped", None)
        got[pkg] = (d, report.format_summary())
    assert got["port"] == got["jax"]
    assert got["port"][0]["passed"]


def test_snapshot_fire_log_replays_with_seed():
    with port_runner._fast_retries():
        ref = port_runner._snapshot_reference(512, "cpu")
        a, b, c = (port_runner.run_snapshot_trial(1, s, 512, ref,
                                                  device_ok=False,
                                                  device="cpu")
                   for s in (7, 7, 8))
    assert a.passed and b.passed and c.passed
    assert (a.spec, a.fire_log) == (b.spec, b.fire_log)
    assert (c.spec, c.fire_log) != (a.spec, a.fire_log)


@pytest.mark.parametrize("trial,seed", [(0, 7), (2, 7), (2, 11)])
def test_worker_crash_trial_equals_jax(trial, seed):
    def run(runner, kw):
        ref = runner._snapshot_reference(512, **kw)
        return trial_view(runner.run_worker_crash_trial(trial, seed, 512,
                                                        ref, **kw))

    got = both_trials(run)
    assert got["port"] == got["jax"]
    view = got["port"]
    assert view[4] and view[11] == 1 and view[13] == 1, view
    ((_key, dead_worker, epoch),) = view[12]
    assert dead_worker == 1 and epoch == 2


# -- the harness catches genuine faults -----------------------------------

def lossy(sinker_cls):
    real_push = sinker_cls.push
    left = {"n": 1}

    def push(self, batch):
        if hasattr(batch, "n_rows") and batch.n_rows > 4 and left["n"]:
            left["n"] -= 1
            return real_push(self, batch.slice(0, batch.n_rows - 4))
        return real_push(self, batch)

    return push


def test_trial_detects_genuinely_lost_rows_as_jax(monkeypatch):
    """A sink that silently drops rows fails the at-least-once audit in
    both packages, with the same violations."""
    # the references come from clean runs
    refs = both_trials(lambda r, kw: r._snapshot_reference(512, **kw))
    monkeypatch.setattr(MemorySinker, "push", lossy(MemorySinker))
    monkeypatch.setattr(RefSinker, "push", lossy(RefSinker))
    got = {}
    for pkg, runner, kw in (("port", port_runner, CPU),
                            ("jax", ref_runner, {})):
        with runner._fast_retries():
            got[pkg] = trial_view(runner.run_snapshot_trial(
                0, 7, 512, refs[pkg], spec="", device_ok=False, **kw))
    assert got["port"] == got["jax"]
    assert not got["port"][4]
    assert any(v.startswith("at-least-once") for v in got["port"][8])


def test_run_trials_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_runner.run_trials(trials=1, mode="snapshot",
                                   device=device)
