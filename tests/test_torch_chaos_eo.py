"""The chaos runner's exactly-once, replication and S&I trials (the
port's `chaos/{runner,wire_backends}.py`) against the JAX package's, on
the CPU.

- exactly_once over the memory, postgres, clickhouse, kafka and s3
  backends, the port on its own protocol fakes
  (`transferia_tpu_torch/recipes/`) and the JAX package on its
  `tests/recipes/` fakes: the fault-free reference multiset has the JAX
  digest, the trial delivers it with zero duplicates and zero losses,
  the fire and steal logs equal the JAX run's and the commit decisions
  are the JAX run's (their order replays within one package).
- `arrow_ipc` and `ydb` report unavailable, naming ROADMAP.md A7, and
  `run_trials` reports them skipped, never passed.
- The replication trial (mq -> memory through the mask) passes with the
  JAX spec and verdict.
- The S&I layered scenario equals the JAX package's run with its spill
  off (`TRANSFERIA_TPU_MVCC_SPILL=0`, the reference's route without
  pyarrow): merged reads, fire logs, admission and cutover logs, kills
  and fences; the pump scenario is reported skipped, naming A7.
"""

import pytest

from transferia_tpu.chaos import failpoints as ref_fp
from transferia_tpu.chaos import runner as ref_runner
from transferia_tpu.chaos import wire_backends as ref_wire
from transferia_tpu_torch.chaos import failpoints as port_fp
from transferia_tpu_torch.chaos import runner as port_runner
from transferia_tpu_torch.chaos import wire_backends as port_wire
from tests.torch_chaos_common import CPU, both_trials, trial_view

BACKENDS = ("memory", "postgres", "clickhouse", "kafka", "s3")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    port_fp.reset()
    ref_fp.reset()
    yield
    port_fp.reset()
    ref_fp.reset()


@pytest.fixture
def no_spill(monkeypatch):
    """The JAX package's MVCC spill off: both packages keep layers in
    memory, which is the reference's own route without pyarrow."""
    monkeypatch.setenv("TRANSFERIA_TPU_MVCC_SPILL", "0")


def test_backend_matrix_keeps_the_reference_names():
    assert port_wire.backend_names() == ref_wire.backend_names()
    assert port_runner.EXACTLY_ONCE_BACKENDS == (
        "memory", "arrow_ipc", "postgres", "clickhouse", "ydb", "kafka",
        "s3")
    for name in BACKENDS:
        assert port_wire.backend_available(name) == (True, "")


@pytest.mark.parametrize("name", ["arrow_ipc", "ydb"])
def test_unavailable_backends_name_their_item(name):
    ok, reason = port_wire.backend_available(name)
    assert not ok and "ROADMAP.md A7" in reason
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        port_wire.make_backend(name, "x", "cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_exactly_once_trial_equals_jax(backend):
    def run(runner, kw):
        ref = runner._exactly_once_reference(512, backend, **kw)
        r = runner.run_exactly_once_trial(0, 7, 512, ref, backend=backend,
                                          **kw)
        # the commit decisions as a multiset: whether the survivor's
        # steal of the victim's part comes before its other claims
        # depends on when the 0.25-s lease expires against the thread's
        # start (one package's run replays its own order exactly, below)
        return (ref.fingerprint, ref.rows, trial_view(r), r.backend,
                sorted(r.commit_log), r.dedup_dropped)

    got = both_trials(run)
    assert got["port"] == got["jax"]
    digest, rows, view, name, commit_log, _ = got["port"]
    assert name == backend and rows == 512
    assert view[4], view                 # passed: delivered == reference
    assert view[10] == 0                 # zero duplicate rows
    assert view[11] == 1 and view[13] >= 1, view  # a kill, fenced
    assert any(not granted for _k, _e, granted in commit_log)


def test_exactly_once_wire_logs_replay_with_seed():
    with port_runner._fast_retries():
        ref = port_runner._exactly_once_reference(512, "s3", "cpu")
        a, b = (port_runner.run_exactly_once_trial(1, 7, 512, ref,
                                                   backend="s3",
                                                   device="cpu")
                for _ in range(2))
    assert a.passed and b.passed
    assert (a.spec, a.fire_log, a.steal_log, a.commit_log) == \
        (b.spec, b.fire_log, b.steal_log, b.commit_log)


def test_run_trials_reports_the_skips_never_passes(monkeypatch):
    # the memory backend and the two unavailable ones (the wire backends
    # run in test_exactly_once_trial_equals_jax)
    monkeypatch.setattr(port_runner, "EXACTLY_ONCE_BACKENDS",
                        ("memory", "arrow_ipc", "ydb"))
    report = port_runner.run_trials(trials=1, seed=7, mode="exactly_once",
                                    rows=256, **CPU)
    assert report.passed
    assert [r.backend for r in report.results] == ["memory"]
    skipped = {s["what"]: s["reason"] for s in report.skipped}
    assert set(skipped) == {"exactly_once backend arrow_ipc",
                            "exactly_once backend ydb"}
    assert all("ROADMAP.md A7" in r for r in skipped.values())
    text = report.format_summary()
    assert "skipped (not run, not counted): exactly_once backend ydb" \
        in text
    assert report.to_dict()["skipped"] == report.skipped
    only_skips = port_runner.run_trials(trials=1, mode="arrow_ipc", **CPU)
    assert not only_skips.results and not only_skips.passed
    assert "ROADMAP.md A7" in only_skips.skipped[0]["reason"]
    assert "chaos verdict: FAIL" in only_skips.format_summary()


def test_replication_trial_equals_jax():
    def run(runner, kw):
        ref = runner._replication_reference(80, **kw)
        r = runner.run_replication_trial(0, 7, 80, ref, **kw)
        return ref.fingerprint, ref.rows, r.spec, r.passed, \
            [str(v) for v in r.verdict.violations]

    got = both_trials(run)
    assert got["port"] == got["jax"]
    assert got["port"][3] and got["port"][1] == 80


def sai_view(out: dict) -> tuple:
    return ([b.to_pydict() for b in out["read"]], out["fires"],
            out["fire_log"], [str(v) for v in out["violations"]],
            out["kills"], out["fence_rejected"], out["logs"],
            list(out["tracker"].violations))


@pytest.mark.parametrize("trial,seed", [(0, 7), (1, 11)])
def test_sai_layered_scenario_equals_jax(trial, seed, no_spill):
    spec = port_runner.snapshot_and_increment_schedule(trial, seed)
    got = {}
    for pkg, runner, kw in (("port", port_runner, CPU),
                            ("jax", ref_runner, {})):
        with runner._fast_retries():
            got[pkg] = [sai_view(runner._sai_scenario(
                trial, seed, 512, sp, f"t-{pkg}-{label}", **kw))
                for sp, label in ((None, "ref"), (spec, "r1"))]
    assert got["port"] == got["jax"]
    (ref_read, *_), (read, fires, _log, violations, kills, fenced, logs,
                     _) = got["port"]
    assert read == ref_read and not violations
    assert kills >= 1 and fenced >= 2 and fires
    assert logs["cutover"] and logs["admit"]


def test_sai_trial_passes_and_skips_the_pump(no_spill):
    with port_runner._fast_retries():
        r = port_runner.run_snapshot_and_increment_trial(0, 7, 512, **CPU)
    assert r.passed, r.verdict.summary()
    assert r.restarts >= 1 and r.fence_rejected >= 2 and r.commit_log
    assert all(k.startswith("layered:") for k in r.fire_log)
    ((skip),) = r.skipped
    assert "pump" in skip["what"] and "ROADMAP.md A7" in skip["reason"]
    assert r.to_dict()["skipped"] == r.skipped
    report = port_runner.run_trials(trials=1, seed=7,
                                    mode="snapshot_and_increment",
                                    rows=512, **CPU)
    assert report.passed
    assert [s["what"] for s in report.skipped] == [
        "snapshot_and_increment pump scenario"]
    assert "pump scenario -- ROADMAP.md A7" in report.format_summary()
