"""The chaos runner's fleet-shaped trials (the port's
`chaos/runner.py`: scheduler_kill and lock_order) against the JAX
package's, on the CPU, each package under its own fast retries and
forced device placement (the port on `device="cpu"`).

- scheduler_kill: a worker slot killed at a seeded dispatch decision;
  the dispatch order, the kill and the rebalance log equal the JAX
  run's, and every transfer's delivery passes its audit.
- lock_order: the fleet_distributed gauntlet (scheduler failover, a
  worker killed mid-part and its ticket reclaimed, an interactive
  preemption, exactly-once per ticket, two runs replayed) under the
  runtime lock-order sentinel: no inversion, and the fire, claim and
  admission logs equal the JAX run's, but for the fires of the
  observability export, whose hits the clock gates (one package's fires
  there are a prefix of the other's).
"""

import pytest

from transferia_tpu.chaos import failpoints as ref_fp
from transferia_tpu_torch.chaos import failpoints as port_fp
from transferia_tpu_torch.chaos import runner as port_runner
from tests.torch_chaos_common import both_trials, trial_view


@pytest.fixture(autouse=True)
def _clean_failpoints():
    port_fp.reset()
    ref_fp.reset()
    yield
    port_fp.reset()
    ref_fp.reset()


def test_scheduler_kill_trial_equals_jax():
    def run(runner, kw):
        ref = runner._snapshot_reference(512, **kw)
        return trial_view(runner.run_scheduler_kill_trial(0, 7, 512, ref,
                                                          **kw))

    got = both_trials(run)
    assert got["port"] == got["jax"]
    view = got["port"]
    assert view[4] and view[11] == 1, view
    assert len(view[14]) == port_runner.SCHEDULER_TRANSFERS + len(view[12])


# sites whose hits the clock decides: an observability export is
# attempted at most once a TRANSFERIA_TPU_OBS_INTERVAL (1 s) of each
# heartbeat, so how many a scenario reaches depends on how long it ran;
# the seed decides which of those hits fire (fleet_distributed_schedule's
# obs.export=prob:0.3 fires on hits 9, 21, 22, ... of seed 7's trial 0)
CLOCK_GATED_SITES = ("obs.export",)


def split_clock_gated(view: tuple) -> tuple:
    """(the view without the clock-gated sites' fires, their fire logs)"""
    fire_log, fire_counts = view[6], view[7]
    gated = {k: list(fire_log.get(k, [])) for k in CLOCK_GATED_SITES}
    for k, hits in gated.items():
        assert fire_counts.get(k, 0) == len(hits), (k, fire_counts, hits)
    rest = (view[:6]
            + ({k: v for k, v in fire_log.items()
                if k not in CLOCK_GATED_SITES},
               {k: v for k, v in fire_counts.items()
                if k not in CLOCK_GATED_SITES})
            + view[8:])
    return rest, gated


def test_lock_order_trial_equals_jax():
    """The fleet_distributed gauntlet under the lock-order sentinel: no
    inversion, and the fire, claim and admission logs of the JAX run.
    The fires of a clock-gated site agree on the hits both runs reached:
    one run's fire log is a prefix of the other's."""
    def run(runner, kw):
        ref = runner._snapshot_reference(runner.FLEET_DIST_ROWS, **kw)
        r = runner.run_lock_order_trial(0, 7, runner.FLEET_DIST_ROWS, ref,
                                        **kw)
        return trial_view(r) + (r.preempts,)

    got = both_trials(run)
    (port_view, port_gated), (jax_view, jax_gated) = (
        split_clock_gated(got["port"]), split_clock_gated(got["jax"]))
    assert port_view == jax_view
    for k in CLOCK_GATED_SITES:
        a, b = sorted((port_gated[k], jax_gated[k]), key=len)
        assert b[:len(a)] == a, (k, port_gated[k], jax_gated[k])
    view = got["port"]
    assert view[0] == "lock_order" and view[4], view
    assert view[11] == 1 and view[15] == 1
