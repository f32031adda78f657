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
  admission logs equal the JAX run's.
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


def test_lock_order_trial_equals_jax():
    """The fleet_distributed gauntlet under the lock-order sentinel: no
    inversion, and the fire, claim and admission logs of the JAX run."""
    def run(runner, kw):
        ref = runner._snapshot_reference(runner.FLEET_DIST_ROWS, **kw)
        r = runner.run_lock_order_trial(0, 7, runner.FLEET_DIST_ROWS, ref,
                                        **kw)
        return trial_view(r) + (r.preempts,)

    got = both_trials(run)
    assert got["port"] == got["jax"]
    view = got["port"]
    assert view[0] == "lock_order" and view[4], view
    assert view[11] == 1 and view[15] == 1
