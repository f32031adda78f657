"""Shared helpers of the chaos tests (`tests/test_torch_chaos*.py`): a
trial run through both packages and the fields of a trial result the
two packages must agree on."""

from transferia_tpu.chaos import runner as ref_runner
from transferia_tpu_torch.chaos import runner as port_runner

CPU = {"device": "cpu"}


def both_trials(fn):
    """fn(runner, kwargs) under each package's fast retries and forced
    device placement; returns {pkg: result}."""
    out = {}
    for pkg, runner, kw in (("port", port_runner, CPU),
                            ("jax", ref_runner, {})):
        with runner._fast_retries(), \
                runner._forced_device_placement() as device_ok:
            assert device_ok
            out[pkg] = fn(runner, kw)
    return out


def trial_view(r) -> tuple:
    return (r.mode, r.trial, r.seed, r.spec, r.passed, r.restarts,
            r.fire_log, {k: v for k, v in r.fire_counts.items() if v},
            [str(v) for v in r.verdict.violations],
            r.verdict.delivered_rows, r.verdict.duplicate_rows, r.kills,
            r.steal_log, r.fence_rejected, r.dispatch_order)
