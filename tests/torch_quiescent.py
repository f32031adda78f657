"""An autouse fixture for the port's tests whose runs bill the
process-wide resource ledger and device counters of either package
(`stats/ledger.py::LEDGER`, `stats/trace.py::TELEMETRY`).  A run can
leave the two apart, and a conservation check run later in the same
worker (the JAX package's `tests/unit/test_fleetobs.py::TestEngineExport`,
a chaos trial's fleet-observability invariant) reads that drift as a
violation.  A module takes it in with
`from tests.torch_quiescent import ledger_quiescent  # noqa: F401`."""

import pytest


@pytest.fixture(autouse=True)
def ledger_quiescent():
    """Both packages' counters and ledger start from zero again after
    each test."""
    yield
    from transferia_tpu.stats import ledger as ref_ledger
    from transferia_tpu.stats import trace as ref_trace
    from transferia_tpu_torch.stats import ledger as port_ledger
    from transferia_tpu_torch.stats import trace as port_trace

    for trace_mod, ledger_mod in ((ref_trace, ref_ledger),
                                  (port_trace, port_ledger)):
        trace_mod.TELEMETRY.reset()
        ledger_mod.LEDGER.reset()
