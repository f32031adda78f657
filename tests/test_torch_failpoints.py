"""The port's failpoints (`transferia_tpu_torch/chaos/failpoints.py`
and its site catalog `chaos/sites.py`) against the JAX package's.

The JAX package's failpoint unit cases run on both packages (`pkg`):
the spec grammar, triggers, the delay and torn-write actions, the fire
log, the disabled path and the metric fold.  The parity cases hold the
two packages to the same draws: one `random.Random(f"{seed}:{site}")`
stream per site, so a spec and a seed fire on the same hits in both
(for a set of specs and seeds, interleaved sites included), and the
5,000-row `sample` snapshot with `snapshot.part.batch` armed to fire
once delivers the same rows as an unarmed run and counts one fire and
one part retry in each package, while one `device.dispatch` fire is
absorbed by the snapshot stage's sink Retrier (no part retry) in both.
Tests arm through `configure`, never the environment variable both
packages read at import.
"""

import time

import pytest

from test_torch_trace import quiet  # noqa: F401  (autouse fixture)
from test_torch_trace import sample_snapshot
from transferia_tpu.abstract.errors import TransferError as RefTransferError
from transferia_tpu.chaos import failpoints as ref_fp
from transferia_tpu.chaos import sites as ref_sites
from transferia_tpu.stats import trace as ref_trace
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu.tasks import snapshot as ref_snapshot
from transferia_tpu_torch.abstract.errors import TransferError
from transferia_tpu_torch.chaos import failpoints as port_fp
from transferia_tpu_torch.chaos import sites as port_sites
from transferia_tpu_torch.stats import trace as port_trace
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks import snapshot as port_snapshot

FP = {"jax": ref_fp, "torch": port_fp}
METRICS = {"jax": RefMetrics, "torch": Metrics}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return request.param


def fires(fp, clause: str, hits: int, seed: int = 0) -> list[int]:
    site = clause.split("=")[0]
    fp.configure(clause, seed=seed)
    out = []
    for i in range(1, hits + 1):
        try:
            fp.failpoint(site)
        except Exception:
            out.append(i)
    fp.reset()
    return out


# -- the catalog and the errors ---------------------------------------------

def test_site_catalog_equals_jax():
    assert port_sites.site_names() == ref_sites.site_names()
    assert {k: v[0] for k, v in port_sites.SITES.items()} == \
        {k: v[0] for k, v in ref_sites.SITES.items()}


def test_injected_errors_are_transfer_errors():
    assert issubclass(port_fp.ChaosInjectedError, TransferError)
    assert issubclass(port_fp.TornWriteError, port_fp.ChaosInjectedError)
    e = port_fp.TornWriteError("sink.push.torn", 3, 7)
    ref = ref_fp.TornWriteError("sink.push.torn", 3, 7)
    assert (str(e), e.kept, e.total) == (str(ref), ref.kept, ref.total)
    assert not issubclass(port_fp.ChaosInjectedError, RefTransferError)


# -- spec parsing ------------------------------------------------------------

def test_full_grammar(pkg):
    sites = FP[pkg].parse_spec(
        "sink.push=after:2,every:3,times:4,raise:ConnectionError;"
        "storage.part.read=prob:0.25;"
        "transform.chain=delay:15;"
        "sink.push.torn=truncate:0.5")
    assert sites["sink.push"].after == 2
    assert sites["sink.push"].every == 3
    assert sites["sink.push"].times == 4
    assert sites["sink.push"].arg is ConnectionError
    assert sites["storage.part.read"].prob == 0.25
    assert sites["transform.chain"].action == "delay"
    assert sites["transform.chain"].arg == pytest.approx(0.015)
    assert sites["sink.push.torn"].action == "truncate"


def test_bare_site_always_fires(pkg):
    sites = FP[pkg].parse_spec("sink.push")
    assert [sites["sink.push"].should_fire() for _ in range(5)] == \
        [True] * 5


@pytest.mark.parametrize("bad", [
    "unknown.site=times:1",
    "sink.push=prob:1.5",
    "sink.push=raise:NoSuchError",
    "sink.push=after:x",
    "sink.push=frobnicate:1",
    "sink.push=times",
    "sink.push=truncate:0",
    "sink.push=times:1;sink.push=times:2",
])
def test_rejects_malformed(pkg, bad):
    with pytest.raises(FP[pkg].FailpointSpecError):
        FP[pkg].parse_spec(bad)


def test_env_activation(pkg):
    fp = FP[pkg]
    assert not fp.activate_from_env({})
    assert fp.activate_from_env({fp.ENV_SPEC: "sink.push=times:1",
                                 fp.ENV_SEED: "11"})
    assert fp.is_enabled()
    with pytest.raises(fp.ChaosInjectedError):
        fp.failpoint("sink.push")


# -- triggers ---------------------------------------------------------------

def test_after_every_times(pkg):
    assert fires(FP[pkg], "sink.push=after:2,every:2,times:3", 12) == \
        [4, 6, 8]


def test_prob_deterministic_under_seed(pkg):
    fp = FP[pkg]
    a = fires(fp, "sink.push=prob:0.3", 50, seed=7)
    assert a == fires(fp, "sink.push=prob:0.3", 50, seed=7)
    assert a != fires(fp, "sink.push=prob:0.3", 50, seed=8)
    assert 0 < len(a) < 50


def test_delay_action_sleeps_without_raising(pkg):
    fp = FP[pkg]
    fp.configure("sink.push=delay:30,times:1")
    t0 = time.monotonic()
    fp.failpoint("sink.push")
    assert time.monotonic() - t0 >= 0.025
    assert fp.fire_counts()["sink.push"] == 1


def test_torn_rows_semantics(pkg):
    fp = FP[pkg]
    fp.configure("sink.push.torn=truncate:0.5,every:2")
    fp.failpoint("sink.push.torn")
    assert fp.torn_rows("sink.push.torn", 100) is None
    assert fp.torn_rows("sink.push.torn", 100) == 50
    assert fp.torn_rows("sink.push.torn", 100) is None
    assert fp.torn_rows("sink.push.torn", 1) is None
    fp.configure("sink.push.torn=truncate:1.0")
    assert fp.torn_rows("sink.push.torn", 10) == 9


def test_noop_when_disabled(pkg):
    fp = FP[pkg]
    assert not fp.is_enabled()
    assert fp.failpoint("not.even.a.site") is None
    assert fp.torn_rows("not.even.a.site", 100) is None
    assert fp.fire_counts() == {}
    fp.configure("sink.push=times:1")
    fp.reset()
    fp.failpoint("sink.push")
    assert fp.hit_counts() == {}


def test_active_scope_disarms(pkg):
    fp = FP[pkg]
    with fp.active("sink.push=times:1"):
        assert fp.is_enabled()
        with pytest.raises(fp.ChaosInjectedError):
            fp.failpoint("sink.push")
    assert not fp.is_enabled()


def test_fold_into_metrics(pkg):
    fp = FP[pkg]
    fp.configure("sink.push=every:1,times:3")
    for _ in range(3):
        with pytest.raises(fp.ChaosInjectedError):
            fp.failpoint("sink.push")
    m = METRICS[pkg]()
    fp.fold_into(m)
    fp.fold_into(m)
    assert m.value("chaos_fires_sink_push") == 3
    assert m.value("chaos_fires") == 3


def test_fire_lands_on_the_active_span(pkg):
    fp = FP[pkg]
    tr = {"jax": ref_trace, "torch": port_trace}[pkg]
    fp.configure("transform.chain=times:1")
    tr.enable(True)
    try:
        with tr.span("transform") as sp:
            with pytest.raises(fp.ChaosInjectedError):
                fp.failpoint("transform.chain")
            ctx = sp.context()
    finally:
        tr.enable(False)
    (inst,) = [s for s in tr.spans() if s[6] < 0]
    assert inst[0] == "chaos_fire" and inst[10] == ctx.span_id
    assert inst[7] == {"site": "transform.chain", "action": "raise",
                       "fire": 1, "hit": 1}


# -- parity: the same fires for a spec and a seed ----------------------------

SPECS = [
    "sink.push=prob:0.3",
    "sink.push=prob:0.5,after:3,times:7",
    "sink.push=every:4,prob:0.6",
    "storage.part.read=prob:0.1",
    "device.dispatch=prob:0.9,every:2",
]


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_fire_sequence_equals_jax(spec, seed):
    assert fires(port_fp, spec, 200, seed) == fires(ref_fp, spec, 200, seed)


@pytest.mark.parametrize("seed", [3, 99])
def test_interleaved_sites_fire_log_equals_jax(seed):
    spec = ("sink.push=prob:0.5;storage.part.read=prob:0.2,after:5;"
            "sink.push.torn=truncate:0.3,prob:0.4;"
            "device.dispatch=every:3,times:4")
    logs = []
    for fp in (ref_fp, port_fp):
        fp.configure(spec, seed)
        torn = []
        for i in range(120):
            for site in ("sink.push", "storage.part.read",
                         "device.dispatch"):
                try:
                    fp.failpoint(site)
                except fp.ChaosInjectedError:
                    pass
            torn.append(fp.torn_rows("sink.push.torn", 10 + i))
        logs.append((fp.fire_log(), fp.hit_counts(), fp.fire_counts(),
                     torn))
        fp.reset()
    assert logs[0] == logs[1]
    assert logs[1][2]["device.dispatch"] == 4


# -- parity: an armed snapshot retries its part once --------------------------

@pytest.fixture
def fast_retries(monkeypatch):
    for mod in (ref_snapshot, port_snapshot):
        monkeypatch.setattr(mod, "PART_RETRY_BASE_DELAY", 0.01)


def test_snapshot_part_batch_fires_once_and_retries_equal_jax(
        fast_retries):
    clean, _, _ = sample_snapshot("torch", "fp-clean", trace_on=False)
    got = {}
    for pkg in ("torch", "jax"):
        ids, snap, spans = sample_snapshot(
            pkg, f"fp-{pkg}", spec="snapshot.part.batch=times:1", seed=5)
        tr = snap["transfers"][f"fp-{pkg}"]
        got[pkg] = (ids, tr["retries"], tr["chaos_fires"], tr["commits"],
                    sorted(s[0] for s in spans if s[6] < 0
                           and s[0] in ("chaos_fire", "part_retry")))
    assert got["torch"] == got["jax"]
    ids, retries, chaos_fires, commits, instants = got["torch"]
    assert ids == clean
    assert (retries, chaos_fires, commits) == (1, 1, 2)
    assert instants == ["chaos_fire", "part_retry"]


def test_snapshot_device_dispatch_is_absorbed_by_the_sink_retrier(
        monkeypatch):
    """By the reference's composition: the snapshot stage's sink
    Retrier wraps the chain, so one device.dispatch fire re-pushes the
    batch and no part retries, in both packages."""
    from transferia_tpu.middlewares import sync as ref_sync
    from transferia_tpu_torch.middlewares import sync as port_sync

    for mod in (ref_sync, port_sync):
        monkeypatch.setattr(mod, "RETRY_BASE_DELAY", 0.01)
    clean, _, _ = sample_snapshot("jax", "fpd-clean", trace_on=False)
    got = {}
    for pkg in ("torch", "jax"):
        ids, snap, spans = sample_snapshot(
            pkg, f"fpd-{pkg}", spec="device.dispatch=times:1", seed=2)
        tr = snap["transfers"][f"fpd-{pkg}"]
        got[pkg] = (ids, tr["retries"], tr["chaos_fires"], tr["rows_out"],
                    sum(1 for s in spans if s[0] == "chaos_fire"))
    assert got["torch"] == got["jax"]
    ids, retries, chaos_fires, rows_out, fire_instants = got["torch"]
    assert ids == clean and rows_out == len(clean)
    assert (retries, chaos_fires, fire_instants) == (0, 1, 1)
