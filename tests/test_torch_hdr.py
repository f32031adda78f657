"""The port's mergeable latency histograms (`transferia_tpu_torch/stats/
hdr.py`) and stage timer (`stats/stagetimer.py`) against the JAX
package's, bucket for bucket.

The same values, made from a seed with numpy (log-uniform over 1 ns to
100 s, zeros and negatives included), go into both packages'
`LogHistogram`s: the bucket maps, counts, extremes and every quantile
are equal, merges are exact and order-free, `diff`/`to_json`/
`from_json` round-trip equally, `StageHistograms` and
`merge_stage_maps` agree, and the stage timer feeds the histograms and
prints the same breakdown.
"""

import numpy as np
import pytest

from transferia_tpu.stats import hdr as ref_hdr
from transferia_tpu.stats import stagetimer as ref_stagetimer
from transferia_tpu_torch.stats import hdr as port_hdr
from transferia_tpu_torch.stats import stagetimer as port_stagetimer

HDR = {"jax": ref_hdr, "torch": port_hdr}
ST = {"jax": ref_stagetimer, "torch": port_stagetimer}
QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


def values(seed: int, n: int) -> list[float]:
    rng = np.random.default_rng(seed)
    v = 10.0 ** rng.uniform(-9, 2, n)
    v[rng.integers(0, n, max(1, n // 50))] = 0.0
    v[rng.integers(0, n, max(1, n // 100))] = -1e-3
    return [float(x) for x in v]


def hist(mod, vals, trace_ids=None):
    h = mod.LogHistogram()
    for i, v in enumerate(vals):
        h.observe(v, trace_ids[i] if trace_ids else 0)
    return h


@pytest.fixture(autouse=True)
def clean_stages():
    for mod in HDR.values():
        mod.STAGES.reset()
    for mod in ST.values():
        mod.enable(False)
        mod.reset()
    yield
    for mod in HDR.values():
        mod.STAGES.reset()
    for mod in ST.values():
        mod.enable(False)
        mod.reset()


@pytest.mark.parametrize("seed", range(4))
def test_buckets_and_quantiles_equal_jax(seed):
    vals = values(seed, 5000)
    ids = list(range(1, len(vals) + 1))
    got, want = hist(port_hdr, vals, ids), hist(ref_hdr, vals, ids)
    assert got.counts == want.counts
    assert (got.count, got.total, got.max_value, got.min_value,
            got.max_trace) == (want.count, want.total, want.max_value,
                               want.min_value, want.max_trace)
    for q in QUANTILES:
        assert got.quantile(q) == want.quantile(q), q
    for v in (1e-6, 1e-3, 0.5, 7.0):
        assert got.fraction_at_most(v) == want.fraction_at_most(v)
    assert got.summary() == want.summary()
    assert got.to_json() == want.to_json()


def test_bucket_index_and_mid_equal_jax():
    for v in values(9, 2000) + [0.0, 2.0 ** -64, 2.0 ** -65, 1.0, 1e30]:
        assert port_hdr.bucket_index(v) == ref_hdr.bucket_index(v)
    for idx in range(0, 3000, 7):
        assert port_hdr.bucket_mid(idx) == ref_hdr.bucket_mid(idx)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_merge_is_exact_and_order_free(pkg):
    mod = HDR[pkg]
    a, b = values(1, 700), values(2, 1300)
    whole = hist(mod, a + b)
    ab = hist(mod, a).merge(hist(mod, b))
    ba = hist(mod, b).merge(hist(mod, a))
    for h in (ab, ba):
        assert h.counts == whole.counts and h.count == whole.count
        assert h.max_value == whole.max_value
        assert h.min_value == whole.min_value
        for q in QUANTILES:
            assert h.quantile(q) == whole.quantile(q)


def test_diff_and_json_round_trip_equal_jax():
    base_vals, more = values(3, 400), values(4, 600)
    out = []
    for mod in (ref_hdr, port_hdr):
        base = hist(mod, base_vals)
        h = hist(mod, base_vals + more)
        d = h.diff(base)
        rt = mod.LogHistogram.from_json(h.to_json())
        junk = mod.LogHistogram.from_json({"counts": {"x": 1, "5": "2"},
                                           "count": "bad"})
        out.append((d.to_json(), rt.to_json(), junk.to_json(),
                    mod.LogHistogram.from_json(None).to_json()))
    assert out[0] == out[1]
    assert out[1][0]["count"] == 600


def test_stage_histograms_and_merge_maps_equal_jax():
    maps = []
    for mod in (ref_hdr, port_hdr):
        reg = mod.StageHistograms()
        for i, v in enumerate(values(5, 900)):
            reg.observe(("decode", "pack", "sink")[i % 3], v, trace_id=i)
        maps.append(reg.snapshot())
        assert reg.get("missing").count == 0
    assert maps[0] == maps[1]
    torn = {"decode": {"counts": "junk"}, "x": None}
    merged = [{k: h.to_json() for k, h in
               mod.merge_stage_maps([maps[0], maps[1], torn, 7]).items()}
              for mod in (ref_hdr, port_hdr)]
    assert merged[0] == merged[1]
    assert merged[1]["pack"]["count"] == 600


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stagetimer_feeds_histograms_and_breakdown(pkg):
    st, mod = ST[pkg], HDR[pkg]
    st.collect_samples("transform")
    st.add("transform", 0.5)      # disabled: nothing recorded
    st.enable(True)
    assert st.enabled()
    with st.stage("transform"):
        pass
    st.add("transform", 0.25)
    st.add("decode", 1.0)
    snap = st.snapshot()
    assert snap["transform"]["calls"] == 2 and snap["decode"]["calls"] == 1
    assert st.samples("transform")[1] == 0.25
    assert mod.STAGES.get("transform").count == 2
    assert mod.STAGES.get("decode").max_value == 1.0
    line = st.format_breakdown(2.0)
    assert line.startswith("decode=1.00s(50%) transform=0.25s(")
    assert line.rsplit(" ", 1)[1].startswith("overlap_factor=0.6")
    st.reset()
    assert st.snapshot() == {} and st.format_breakdown(1.0) == ""


def test_breakdown_text_equal_jax():
    lines = []
    for pkg in ("jax", "torch"):
        st = ST[pkg]
        st.enable(True)
        for name, secs in (("source_decode", 0.4), ("pack", 0.125),
                           ("device_wait", 0.0625), ("pack", 0.5)):
            st.add(name, secs)
        lines.append((st.snapshot(), st.format_breakdown(1.5)))
        st.enable(False)
    assert lines[0] == lines[1]
