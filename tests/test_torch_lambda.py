"""The lambda transformer and the SR fan-in user function (K15's plain
version) against the JAX package's `LambdaTransformer`, exactly.

The same batch goes through `transferia_tpu.transform.plugins.lambda_tf`
with bench.py's jax.jit `bench_lambda` (bench.py:1006-1018) and through
the port's transformer with `transferia_tpu_torch.ops.lambdas
:bench_lambda` on the CPU, in both of the port's placements.  Values,
dtypes, canonical types, validity and schemas must be identical,
including the reference's int64 -> int32 truncation of the `id` column
(the JAX package runs without x64).  The placement state machine is
driven with a stubbed link profile and a fake clock through both
packages and must choose the same strategy at every batch.
"""

import numpy as np
import pytest
import torch

from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.ops import linkprobe as ref_linkprobe
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu.transform.plugins import lambda_tf as ref_lambda
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.ops import linkprobe as port_linkprobe
from transferia_tpu_torch.ops.lambdas import (
    bench_lambda,
    region_sign_flip,
    region_sign_flip_plain,
)
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.plugins import lambda_tf as port_lambda

REF_FN = "bench:bench_lambda"
PORT_FN = "transferia_tpu_torch.ops.lambdas:bench_lambda"
SR_COLS = [("id", "int64", True), ("url", "utf8"), ("region", "int32")]

# the truncation table: (ids, region) -> int32 result under jax.jit
TRUNCATION = [(1, 1, 1), (2**31 + 5, 500, 2147483643), (-7, 450, 7),
              (2**40, 3, 0), (2**31, 500, -2**31), (-2**31, 500, -2**31),
              (-2**63, 7, 0), (2**63 - 1, 399, -1), (5, 400, -5),
              (5, 399, 5), (6, -1, 6)]


@pytest.fixture
def placement():
    """Pin the reference to its host strategy and the port to `mode`;
    restore both afterwards."""
    def pin(mode):
        ref_tfused.set_placement("host")
        port_tfused.set_placement(mode)

    yield pin
    ref_tfused.set_placement(None)
    port_tfused.set_placement(None)


def sr_data(n, seed=0, nulls=False):
    """measure_kafka_sr2ch's columns (bench.py:1178-1186) with ids drawn
    over the whole int64 range."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64).tolist()
    region = rng.integers(-5, 505, n).astype(np.int32).tolist()
    url = [f"https://e.test/{i % 997}" for i in range(n)]
    if nulls:
        for i in range(0, n, 3):
            ids[i] = None
        for i in range(1, n, 5):
            region[i] = None
    return {"id": ids, "url": url, "region": region}


def batches(cols, data, table=("", "hits")):
    port = ColumnBatch.from_pydict(TableID(*table), new_table_schema(cols),
                                   data)
    ref = RefBatch.from_pydict(RefTableID(*table), ref_schema(cols), data)
    return port, ref


def schema_rows(schema):
    return [(c.name, c.data_type.value, c.primary_key, c.required)
            for c in schema]


def column_state(col):
    data = np.asarray(col.data)
    return (col.ctype.value, str(data.dtype), data.tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def outcome(call):
    """What a call returns, or the exception it raised."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return e


def assert_same(out, ref_out):
    assert (out.table_id.namespace, out.table_id.name) == \
        (ref_out.table_id.namespace, ref_out.table_id.name)
    assert schema_rows(out.schema) == schema_rows(ref_out.schema)
    assert out.n_rows == ref_out.n_rows
    assert list(out.columns) == list(ref_out.columns)
    for name in ref_out.columns:
        assert column_state(out.column(name)) == \
            column_state(ref_out.column(name)), name


def run_both(config, cols, data, table=("", "hits")):
    port_batch, ref_batch = batches(cols, data, table)
    tr = port_lambda.LambdaTransformer(**config)
    tr.bind_device("cpu")  # the chain's device="cpu"
    out = tr.apply(port_batch)
    ref_out = ref_lambda.LambdaTransformer(**config_for_ref(config)).apply(
        ref_batch)
    return out.transformed, ref_out.transformed


def config_for_ref(config):
    cfg = dict(config)
    if cfg.get("function") == PORT_FN:
        cfg["function"] = REF_FN
    return cfg


# -- the user function ------------------------------------------------------

@pytest.mark.parametrize("mode", ["host", "device"])
def test_truncation_table_through_the_chains(mode, placement):
    placement(mode)
    ids, region, want = map(list, zip(*TRUNCATION))
    data = {"id": ids, "url": [f"u{i}" for i in range(len(ids))],
            "region": region}
    port_batch, ref_batch = batches(SR_COLS, data)
    out = build_chain({"transformers": [{"lambda": {"function": PORT_FN}}]},
                      device="cpu").apply(port_batch)
    ref_out = ref_build_chain({"transformers": [
        {"lambda": {"function": REF_FN}}]}).apply(ref_batch)
    assert_same(out, ref_out)
    assert out.column("id").data.tolist() == want
    assert out.schema.find("id").data_type.value == "int32"


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1024, 1200])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_ragged_sizes(n, bucket, mode, placement):
    placement(mode)
    out, ref_out = run_both({"function": PORT_FN, "bucket": bucket},
                            SR_COLS, sr_data(n, seed=n))
    assert_same(out, ref_out)
    assert out.column("id").data.dtype == np.int32


@pytest.mark.parametrize("mode", ["host", "device"])
def test_nulls_in_id_and_region(mode, placement):
    placement(mode)
    out, ref_out = run_both({"function": PORT_FN}, SR_COLS,
                            sr_data(300, seed=3, nulls=True))
    assert_same(out, ref_out)
    assert out.column("id").validity is not None
    assert not out.column("id").validity.all()


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 70_001])
def test_plain_version_against_numpy_int32(n):
    rng = np.random.default_rng(n)
    ids = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    region = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
        np.int32)
    edge_ids = np.array([2**31, -2**31, 2**31 + 5, 2**40, -2**63, 2**63 - 1,
                         -1, 0], dtype=np.int64)
    edge_region = np.array([399, 400, -1, 0, 500, 2**31 - 1, -2**31, 400],
                           dtype=np.int32)
    if n:
        k = min(n, len(edge_ids))
        ids[:k], region[:k] = edge_ids[:k], edge_region[:k]
    low = ids.astype(np.int32)
    for threshold in (400, -2**31, 2**31 - 1, 0):
        want = np.where(region < threshold, low, -low)
        got = region_sign_flip_plain(torch.from_numpy(ids),
                                     torch.from_numpy(region), threshold)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(region_sign_flip(
            torch.from_numpy(ids), torch.from_numpy(region),
            threshold).numpy(), want)


def test_bench_lambda_matches_bench_py_directly():
    import bench

    ids = np.array([t[0] for t in TRUNCATION], dtype=np.int64)
    region = np.array([t[1] for t in TRUNCATION], dtype=np.int32)
    ref = bench.bench_lambda({"id": ids, "region": region})["id"]
    got = bench_lambda({"id": torch.from_numpy(ids),
                        "region": torch.from_numpy(region)})["id"]
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(got.numpy(), ref)
    # other integer widths: int32 ids and an int64 region, as jax.jit
    # without x64 sees them
    ref = bench.bench_lambda({"id": ids.astype(np.int32),
                              "region": region.astype(np.int64) + 2**32})
    got = bench_lambda({"id": ids.astype(np.int32),
                        "region": region.astype(np.int64) + 2**32})
    assert np.array_equal(got["id"].numpy(), ref["id"])


def test_kernel_wrapper_checks_its_arguments():
    ids = torch.zeros(4, dtype=torch.int64)
    region = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        region_sign_flip(ids.to(torch.int32), region)
    with pytest.raises(ValueError, match="region"):
        region_sign_flip(ids, region.to(torch.int64))
    with pytest.raises(ValueError, match="region"):
        region_sign_flip(ids, region[:3])
    with pytest.raises(ValueError, match="int32"):
        region_sign_flip(ids, region, 2**31)
    with pytest.raises(ValueError, match="integer"):
        bench_lambda({"id": ids.to(torch.float64), "region": region})


# -- modes, types, tables, resolution ---------------------------------------

AMOUNT_COLS = [("id", "int64", True), ("email", "utf8"),
               ("amount", "double"), ("country", "utf8")]


def amount_data(n=4):
    """tests/unit/test_transformers.py make_batch."""
    return {"id": list(range(1, n + 1)),
            "email": [f"u{i}@example.com" for i in range(1, n + 1)],
            "amount": [i * 10.0 for i in range(1, n + 1)],
            "country": ["de", "us", "de", "fr"][:n]}


@pytest.mark.parametrize("mode", ["host", "device"])
def test_mask_mode(mode, placement):
    placement(mode)
    fn = lambda cols: cols["amount"] > 25  # noqa: E731
    out, ref_out = run_both({"function": fn, "mode": "mask"}, AMOUNT_COLS,
                            amount_data())
    assert_same(out, ref_out)
    assert out.to_pydict()["id"] == [3, 4]


@pytest.mark.parametrize("mode", ["host", "device"])
def test_columns_mode_keeps_the_type_when_the_dtype_holds(mode, placement):
    placement(mode)
    fn = lambda cols: {"amount": cols["amount"] * 2}  # noqa: E731
    out, ref_out = run_both({"function": fn}, AMOUNT_COLS, amount_data())
    assert_same(out, ref_out)
    assert out.to_pydict()["amount"] == [20.0, 40.0, 60.0, 80.0]


def test_batch_mode():
    fn = lambda b: b.slice(1, 3)  # noqa: E731
    out, ref_out = run_both({"function": fn, "mode": "batch"}, AMOUNT_COLS,
                            amount_data())
    assert_same(out, ref_out)
    assert out.n_rows == 2


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8", "uint16", "uint32", "uint64",
                                   "float32", "float64", "bool"])
@pytest.mark.parametrize("target", ["amount", "fresh", "email"])
def test_infer_ctype_entries(dtype, target, placement):
    """A numpy output of each dtype, into an existing fixed column, a new
    column and a var-width column, in both packages; the port's torch
    outputs of the same dtype give the same column."""
    placement("host")

    def fn(cols):
        return {target: np.arange(len(cols["id"])).astype(dtype)}

    def torch_fn(cols):
        return {target: torch.from_numpy(
            np.arange(len(cols["id"])).astype(dtype))}

    port_batch, ref_batch = batches(AMOUNT_COLS, amount_data())
    ref = outcome(lambda: ref_lambda.LambdaTransformer(fn).apply(ref_batch))
    for f in (fn, torch_fn):
        got = outcome(lambda: port_lambda.LambdaTransformer(f).apply(
            port_batch))
        if isinstance(ref, Exception):
            # a uint8 array into a var-width column keeps its type and
            # lacks offsets: both packages refuse the column
            assert (type(got), str(got)) == (type(ref), str(ref))
        else:
            assert_same(got.transformed, ref.transformed)
    assert port_lambda._infer_ctype(np.zeros(1, dtype)) == \
        port_lambda.CanonicalType(ref_lambda._infer_ctype(
            np.zeros(1, dtype)).value)


@pytest.mark.parametrize("dtype", ["float16", "complex64", "datetime64[s]"])
def test_infer_ctype_raises_on_unsupported(dtype, placement):
    placement("host")

    def fn(cols):
        return {"amount": np.zeros(len(cols["id"]), dtype)}

    port_batch, ref_batch = batches(AMOUNT_COLS, amount_data())
    with pytest.raises(ValueError, match="unsupported dtype") as port_err:
        port_lambda.LambdaTransformer(fn).apply(port_batch)
    with pytest.raises(ValueError, match="unsupported dtype") as ref_err:
        ref_lambda.LambdaTransformer(fn).apply(ref_batch)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("table", [("db", "users"), ("db", "other"),
                                   ("x", "users")])
def test_tables_include(table, placement):
    placement("host")
    cfg = {"transformers": [{"lambda": {
        "function": lambda cols: {"amount": cols["amount"] + 1},
        "tables": ["db.users"]}}]}
    port_batch, ref_batch = batches(AMOUNT_COLS, amount_data(), table)
    chain, ref_chain = build_chain(cfg, device="cpu"), ref_build_chain(cfg)
    plan = chain.plan_for(port_batch.table_id, port_batch.schema).steps
    ref_plan = ref_chain.plan_for(ref_batch.table_id, ref_batch.schema).steps
    assert [s.describe() for s in plan] == [s.describe() for s in ref_plan]
    assert len(plan) == (1 if table == ("db", "users") else 0)
    assert_same(chain.apply(port_batch), ref_chain.apply(ref_batch))


@pytest.mark.parametrize("config", [
    {"function": "f", "mode": "rows"},
    {"function": None},
    {"function": {"a": 1}},
    {"function": 3},
])
def test_bad_config_raises_alike(config):
    with pytest.raises(ValueError) as port_err:
        port_lambda.LambdaTransformer(**config)
    with pytest.raises(ValueError) as ref_err:
        ref_lambda.LambdaTransformer(**config)
    assert str(port_err.value) == str(ref_err.value)


def test_resolution_is_lazy_and_alike():
    # a dotted path that does not import still builds (validate on a
    # control host), and fails only when first called
    t = port_lambda.LambdaTransformer("no_such_module_xyz:fn")
    ref = ref_lambda.LambdaTransformer("no_such_module_xyz:fn")
    for tr in (t, ref):
        with pytest.raises(ModuleNotFoundError):
            tr.fn  # noqa: B018
    for mod in (port_lambda, ref_lambda):
        with pytest.raises(KeyError, match="register_lambda"):
            mod._resolve("not_registered")
    assert port_lambda._resolve(PORT_FN) is bench_lambda
    marker = lambda cols: cols  # noqa: E731
    port_lambda.register_lambda("torch_test_marker", marker)
    assert port_lambda._resolve("torch_test_marker") is marker
    assert port_lambda.LambdaTransformer(
        "torch_test_marker").fn is marker
    assert t.describe() == ref.describe() == "lambda(no_such_module_xyz:fn)"


def test_only_read_columns_are_staged():
    seen = {}

    def fn(cols):
        seen["names"] = sorted(cols)
        seen["id"] = cols["id"]
        seen["staged"] = sorted(cols._staged)
        return {"id": cols["id"]}

    port_batch, _ = batches(SR_COLS, sr_data(10))
    tr = port_lambda.LambdaTransformer(fn)
    tr.bind_device("cpu")
    port_tfused.set_placement("device")
    try:
        out = tr.apply(port_batch).transformed
    finally:
        port_tfused.set_placement(None)
    # var-width url is not offered; region is offered but never staged
    assert seen["names"] == ["id", "region"]
    assert seen["staged"] == ["id"]
    assert isinstance(seen["id"], torch.Tensor)
    assert seen["id"].numel() == 256  # bucketed
    assert np.array_equal(out.column("id").data,
                          port_batch.column("id").data)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1200])
def test_bucket_shapes_alike(n, bucket, placement):
    placement("host")
    shapes = {"port": [], "ref": []}

    def make(key):
        def fn(cols):
            shapes[key].append(len(cols["id"]))
            return {"id": cols["id"]}
        return fn

    port_batch, ref_batch = batches(SR_COLS, sr_data(n))
    port_lambda.LambdaTransformer(make("port"), bucket=bucket).apply(
        port_batch)
    ref_lambda.LambdaTransformer(make("ref"), bucket=bucket).apply(ref_batch)
    assert shapes["port"] == shapes["ref"]
    want = n if not bucket else max(256, 1 << (n - 1).bit_length())
    assert shapes["port"] == [want]


# -- placement --------------------------------------------------------------

class _Link:
    def __init__(self, rtt_s, bytes_per_s):
        self.launch_overhead_s = rtt_s
        self.h2d_bytes_per_s = bytes_per_s
        self.d2h_bytes_per_s = bytes_per_s


class _Clock:
    """Stands in for both modules' `time`: the user fn advances it by
    the chosen strategy's cost per row."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def drive(mod, link, cost_ns, n_batches, monkeypatch, n_rows=1024):
    """Push n_batches through one package's transformer with a stubbed
    link profile and a fake clock; return the strategy of every batch
    and the final per-strategy EWMAs."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    linkprobe = ref_linkprobe if mod is ref_lambda else port_linkprobe
    monkeypatch.setattr(linkprobe, "probe_link", lambda *a, **k: link)
    trace = []
    tr = None

    def fn(cols):
        clock.t += cost_ns[trace[-1]] * n_rows / 1e9
        return {"amount": cols["amount"]}

    tr = mod.LambdaTransformer(fn)
    if mod is port_lambda:
        tr.bind_device("cpu")
    pick = tr._pick_strategy

    def recording_pick(*args):
        trace.append(pick(*args))
        return trace[-1]

    monkeypatch.setattr(tr, "_pick_strategy", recording_pick)
    cols = [("id", "int64"), ("amount", "double")]
    data = {"id": list(range(n_rows)), "amount": [1.0] * n_rows}
    port_batch, ref_batch = batches(cols, data)
    batch = ref_batch if mod is ref_lambda else port_batch
    for _ in range(n_batches):
        tr.apply(batch)
    return trace, dict(tr._ns_row)


FAST_LINK = _Link(1e-6, 1e12)
SLOW_LINK = _Link(0.07, 1e6)


@pytest.mark.parametrize("case", ["device_wins", "host_wins", "gated"])
def test_placement_state_machine_alike(case, monkeypatch):
    link, cost = {
        "device_wins": (FAST_LINK, {"host": 100.0, "device": 10.0}),
        "host_wins": (FAST_LINK, {"host": 100.0, "device": 1000.0}),
        "gated": (SLOW_LINK, {"host": 100.0, "device": 10.0}),
    }[case]
    for mod in (ref_tfused, port_tfused):
        mod.set_placement("auto")
    try:
        traces = {}
        for name, mod in (("ref", ref_lambda), ("port", port_lambda)):
            traces[name] = drive(mod, link, cost, 600, monkeypatch)
    finally:
        for mod in (ref_tfused, port_tfused):
            mod.set_placement(None)
    trace, ns = traces["port"]
    assert traces["port"] == traces["ref"]
    # host first: an unscored warm-up, then a scored host call
    assert trace[:2] == ["host", "host"]
    if case == "gated":
        # the link model never lets the device probe, re-probes included
        assert set(trace) == {"host"}
        assert ns["device"] < 0
        return
    # the device's warm-up, then its first scored call
    assert trace[2:4] == ["device", "device"]
    winner = "device" if case == "device_wins" else "host"
    loser = "host" if winner == "device" else "device"
    # the loser is re-probed exactly at batches 255, 511 (0-based)
    probes = [i for i, s in enumerate(trace[4:], start=4) if s == loser]
    assert probes == [255, 511]
    assert ns[winner] == pytest.approx(cost[winner])
    assert ns[loser] == pytest.approx(cost[loser])


@pytest.mark.parametrize("pinned", ["host", "device"])
def test_placement_pinned_by_the_knob(pinned, monkeypatch):
    monkeypatch.setenv("TRANSFERIA_TPU_PLACEMENT", pinned)
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)  # re-read the env
    try:
        for mod in (ref_lambda, port_lambda):
            trace, _ = drive(mod, SLOW_LINK, {"host": 1.0, "device": 1.0},
                             300, monkeypatch)
            assert set(trace) == {pinned}
    finally:
        for mod in (ref_tfused, port_tfused):
            mod.set_placement(None)


def test_device_strategy_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain = build_chain({"transformers": [{"lambda": {"function": PORT_FN}}]})
    port_batch, _ = batches(SR_COLS, sr_data(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chain.apply(port_batch)
    tr = port_lambda.LambdaTransformer(PORT_FN)
    port_tfused.set_placement("device")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tr.apply(port_batch)
    finally:
        port_tfused.set_placement(None)
