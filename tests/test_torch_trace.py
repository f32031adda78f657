"""The port's tracing plane (`transferia_tpu_torch/stats/trace.py`)
against the JAX package's `transferia_tpu/stats/trace.py`.

Every behavioral case of the JAX package's trace tests that needs no
deferred module (fleet, Flight, shm, the debug endpoints) runs here on
both packages (`pkg` is "jax" or "torch").  The parity cases drive the
same work through both packages and compare what the timelines and the
device counters record: the fused chain of the JAX package's
`test_device_telemetry_wired_in_fused_path` and a 5,000-row `sample` ->
memory snapshot give the same multiset of span names, the same multiset
of parent -> child name edges and the same `TELEMETRY` counters, with
each difference by design pinned and named.  Timings are never
compared.

The scenario runners here (`fused_chain`, `sample_snapshot`) are shared
with the ledger and failpoint tests.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest

from transferia_tpu.abstract import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.chaos import failpoints as ref_failpoints
from transferia_tpu.columnar import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import (
    ShardingUploadParams as RefSharding,
)
from transferia_tpu.ops import dispatch as ref_dispatch
from transferia_tpu.ops import fused as ref_fused
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import sample as ref_sample
from transferia_tpu.stats import ledger as ref_ledger
from transferia_tpu.stats import trace as ref_trace
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.tasks import snapshot as ref_snapshot
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.chaos import failpoints as port_failpoints
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import (
    Runtime,
    ShardingUploadParams,
    Transfer,
)
from transferia_tpu_torch.ops import dispatch as port_dispatch
from transferia_tpu_torch.ops import fused as port_fused
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import sample as port_sample
from transferia_tpu_torch.stats import ledger as port_ledger
from transferia_tpu_torch.stats import trace as port_trace
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks import SnapshotLoader
from transferia_tpu_torch.tasks import snapshot as port_snapshot
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused

TRACE = {"jax": ref_trace, "torch": port_trace}
LEDGER = {"jax": ref_ledger.LEDGER, "torch": port_ledger.LEDGER}
FAILPOINTS = {"jax": ref_failpoints, "torch": port_failpoints}
METRICS = {"jax": RefMetrics, "torch": Metrics}

CHAIN = {"transformers": [
    {"mask_field": {"columns": ["url"], "salt": "s"}},
    {"filter_rows": {"filter": "region < 400"}},
]}
QUICK_START = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s3cr3t"}},
    {"filter_rows": {"filter": "age >= 21"}},
]}
SNAPSHOT_ROWS = 5000


def _quiet():
    for pkg in TRACE:
        TRACE[pkg].enable(False)
        TRACE[pkg].reset()
        TRACE[pkg].TELEMETRY.reset()
        LEDGER[pkg].reset()
        FAILPOINTS[pkg].reset()


@pytest.fixture(autouse=True)
def quiet():
    _quiet()
    yield
    _quiet()


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return request.param


# -- the shared scenarios ---------------------------------------------------

def fused_chain(pkg: str, n: int = 123, encoding=None):
    """The JAX package's `test_device_telemetry_wired_in_fused_path`:
    the mask + filter chain on one batch, device placement, tracing on.
    Returns (rows out, TELEMETRY snapshot, recorded spans)."""
    data = {
        "id": list(range(n)),
        "url": [f"https://e{i}.com" for i in range(n)],
        "region": [i % 500 for i in range(n)],
    }
    cols = [("id", "int32", True), ("url", "utf8"), ("region", "int32")]
    tr = TRACE[pkg]
    tr.TELEMETRY.reset()
    tr.reset()
    if pkg == "jax":
        batch = RefBatch.from_pydict(RefTableID("web", "hits"),
                                     ref_schema(cols), data)
        mods = (ref_tfused, ref_dispatch)
        ref_tfused.set_device_fusion(True)
        make = lambda: ref_build_chain(CHAIN)  # noqa: E731
    else:
        batch = ColumnBatch.from_pydict(TableID("web", "hits"),
                                        new_table_schema(cols), data)
        mods = (port_tfused, port_dispatch)
        make = lambda: build_chain(CHAIN, device="cpu")  # noqa: E731
    mods[0].set_placement("device")
    mods[1].set_dispatch_encoding(encoding)
    tr.enable(True)
    try:
        out = make().apply(batch)
    finally:
        tr.enable(False)
        mods[0].set_placement(None)
        mods[1].set_dispatch_encoding(None)
        ref_tfused.set_device_fusion(None)
    return out.n_rows, tr.TELEMETRY.snapshot(), tr.spans()


def sample_snapshot(pkg: str, sid: str, spec: str = "", seed: int = 0,
                    trace_on: bool = True):
    """A 5,000-row `sample` -> memory snapshot through the package's
    SnapshotLoader: the QUICK_START chain (device placement), 2 parts
    on 2 upload threads, staged commits on, tracing on.  `spec` arms
    the package's failpoints for the run.  Returns (sorted delivered
    ids, LEDGER snapshot, spans)."""
    if pkg == "jax":
        mem, sample, transfer, runtime, sharding = (
            ref_memory, ref_sample, RefTransfer, RefRuntime, RefSharding)
        tfused = ref_tfused
    else:
        mem, sample, transfer, runtime, sharding = (
            port_memory, port_sample, Transfer, Runtime,
            ShardingUploadParams)
        tfused = port_tfused
    mem.get_store(sid).clear()
    t = transfer(
        id=sid,
        src=sample.SampleSourceParams(preset="users", table="users",
                                      rows=SNAPSHOT_ROWS, shard_parts=2,
                                      batch_rows=1024),
        dst=mem.MemoryTargetParams(sink_id=sid),
        transformation=QUICK_START,
        runtime=runtime(sharding=sharding(process_count=2)))
    tr = TRACE[pkg]
    tfused.set_placement("device")
    if spec:
        FAILPOINTS[pkg].configure(spec, seed)
    tr.enable(trace_on)
    try:
        if pkg == "jax":
            RefLoader(t, RefCoordinator()).upload_tables()
        else:
            SnapshotLoader(t, MemoryCoordinator(),
                           device="cpu").upload_tables()
    finally:
        tr.enable(False)
        tfused.set_placement(None)
        FAILPOINTS[pkg].reset()
    ids = sorted(it.column_values[0] for it in mem.get_store(sid).rows())
    return ids, LEDGER[pkg].snapshot(), tr.spans()


def name_multiset(spans, drop=()) -> collections.Counter:
    return collections.Counter(s[0] for s in spans
                               if s[6] >= 0 and s[0] not in drop)


def edge_multiset(spans, drop=()) -> collections.Counter:
    """parent name -> child name over every recorded span whose parent
    id resolves to a recorded span (instants excluded)."""
    names = {s[9]: s[0] for s in spans if s[6] >= 0}
    return collections.Counter(
        (names[s[10]], s[0]) for s in spans
        if s[6] >= 0 and s[10] in names
        and s[0] not in drop and names[s[10]] not in drop)


# -- disabled path ----------------------------------------------------------

def test_disabled_span_is_shared_noop_singleton(pkg):
    tr = TRACE[pkg]
    assert not tr.enabled()
    s1, s2 = tr.span("a"), tr.span("b")
    assert s1 is s2
    assert not s1
    with s1:
        s1.add(bytes=123)
    assert s1.context() is None
    assert tr.spans() == []
    assert tr.current_context() is None


def test_disabled_path_allocates_nothing(pkg):
    import tracemalloc

    tr = TRACE[pkg]
    with tr.span("warm"):
        pass
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(1000):
        with tr.span("hot"):
            pass
        tr.instant("hot_instant")
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    growth = sum(s.size_diff for s in after.compare_to(before, "lineno")
                 if s.size_diff > 0)
    assert growth < 20_000, f"disabled spans allocated {growth}B"
    assert tr.spans() == []


# -- recording --------------------------------------------------------------

def test_span_nesting_and_self_time(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("outer"):
        assert tr.current() == "outer"
        time.sleep(0.02)
        with tr.span("inner"):
            assert tr.current() == "inner"
            time.sleep(0.02)
    assert tr.current() is None
    rec = {s[0]: s for s in tr.spans()}
    assert set(rec) == {"outer", "inner"}
    assert rec["outer"][6] == 0 and rec["inner"][6] == 1
    outer_dur, outer_self = rec["outer"][4], rec["outer"][5]
    assert outer_dur >= rec["inner"][4]
    assert outer_self <= outer_dur - rec["inner"][4] + 0.005


def test_span_stacks_are_per_thread(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    seen = {}
    barrier = threading.Barrier(2)

    def worker(name):
        with tr.span(name):
            barrier.wait()
            seen[name] = tr.current()
            barrier.wait()

    threads = [threading.Thread(target=worker, args=(f"t{i}",))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"t0": "t0", "t1": "t1"}
    rec = tr.spans()
    assert len(rec) == 2 and len({s[1] for s in rec}) == 2
    assert all(s[6] == 0 for s in rec)


def test_ring_buffer_is_bounded(pkg):
    tr = TRACE[pkg]
    tr.enable(True, capacity=64)
    try:
        for _ in range(200):
            with tr.span("s"):
                pass
        assert len(tr.spans()) == 64
    finally:
        tr.enable(False, capacity=tr.DEFAULT_CAPACITY)


def test_chrome_trace_schema(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("part", table="ns.t", part="0"):
        with tr.span("transform", rows=10):
            pass
    tr.instant("kernel_build", seconds=0.5)
    doc = json.loads(json.dumps(tr.export_chrome_trace()))
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in events} <= {"X", "M", "i"}
    complete = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(complete) == {"part", "transform"}
    p, c = complete["part"], complete["transform"]
    assert c["tid"] == p["tid"] and p["ts"] <= c["ts"]
    assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1
    assert p["args"]["table"] == "ns.t"
    assert c["args"]["parent_id"] == p["args"]["span_id"]
    assert any(e["ph"] == "M" and e["name"] == "thread_name"
               and e["tid"] == p["tid"] for e in events)
    assert any(e["ph"] == "i" and e["name"] == "kernel_build"
               for e in events)
    assert set(doc["otherData"]["device_telemetry"]) == \
        set(tr.TELEMETRY.snapshot())


def test_write_chrome_trace_loads(pkg, tmp_path):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("a"):
        tr.instant("b", x=object())  # not JSON: exported as its str
    path = tmp_path / "t.json"
    n = tr.write_chrome_trace(str(path))
    with open(path) as fh:
        doc = json.load(fh)
    assert n == len(doc["traceEvents"]) >= 3


def test_stage_summary_percentiles_and_bytes(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    for _ in range(10):
        with tr.span("sink", bytes=100):
            time.sleep(0.002)
    s = tr.stage_summary()
    st = s["stages"]["sink"]
    assert st["calls"] == 10 and st["bytes"] == 1000
    assert 0 < st["p50_ms"] <= st["p99_ms"]
    assert s["overlap_factor"] > 0
    text = tr.format_summary()
    assert text.splitlines()[0].startswith("wall=")
    assert any(line.startswith("sink ") for line in text.splitlines())


def test_format_summary_device_line(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("x"):
        pass
    assert "device:" not in tr.format_summary()
    tr.TELEMETRY.record_launch(3)
    tr.TELEMETRY.record_h2d(100)
    line = tr.format_summary().splitlines()[-1]
    assert line.startswith("device: launches=3 h2d=100B/1x")


def test_telemetry_folds_into_metrics(pkg):
    tr = TRACE[pkg]
    tr.TELEMETRY.record_h2d(1000)
    tr.TELEMETRY.record_d2h(500)
    tr.TELEMETRY.record_launch()
    tr.TELEMETRY.record_compile(0.25)
    tr.TELEMETRY.record_dispatch(100, 400)
    m = METRICS[pkg]()
    tr.TELEMETRY.fold_into(m)
    assert m.value("device_h2d_bytes") == 1000
    assert m.value("device_d2h_bytes") == 500
    assert m.value("device_launches") == 1
    assert m.value("device_xla_compiles") == 1
    assert m.value("dispatch_compression_ratio") == 4.0
    tr.TELEMETRY.fold_into(m)
    assert m.value("device_h2d_bytes") == 1000
    tr.TELEMETRY.record_h2d(24)
    tr.TELEMETRY.fold_into(m)
    assert m.value("device_h2d_bytes") == 1024


def test_capture_seconds_preserves_a_live_capture(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("live"):
        pass
    doc = tr.capture_seconds(0.05)
    assert tr.enabled()
    assert any(e.get("name") == "live" for e in doc["traceEvents"])
    assert [s[0] for s in tr.spans()] == ["live"]


def test_capture_seconds_when_off_restores_state(pkg):
    tr = TRACE[pkg]
    doc = tr.capture_seconds(0.05)
    assert not tr.enabled()
    assert "traceEvents" in doc


# -- causality --------------------------------------------------------------

def test_nested_spans_share_trace_and_link_parent(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("root") as root:
        ctx = root.context()
        with tr.span("child"):
            pass
    rec = {s[0]: s for s in tr.spans()}
    assert rec["root"][8] == rec["root"][9] == ctx.trace_id
    assert rec["child"][8] == ctx.trace_id
    assert rec["child"][10] == rec["root"][9]


def test_sibling_roots_get_distinct_traces(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    for _ in range(2):
        with tr.span("root"):
            pass
    a, b = tr.spans()
    assert a[8] != b[8] and a[10] == b[10] == 0


def test_instant_lands_on_active_span(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("host") as sp:
        tr.instant("fire", site="x")
        ctx = sp.context()
    inst = [s for s in tr.spans() if s[6] < 0]
    assert len(inst) == 1
    assert inst[0][8] == ctx.trace_id and inst[0][10] == ctx.span_id
    assert inst[0][7] == {"site": "x"}


def test_complete_records_retroactive_span_with_parent(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("owner") as sp:
        parent = sp.context()
    t0 = time.perf_counter() - 0.5
    tr.complete("queue_wait", t0, 0.5, parent=parent, rows=3)
    rec = {s[0]: s for s in tr.spans()}
    q = rec["queue_wait"]
    assert q[4] == 0.5 and q[8] == parent.trace_id
    assert q[10] == parent.span_id and q[7] == {"rows": 3}


def test_adopted_parents_worker_spans_and_exports_flow(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.span("submit"):
        ctx = tr.current_context()

        def worker():
            with tr.adopted(ctx), tr.span("decode_readahead"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    rec = {s[0]: s for s in tr.spans()}
    assert rec["decode_readahead"][10] == rec["submit"][9]
    assert rec["decode_readahead"][1] != rec["submit"][1]
    flows = [e for e in tr.export_chrome_trace()["traceEvents"]
             if e.get("cat") == "flow"]
    assert sorted(e["ph"] for e in flows) == ["f", "s"]
    assert {e["id"] for e in flows} == {rec["decode_readahead"][9]}


def test_adopted_none_is_noop(pkg):
    tr = TRACE[pkg]
    tr.enable(True)
    with tr.adopted(None), tr.span("alone"):
        pass
    (rec,) = tr.spans()
    assert rec[10] == 0


def test_wire_format_round_trip_and_junk_tolerance(pkg):
    tr = TRACE[pkg]
    ctx = tr.SpanContext(7, 11)
    assert tr.parse_wire(tr.wire_format(ctx)) == ctx
    assert tr.parse_wire(tr.wire_format(ctx).encode()) == ctx
    assert tr.wire_format(None) == ""
    for junk in (None, "", b"", "x:y", "12", ":"):
        assert tr.parse_wire(junk) is None


def test_ids_of_both_packages_carry_host_and_pid():
    """Both packages salt span ids with (host, pid): the same high bits."""
    ids = []
    for tr in (ref_trace, port_trace):
        tr.enable(True)
        with tr.span("x"):
            pass
        ids.append(tr.spans()[0][9])
        tr.enable(False)
    assert ids[0] >> 32 == ids[1] >> 32


# -- parity: the fused chain -------------------------------------------------

# what the JAX package stages beyond the port on this batch: with the
# dispatch encoding on, the encoded predicate column's base crosses the
# link there (a 4-byte device array) and rides as a kernel argument in
# the port (as tests/test_torch_fusedmesh.py pins on the mesh)
KERNEL_ARG_BYTES = {"raw": 0, "auto": 4}


@pytest.mark.parametrize("encoding", ["raw", "auto"])
def test_fused_chain_spans_and_counters_equal_jax(encoding):
    got = fused_chain("torch", encoding=encoding)
    want = fused_chain("jax", encoding=encoding)
    assert got[0] == want[0] == sum(1 for i in range(123) if i % 500 < 400)
    tel, ref_tel = got[1], want[1]
    for key in ("device_launches", "h2d_transfers", "d2h_bytes",
                "d2h_transfers", "h2d_raw_equiv_bytes", "dict_pool_hits",
                "dict_pool_uploads", "dict_pool_share_hits",
                "lazy_dict_preserved", "dict_flat_materializations"):
        assert tel[key] == ref_tel[key], key
    for key in ("h2d_bytes", "h2d_encoded_bytes"):
        assert ref_tel[key] - tel[key] == KERNEL_ARG_BYTES[encoding], key
    assert tel["device_launches"] == 1 and tel["h2d_bytes"] > 0
    assert tel["kernel_seconds"] > 0 and tel["compile_events"] == 0
    assert name_multiset(got[2]) == name_multiset(want[2])
    assert edge_multiset(got[2]) == edge_multiset(want[2])
    assert {"fused_run", "pack", "device_decode", "device_dispatch",
            "device_wait", "host_post"} <= set(name_multiset(got[2]))
    assert edge_multiset(got[2])[("fused_run", "device_dispatch")] == 1
    for spans, t in ((got[2], tel), (want[2], ref_tel)):
        (disp,) = [s for s in spans if s[0] == "device_dispatch"]
        (wait,) = [s for s in spans if s[0] == "device_wait"]
        (dec,) = [s for s in spans if s[0] == "device_decode"]
        assert disp[7]["bytes"] == t["h2d_bytes"]
        assert dec[7]["encoded_bytes"] == t["h2d_encoded_bytes"]
        assert wait[7]["bytes"] == t["d2h_bytes"]


# -- parity: a sample snapshot ----------------------------------------------

def untimed(spans) -> list:
    """The spans but those whose number the run's timing sets, in
    either package: the heartbeat's lease renewals and periodic fleet
    observability exports fire on its 5-s timer, and a part's export is
    skipped when another export holds the exporter's lock (the two
    parts commit on two upload threads).  The final `obs_export`, made
    once whatever the timing, stays."""
    return [s for s in spans if s[0] != "lease_renew" and not (
        s[0] == "obs_export" and s[7].get("kind") != "final")]


def test_sample_snapshot_spans_equal_jax(monkeypatch):
    # no export coalesced by the clock: a part's is skipped only under
    # the lock
    monkeypatch.setenv("TRANSFERIA_TPU_OBS_INTERVAL", "0")
    ids, _, spans = sample_snapshot("torch", "tr-port")
    ref_ids, _, ref_spans = sample_snapshot("jax", "tr-jax")
    assert ids == ref_ids and 0 < len(ids) < SNAPSHOT_ROWS
    for got in (spans, ref_spans):
        parts = [s for s in got
                 if s[0] == "obs_export" and s[7].get("kind") == "part"]
        assert len(parts) <= 2
    spans, ref_spans = untimed(spans), untimed(ref_spans)
    names = name_multiset(spans)
    assert names == name_multiset(ref_spans)
    edges = edge_multiset(spans)
    assert edges == edge_multiset(ref_spans)
    # the final export, once in each package
    assert names["obs_export"] == 1
    # one operation root; each part under it across the upload threads
    assert names["snapshot_op"] == 1 and names["part"] == 2
    assert edges[("snapshot_op", "part")] == 2
    assert edges[("part", "batch")] == names["batch"] == 6
    assert edges[("batch", "transform")] == 6
    assert edges[("transform", "fused_run")] == 6
    assert edges[("fused_run", "device_dispatch")] == 6


def test_sample_snapshot_counters_equal_jax():
    sample_snapshot("torch", "tc-port")
    sample_snapshot("jax", "tc-jax")
    tel = port_trace.TELEMETRY.snapshot()
    ref_tel = ref_trace.TELEMETRY.snapshot()
    for key in ("device_launches", "h2d_transfers", "d2h_bytes",
                "d2h_transfers", "h2d_raw_equiv_bytes", "dict_pool_hits",
                "dict_pool_uploads", "lazy_dict_preserved"):
        assert tel[key] == ref_tel[key], key
    assert tel["device_launches"] > 0
    # each fused batch's `age` column is delta-encoded: its base is a
    # kernel argument in the port, 4 staged bytes in the JAX package
    assert ref_tel["h2d_bytes"] - tel["h2d_bytes"] == \
        4 * tel["device_launches"]
