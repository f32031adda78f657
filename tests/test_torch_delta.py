"""The port's Delta Lake source and event-model snapshot
(`transferia_tpu_torch/providers/misc_providers.py`, `events/`,
`tasks/snapshot_v2.py`, `providers/clickhouse/a2.py`, the activation's
event-model branch) against the JAX package's, on the CPU.  Every
comparison is exact.

Two tables: the JAX tests' own fixture (`tests/e2e/test_a2_e2e.py`,
written by pyarrow with its defaults: dictionary pages, SNAPPY, the
`ARROW:schema` blob; a stale file added and then removed), and ClickBench
files from the port's recipe writer in 30,000-row groups, so that a
batch of 65,536 rows runs across row groups.  The JAX side reads through
pyarrow and fsspec, the port through its own Parquet decoder and its
own S3 client (on a directory, `file://`, and `s3://` on the port's fake
S3).

- `DeltaStorage`: the live files, `table_list`, the schema, every
  batch's cut and rows; `read_bytes` (a difference to arrow's, pinned).
- The snapshot provider's contract, parts and progress.
- `upload_v2` into the fake ClickHouse (CREATE before INSERT), and
  through the bridge.
- `activate_delivery`: the event-model route into the memory sink (the
  same control events), a `filter_rows` transformation forcing the
  bridge (`[4, 5]`), bench.py's chain with `device="cpu"`, and the
  SNAPSHOT_AND_INCREMENT branch.
- The CLI on a Delta YAML (a directory and the port's fake S3), and
  `checksum` against the JAX CLI.
- The error texts.
"""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout
from dataclasses import dataclass

import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from transferia_tpu.abstract.errors import \
    AbortTransferError as RefAbortTransferError
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import \
    TableDescription as RefTableDescription
from transferia_tpu.cli import main as ref_main
from transferia_tpu.coordinator import MemoryCoordinator as RefMemoryCP
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import endpoint as ref_endpoint
from transferia_tpu.models.transfer import TransferType as RefTransferType
from transferia_tpu.mvcc import runner as ref_mvcc_runner
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import misc_providers as ref_misc
from transferia_tpu.providers import registry as ref_registry
from transferia_tpu.providers.clickhouse import \
    CHTargetParams as RefCHTargetParams
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.tasks.snapshot_v2 import upload_v2 as ref_upload_v2
from transferia_tpu_torch.abstract.errors import AbortTransferError
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.cli import main as port_main
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.events import EventTarget
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.models import endpoint as port_endpoint
from transferia_tpu_torch.models.transfer import TransferType
from transferia_tpu_torch.mvcc import runner as port_mvcc_runner
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import misc_providers as port_misc
from transferia_tpu_torch.providers import registry as port_registry
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.recipes.clickbench import (
    clickbench_rows,
    slice_rows,
    write_clickbench,
)
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_s3 import FakeS3
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.tasks.snapshot_v2 import upload_v2

BENCH_CHAIN = {"transformers": [
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}
# the ClickBench table: (file, rows) in the log's order; the stale one is
# added in version 0 and removed in version 1
CB_FILES = (("hits-0.parquet", 70_000), ("hits-stale.parquet", 10_000),
            ("hits-1.parquet", 40_000))
CB_GROUP_ROWS = 30_000
BUCKET = "lake"

PKG = {
    "port": dict(misc=port_misc, TableID=TableID, TD=TableDescription,
                 Transfer=Transfer, CH=FakeCH, CHParams=CHTargetParams,
                 memory=port_memory, cp=MemoryCoordinator,
                 activate=lambda t, cp: activate_delivery(t, cp,
                                                          device="cpu"),
                 upload_v2=lambda t, cp, sp: upload_v2(t, cp, sp,
                                                       device="cpu")),
    "jax": dict(misc=ref_misc, TableID=RefTableID, TD=RefTableDescription,
                Transfer=RefTransfer, CH=RefFakeCH,
                CHParams=RefCHTargetParams, memory=ref_memory,
                cp=RefMemoryCP, activate=ref_activate,
                upload_v2=ref_upload_v2),
}


def write_log(root, versions: list) -> None:
    os.makedirs(os.path.join(root, "_delta_log"), exist_ok=True)
    for v, actions in enumerate(versions):
        with open(os.path.join(root, "_delta_log", f"{v:020d}.json"),
                  "w") as fh:
            fh.write("\n".join(json.dumps(a) for a in actions))


@pytest.fixture()
def delta_dir(tmp_path):
    """The JAX tests' fixture (tests/e2e/test_a2_e2e.py), as written
    there."""
    root = tmp_path / "dtable"
    root.mkdir()
    files = {
        "part-0.parquet": ([1, 2, 3], ["a", "b", "c"]),
        "part-1.parquet": ([4, 5], ["d", "e"]),
        "part-stale.parquet": ([99], ["zzz"]),
    }
    for name, (ids, names) in files.items():
        pq.write_table(pa.table({"id": ids, "name": names}), root / name)
    write_log(str(root), [
        [{"metaData": {"id": "t"}}, {"add": {"path": "part-0.parquet"}},
         {"add": {"path": "part-stale.parquet"}}],
        [{"add": {"path": "part-1.parquet"}},
         {"remove": {"path": "part-stale.parquet"}}]])
    return root


@pytest.fixture(scope="module")
def cb_dir(tmp_path_factory):
    """ClickBench files of the port's recipe writer in 30,000-row
    groups: (root, generator rows, kept rows of the live files)."""
    root = tmp_path_factory.mktemp("cb") / "hits"
    root.mkdir()
    n = sum(r for _, r in CB_FILES)
    rows = clickbench_rows(n)
    lo, kept = 0, 0
    for name, k in CB_FILES:
        _, kk = write_clickbench(str(root / name), k,
                                 rows=slice_rows(rows, lo, lo + k),
                                 row_group_rows=CB_GROUP_ROWS)
        if "stale" not in name:
            kept += kk
        lo += k
    write_log(str(root), [
        [{"metaData": {"id": "hits"}}, {"add": {"path": "hits-0.parquet"}},
         {"add": {"path": "hits-stale.parquet"}}],
        [{"add": {"path": "hits-1.parquet"}},
         {"remove": {"path": "hits-stale.parquet"}},
         {"commitInfo": {"operation": "WRITE"}}]])
    return root, rows, kept


@pytest.fixture()
def fake_s3():
    fake = FakeS3(public_read=True).start()
    yield fake
    fake.stop()


def upload_dir(fake, root, prefix: str) -> str:
    """Every file under root into the fake bucket under prefix; the
    table's s3:// path."""
    for d, _, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(os.path.join(d, n), root)
            with open(os.path.join(d, n), "rb") as fh:
                fake.put_object(f"{prefix}/{rel}", fh.read())
    return f"s3://{BUCKET}/{prefix}"


def port_params(path: str, fake=None, **kw):
    if fake is not None:
        kw["endpoint_url"] = fake.endpoint
    return port_misc.DeltaSourceParams(path=path, **kw)


def rows_of(batch) -> list:
    return [tuple(it.as_dict().items()) for it in batch.to_rows()]


def storage_view(pkg: str, params) -> dict:
    """What a package's DeltaStorage gives: the live files (relative to
    the table root), table_list, the schema and every batch."""
    m = PKG[pkg]
    st = m["misc"].DeltaStorage(params)
    files = st._resolve()
    root = files[0].rsplit("/", 1)[0]
    info = st.table_list()[st.table]
    got = []
    st.load_table(m["TD"](id=st.table), got.append)
    return {"files": [f[len(root) + 1:] for f in files],
            "eta": info.eta_rows,
            "schema": st.table_schema(st.table).to_json(),
            "counts": [st.file_row_count(f) for f in files],
            "cuts": [b.n_rows for b in got],
            "rows": [rows_of(b) for b in got]}


# -- the storage ---------------------------------------------------------------

@pytest.mark.parametrize("where", ["dir", "file", "s3"])
def test_storage_on_the_jax_fixture_equals_jax(delta_dir, where, fake_s3):
    want = storage_view("jax", ref_misc.DeltaSourceParams(
        path=str(delta_dir), table="dt"))
    path = {"dir": str(delta_dir), "file": f"file://{delta_dir}",
            "s3": None}[where]
    if path is None:
        path = upload_dir(fake_s3, delta_dir, "dtable")
    got = storage_view("port", port_params(
        path, fake_s3 if where == "s3" else None, table="dt"))
    assert got == want
    assert got["files"] == ["part-0.parquet", "part-1.parquet"]
    assert got["eta"] == 5 and got["cuts"] == [3, 2]


@pytest.mark.parametrize("batch_rows", [65_536, 20_000, 7_777])
@pytest.mark.parametrize("where", ["dir", "s3"])
def test_clickbench_batches_cut_across_row_groups_as_jax(cb_dir, batch_rows,
                                                         where, fake_s3):
    root, _, _ = cb_dir
    want = storage_view("jax", ref_misc.DeltaSourceParams(
        path=str(root), table="hits", batch_rows=batch_rows))
    path = str(root) if where == "dir" else upload_dir(fake_s3, root, "cb")
    got = storage_view("port", port_params(
        path, fake_s3 if where == "s3" else None, table="hits",
        batch_rows=batch_rows))
    assert got["cuts"] == want["cuts"]
    assert got["files"] == want["files"] == ["hits-0.parquet",
                                             "hits-1.parquet"]
    assert got["eta"] == want["eta"] == 110_000
    assert got == want
    if batch_rows == 65_536:
        # pyarrow's iter_batches runs across the 30,000-row groups
        assert got["cuts"] == [65_536, 4_464, 40_000]


def test_read_bytes_is_the_decoded_columns_bytes(cb_dir):
    """A difference to the reference, pinned (ROADMAP.md C's notes): a
    batch's `read_bytes` is its decoded columns' bytes
    (`ColumnBatch.nbytes`, as the JAX package's own native Parquet route
    in `providers/file.py` counts them); the JAX Delta source counts
    arrow's `RecordBatch.nbytes` (validity bitmaps arrow allocates, int32
    string offsets, a batch's own copy of the values).  Rows and cuts
    are equal (above)."""
    root, _, _ = cb_dir
    got, want = [], []
    port_misc.DeltaStorage(port_params(str(root), table="hits")).load_table(
        TableDescription(id=TableID("", "hits")), got.append)
    ref_misc.DeltaStorage(ref_misc.DeltaSourceParams(
        path=str(root), table="hits")).load_table(
        RefTableDescription(id=RefTableID("", "hits")), want.append)
    assert [b.read_bytes for b in got] == [b.nbytes() for b in got]
    rbs = [rb for f in ("hits-0.parquet", "hits-1.parquet")
           for rb in pq.ParquetFile(root / f).iter_batches(65_536)]
    assert [b.read_bytes for b in want] == [rb.nbytes for rb in rbs]
    assert [b.n_rows for b in got] == [rb.num_rows for rb in rbs]
    assert [b.read_bytes for b in got] != [b.read_bytes for b in want]


@pytest.mark.parametrize("versions,match", [
    (None, "delta source: no _delta_log under"),
    ([], "has no live files"),
    ([[{"add": {"path": "a.parquet"}}], [{"remove": {"path": "a.parquet"}}]],
     "has no live files"),
])
@pytest.mark.parametrize("where", ["dir", "s3"])
def test_error_texts_equal_jax(tmp_path, versions, match, where, fake_s3):
    root = tmp_path / "t"
    root.mkdir()
    (root / "readme.txt").write_text("not a table")
    if versions is not None:
        write_log(str(root), versions)
        if not versions:
            (root / "_delta_log" / "_last_checkpoint").write_text("{}")
    msgs = []
    with pytest.raises(FileNotFoundError, match=match) as e:
        ref_misc.DeltaStorage(ref_misc.DeltaSourceParams(
            path=str(root)))._resolve()
    msgs.append(str(e.value))
    path = str(root) if where == "dir" else upload_dir(fake_s3, root, "t")
    with pytest.raises(FileNotFoundError, match=match) as e:
        port_misc.DeltaStorage(port_params(
            path, fake_s3 if where == "s3" else None))._resolve()
    if where == "dir":
        msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    else:
        assert repr(path) in str(e.value)


# -- the snapshot provider -----------------------------------------------------

def provider_view(pkg: str, path: str) -> dict:
    m = PKG[pkg]
    sp = m["misc"].DeltaSnapshotProvider(m["misc"].DeltaSourceParams(
        path=path, table="dt"))
    sp.init()
    sp.begin_snapshot()
    objects = sp.data_objects()
    tid = m["TableID"]("", "dt")
    assert list(objects) == [tid]
    parts = objects[tid]
    tds = sp.data_objects_to_table_parts()
    back = sp.table_part_to_data_object_part(tds[0])
    assert back.part_key == tds[0].filter
    assert sp.data_objects([m["TableID"]("", "other")]) == {}
    events = []

    class Capture(_capture_base(pkg)):
        def async_push(self, evs):
            import concurrent.futures

            events.extend(evs)
            f = concurrent.futures.Future()
            f.set_result(None)
            return f

    progress = []
    for part in parts:
        source = sp.create_snapshot_source(part)
        assert not source.progress().done and not source.running()
        source.start(Capture())
        p = source.progress()
        progress.append((p.done, p.current, p.total))
    sp.end_snapshot()
    return {"parts": [(os.path.basename(p.part_key), p.eta_rows)
                      for p in parts],
            "schema": [c.name for c in sp.table_schema(parts[0])],
            "tds": [(os.path.basename(t.filter), t.eta_rows) for t in tds],
            "progress": progress,
            "events": [(type(e).__name__, rows_of(e.batch))
                       for e in events]}


def _capture_base(pkg):
    if pkg == "port":
        return EventTarget
    from transferia_tpu.events.pipeline import EventTarget as RefTarget

    return RefTarget


def test_snapshot_provider_contract_and_progress_equal_jax(delta_dir):
    got = provider_view("port", str(delta_dir))
    assert got == provider_view("jax", str(delta_dir))
    assert got["parts"] == [("part-0.parquet", 3), ("part-1.parquet", 2)]
    assert got["progress"] == [(True, 3, 3), (True, 2, 2)]
    assert {e[0] for e in got["events"]} == {"InsertBatchEvent"}


def test_file_list_is_pinned_for_the_snapshot(delta_dir):
    """begin_snapshot resolves the log once: a version committed
    mid-load is not read until end_snapshot."""
    sp = port_misc.DeltaSnapshotProvider(port_params(str(delta_dir),
                                                     table="dt"))
    sp.begin_snapshot()
    pq.write_table(pa.table({"id": [6], "name": ["f"]}),
                   delta_dir / "part-2.parquet")
    write_log(str(delta_dir), [
        [{"add": {"path": "part-0.parquet"}},
         {"add": {"path": "part-stale.parquet"}}],
        [{"add": {"path": "part-1.parquet"}},
         {"remove": {"path": "part-stale.parquet"}}],
        [{"add": {"path": "part-2.parquet"}}]])
    tid = TableID("", "dt")
    assert len(sp.data_objects()[tid]) == 2
    sp.end_snapshot()
    assert len(sp.data_objects()[tid]) == 3


# -- upload_v2 and the activation ------------------------------------------------

def ch_upload(pkg: str, path: str, transformation=None) -> dict:
    m = PKG[pkg]
    ch = m["CH"]().start()
    try:
        t = m["Transfer"](
            id="a2-delta-ch",
            src=m["misc"].DeltaSourceParams(path=path, table="dt"),
            dst=m["CHParams"](host="127.0.0.1", port=ch.port,
                              bufferer=None),
            transformation=transformation)
        n = m["upload_v2"](t, m["cp"](), m["misc"].DeltaSnapshotProvider(
            t.src))
        verbs = [q.split()[0].upper() for q in ch.queries
                 if q.split()[0].upper() in ("CREATE", "INSERT")]
        return {"rows_moved": n, "verbs": verbs,
                "rows": sorted(tuple(sorted(r.items()))
                               for r in ch.rows("dt"))}
    finally:
        ch.stop()


def test_upload_v2_into_the_native_ch_target_equals_jax(delta_dir):
    got = ch_upload("port", str(delta_dir))
    assert got == ch_upload("jax", str(delta_dir))
    assert got["rows_moved"] == 5
    assert [r[0][1] for r in got["rows"]] == [1, 2, 3, 4, 5]
    # the Init event's DDL arrived before the first insert
    assert got["verbs"] == ["CREATE", "INSERT", "INSERT"]


def test_upload_v2_bridged_with_a_transformation_equals_jax(delta_dir):
    chain = {"transformers": [{"filter_rows": {"filter": "id <> 2"}}]}
    got = ch_upload("port", str(delta_dir), chain)
    assert got == ch_upload("jax", str(delta_dir), chain)
    assert [r[0][1] for r in got["rows"]] == [1, 3, 4, 5]


def test_make_event_target_routes(delta_dir):
    from transferia_tpu_torch.events import EventTargetOverAsyncSink
    from transferia_tpu_torch.providers.clickhouse.a2 import CHEventTarget
    from transferia_tpu_torch.tasks.snapshot_v2 import make_event_target

    src = port_params(str(delta_dir), table="dt")
    ch = CHTargetParams(host="127.0.0.1", port=1, bufferer=None)
    native = make_event_target(Transfer(id="r1", src=src, dst=ch),
                               device="cpu")
    assert isinstance(native, CHEventTarget)
    native.close()
    bridged = make_event_target(Transfer(
        id="r2", src=src, dst=ch, transformation={"transformers": [
            {"filter_rows": {"filter": "id > 3"}}]}), device="cpu")
    assert isinstance(bridged, EventTargetOverAsyncSink)
    bridged.close()
    mem = make_event_target(Transfer(
        id="r3", src=src, dst=port_memory.MemoryTargetParams(sink_id="r3")),
        device="cpu")
    assert isinstance(mem, EventTargetOverAsyncSink)
    mem.close()


def memory_activation(pkg: str, path: str, sink: str,
                      transformation=None) -> dict:
    m = PKG[pkg]
    store = m["memory"].get_store(sink)
    store.clear()
    t = m["Transfer"](
        id=sink, src=m["misc"].DeltaSourceParams(path=path, table="dt"),
        dst=m["memory"].MemoryTargetParams(sink_id=sink),
        transformation=transformation)
    m["activate"](t, m["cp"]())
    return {"rows": [tuple(it.as_dict().items()) for it in store.rows()],
            "controls": [(e.kind.value, e.table) for e in
                         store.control_events()]}


def test_activate_routes_through_the_event_pipeline_as_jax(delta_dir):
    got = memory_activation("port", str(delta_dir), "a2_bridge")
    assert got == memory_activation("jax", str(delta_dir), "a2_bridge")
    assert len(got["rows"]) == 5
    assert got["controls"] == [("init_load_table", "dt"),
                               ("done_load_table", "dt")]


def test_transformation_routes_through_the_v1_stack_as_jax(delta_dir):
    """A configured transformer forces the bridged v1 path even with a
    native target, in both packages: the filter really ran."""
    got = {}
    for pkg in ("port", "jax"):
        m = PKG[pkg]
        ch = m["CH"]().start()
        try:
            t = m["Transfer"](
                id="a2-transform",
                src=m["misc"].DeltaSourceParams(path=str(delta_dir),
                                                table="dt"),
                dst=m["CHParams"](host="127.0.0.1", port=ch.port,
                                  bufferer=None),
                transformation={"transformers": [
                    {"filter_rows": {"filter": "id > 3"}}]})
            m["activate"](t, m["cp"]())
            got[pkg] = sorted(r["id"] for r in ch.rows("dt"))
        finally:
            ch.stop()
    assert got["port"] == got["jax"] == [4, 5]


def test_bench_chain_on_the_cpu_equals_jax(cb_dir):
    """bench.py's mask and filter behind the bridge, `device="cpu"` in the
    port: the kept rows equal the JAX package's, and numpy's count."""
    root, rows, kept = cb_dir
    got = {}
    for pkg in ("port", "jax"):
        m = PKG[pkg]
        store = m["memory"].get_store("a2_bench")
        store.clear()
        t = m["Transfer"](
            id="a2-bench", src=m["misc"].DeltaSourceParams(
                path=str(root), table="hits"),
            dst=m["memory"].MemoryTargetParams(sink_id="a2_bench"),
            transformation=BENCH_CHAIN)
        m["activate"](t, m["cp"]())
        got[pkg] = [tuple(it.as_dict().items()) for it in store.rows()]
    assert got["port"] == got["jax"]
    assert len(got["port"]) == kept > 0
    urls = [dict(r)["URL"] for r in got["port"][:3]]
    assert all(len(u) == 64 and int(u, 16) >= 0 for u in urls)


# -- SNAPSHOT_AND_INCREMENT --------------------------------------------------------

def test_snapshot_and_increment_on_delta_aborts_as_jax(delta_dir):
    """A Delta schema carries no primary key, and S&I replication needs
    one: both packages abort before the upload (ROADMAP.md C's notes)."""
    msgs = []
    for pkg, err in (("port", AbortTransferError),
                     ("jax", RefAbortTransferError)):
        m = PKG[pkg]
        t = m["Transfer"](
            id="dl-sni", type=(TransferType if pkg == "port"
                               else RefTransferType).SNAPSHOT_AND_INCREMENT,
            src=m["misc"].DeltaSourceParams(path=str(delta_dir),
                                            table="dt"),
            dst=m["memory"].MemoryTargetParams(sink_id="dl_sni"))
        with pytest.raises(err, match="replication requires primary") as e:
            m["activate"](t, m["cp"]())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _keyed_provider(pkg: str):
    """A `delta_keyed` provider in a package's registries: the Delta
    source with `id` declared the key, so that an S&I activation reaches
    the event-model branch."""
    m = PKG[pkg]
    misc = m["misc"]
    endpoint = port_endpoint if pkg == "port" else ref_endpoint
    registry = port_registry if pkg == "port" else ref_registry

    @endpoint.register_endpoint
    @dataclass
    class KeyedParams(misc.DeltaSourceParams):
        PROVIDER = "delta_keyed"

    class KeyedStorage(misc.DeltaStorage):
        def table_schema(self, table):
            from dataclasses import replace

            schema = super().table_schema(table)
            return type(schema)([replace(c, primary_key=c.name == "id")
                                 for c in schema])

    class KeyedSnapshot(misc.DeltaSnapshotProvider):
        def __init__(self, params):
            super().__init__(params)
            self.storage = KeyedStorage(params)

    @registry.register_provider
    class KeyedProvider(misc.DeltaProvider):
        NAME = "delta_keyed"

        def storage(self):
            return KeyedStorage(self.transfer.src)

        def snapshot_provider(self):
            return KeyedSnapshot(self.transfer.src)

    return KeyedParams


def test_snapshot_and_increment_takes_the_event_pipeline_as_jax(
        delta_dir, monkeypatch):
    """With the MVCC coordinator, S&I takes the event-model upload, not
    the MVCC cutover, when the source has a snapshot provider."""
    got = {}
    for pkg, runner in (("port", port_mvcc_runner),
                        ("jax", ref_mvcc_runner)):
        def no_cutover(*a, **kw):
            raise AssertionError("the MVCC cutover ran")

        monkeypatch.setattr(runner, "activate_snapshot_and_increment",
                            no_cutover)
        m = PKG[pkg]
        params = _keyed_provider(pkg)
        store = m["memory"].get_store("dl_sni_keyed")
        store.clear()
        cp = m["cp"]()
        assert cp.supports_mvcc()
        t = m["Transfer"](
            id="dl-sni-k", type=(TransferType if pkg == "port"
                                 else RefTransferType).SNAPSHOT_AND_INCREMENT,
            src=params(path=str(delta_dir), table="dt"),
            dst=m["memory"].MemoryTargetParams(sink_id="dl_sni_keyed"))
        m["activate"](t, cp)
        got[pkg] = ([tuple(it.as_dict().items()) for it in store.rows()],
                    [e.kind.value for e in store.control_events()],
                    cp.get_transfer_state("dl-sni-k"))
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 5


# -- the CLI -------------------------------------------------------------------

def run_cli(pkg: str, argv: list) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        if pkg == "port":
            rc = port_main.main(["--device", "cpu", "--log-level", "error"]
                                + argv)
        else:
            rc = ref_main.main(["--log-level", "error"] + argv)
    return rc, out.getvalue(), err.getvalue()


DELTA_YAML = """\
id: delta-yaml
type: SNAPSHOT_ONLY
src:
  type: delta
  params:
    path: "{path}"
    table: hits
    batch_rows: {batch_rows}{extra}
dst:
  type: {dst}
  params:
{dst_params}
transformation:
  transformers:
    - mask_field: {{columns: [URL], salt: bench-salt}}
    - filter_rows: {{filter: "RegionID < 400 AND ResolutionWidth >= 390"}}
"""


def delta_yaml(tmp_path, name: str, path: str, dst: str, dst_params: str,
               fake=None, batch_rows: int = 65_536) -> str:
    extra = "" if fake is None else \
        f'\n    endpoint_url: "{fake.endpoint}"\n    anon: true'
    p = tmp_path / name
    p.write_text(DELTA_YAML.format(path=path, batch_rows=batch_rows,
                                   extra=extra, dst=dst,
                                   dst_params=dst_params))
    return str(p)


@pytest.mark.parametrize("where", ["dir", "s3"])
def test_cli_activate_on_a_delta_yaml_equals_jax(cb_dir, tmp_path, where,
                                                  fake_s3):
    root, _, kept = cb_dir
    want_yaml = delta_yaml(tmp_path, "jax.yaml", str(root), "memory",
                           "    sink_id: cli_delta")
    path = str(root) if where == "dir" else upload_dir(fake_s3, root, "cb")
    got_yaml = delta_yaml(tmp_path, "port.yaml", path, "memory",
                          "    sink_id: cli_delta",
                          fake_s3 if where == "s3" else None)
    got = {}
    for pkg, mem, yaml in (("port", port_memory, got_yaml),
                           ("jax", ref_memory, want_yaml)):
        mem.get_store("cli_delta").clear()
        rc, out, _ = run_cli(pkg, ["activate", "--transfer", yaml])
        got[pkg] = (rc, out, [tuple(it.as_dict().items())
                              for it in mem.get_store("cli_delta").rows()])
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and len(got["port"][2]) == kept


def test_cli_validate_and_bigquery_refusal(cb_dir, tmp_path):
    root, _, _ = cb_dir
    yaml = delta_yaml(tmp_path, "v.yaml", str(root), "memory",
                      "    sink_id: cli_delta_v")
    rc, out, _ = run_cli("port", ["validate", "--transfer", yaml])
    assert rc == 0 and "OK" in out
    bq = tmp_path / "bq.yaml"
    bq.write_text(f'id: bq\nsrc: {{type: delta, params: {{path: "{root}"}}}}'
                  "\ndst: {type: bigquery, params: {project: p}}\n")
    from transferia_tpu_torch.cli.config import ConfigError, load_transfer

    with pytest.raises(ConfigError, match="bigquery.*ROADMAP.md A7, "
                                          "blocked"):
        load_transfer(str(bq))


@pytest.mark.parametrize("method", ["compare", "fingerprint"])
def test_cli_checksum_of_a_delta_source_equals_jax(delta_dir, tmp_path,
                                                   method):
    """The JAX checksum accepts a Delta source against its ClickHouse
    target, and the port's gives the same reports.  The Delta source
    counts no rows (it has no `estimate_table_rows_count`), so against
    ClickHouse both report "row counts differ: src=0" and exit 1 on a
    clean target (ROADMAP.md C's notes); the digests and values agree,
    and a value altered in the target adds its difference."""
    got = {}
    for pkg in ("port", "jax"):
        m = PKG[pkg]
        ch = m["CH"]().start()
        try:
            yaml = tmp_path / f"{pkg}-{method}.yaml"
            yaml.write_text(
                "id: dl-ck\nsrc:\n  type: delta\n  params:\n"
                f'    path: "{delta_dir}"\n    table: dt\n'
                "dst:\n  type: ch\n  params:\n    host: 127.0.0.1\n"
                f"    port: {ch.port}\n")
            rc_act, _, _ = run_cli(pkg, ["activate", "--transfer",
                                         str(yaml)])
            argv = ["checksum", "--transfer", str(yaml), "--method", method]
            if method == "fingerprint":
                argv += ["--fingerprint-backend", "device"]
            clean = run_cli(pkg, argv)
            with ch.lock:
                row = min(ch.tables["dt"]["rows"], key=lambda r: r["id"])
                row["name"] = b"altered"
            altered = run_cli(pkg, argv)
            got[pkg] = (rc_act, clean, altered)
        finally:
            ch.stop()
    assert got["port"] == got["jax"]
    rc_act, (rc, out, _), (rc_alt, out_alt, _) = got["port"]
    assert (rc_act, rc, rc_alt) == (0, 1, 1)
    assert "row counts differ: src=0 dst=5" in out and "diffs=1" in out
    assert "diffs=1" not in out_alt
