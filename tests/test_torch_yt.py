"""The port's YTsaurus provider (`transferia_tpu_torch/providers/yt/`: the
HTTP-proxy client, the static-table source with row-range shards, the
static-table sink and the dynamic-table sink) against the JAX package's,
on the CPU, exactly.

- The two fakes speak one protocol: the port's client against the JAX
  package's fake (`tests/recipes/fake_yt.py`) and the JAX client against
  the port's (`recipes/fake_yt.py`), every command the client sends.
- The cases of `tests/e2e/test_yt_e2e.py` and
  `tests/e2e/test_yt_dynamic_e2e.py`, each package against its own fake:
  the snapshot to memory over range shards, discovery and schema, the
  static sink with DROP and TRUNCATE cleanup, YT -> YT with `string`
  columns of arbitrary bytes 0-255 (latin-1 on the JSON wire), OAuth; the
  dynamic sink's create/mount lifecycle, upserts and deletes in arrival
  order, a key-changing UPDATE as a delete and an upsert, the split at
  tablet pivots, the pivot cache dropped on a failed write, ordered
  append and cleanup: equal final tables (rows, schema, attributes).
- The slice through the chain: YT -> mask on a utf8 column + an int32
  filter -> memory, byte-identical to the JAX package's run on the CPU.
"""

import struct

import numpy as np
import pytest

from tests.recipes import fake_yt as ref_fake
from tests.torch_quiescent import ledger_quiescent  # noqa: F401
from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.change_item import OldKeys as RefOldKeys
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import ColSchema as RefCol
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import TableSchema as RefSchema
from transferia_tpu.abstract.table import TableDescription as RefTD
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import CleanupPolicy as RefCleanup
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import (
    ShardingUploadParams as RefSharding,
)
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.sample import (
    SampleSourceParams as RefSampleParams,
)
from transferia_tpu.providers.yt import client as ref_client
from transferia_tpu.providers.yt import provider as ref_provider
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import CleanupPolicy, Transfer, TransferType
from transferia_tpu_torch.models.transfer import (
    Runtime,
    ShardingUploadParams,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.providers.yt import client as port_client
from transferia_tpu_torch.providers.yt import provider as port_provider
from transferia_tpu_torch.recipes import fake_yt as port_fake
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.transform import fused as port_tfused

CPU = {"device": "cpu"}
PKGS = {
    "port": dict(client=port_client, provider=port_provider, fake=port_fake,
                 memory=port_memory, transfer=Transfer, ttype=TransferType,
                 cleanup=CleanupPolicy, coordinator=MemoryCoordinator,
                 activate=activate_delivery, runtime=Runtime,
                 sharding=ShardingUploadParams, sample=SampleSourceParams,
                 tid=TableID, td=TableDescription, item=ChangeItem,
                 old_keys=OldKeys, kind=Kind, ct=CanonicalType,
                 col=ColSchema, schema=TableSchema, batch=ColumnBatch,
                 fused=port_tfused, kw=CPU),
    "jax": dict(client=ref_client, provider=ref_provider, fake=ref_fake,
                memory=ref_memory, transfer=RefTransfer,
                ttype=RefTransferType, cleanup=RefCleanup,
                coordinator=RefCoordinator, activate=ref_activate,
                runtime=RefRuntime, sharding=RefSharding,
                sample=RefSampleParams, tid=RefTableID, td=RefTD,
                item=RefItem, old_keys=RefOldKeys, kind=RefKind,
                ct=RefCT, col=RefCol, schema=RefSchema, batch=RefBatch,
                fused=ref_tfused, kw={}),
}

USERS_SCHEMA = [
    {"name": "id", "type": "int64", "sort_order": "ascending"},
    {"name": "name", "type": "utf8"},
    {"name": "payload", "type": "string"},
    {"name": "score", "type": "double"},
    {"name": "ok", "type": "boolean"},
    {"name": "region", "type": "int32"},
]


def users(n: int, seed: int = 3) -> list:
    """`n` rows; `payload` holds 0-40 arbitrary bytes (every value 0-255
    appears), as the YT JSON wire carries them: latin-1 text."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 41, n)
    blob = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    k = min(256, blob.size)
    blob[:k] = np.arange(k, dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    region = rng.integers(0, 1000, n)
    return [{"id": i, "name": f"user-{i}@example.test",
             "payload": bytes(blob[offs[i]:offs[i + 1]]).decode("latin-1"),
             "score": i * 0.5, "ok": i % 2 == 0,
             "region": int(region[i])} for i in range(n)]


@pytest.fixture
def fakes():
    srvs = {pkg: PKGS[pkg]["fake"].FakeYT().start() for pkg in PKGS}
    yield srvs
    for s in srvs.values():
        s.stop()


def proxy(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def canon(v):
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float):
        return ("f", struct.pack(">d", v))
    if isinstance(v, dict):
        return {k: canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(canon(x) for x in v)
    if type(v).__name__ == "Kind":
        return v.value
    return v


def node_state(srv, prefix: str, by: str = "") -> dict:
    """Every node under `prefix`: type, attributes and rows (sorted by
    column `by` where parts landed from parallel threads)."""
    def rows(n):
        if by and n.get("rows") is not None:
            return canon(sorted(n["rows"], key=lambda r: r[by]))
        return canon(n.get("rows"))

    if hasattr(srv, "sync_rows"):   # the port's fake orders on read
        srv.sync_rows()
    return {p: (n["type"], canon(n["attrs"]), rows(n))
            for p, n in srv.nodes.items() if p.startswith(prefix)}


def batch_key(b) -> tuple:
    return (str(b.table_id),
            tuple((c.name, c.data_type.value, c.primary_key)
                  for c in b.schema.columns), canon(b.to_pydict()))


# -- the client, across the fakes ---------------------------------------------

@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_client_against_either_fake(client, server, fakes):
    mod = PKGS[client]["client"]
    srv = fakes[server]
    c = mod.YTClient(f"http://{proxy(srv)}")
    assert (c.host, c.port, c.secure) == ("127.0.0.1", srv.port, False)
    rows = users(50)
    c.create("table", "//home/db/users",
             attributes={"schema": USERS_SCHEMA}, recursive=True)
    c.create("table", "//home/db/users", ignore_existing=True)
    with pytest.raises(mod.YTError, match="400"):
        c.create("table", "//home/db/users")
    c.write_table("//home/db/users", rows[:30])
    c.write_table("//home/db/users", rows[30:])
    assert c.get("//home/db/users/@row_count") == 50
    assert c.get("//home/db/@type") == "map_node"
    assert c.list("//home/db") == ["users"] and c.exists("//home/db/users")
    assert c.get("//home/nope/@type", default=None) is None
    with pytest.raises(mod.YTError, match="404"):
        c.get("//home/nope/@type")
    got = [r for chunk in c.read_table("//home/db/users[#10:#20]",
                                       batch_rows=3) for r in chunk]
    assert got == rows[10:20]
    assert [len(b) for b in c.read_table("//home/db/users",
                                         batch_rows=16)] == [16, 16, 16, 2]
    c.write_table("//home/db/users", rows[:5], append=False)
    assert c.get("//home/db/users/@row_count") == 5
    c.set("//home/db/users/@note", {"a": [1, 2]})
    assert c.get("//home/db/users/@note") == {"a": [1, 2]}
    tx = c.start_transaction()
    assert tx.startswith("tx-")
    c.commit_transaction(tx)
    c.abort_transaction(c.start_transaction())
    with pytest.raises(mod.YTError, match="400"):
        c.write_table("//home/db/users", [{"nope": 1}])
    # a dynamic table: mount, pivots, upserts, deletes
    c.create("table", "//home/dyn/t", attributes={
        "dynamic": True, "schema": USERS_SCHEMA[:2],
        "_pivot_keys_on_mount": [[], [25]]})
    assert c.tablet_state("//home/dyn/t") == "unmounted"
    with pytest.raises(mod.YTError, match="400"):
        c.insert_rows("//home/dyn/t", [{"id": 1, "name": "a"}])
    c.mount_table("//home/dyn/t")
    assert c.tablet_state("//home/dyn/t") == "mounted"
    assert c.pivot_keys("//home/dyn/t") == [[], [25]]
    c.insert_rows("//home/dyn/t", [{"id": i, "name": f"n{i}"}
                                   for i in (30, 1, 7)])
    c.insert_rows("//home/dyn/t", [{"id": 7}], update=True)
    c.delete_rows("//home/dyn/t", [{"id": 1}, {"id": 99}])
    assert [r for b in c.read_table("//home/dyn/t") for r in b] == \
        [{"id": 7, "name": "n7"}, {"id": 30, "name": "n30"}]
    c.unmount_table("//home/dyn/t")
    assert c.tablet_state("//home/dyn/t") == "unmounted"
    c.remove("//home/dyn/t")
    assert not c.exists("//home/dyn/t")
    c.ping()
    with pytest.raises(mod.YTError, match="unreachable"):
        mod.YTClient("127.0.0.1:1", timeout=2.0).ping()


def test_auth_required_equals_jax():
    for pkg in PKGS:
        srv = PKGS[pkg]["fake"].FakeYT(token="sekret").start()
        mod = PKGS[pkg]["client"]
        try:
            srv.add_table("//home/db/users", USERS_SCHEMA, users(5))
            with pytest.raises(mod.YTError, match="401"):
                mod.YTClient(proxy(srv)).list("//home/db")
            ok = mod.YTClient(proxy(srv), token="sekret")
            assert ok.list("//home/db") == ["users"]
        finally:
            srv.stop()


# -- the static source --------------------------------------------------------

def test_snapshot_to_memory_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        srv.add_table("//home/db/users", USERS_SCHEMA, users(500))
        store = p["memory"].get_store(f"yt1-{pkg}")
        store.clear()
        t = p["transfer"](
            id="yt1", type=p["ttype"].SNAPSHOT_ONLY,
            src=p["provider"].YTSourceParams(
                proxy=proxy(srv), paths=["//home/db/users"], batch_rows=128,
                desired_part_rows=200),
            dst=p["memory"].MemoryTargetParams(sink_id=f"yt1-{pkg}"),
            runtime=p["runtime"](sharding=p["sharding"](process_count=2)))
        p["activate"](t, p["coordinator"](), **p["kw"])
        got[pkg] = (sorted((canon(r.as_dict()) for r in store.rows()),
                           key=lambda d: d["id"]),
                    srv.requests.count("read_table"))
        store.clear()
    assert got["port"] == got["jax"]
    rows, reads = got["port"]
    assert [d["id"] for d in rows] == list(range(500)) and reads == 3
    want = users(500)
    assert all(d["payload"] == want[d["id"]]["payload"].encode("latin-1")
               for d in rows)


def test_storage_discovery_shards_and_schema_equal_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        srv.add_table("//home/db/users", USERS_SCHEMA, users(450))
        srv.add_table("//home/db/other", USERS_SCHEMA[:2], [])
        srv.nodes["//home/db/dir"] = {"type": "map_node", "attrs": {}}
        st = p["provider"].YTStorage(p["provider"].YTSourceParams(
            proxy=proxy(srv), paths=["//home/db"], desired_part_rows=200,
            batch_rows=64))
        tid = p["tid"]("//home/db", "users")
        tables = st.table_list()
        parts = st.shard_table(p["td"](id=tid))
        loaded = []
        for part in parts:
            out = []
            st.load_table(part, out.append)
            loaded.append((part.filter, part.eta_rows,
                           [batch_key(b) for b in out]))
        got[pkg] = (sorted((str(k), v.eta_rows, v.schema.to_json())
                           for k, v in tables.items()),
                    st.exact_table_rows_count(tid), st.table_exists(tid),
                    loaded,
                    st.shard_table(p["td"](id=p["tid"]("//home/db",
                                                       "other")))[0].filter)
        with pytest.raises(p["client"].YTError, match="does not exist"):
            p["provider"].YTStorage(p["provider"].YTSourceParams(
                proxy=proxy(srv), paths=["//nope"])).table_list()
    assert got["port"] == got["jax"]
    _, count, exists, loaded, whole = got["port"]
    assert count == 450 and exists and whole == ""
    assert [f for f, _, _ in loaded] == ["rows:0:200", "rows:200:400",
                                         "rows:400:450"]


# -- the static sink ----------------------------------------------------------

def sample_into(pkg: str, srv, dst_dir: str, policy=None, rows: int = 300):
    p = PKGS[pkg]
    kw = {} if policy is None else {"cleanup_policy": policy}
    t = p["transfer"](
        id="yt2", type=p["ttype"].SNAPSHOT_ONLY,
        src=p["sample"](preset="users", table="users", rows=rows,
                        batch_rows=100),
        dst=p["provider"].YTStaticTargetParams(proxy=proxy(srv),
                                               dir=dst_dir, **kw))
    p["activate"](t, p["coordinator"](), **p["kw"])


@pytest.mark.parametrize("policy", ["drop", "truncate"])
def test_static_sink_and_cleanup_equal_jax(fakes, policy):
    got = {}
    for pkg, srv in fakes.items():
        pol = PKGS[pkg]["cleanup"](policy)
        sample_into(pkg, srv, "//home/sink", pol)
        first = node_state(srv, "//home/sink", by="user_id")
        sample_into(pkg, srv, "//home/sink", pol)
        got[pkg] = (first, node_state(srv, "//home/sink", by="user_id"))
    assert got["port"] == got["jax"]
    first, second = got["port"]
    assert first == second
    (kind, attrs, rows), = [v for k, v in second.items()
                            if k.endswith("/users")]
    assert kind == "table" and len(rows) == 300
    assert sorted(r["user_id"] for r in rows) == list(range(300))


def test_yt_to_yt_binary_strings_round_trip_equal_jax(fakes):
    """Every byte 0-255 in a `string` column crosses the JSON wire as
    latin-1 and lands exactly; a rerun under TRUNCATE leaves one copy."""
    got = {}
    src_rows = users(300, seed=8)
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        srv.add_table("//home/db/users", USERS_SCHEMA, src_rows)
        t = p["transfer"](
            id="yt3", type=p["ttype"].SNAPSHOT_ONLY,
            src=p["provider"].YTSourceParams(
                proxy=proxy(srv), paths=["//home/db/users"],
                desired_part_rows=128, batch_rows=50),
            dst=p["provider"].YTStaticTargetParams(
                proxy=proxy(srv), dir="//home/copy",
                cleanup_policy=p["cleanup"].TRUNCATE))
        p["activate"](t, p["coordinator"](), **p["kw"])
        p["activate"](t, p["coordinator"](), **p["kw"])
        got[pkg] = node_state(srv, "//home/copy", by="id")
    assert got["port"] == got["jax"]
    _, attrs, rows = got["port"]["//home/copy/users"]
    assert attrs["schema"][0] == canon({"name": "id", "type": "int64",
                                        "sort_order": "ascending"})
    assert rows == tuple(canon(r) for r in src_rows)


# -- the dynamic sink ---------------------------------------------------------

def dyn_schema(pkg: str):
    p = PKGS[pkg]
    ct = p["ct"]
    return p["schema"]([
        p["col"]("id", ct.INT64, primary_key=True, required=True),
        p["col"]("name", ct.UTF8), p["col"]("score", ct.DOUBLE),
        p["col"]("blob", ct.STRING)])


def dyn_item(pkg: str, kind: str, id_, name=None, score=None, old_id=None,
             blob=None):
    p = PKGS[pkg]
    old = (p["old_keys"](key_names=("id",), key_values=(old_id,))
           if old_id is not None else p["old_keys"]((), ()))
    return p["item"](kind=p["kind"](kind), schema="db", table="users",
                     column_names=("id", "name", "score", "blob"),
                     column_values=(id_, name, score, blob),
                     table_schema=dyn_schema(pkg), old_keys=old)


def dyn_sink(pkg: str, srv, **kw):
    p = PKGS[pkg]["provider"]
    return p.YTDynamicSinker(p.YTDynamicTargetParams(
        proxy=proxy(srv), dir="//home/sink", **kw))


def test_dyntable_lifecycle_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        sink = dyn_sink(pkg, srv, tablet_count=4)
        ct = p["ct"]
        sink.push(p["batch"].from_pydict(
            p["tid"]("db", "users"), dyn_schema(pkg),
            {"id": [1, 2, 3], "name": ["a", "b", "c"],
             "score": [1.5, 2.5, float("nan")],
             "blob": [b"\x00\xff", None, bytes(range(200, 256))]}))
        states = [node_state(srv, "//home/sink")]
        sink.push([
            dyn_item(pkg, "update", 2, "b2", 9.0, old_id=2),
            dyn_item(pkg, "delete", 1, old_id=1),
            dyn_item(pkg, "insert", 1, "a-again", 0.5),
            dyn_item(pkg, "insert", 4, "d", 4.5, blob=b"\x80"),
            # a key-changing UPDATE: the old key's row goes
            dyn_item(pkg, "update", 7, "c-moved", 3.5, old_id=3),
            dyn_item(pkg, "delete", 99, old_id=99),
        ])
        states.append(node_state(srv, "//home/sink"))
        sink.push([dyn_item(pkg, "delete", 4, old_id=4),
                   dyn_item(pkg, "delete", None, old_id=None)])
        states.append(node_state(srv, "//home/sink"))
        sink.push([])
        assert ct.STRING
        got[pkg] = states
    assert got["port"] == got["jax"]
    _, attrs, _ = got["port"][0]["//home/sink/users"]
    assert attrs["dynamic"] and attrs["tablet_state"] == "mounted"
    assert attrs["tablet_count"] == 4
    assert [c["name"] for c in attrs["schema"]] == ["id", "name", "score",
                                                    "blob"]
    rows = got["port"][1]["//home/sink/users"][2]
    assert [r["id"] for r in rows] == [1, 2, 4, 7]
    assert rows[3]["name"] == "c-moved" and rows[1]["name"] == "b2"
    assert [r["id"] for r in got["port"][2]["//home/sink/users"][2]] == \
        [1, 2, 7]


def test_dyntable_tablet_split_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        srv.nodes["//home"] = {"type": "map_node", "attrs": {}}
        srv.nodes["//home/sink"] = {"type": "map_node", "attrs": {}}
        srv.nodes["//home/sink/users"] = {
            "type": "table", "rows": [],
            "attrs": {"dynamic": True, "schema": [
                {"name": "id", "type": "int64", "sort_order": "ascending"},
                {"name": "name", "type": "utf8"},
                {"name": "score", "type": "double"},
                {"name": "blob", "type": "string"}],
                "_pivot_keys_on_mount": [[], [250], [500], [750]]}}
        sink = dyn_sink(pkg, srv, batch_rows=2)
        ids = [10, 600, 20, 990, 499, 500, 250, 249, 751, 0]
        before = len(srv.requests)
        sink.push([dyn_item(pkg, "insert", i, f"n{i}", float(i))
                   for i in ids])
        requests = srv.requests[before:]
        tid = PKGS[pkg]["tid"]("db", "users")
        chunks = sink._tablet_split(tid, "id", [{"id": i} for i in ids])
        mixed = sink._tablet_split(tid, "id", [{"id": "x"}, {"id": 3}])
        sink._pivots[tid] = [[], [1, "a"]]
        composite = sink._tablet_split(tid, "id", [{"id": 1}, {"id": 9}])
        got[pkg] = (node_state(srv, "//home/sink"), requests, chunks,
                    mixed, composite)
    assert got["port"] == got["jax"]
    state, requests, chunks, mixed, composite = got["port"]
    assert [sorted(r["id"] for r in c) for c in chunks] == \
        [[0, 10, 20, 249], [250, 499], [500, 600], [751, 990]]
    assert requests.count("insert_rows") == 5   # 2 + 1 + 1 + 1
    assert len(mixed) == 1 and len(composite) == 1


def test_dyntable_pivot_cache_dropped_on_a_failed_write_equals_jax(fakes):
    """A write that fails (the table unmounted under the sink) drops the
    cached pivots and the mounted mark; the retried push remounts and
    re-reads them."""
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        sink = dyn_sink(pkg, srv)
        tid = p["tid"]("db", "users")
        sink.push([dyn_item(pkg, "insert", 1, "a", 1.0)])
        assert tid in sink._pivots and tid in sink._ready
        srv.nodes["//home/sink/users"]["attrs"]["tablet_state"] = \
            "unmounted"
        with pytest.raises(p["client"].YTError, match="not mounted"):
            sink.push([dyn_item(pkg, "insert", 2, "b", 2.0)])
        dropped = (tid in sink._pivots, tid in sink._ready)
        sink.push([dyn_item(pkg, "insert", 2, "b", 2.0)])
        got[pkg] = (dropped, node_state(srv, "//home/sink"),
                    srv.requests.count("mount_table"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == (False, False) and got["port"][2] == 2


def test_dyntable_ordered_append_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        sink = dyn_sink(pkg, srv, ordered=True, batch_rows=2)
        sink.push([dyn_item(pkg, "insert", i, f"n{i}", float(i))
                   for i in (3, 1, 2)])
        sink.push([dyn_item(pkg, "insert", 1, "dup", 0.0)])
        got[pkg] = node_state(srv, "//home/sink")
    assert got["port"] == got["jax"]
    _, attrs, rows = got["port"]["//home/sink/users"]
    assert all("sort_order" not in c for c in attrs["schema"])
    assert [r["id"] for r in rows] == [3, 1, 2, 1]


@pytest.mark.parametrize("policy", ["drop", "truncate", "disabled"])
def test_dyn_endpoint_through_activate_and_cleanup_equal_jax(fakes, policy):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        t = p["transfer"](
            id="yt-dyn-act",
            src=p["sample"](preset="users", rows=500),
            dst=p["provider"].YTDynamicTargetParams(
                proxy=proxy(srv), dir="//home/act",
                cleanup_policy=p["cleanup"](policy)))
        p["activate"](t, p["coordinator"](), **p["kw"])
        first = node_state(srv, "//home/act", by="user_id")
        p["activate"](t, p["coordinator"](), **p["kw"])
        got[pkg] = (first, node_state(srv, "//home/act", by="user_id"),
                    srv.requests.count("remove"))
    assert got["port"] == got["jax"]
    first, second, removes = got["port"]
    (_, attrs, rows), = [v for v in first.values() if v[0] == "table"]
    assert attrs["dynamic"] and attrs["tablet_state"] == "mounted"
    assert len(rows) == 500
    assert removes == (0 if policy == "disabled" else 1)


def test_yt_provider_test_and_wiring_equal_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        srv.add_table("//home/db/users", USERS_SCHEMA, users(3))
        from importlib import import_module

        reg = import_module(p["provider"].__name__.rsplit(".", 3)[0]
                            + ".providers.registry")
        src = p["provider"].YTSourceParams(proxy=proxy(srv),
                                           paths=["//home/db"])
        dst = p["provider"].YTDynamicTargetParams(proxy=proxy(srv))
        out = []
        for name, t in (("yt", p["transfer"](id="w", src=src, dst=dst)),
                        ("yt_dyn", p["transfer"](id="w", src=src,
                                                 dst=dst))):
            kw = {"device": "cpu"} if pkg == "port" else {}
            prov = reg.get_provider(name, t, **kw)
            res = prov.test()
            out.append((type(prov.storage()).__name__,
                        type(prov.sinker()).__name__, res.ok,
                        [c[0] for c in res.checks] if hasattr(res, "checks")
                        else None))
        got[pkg] = out
    assert got["port"] == got["jax"]
    assert got["port"][0][:3] == ("YTStorage", "YTDynamicSinker", True)


# -- the slice through the chain ---------------------------------------------

CHAIN = {"transformers": [
    {"mask_field": {"columns": ["name"], "salt": "yt-salt"}},
    {"filter_rows": {"filter": "region < 400"}}]}


@pytest.mark.parametrize("placement", ["device", "host"])
def test_chain_mask_and_int32_filter_equal_jax(fakes, placement):
    got = {}
    src_rows = users(2000, seed=4)
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        srv.add_table("//home/db/users", USERS_SCHEMA, src_rows)
        sink_id = f"yt-chain-{pkg}"
        store = p["memory"].get_store(sink_id)
        store.clear()
        p["fused"].set_placement(placement)
        try:
            t = p["transfer"](
                id="yt-chain", src=p["provider"].YTSourceParams(
                    proxy=proxy(srv), paths=["//home/db/users"],
                    desired_part_rows=500, batch_rows=300),
                dst=p["memory"].MemoryTargetParams(sink_id=sink_id),
                transformation=CHAIN)
            p["activate"](t, p["coordinator"](), **p["kw"])
            got[pkg] = sorted((canon(r.as_dict()) for r in store.rows()),
                              key=lambda d: d["id"])
        finally:
            p["fused"].set_placement(None)
            store.clear()
    assert got["port"] == got["jax"]
    assert [d["id"] for d in got["port"]] == \
        [r["id"] for r in src_rows if r["region"] < 400]
    assert all(len(d["name"]) == 64 for d in got["port"])
