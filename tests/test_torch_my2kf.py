"""BASELINE config #4 (mysql2kafka): the port's MySQL snapshot source,
its Kafka sink with the transactional staged publish, and the whole
MySQL -> mask -> Debezium -> Kafka activation against the JAX
package's, on the CPU, exactly.

Each package runs against its own fake MySQL and fake Kafka.  Held
equal: the wire (native-password auth, a wrong password, both auth
tokens); `MySQLStorage` over a mixed-type table (int, bigint, varchar,
decimal, double, bigint unsigned, varbinary, json, NULLs) under keyset
paging (one key column) and OFFSET paging (a composite key), with and
without a filter: the batches, the statements sent, the catalog, counts,
`position` and the samples; a `datetime` column, which both packages
refuse alike (the text protocol's value is not an integer); the
cleanup of a MySQL target; the sink's partition choice (`_key_partitions`
over the host library's `crc32c_batch`, equal to the pure CRC32C) and
`hash_column_to_shards`; a 5,000-row activation of bench.py's
measure_mysql2kafka shape (mask, Debezium, 16 partitions) with the
emitter's clock pinned: every partition's (key, value) list, the
transactional ids and the transfer's state; and the staged publish's
epoch fence (a stale epoch raises StaleEpochPublishError naming the
fake's disclosed epoch) and its supersede-in-place republish.
"""

import types

import numpy as np
import pytest

from tests.recipes.fake_kafka import FakeKafka as RefFakeKafka
from tests.recipes.fake_mysql import FakeMySQL as RefFakeMySQL
from tests.recipes.fake_mysql import FakeMyTable as RefFakeMyTable
from transferia_tpu.abstract.errors import (
    StaleEpochPublishError as RefStaleEpoch,
)
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import (
    new_table_schema as ref_new_table_schema,
)
from transferia_tpu.abstract.table import (
    TableDescription as RefTableDescription,
)
from transferia_tpu.columnar.batch import Column as RefColumn
from transferia_tpu.columnar.batch import ColumnBatch as RefColumnBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.debezium import emitter as ref_emitter_mod
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.kafka.provider import (
    KafkaSinker as RefKafkaSinker,
)
from transferia_tpu.providers.kafka.provider import (
    KafkaTargetParams as RefKafkaParams,
)
from transferia_tpu.providers.mysql import MySQLSourceParams as RefMyParams
from transferia_tpu.providers.mysql import MySQLTargetParams as RefMyTarget
from transferia_tpu.providers.mysql import provider as ref_my_provider
from transferia_tpu.providers.mysql import wire as ref_wire
from transferia_tpu.providers.mysql.provider import (
    MySQLStorage as RefStorage,
)
from transferia_tpu.providers.registry import get_provider as ref_provider
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu.transform.plugins.sharder import (
    hash_column_to_shards as ref_hash_column_to_shards,
)
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    new_table_schema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.debezium import emitter as port_emitter_mod
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers.kafka import KafkaTargetParams
from transferia_tpu_torch.providers.kafka.protocol import crc32c_py
from transferia_tpu_torch.providers.kafka.provider import KafkaSinker
from transferia_tpu_torch.providers.mysql import (
    MySQLSourceParams,
    MySQLTargetParams,
)
from transferia_tpu_torch.providers.mysql import provider as port_my_provider
from transferia_tpu_torch.providers.mysql import wire as port_wire
from transferia_tpu_torch.providers.mysql.provider import MySQLStorage
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.recipes.fake_mysql import FakeMySQL, FakeMyTable
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.plugins.sharder import (
    hash_column_to_shards,
)

PKGS = {
    "port": dict(mysql=FakeMySQL, table=FakeMyTable, kafka=FakeKafka,
                 storage=MySQLStorage, params=MySQLSourceParams,
                 target=MySQLTargetParams, kafka_params=KafkaTargetParams,
                 sinker=KafkaSinker, tid=TableID, td=TableDescription,
                 transfer=Transfer, coordinator=MemoryCoordinator,
                 activate=activate_delivery, provider=get_provider,
                 wire=port_wire, mod=port_my_provider,
                 stale=StaleEpochPublishError, ct=CanonicalType,
                 column=Column, batch=ColumnBatch,
                 new_schema=new_table_schema, kw={"device": "cpu"}),
    "jax": dict(mysql=RefFakeMySQL, table=RefFakeMyTable,
                kafka=RefFakeKafka, storage=RefStorage, params=RefMyParams,
                target=RefMyTarget, kafka_params=RefKafkaParams,
                sinker=RefKafkaSinker, tid=RefTableID,
                td=RefTableDescription, transfer=RefTransfer,
                coordinator=RefCoordinator, activate=ref_activate,
                provider=ref_provider, wire=ref_wire, mod=ref_my_provider,
                stale=RefStaleEpoch, ct=RefCT, column=RefColumn,
                batch=RefColumnBatch, new_schema=ref_new_table_schema,
                kw={}),
}


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """Both emitter modules read a fixed wall clock (`ts_ms`)."""
    clock = types.SimpleNamespace(time=lambda: 1_753_000_000.125)
    monkeypatch.setattr(port_emitter_mod, "time", clock)
    monkeypatch.setattr(ref_emitter_mod, "time", clock)


def outcome(fn):
    """A call's result, or its exception as (type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


# -- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("password,given", [("", ""), ("s3cr3t", "s3cr3t"),
                                            ("s3cr3t", "wrong")])
def test_wire_equals_jax(password, given):
    got = {}
    for pkg, p in PKGS.items():
        my = p["mysql"](password=password).start()
        try:
            def run():
                c = p["wire"].MySQLConnection(
                    host="127.0.0.1", port=my.port, user="root",
                    password=given).connect()
                try:
                    c.ping()
                    return c.query("SHOW MASTER STATUS")
                finally:
                    c.close()

            got[pkg] = outcome(run)
        finally:
            my.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("ok" if password == given else "raised")


def test_auth_tokens_equal_jax():
    rng = np.random.default_rng(3)
    for n in (8, 20, 32):
        nonce = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for pw in ("", "p", "pässwörd"):
            assert port_wire._native_password_token(pw, nonce) == \
                ref_wire._native_password_token(pw, nonce)
            assert port_wire._caching_sha2_token(pw, nonce) == \
                ref_wire._caching_sha2_token(pw, nonce)


# -- MySQLStorage --------------------------------------------------------------

COLUMNS = [("id", "bigint", "bigint(20)", True, True),
           ("k2", "int", "int(11)", False, True),
           ("name", "varchar", "varchar(64)", False, False),
           ("amount", "decimal", "decimal(10,2)", False, False),
           ("score", "double", "double", False, False),
           ("big", "bigint", "bigint(20) unsigned", False, False),
           ("raw", "varbinary", "varbinary(16)", False, False),
           ("doc", "json", "json", False, False)]
COMPOSITE = [(c[0], c[1], c[2], c[0] in ("id", "k2"), c[4])
             for c in COLUMNS]


def table_rows(n: int, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n) * 3 + 1
    out = []
    for i, key in enumerate(ids.tolist()):
        null = i % 6 == 2
        out.append({
            "id": key, "k2": int(rng.integers(0, 4)),
            "name": None if null else f"n'{i}\\ü" if i % 4 == 0
            else f"name{i}",
            "amount": None if null else
            f"{int(rng.integers(-10**6, 10**6)) / 100:.2f}",
            "score": None if null else float(rng.standard_normal()),
            "big": None if null else int(rng.integers(0, 2**63)) * 2 + 1,
            "raw": None if null else f"r{i}",
            "doc": None if null else f'{{"i": {i}}}',
        })
    return out


def storage_calls(pkg: str, columns, batch_rows: int, filt: str):
    p = PKGS[pkg]
    my = p["mysql"]().start()
    try:
        my.add_table(p["table"]("db", "t", columns, table_rows(40)))
        st = p["storage"](p["params"](host="127.0.0.1", port=my.port,
                                      database="db",
                                      batch_rows=batch_rows))
        tid = p["tid"]("db", "t")
        batches = []

        def load():
            st.load_table(p["td"](id=tid, filter=filt), batches.append)
            return [(str(b.table_id), b.to_pydict()) for b in batches]

        def sample(method, *args):
            out = []
            getattr(st, method)(p["td"](id=tid), *args, out.append)
            return [b.to_pydict() for b in out]

        try:
            schema = st.table_schema(tid)
            return dict(
                tables=[(str(k), v.eta_rows)
                        for k, v in st.table_list().items()],
                schema=[(c.name, c.data_type.value, c.primary_key,
                         c.required, c.original_type) for c in schema],
                exact=st.exact_table_rows_count(tid),
                position=st.position(),
                load=outcome(load),
                size=outcome(lambda: st.table_size_in_bytes(tid)),
                random=outcome(lambda: sample("load_random_sample")),
                top_bottom=outcome(
                    lambda: sample("load_top_bottom_sample")),
                by_set=outcome(lambda: sample(
                    "load_sample_by_set", [{"id": 4}, {"id": 7}])),
                queries=list(my.queries))
        finally:
            st.close()
    finally:
        my.stop()


@pytest.mark.parametrize("filt", ["", "`region` >= 2", "`id` > 60"])
@pytest.mark.parametrize("paging", ["keyset", "offset"])
def test_storage_equals_jax(paging, filt):
    columns = COLUMNS if paging == "keyset" else COMPOSITE
    if paging == "keyset" and filt == "`id` > 60":
        # the fake applies only the first `col` > literal condition, so a
        # keyset page after this filter would repeat: one page
        batch_rows = 100
    else:
        batch_rows = 7
    got = storage_calls("port", columns, batch_rows, filt)
    assert got == storage_calls("jax", columns, batch_rows, filt)
    assert got["load"][0] == "ok"
    rows = [r for _, b in got["load"][1] for r in zip(*b.values())]
    want = 40 if filt != "`id` > 60" else sum(
        1 for r in table_rows(40) if r["id"] > 60)
    assert len(rows) == want
    pages = len(got["load"][1])
    assert pages == (1 if batch_rows == 100 else -(-want // 7))
    assert got["position"] == {"binlog_file": "binlog.000001",
                               "binlog_pos": "4242", "gtid_set": ""}


def test_datetime_column_is_refused_as_in_jax():
    columns = [("id", "bigint", "bigint", True, True),
               ("seen", "datetime", "datetime", False, False)]
    got = {}
    for pkg, p in PKGS.items():
        my = p["mysql"]().start()
        try:
            my.add_table(p["table"]("db", "t", columns, [
                {"id": 1, "seen": "2024-01-02 03:04:05"}]))
            st = p["storage"](p["params"](host="127.0.0.1", port=my.port,
                                          database="db"))
            got[pkg] = outcome(lambda: st.load_table(
                p["td"](id=p["tid"]("db", "t")), lambda b: None))
            st.close()
        finally:
            my.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ("raised", "ValueError")


@pytest.mark.parametrize("policy", ["drop", "truncate"])
def test_mysql_target_cleanup_equals_jax(policy):
    got = {}
    for pkg, p in PKGS.items():
        my = p["mysql"]().start()
        try:
            my.add_table(p["table"]("db", "t", COLUMNS, table_rows(5)))
            my.add_table(p["table"]("db", "u", COLUMNS, table_rows(3)))
            target = p["target"](host="127.0.0.1", port=my.port,
                                 database="db")
            target.cleanup_policy = type(target.cleanup_policy)(policy)
            t = p["transfer"](id="c", dst=target, src=p["params"](
                host="127.0.0.1", port=my.port, database="db"))
            prov = p["provider"]("mysql", t)
            prov.cleanup([p["td"](id=p["tid"]("db", "t")),
                          p["tid"]("", "missing")
                          if policy == "drop" else p["tid"]("db", "u")])
            got[pkg] = (prov.test().ok,
                        {k: len(v.rows) for k, v in my.tables.items()},
                        list(my.queries))
        finally:
            my.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0]


def test_left_out_parts_raise():
    t = Transfer(id="w", src=MySQLSourceParams(),
                 dst=MySQLTargetParams())
    prov = get_provider("mysql", t)
    # the binlog tail and the MySQL target are ported: no call raises
    for call in (prov.source, prov.sinker, prov.destination_storage):
        assert call() is not None
    st = prov.storage()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        st.get_increment_state([], {})
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        st.next_increment_state([])


# -- the Kafka sink's partitioning ----------------------------------------------

def test_key_partitions_equal_jax_and_the_pure_crc():
    rng = np.random.default_rng(11)
    keys = [bytes(rng.integers(0, 256, k, dtype=np.uint8))
            for k in rng.integers(0, 40, 300)] + [b"", None]
    pairs = [(k, b"v") for k in keys]
    for n in (1, 3, 16, 64):
        got = KafkaSinker._key_partitions(pairs, n)
        want = RefKafkaSinker._key_partitions(pairs, n)
        assert np.asarray(got).tolist() == np.asarray(want).tolist()
        assert got.tolist() == [crc32c_py(k or b"") % n for k in keys]


@pytest.mark.parametrize("ctype,values", [
    ("INT64", [0, -1, 2**62, 17, 3]),
    ("INT32", list(range(-50, 50))),
    ("UINT8", list(range(256))),
    ("DOUBLE", [0.5, -1e300, 3.25, 0.0]),
    ("UTF8", ["", "a", "ünï", None, "x" * 300, "ab"]),
    ("STRING", [b"", b"\x00\xff", None, bytes(range(200))]),
])
def test_hash_column_to_shards_equals_jax(ctype, values):
    for n in (1, 7, 16):
        got = hash_column_to_shards(
            Column.from_pylist("c", CanonicalType[ctype], values), n)
        want = ref_hash_column_to_shards(
            RefColumn.from_pylist("c", RefCT[ctype], values), n)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()


# -- activate_delivery: mysql2kafka ----------------------------------------------

MY2KF_COLUMNS = [("id", "bigint", "bigint", True, True),
                 ("email", "varchar", "varchar(255)", False, False),
                 ("region", "int", "int", False, False)]
MASK = {"transformers": [{"mask_field": {"columns": ["email"],
                                         "salt": "bench"}}]}


def my2kf(pkg: str, rows: int, **dst):
    """bench.py measure_mysql2kafka's shape at `rows` rows."""
    p = PKGS[pkg]
    my, kf = p["mysql"]().start(), p["kafka"](n_partitions=16).start()
    try:
        my.add_table(p["table"]("db", "users", MY2KF_COLUMNS, [
            {"id": i, "email": f"user{i}@example.test", "region": i % 500}
            for i in range(rows)]))
        t = p["transfer"](
            id="my2kf", src=p["params"](host="127.0.0.1", port=my.port,
                                        database="db", user="root"),
            dst=p["kafka_params"](brokers=[f"127.0.0.1:{kf.port}"],
                                  topic="cdc", serializer="debezium",
                                  **dst),
            transformation=MASK)
        cp = p["coordinator"]()
        p["activate"](t, cp, **p["kw"])
        parts = [[(r.key, r.value) for r in kf.records("cdc", i)]
                 for i in range(16)]
        return (parts, sum(len(x) for x in kf.topics["cdc"]),
                kf.live_size("cdc"), sorted(kf.txns),
                cp.get_transfer_state("my2kf"), cp.get_status("my2kf").value)
    finally:
        my.stop()
        kf.stop()


@pytest.mark.parametrize("staged", ["auto", "off"])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_activate_my2kf_equals_jax(monkeypatch, mode, staged):
    monkeypatch.setenv("TRANSFERIA_TPU_STAGED_COMMIT", staged)
    port_tfused.set_placement(mode)
    ref_tfused.set_placement("host")
    try:
        got = my2kf("port", 5000)
        want = my2kf("jax", 5000)
    finally:
        port_tfused.set_placement(None)
        ref_tfused.set_placement(None)
    assert got == want
    parts, offsets, live, txns, state, status = got
    assert offsets == live == 5000 and status == "activated"
    assert all(parts)  # every one of the 16 partitions holds records
    assert len(txns) == (1 if staged == "auto" else 0)
    assert state["snapshot_position"]["binlog_pos"] == "4242"
    for i, recs in enumerate(parts):
        assert all(crc32c_py(k) % 16 == i for k, _ in recs)


def test_activate_my2kf_partition_by_equals_jax():
    port_tfused.set_placement("host")
    ref_tfused.set_placement("host")
    try:
        got = my2kf("port", 700, partition_by="region")
        want = my2kf("jax", 700, partition_by="region")
    finally:
        port_tfused.set_placement(None)
        ref_tfused.set_placement(None)
    assert got == want
    assert got[1] == 700


# -- the staged publish: the epoch fence and the republish --------------------

def staged_script(pkg: str):
    """begin/push/publish at epochs 2, then 1 (a zombie), then 3 (the
    part's republish); the fake's log after each step."""
    p = PKGS[pkg]
    kf = p["kafka"](n_partitions=4).start()
    schema = p["new_schema"]([("id", "int64", True), ("v", "utf8")])

    def batch(lo, hi):
        return p["batch"].from_pydict(p["tid"]("db", "t"), schema, {
            "id": list(range(lo, hi)),
            "v": [f"v{i}" for i in range(lo, hi)]})

    def sinker():
        return p["sinker"](p["kafka_params"](
            brokers=[f"127.0.0.1:{kf.port}"], topic="out",
            serializer="json"), **({"device": "cpu"} if pkg == "port"
                                   else {}))

    def log():
        return (sum(len(x) for x in kf.topics.get("out", [])),
                kf.live_size("out"),
                sorted((k, v["epoch"]) for k, v in kf.txns.items()),
                [[(r.key, r.value) for r in kf.records("out", i)]
                 for i in range(4)])

    steps = []
    try:
        s2 = sinker()
        s2.begin_part("db.t/0", 2)
        s2.push(batch(0, 30))
        steps.append(("publish2", s2.publish_part("db.t/0", 2), log()))
        zombie = sinker()
        zombie.begin_part("db.t/0", 1)
        zombie.push(batch(100, 110))
        try:
            zombie.publish_part("db.t/0", 1)
            steps.append(("zombie published", log()))
        except p["stale"] as e:
            steps.append(("stale", e.key, e.epoch, e.published_epoch,
                          log()))
        s3 = sinker()
        s3.begin_part("db.t/0", 3)
        s3.push(batch(0, 12))
        steps.append(("publish3", s3.publish_part("db.t/0", 3), log()))
        plain = sinker()
        plain.push(batch(200, 205))
        steps.append(("plain", log()))
        for s in (s2, zombie, s3, plain):
            s.close()
    finally:
        kf.stop()
    return steps


def test_staged_publish_fence_and_republish_equal_jax():
    got = staged_script("port")
    assert got == staged_script("jax")
    publish2, stale, publish3, plain = got
    assert publish2[1] == 30 and publish2[2][:2] == (30, 30)
    # the zombie's epoch 1 is fenced with the fake's current epoch 2
    assert stale[:4] == ("stale", "db.t/0", 1, 2)
    assert stale[4] == publish2[2]
    # the republish supersedes: offsets grow, live records do not
    assert publish3[1] == 12 and publish3[2][:2] == (42, 12)
    assert publish3[2][2] == [("trtpu.db.t_0", 3)]
    assert plain[1][:2] == (47, 17)
