"""The MySQL target of the port (`MySQLSinker`, the provider's `sinker`
and `destination_storage`) against the JAX package's, on the CPU,
exactly.

Each package writes to its own fake MySQL.  Held equal, after the same
batches: the statements the sink sends (CREATE TABLE through the target
type rules, TEXT/BLOB keys as varchar(255)/varbinary(255), multi-row
INSERT in chunks of 500 with ON DUPLICATE KEY UPDATE when a key exists,
REPLACE/UPDATE/DELETE for a batch with kinds, the key taken from the old
keys) and the fake's tables; the read-back through
`destination_storage`; and the binlog -> mask -> MySQL replication of
the users stream of `recipes.cdc`, whose target table must also equal
the stream's final state with masked emails.
"""

import hashlib
import hmac
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests.recipes.fake_mysql import FakeMySQL as RefFakeMySQL
from tests.recipes.fake_mysql import FakeMyTable as RefFakeMyTable
from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.change_item import OldKeys as RefOldKeys
from transferia_tpu.abstract.change_item import (
    init_table_load as ref_init_table_load,
)
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.abstract.table import (
    TableDescription as RefTableDescription,
)
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.mysql import MySQLSourceParams as RefMyParams
from transferia_tpu.providers.mysql import MySQLTargetParams as RefMyTarget
from transferia_tpu.providers.mysql.provider import MySQLSinker as RefSinker
from transferia_tpu.providers.registry import get_provider as ref_provider
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu_torch.abstract.change_item import (
    ChangeItem,
    OldKeys,
    init_table_load,
)
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers.mysql import (
    MySQLSourceParams,
    MySQLTargetParams,
)
from transferia_tpu_torch.providers.mysql.provider import MySQLSinker
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes import cdc
from transferia_tpu_torch.recipes.fake_mysql import FakeMySQL, FakeMyTable
from transferia_tpu_torch.runtime.local import run_replication

PKGS = {
    "port": dict(mysql=FakeMySQL, table=FakeMyTable, item=ChangeItem,
                 old_keys=OldKeys, kind=Kind, tid=TableID,
                 schema=new_table_schema, batch=ColumnBatch,
                 sinker=MySQLSinker, target=MySQLTargetParams,
                 params=MySQLSourceParams, transfer=Transfer,
                 provider=get_provider, td=TableDescription,
                 coordinator=MemoryCoordinator, run=run_replication,
                 init=init_table_load, kw={"device": "cpu"}),
    "jax": dict(mysql=RefFakeMySQL, table=RefFakeMyTable, item=RefItem,
                old_keys=RefOldKeys, kind=RefKind, tid=RefTableID,
                schema=ref_schema, batch=RefBatch, sinker=RefSinker,
                target=RefMyTarget, params=RefMyParams,
                transfer=RefTransfer, provider=ref_provider,
                td=RefTableDescription, coordinator=RefCoordinator,
                run=ref_run, init=ref_init_table_load, kw={}),
}

WIDE = [("id", "int64", True), ("i8", "int8"), ("u32", "uint32"),
        ("f", "double"), ("b", "boolean"), ("s", "utf8"),
        ("raw", "string"), ("d", "date"), ("ts", "timestamp"),
        ("dec", "decimal"), ("doc", "any")]


def wide_data(rng, ids) -> dict:
    n = len(ids)

    def nulls(vals):
        return [None if rng.random() < 0.1 else v for v in vals]

    return {
        "id": list(ids),
        "i8": nulls(rng.integers(-128, 128, n).tolist()),
        "u32": nulls(rng.integers(0, 2 ** 32, n, dtype=np.int64).tolist()),
        "f": nulls(np.round(rng.normal(0, 100, n), 3).tolist()),
        "b": nulls((rng.random(n) < 0.5).tolist()),
        "s": nulls([f"o'k\\{i}(é)" if i % 3 else f"s{i}" for i in ids]),
        "raw": nulls([bytes([i % 256, 0, 255]) for i in ids]),
        "d": nulls(rng.integers(0, 20000, n).tolist()),
        "ts": nulls(rng.integers(0, 2 ** 40, n).tolist()),
        "dec": nulls([f"{i}.25" for i in ids]),
        "doc": nulls([{"k": i} for i in ids]),
    }


def fake_state(srv) -> tuple:
    tables = {f"{d}.{n}": (t.columns, t.rows)
              for (d, n), t in sorted(srv.tables.items())}
    return srv.queries, tables


def both(fn, *args):
    """fn over each package, the two runs at once (they share no fake,
    store or coordinator): (port's result, JAX package's result)."""
    with ThreadPoolExecutor(2) as ex:
        port, ref = ex.submit(fn, "port", *args), ex.submit(fn, "jax", *args)
        return port.result(), ref.result()


def sink_run(pkg: str, seed: int):
    p = PKGS[pkg]
    rng = np.random.default_rng(seed)
    srv = p["mysql"]().start()
    try:
        sink = p["sinker"](p["target"](host="127.0.0.1", port=srv.port,
                                       database="db"))
        wide = p["schema"](WIDE)
        tid = p["tid"]("", "wide")
        # an insert, then an upsert over half the keys, in 500-row chunks
        sink.push(p["batch"].from_pydict(
            tid, wide, wide_data(rng, range(0, 700))))
        sink.push(p["batch"].from_pydict(
            tid, wide, wide_data(rng, range(350, 1200))))
        # no key: plain INSERT, duplicates kept
        nokey = p["schema"]([("a", "int32"), ("t", "utf8")])
        for _ in range(2):
            sink.push(p["batch"].from_pydict(
                p["tid"]("db", "nokey"), nokey,
                {"a": [1, 2, None], "t": ["x", None, "z"]}))
        # a text key becomes varchar(255)
        tkey = p["schema"]([("k", "utf8", True), ("v", "int64")])
        sink.push(p["batch"].from_pydict(
            p["tid"]("db", "tkey"), tkey,
            {"k": ["a", "b", "c"], "v": [1, 2, 3]}))
        # mixed kinds as rows, then as a columnar block with kinds
        users = p["schema"]([("id", "int64", True), ("email", "utf8"),
                             ("region", "int32")])
        uid = p["tid"]("db", "users")

        def item(kind, values, old=None):
            return p["item"](
                kind=p["kind"](kind), schema="db", table="users",
                column_names=("id", "email", "region") if values else (),
                column_values=values or (), table_schema=users,
                old_keys=p["old_keys"](("id",), (old,)) if old is not None
                else p["old_keys"]())

        rows = [item("insert", (i, f"u{i}@e.test", i % 7))
                for i in range(40)]
        rows += [item("update", (i, f"v{i}@e.test", i % 7), i)
                 for i in range(0, 40, 3)]
        rows += [item("update", (i + 100, f"moved{i}", 1), i)
                 for i in range(1, 40, 9)]
        rows += [item("delete", None, i) for i in range(2, 40, 5)]
        rows.append(p["init"](uid, users))
        sink.push(rows)
        sink.push([p["init"](uid, users)])
        block = [item("insert", (i, None if i % 4 == 0 else f"w{i}", 3))
                 for i in range(200, 230)]
        block += [item("delete", None, i) for i in range(200, 230, 2)]
        block += [item("update", (i, "again", 4), i)
                  for i in range(201, 230, 4)]
        sink.push(p["batch"].from_rows(block))
        sink.close()
        # the read-back storage of the target
        t = p["transfer"](id="read", src=p["params"](), dst=p["target"](
            host="127.0.0.1", port=srv.port, database="db"))
        storage = p["provider"]("mysql", t).destination_storage()
        got = []
        storage.load_table(p["td"](id=p["tid"]("db", "users")),
                           lambda b: got.append(b.to_pydict()))
        storage.close()
        return fake_state(srv), got
    finally:
        srv.stop()


@pytest.mark.parametrize("seed", range(2))
def test_mysql_sinker_equals_jax(seed):
    got, want = both(sink_run, seed)
    assert got == want
    (queries, tables), read = got
    assert queries[0].startswith("CREATE TABLE IF NOT EXISTS `db`.`wide`")
    assert "`s` longtext" in queries[0] and "`dec` decimal(65,30)" in \
        queries[0] and "PRIMARY KEY (`id`)" in queries[0]
    assert sum(q.startswith("INSERT INTO `db`.`wide`") for q in queries) \
        == 4  # 700 and 850 rows in chunks of 500
    assert all("ON DUPLICATE KEY UPDATE" in q for q in queries
               if q.startswith("INSERT INTO `db`.`wide`"))
    assert "`k` varchar(255) NOT NULL" in \
        next(q for q in queries if "`tkey`" in q)
    cols, rows = tables["db.wide"]
    assert sorted(int(r["id"]) for r in rows) == list(range(1200))
    assert len(tables["db.nokey"][1]) == 6
    ids = sorted(int(i) for b in read for i in b["id"])
    want = set(range(40)) - set(range(2, 40, 5)) - set(range(1, 40, 9))
    want |= {i + 100 for i in range(1, 40, 9)}
    want |= set(range(201, 230, 2))
    assert ids == sorted(want)


def test_provider_returns_the_target_and_the_tails():
    t = Transfer(id="w", src=MySQLSourceParams(), dst=MySQLTargetParams())
    prov = get_provider("mysql", t, device="cpu")
    assert isinstance(prov.sinker(), MySQLSinker)
    assert type(prov.destination_storage()).__name__ == "MySQLStorage"
    assert type(prov.source()).__name__ == "MySQLBinlogSource"


# -- binlog -> mask -> MySQL --------------------------------------------------

USERS = cdc.users_changes(700, 200, 100, seed=8)
SALT = "my2my"


def wait_for(cond, seconds: float = 30.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


def my2my(pkg: str):
    p = PKGS[pkg]
    src, dst = p["mysql"]().start(), p["mysql"]().start()
    try:
        src.add_table(p["table"]("db", "users", cdc.USERS_COLUMNS))
        last = cdc.feed_users_binlog(src, USERS, txn_changes=100)
        fed = f"{cdc.USERS_SID}:1-{last}"
        t = p["transfer"](
            id=f"my2my-{pkg}", type="INCREMENT_ONLY",
            src=p["params"](host="127.0.0.1", port=src.port, database="db"),
            dst=p["target"](host="127.0.0.1", port=dst.port, database="db"),
            transformation={"transformers": [{"mask_field": {
                "columns": ["email"], "salt": SALT}}]})
        cp, stop = p["coordinator"](), threading.Event()
        th = threading.Thread(target=p["run"], args=(t, cp), kwargs={
            "stop_event": stop, "backoff": 0.2, **p["kw"]}, daemon=True)
        th.start()
        try:
            wait_for(lambda: cp.get_transfer_state(t.id).get(
                "mysql_binlog", {}).get("gtid_set") == fed)
        finally:
            stop.set()
            th.join(5)
        assert not th.is_alive()
        state = cp.get_transfer_state(t.id)["mysql_binlog"]
        return fake_state(dst), state, fed
    finally:
        src.stop()
        dst.stop()


def test_binlog_to_mysql_target_equals_jax():
    ((queries, tables), state, fed), want = both(my2my)
    assert ((queries, tables), state) == want[:2]
    assert state["gtid_set"] == fed
    want = {
        str(i): (None if e is None else hmac.new(
            SALT.encode(), e.encode(), hashlib.sha256).hexdigest(), str(r))
        for i, (e, r) in cdc.users_final_state(USERS).items()}
    rows = tables["db.users"][1]
    assert {r["id"]: (r["email"], r["region"]) for r in rows} == want
    assert len(rows) == len(want)
