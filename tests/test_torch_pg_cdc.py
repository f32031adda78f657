"""The Postgres logical-replication tail of the port (the LSN helpers,
`Wal2JsonDecoder`, `PGReplicationSource` through `run_replication`, the
slot's lifecycle and `SlotMonitor`) against the JAX package's, on the
CPU, exactly.

Held equal: the LSN conversions; the decoder over seeded wal2json v2
messages (insert, update and delete with and without identity, truncate,
begin/commit/message markers, coercions that fail, an unknown action)
and its schema cache; `_split_homogeneous`; and, each package against
its own fake Postgres, the replication of the wal2json scenario of the
JAX package's e2e suite into the memory sink (rows, kinds, old keys,
the slot created, the checkpointed `pg_wal_lsn`, the standby status
flushed, a live message), a mixed-kind stream through the mask, the
hits stream of `recipes.cdc` through the filter into the fake
ClickHouse (the rows, the last fed LSN checkpointed, the slot dropped
by `deactivate`), and `SlotMonitor`'s lag and its fatal error.  Every
run stops its replication thread through `stop_event` within a few
seconds.
"""

import enum
import hashlib
import hmac
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_postgres import FakePG as RefFakePG
from transferia_tpu.abstract.errors import FatalError as RefFatalError
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCHParams
from transferia_tpu.providers.postgres import PGSourceParams as RefPGParams
from transferia_tpu.providers.postgres import replication as ref_repl
from transferia_tpu.providers.registry import get_provider as ref_provider
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu_torch.abstract.errors import FatalError
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.providers.postgres import replication as port_repl
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes import cdc
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_postgres import FakePG
from transferia_tpu_torch.runtime.local import run_replication

PKGS = {
    "port": dict(pg=FakePG, ch=FakeCH, params=PGSourceParams,
                 ch_params=CHTargetParams, transfer=Transfer,
                 coordinator=MemoryCoordinator, memory=port_memory,
                 run=run_replication, repl=port_repl, provider=get_provider,
                 fatal=FatalError, kw={"device": "cpu"}),
    "jax": dict(pg=RefFakePG, ch=RefFakeCH, params=RefPGParams,
                ch_params=RefCHParams, transfer=RefTransfer,
                coordinator=RefCoordinator, memory=ref_memory, run=ref_run,
                repl=ref_repl, provider=ref_provider, fatal=RefFatalError,
                kw={}),
}


def plain(obj):
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(x) for x in obj)
    return obj


def norm_item(it):
    """A change, the wall-clock commit time set aside."""
    if it is None:
        return None
    schema = None if it.table_schema is None else [
        (c.name, c.data_type.value, c.primary_key, c.original_type)
        for c in it.table_schema]
    return (plain(it.kind), it.schema, it.table, tuple(it.column_names),
            tuple(it.column_values), tuple(it.old_keys.key_names),
            tuple(it.old_keys.key_values), it.lsn, it.txn_id, schema)


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


def both(fn, *args):
    """fn over each package, the two runs at once (they share no fake,
    store or coordinator): (port's result, JAX package's result)."""
    with ThreadPoolExecutor(2) as ex:
        port, ref = ex.submit(fn, "port", *args), ex.submit(fn, "jax", *args)
        return port.result(), ref.result()


# -- the LSN helpers and the decoder ------------------------------------------

def test_lsn_conversion_equals_jax():
    rng = np.random.default_rng(3)
    for v in [0, 1, 0x1000, (10 << 32) | 0xBC, 2 ** 64 - 1] + \
            rng.integers(0, 2 ** 63, 50, dtype=np.int64).tolist():
        text = port_repl.int_to_lsn(v)
        assert text == ref_repl.int_to_lsn(v)
        assert port_repl.lsn_to_int(text) == ref_repl.lsn_to_int(text) == v
    assert port_repl.lsn_to_int("A/BC") == (10 << 32) | 0xBC


TYPES = [("bigint", lambda r, i: int(r.integers(-10**12, 10**12))),
         ("integer", lambda r, i: int(r.integers(-1000, 1000))),
         ("text", lambda r, i: f"t{i}'é"),
         ("double precision", lambda r, i: float(r.normal())),
         ("numeric", lambda r, i: f"{r.integers(0, 10**6) / 100:.2f}"),
         ("boolean", lambda r, i: bool(r.random() < 0.5)),
         ("jsonb", lambda r, i: {"k": i}),
         ("character varying", lambda r, i: "v" * (i % 5))]


def wal_messages(seed: int, n: int = 200) -> list[bytes]:
    """Seeded wal2json v2 messages over two tables whose columns change
    once, with NULLs, strings where numbers belong and every action."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = rng.random()
        table = "a" if rng.random() < 0.7 else "b"
        ncols = 3 + (i > n // 2) + (table == "b")
        cols = []
        for j in range(ncols):
            name, gen = TYPES[(j * 3 + (table == "b")) % len(TYPES)]
            v = None if rng.random() < 0.1 else gen(rng, i)
            if v is not None and name in ("bigint", "integer") and \
                    rng.random() < 0.1:
                v = str(v) if rng.random() < 0.5 else "x" + str(v)
            cols.append({"name": f"c{j}", "type": name, "value": v})
        cols[0] = {"name": "id", "type": "bigint", "value": i}
        pk = [{"name": "id", "type": "bigint"}] if rng.random() < 0.8 \
            else []
        ident = [{"name": "id", "type": "bigint", "value": i - 1}]
        if r < 0.08:
            obj = {"action": "B"} if rng.random() < 0.5 else {"action": "C"}
        elif r < 0.1:
            obj = {"action": "M", "prefix": "p", "content": "c"}
        elif r < 0.12:
            obj = {"action": "T", "schema": "public", "table": table}
        elif r < 0.13:
            obj = {"action": "Z"}
        elif r < 0.6:
            obj = {"action": "I", "schema": "public", "table": table,
                   "columns": cols, "pk": pk}
        elif r < 0.85:
            obj = {"action": "U", "schema": "public", "table": table,
                   "columns": cols, "pk": pk}
            if rng.random() < 0.7:
                obj["identity"] = ident
        else:
            obj = {"action": "D", "schema": "public", "table": table,
                   "identity": ident, "pk": pk}
        out.append(json.dumps(obj).encode())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_wal2json_decoder_equals_jax(seed):
    port, ref = port_repl.Wal2JsonDecoder(), ref_repl.Wal2JsonDecoder()
    items, ref_items = [], []
    for k, msg in enumerate(wal_messages(seed)):
        a = outcome(lambda: port.decode(msg, 0x2000 + 8 * k, f"tx{k}"))
        b = outcome(lambda: ref.decode(msg, 0x2000 + 8 * k, f"tx{k}"))
        assert a[0] == b[0] and a[2:] == b[2:]
        if a[0] == "ok":
            assert norm_item(a[1]) == norm_item(b[1])
            if a[1] is not None:
                items.append(a[1])
                ref_items.append(b[1])
    assert sorted(port._schemas) == sorted(ref._schemas)
    # the cache hands one schema object to every message of a shape
    assert len({id(it.table_schema) for it in items
                if it.table_schema is not None}) == len(port._schemas)
    runs = port_repl._split_homogeneous(items)
    ref_runs = ref_repl._split_homogeneous(ref_items)
    assert [[norm_item(it) for it in r] for r in runs] == \
        [[norm_item(it) for it in r] for r in ref_runs]
    assert {plain(it.kind) for it in items} == {"insert", "update",
                                                "delete", "truncate"}


def test_dblog_snapshot_names_its_item():
    params = PGSourceParams(dblog_snapshot=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A10"):
        port_repl.PGReplicationSource(params, "t")
    t = Transfer(id="dblog", type="INCREMENT_ONLY", src=params,
                 dst=port_memory.MemoryTargetParams(sink_id="dblog"))
    with pytest.raises(NotImplementedError, match="DBLog.*A10"):
        get_provider("pg", t, device="cpu").source()
    # a left-out part fails the replication at once: no retry loop
    cp = MemoryCoordinator()
    with pytest.raises(NotImplementedError, match="A10"):
        run_replication(t, cp, backoff=30, device="cpu")
    assert cp.get_status("dblog").value == "failed"


# -- replication runs ---------------------------------------------------------

def wait_for(cond, seconds: float = 30.0) -> None:
    deadline = time.monotonic() + seconds
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.02)


class Replication:
    def __init__(self, pkg: str, srv, tid: str, dst=None,
                 transformation=None, **src):
        p = self.p = PKGS[pkg]
        self.srv, self.tid, self.cp, self.store = (srv, tid,
                                                   p["coordinator"](), None)
        if dst is None:
            self.store = p["memory"].get_store(tid)
            self.store.clear()
            dst = p["memory"].MemoryTargetParams(sink_id=tid)
        self.transfer = p["transfer"](
            id=tid, type="INCREMENT_ONLY", dst=dst,
            src=p["params"](host="127.0.0.1", port=srv.port, database="db",
                            user="u", **src),
            transformation=transformation)

    def __enter__(self):
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self.p["run"], args=(self.transfer, self.cp),
            kwargs={"stop_event": self.stop, "backoff": 0.1,
                    **self.p["kw"]}, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        if self.p is PKGS["jax"]:
            # the JAX package's source looks at its stop only after a
            # WAL message (ROADMAP.md C4): a logical message, which
            # decodes to nothing, lets it see the stop
            self.srv.feed_wal(json.dumps({"action": "M"}).encode())
        self.thread.join(5)
        assert not self.thread.is_alive()
        return False

    def lsn(self):
        return self.cp.get_transfer_state(self.tid).get("pg_wal_lsn")


def w2j(action: str, i: int, name=None, identity: bool = True) -> bytes:
    obj = {"action": action, "schema": "public", "table": "t",
           "pk": [{"name": "id", "type": "bigint"}]}
    if action != "D":
        obj["columns"] = [{"name": "id", "type": "bigint", "value": i},
                          {"name": "name", "type": "text", "value": name}]
    if action != "I" and identity:
        obj["identity"] = [{"name": "id", "type": "bigint", "value": i}]
    return json.dumps(obj).encode()


def stream_to_memory(pkg: str):
    srv = PKGS[pkg]["pg"]().start()
    try:
        srv.feed_wal(json.dumps({"action": "B"}).encode())
        for i in range(5):
            srv.feed_wal(w2j("I", i, f"n{i}"))
        srv.feed_wal(w2j("U", 2, "updated"))
        srv.feed_wal(w2j("D", 0))
        srv.feed_wal(json.dumps({"action": "C"}).encode())
        with Replication(pkg, srv, f"pgcdc-{pkg}") as rep:
            wait_for(lambda: rep.store.row_count() >= 7)
            slots = dict(srv.slots)
            last = port_repl.int_to_lsn(srv.wal[-1][0])
            wait_for(lambda: rep.lsn() == last and srv.flushed_lsn > 0)
            flushed = srv.flushed_lsn
            srv.feed_wal(w2j("I", 100, "live"))
            wait_for(lambda: rep.store.row_count() >= 8)
            last = port_repl.int_to_lsn(srv.wal[-1][0])
            wait_for(lambda: rep.lsn() == last
                     and srv.flushed_lsn > flushed)
            final = rep.lsn(), srv.flushed_lsn
        rows = [norm_item(it) for it in rep.store.rows()]
        return rows, slots, flushed, final
    finally:
        srv.stop()


def test_pg_cdc_stream_to_memory_equals_jax():
    (rows, slots, flushed, final), (ref_rows, ref_slots, ref_flushed,
                                    ref_final) = both(stream_to_memory)
    assert (rows, flushed, final) == (ref_rows, ref_flushed, ref_final)
    assert list(slots) == ["transferia_pgcdc_port"]
    assert list(ref_slots) == ["transferia_pgcdc_jax"]
    assert [r[0] for r in rows] == ["insert"] * 5 + ["update", "delete",
                                                     "insert"]
    assert rows[5][4] == (2, "updated") and rows[5][5:7] == (("id",), (2,))
    assert rows[6][5:7] == (("id",), (0,))
    assert rows[7][4] == (100, "live")
    assert flushed > 0 and final[1] > flushed


def mixed_through_mask(pkg: str):
    """Inserts, updates (with and without identity) and deletes in
    transactions, through mask_field name."""
    rng = np.random.default_rng(9)
    srv = PKGS[pkg]["pg"]().start()
    try:
        live = []
        for k in range(400):
            if k % 50 == 0:
                srv.feed_wal(json.dumps({"action": "B"}).encode())
            r = rng.random()
            if r < 0.6 or not live:
                live.append(k)
                srv.feed_wal(w2j("I", k, None if k % 13 == 0
                                 else f"user{k}"))
            elif r < 0.85:
                i = live[int(rng.integers(len(live)))]
                srv.feed_wal(w2j("U", i, f"user{i}.{k}",
                                 identity=bool(rng.random() < 0.7)))
            else:
                i = live.pop(int(rng.integers(len(live))))
                srv.feed_wal(w2j("D", i))
            if k % 50 == 49:
                srv.feed_wal(json.dumps({"action": "C"}).encode())
        last = port_repl.int_to_lsn(srv.wal[-1][0])
        with Replication(pkg, srv, f"pgmask-{pkg}", transformation={
                "transformers": [{"mask_field": {"columns": ["name"],
                                                 "salt": "pg"}}]}) as rep:
            wait_for(lambda: rep.lsn() == last)
        return [norm_item(it) for it in rep.store.rows()], last
    finally:
        srv.stop()


def test_mixed_kinds_through_the_mask_equal_jax():
    got, want = both(mixed_through_mask)
    assert got == want
    rows, lsn = got
    assert {r[0] for r in rows} == {"insert", "update", "delete"}
    for r in rows:
        if r[0] == "insert":
            assert r[4][1] == (None if r[4][0] % 13 == 0 else hmac.new(
                b"pg", f"user{r[4][0]}".encode(),
                hashlib.sha256).hexdigest())
        elif r[0] == "update":
            assert len(r[4][1]) == 64
        else:
            assert set(r[4]) <= {None} and len(r[6]) == 1


HITS_FILTER = {"transformers": [
    {"filter_rows": {"filter": "region < 400 AND score >= 10"}}]}


def hits_to_ch(pkg: str, rows: int = 3000):
    p = PKGS[pkg]
    srv, ch = p["pg"]().start(), p["ch"]().start()
    try:
        last = port_repl.int_to_lsn(cdc.feed_hits_wal(srv, rows,
                                                      txn_rows=500))
        dst = p["ch_params"](host="127.0.0.1", port=ch.port, bufferer=None)
        with Replication(pkg, srv, f"pg2ch-cdc-{pkg}", dst=dst,
                         transformation=HITS_FILTER) as rep:
            wait_for(lambda: rep.lsn() == last)
            lsn = rep.lsn()
        slot = dict(srv.slots)
        p["provider"]("pg", rep.transfer).deactivate()
        got = sorted(tuple(sorted(r.items()))
                     for r in ch.rows("public__hits"))
        return got, lsn, last, slot, dict(srv.slots)
    finally:
        ch.stop()
        srv.stop()


def test_hits_stream_into_clickhouse_equals_jax():
    (got, lsn, last, slot, after), (ref_got, ref_lsn, _, ref_slot,
                                    ref_after) = both(hits_to_ch)
    assert (got, lsn, after) == (ref_got, ref_lsn, ref_after)
    assert list(ref_slot) == ["transferia_pg2ch_cdc_jax"]
    i = np.arange(3000)
    keep = (i % 500 < 400) & ((i % 91) * 1.5 >= 10)
    assert [dict(r)["id"] for r in got] == sorted(i[keep].tolist())
    assert lsn == last
    assert list(slot) == ["transferia_pg2ch_cdc_port"] and after == {}


def test_slot_monitor_equals_jax():
    out = {}
    for pkg, p in PKGS.items():
        srv = p["pg"]().start()
        try:
            params = p["params"](host="127.0.0.1", port=srv.port,
                                 database="db", user="u")
            lag = p["repl"].SlotMonitor(params, "s1",
                                        max_lag_bytes=10_000).check_once()
            with pytest.raises(p["fatal"], match="lag") as exc:
                p["repl"].SlotMonitor(params, "s1",
                                      max_lag_bytes=10).check_once()
            fired = []
            mon = p["repl"].SlotMonitor(params, "s1", max_lag_bytes=10,
                                        interval=0.01)
            mon.start(fired.append)
            wait_for(lambda: fired)
            mon.stop()
            out[pkg] = (lag, str(exc.value), str(fired[0]))
        finally:
            srv.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == 1024


def test_deactivate_drops_slot_equals_jax():
    out = {}
    for pkg, p in PKGS.items():
        srv = p["pg"]().start()
        try:
            t = p["transfer"](
                id="pg-drop", type="INCREMENT_ONLY",
                src=p["params"](host="127.0.0.1", port=srv.port,
                                database="db", user="u",
                                slot_name="myslot"),
                dst=p["memory"].MemoryTargetParams(sink_id="x"))
            srv.slots["myslot"] = "wal2json"
            srv.slots["other"] = "wal2json"
            p["provider"]("pg", t).deactivate()
            # a second drop finds no slot and only warns
            p["provider"]("pg", t).deactivate()
            out[pkg] = dict(srv.slots)
        finally:
            srv.stop()
    assert out["port"] == out["jax"] == {"other": "wal2json"}


def test_stop_is_seen_between_keepalives():
    """ROADMAP.md C4: with no WAL flowing and a keepalive every ~70 ms
    (the fake's pace), the stream never goes quiet for the 0.2-s probe;
    the port's source sees its stop at a keepalive and ends at once."""
    srv = FakePG().start()
    try:
        rep = Replication("port", srv, "pg-stop")
        with rep:
            wait_for(lambda: "transferia_pg_stop" in srv.slots)
            t0 = time.monotonic()
            rep.stop.set()
            rep.thread.join(2.0)
            assert not rep.thread.is_alive()
            assert time.monotonic() - t0 < 2.0
    finally:
        srv.stop()
