"""The port's MongoDB provider (`transferia_tpu_torch/providers/mongo/`:
the BSON codec, the OP_MSG client with SCRAM-SHA-256, the snapshot in
`_id`-range shards, the change stream with its resume token and the
upsert/delete sink) against the JAX package's, on the CPU, exactly.

- BSON: the port's `encode` is byte-identical to the JAX package's on the
  documents of `tests/e2e/test_mongo_e2e.py` and on hypothesis-generated
  documents, `decode(encode(x))` round-trips, and `to_jsonish` agrees.
- SCRAM-SHA-256: with the nonce fixed (`os.urandom` patched), the
  client-first and client-final messages equal the JAX client's for the
  same server-first message.  (The JAX package's fake has no
  `saslStart`, so no round trip of authentication runs.)
- Each package against its own fake (the port's
  `recipes/fake_mongo.py`, the JAX package's `tests/recipes/`): the
  snapshot through `activate_delivery`, the `_id`-range shards and the
  sharded `SnapshotLoader` run, the change stream through
  `run_replication` (insert, update, replace, delete, an update whose
  document is gone, a drop) stopped and restarted, and the sink's
  upserts and deletes: equal stores and equal transfer state.
- The port alone: a stream stopped mid-way resumes from the recorded
  token, with no event lost and none delivered twice.
"""

import hashlib
import hmac
import os
import threading
import time
from base64 import b64decode, b64encode

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.recipes import fake_mongo as ref_fake
from transferia_tpu.abstract import ChangeItem as RefChangeItem
from transferia_tpu.abstract import OldKeys as RefOldKeys
from transferia_tpu.abstract import TableID as RefTableID
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.table import TableDescription as RefTD
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import (
    ShardingUploadParams as RefSharding,
)
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.mongo import bson as ref_bson
from transferia_tpu.providers.mongo import provider as ref_provider
from transferia_tpu.providers.mongo import wire as ref_wire
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.models.transfer import (
    Runtime,
    ShardingUploadParams,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.mongo import bson as port_bson
from transferia_tpu_torch.providers.mongo import provider as port_provider
from transferia_tpu_torch.providers.mongo import wire as port_wire
from transferia_tpu_torch.recipes import fake_mongo as port_fake
from transferia_tpu_torch.runtime.local import run_replication
from transferia_tpu_torch.tasks import SnapshotLoader, activate_delivery

CPU = {"device": "cpu"}
PKGS = {
    "port": dict(fake=port_fake.FakeMongo, bson=port_bson,
                 provider=port_provider, memory=port_memory,
                 transfer=Transfer, coordinator=MemoryCoordinator,
                 activate=activate_delivery, run=run_replication,
                 loader=SnapshotLoader, runtime=Runtime,
                 sharding=ShardingUploadParams, tid=TableID,
                 td=TableDescription, item=ChangeItem, old_keys=OldKeys,
                 kind=Kind, kw=CPU),
    "jax": dict(fake=ref_fake.FakeMongo, bson=ref_bson,
                provider=ref_provider, memory=ref_memory,
                transfer=RefTransfer, coordinator=RefCoordinator,
                activate=ref_activate, run=ref_run, loader=RefLoader,
                runtime=RefRuntime, sharding=RefSharding, tid=RefTableID,
                td=RefTD, item=RefChangeItem, old_keys=RefOldKeys,
                kind=RefKind, kw={}),
}


def plain(v):
    """Enums by value, ChangeItems and BSON values walked, so that the
    two packages' objects compare."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    if hasattr(v, "value") and type(v).__name__ == "Kind":
        return v.value
    if type(v).__name__ in ("ObjectId", "Binary", "Timestamp",
                            "UTCDateTime"):
        return (type(v).__name__, *(getattr(v, s) for s in v.__slots__))
    return v


def store_rows(store) -> list:
    return [(str(r.table_id), plain(r.kind), plain(r.as_dict()),
             plain(tuple(r.old_keys.key_names)),
             plain(tuple(r.old_keys.key_values)))
            for r in store.rows()]


# -- BSON ---------------------------------------------------------------------

def e2e_documents(b) -> list:
    """tests/e2e/test_mongo_e2e.py's documents, with `b`'s classes."""
    return [
        {"s": "text", "i": 5, "big": 2**40, "f": 1.5, "b": True,
         "none": None, "arr": [1, "two", {"three": 3}],
         "nested": {"x": {"y": "z"}},
         "oid": b.ObjectId(b"\x01" * 12),
         "dt": b.UTCDateTime(1_700_000_000_000),
         "ts": b.Timestamp(100, 2),
         "bin": b"\x00\xff"},
        {"a": 1},
        *[{"_id": f"i{n}", "name": f"item {n}", "price": n * 2.0,
           "tags": ["a", "b"]} for n in range(25)],
        {"_id": {"k": 3}, "v": 3},
        {"neg": -(2**31), "edge": 2**31 - 1, "over": 2**31,
         "min64": -(2**63), "sub": b.Binary(b"\x02\x03", 4),
         "tuple": (1, 2.5, None), "empty": {}, "earr": []},
    ]


def test_bson_encode_is_byte_identical_on_the_e2e_documents():
    ports, refs = e2e_documents(port_bson), e2e_documents(ref_bson)
    for p, r in zip(ports, refs):
        data = port_bson.encode(p)
        assert data == ref_bson.encode(r)
        back, end = port_bson.decode(data)
        assert end == len(data)
        ref_back, _ = ref_bson.decode(data)
        assert plain(back) == plain(ref_back)
        assert plain(port_bson.to_jsonish(back)) == \
            plain(ref_bson.to_jsonish(ref_back))
    assert port_bson.encode({"a": 1}) == \
        b"\x0c\x00\x00\x00\x10a\x00\x01\x00\x00\x00\x00"


def test_bson_decode_of_the_other_types_equals_jax():
    """Element types the encoder never writes (undefined, regex,
    decimal128) and an array whose keys are out of order decode as the
    JAX package's do; unknown types raise."""
    arr = b"\x101\x00" + (7).to_bytes(4, "little") + b"\x100\x00" + \
        (5).to_bytes(4, "little")
    arr = (len(arr) + 5).to_bytes(4, "little") + arr + b"\x00"
    body = (b"\x06u\x00" + b"\x0br\x00ab\x00i\x00"
            + b"\x13d\x00" + bytes(range(16)) + b"\x04a\x00" + arr)
    data = (len(body) + 5).to_bytes(4, "little") + body + b"\x00"
    got, want = port_bson.decode(data)[0], ref_bson.decode(data)[0]
    assert plain(got) == plain(want)
    assert got["r"] == {"$regex": "ab", "$options": "i"}
    assert got["a"] == [5, 7]
    bad = b"\x08\x00\x00\x00\x7fx\x00\x00"
    for mod in (port_bson, ref_bson):
        with pytest.raises(ValueError, match="unsupported element type"):
            mod.decode(bad)
        with pytest.raises(TypeError, match="cannot encode"):
            mod.encode({"x": object()})


_keys = st.text(st.characters(blacklist_characters="\x00",
                              blacklist_categories=("Cs",)), max_size=8)
_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2**63), max_value=2**63 - 1)
            | st.floats(allow_nan=False)
            | st.text(st.characters(blacklist_categories=("Cs",)),
                      max_size=20)
            | st.binary(max_size=20))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=4)
    | st.dictionaries(_keys, inner, max_size=4),
    max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(_keys, _values, max_size=6))
def test_bson_encode_equals_jax_on_generated_documents(doc):
    data = port_bson.encode(doc)
    assert data == ref_bson.encode(doc)
    back, end = port_bson.decode(data)
    assert end == len(data) and back == doc
    assert port_bson.to_jsonish(back) == ref_bson.to_jsonish(back)


# -- SCRAM-SHA-256 ------------------------------------------------------------

def scram_exchange(wire, monkeypatch) -> tuple:
    """The messages `wire`'s client sends for a fixed nonce and server
    first message; the server's final message carries the signature a
    server holding the password computes."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    salt, iters, password = b"salt-1234", 4096, "p@ss'w\"rd"
    sent = []

    def command(db, cmd):
        sent.append((db, {k: (bytes(v.raw) if hasattr(v, "raw") else v)
                          for k, v in cmd.items()}))
        if "saslStart" in cmd:
            first = bytes(cmd["payload"].raw).decode()
            nonce = first.split("r=", 1)[1]
            server_first = (f"r={nonce}SRV,s={b64encode(salt).decode()},"
                            f"i={iters}")
            sent.append(("server-first", server_first))
            return {"ok": 1, "conversationId": 7,
                    "payload": server_first.encode()}
        final = bytes(cmd["payload"].raw).decode()
        without_proof = final.rsplit(",p=", 1)[0]
        client_first_bare = sent[0][1]["payload"].decode()[3:]
        auth = ",".join([client_first_bare, sent[1][1], without_proof])
        salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                     iters)
        server_key = hmac.new(salted, b"Server Key",
                              hashlib.sha256).digest()
        sig = hmac.new(server_key, auth.encode(), hashlib.sha256).digest()
        return {"ok": 1, "conversationId": 7, "done": True,
                "payload": f"v={b64encode(sig).decode()}".encode()}

    conn = wire.MongoConnection(user="reader", password=password,
                                auth_db="admin")
    conn.command = command
    conn._scram_auth()
    return sent


def test_scram_messages_equal_jax(monkeypatch):
    got = scram_exchange(port_wire, monkeypatch)
    want = scram_exchange(ref_wire, monkeypatch)
    assert got == want
    first, final = got[0][1]["payload"], got[2][1]["payload"]
    assert first.startswith(b"n,,n=reader,r=")
    assert b",p=" in final and got[2][1]["conversationId"] == 7


def test_scram_rejects_a_bad_server_signature(monkeypatch):
    for wire in (port_wire, ref_wire):
        conn = wire.MongoConnection(user="u", password="p")
        monkeypatch.setattr(os, "urandom", lambda n: b"\x01" * n)

        def command(db, cmd):
            if "saslStart" in cmd:
                nonce = bytes(cmd["payload"].raw).decode().split("r=")[1]
                return {"ok": 1, "payload":
                        f"r={nonce}X,s={b64encode(b's').decode()},i=1"
                        .encode()}
            return {"ok": 1, "payload": b"v=" + b64encode(b"wrong")}

        conn.command = command
        with pytest.raises(wire.MongoError, match="signature mismatch"):
            conn._scram_auth()
    assert b64decode(b64encode(b"wrong")) == b"wrong"


# -- each package against its own fake ----------------------------------------

def items(n: int) -> list[dict]:
    return [{"_id": f"i{k}", "name": f"item {k}", "price": k * 2.0,
             "tags": ["a", "b"], "n": {"k": k}} for k in range(n)]


def with_fake(pkg, fn):
    srv = PKGS[pkg]["fake"]().start()
    try:
        return fn(srv)
    finally:
        srv.stop()


@pytest.mark.parametrize("batch_rows", [10, 1000])
def test_snapshot_equals_jax(batch_rows):
    def run(pkg):
        p = PKGS[pkg]

        def go(srv):
            srv.seed("shop", "items", items(25))
            srv.seed("shop", "other", [{"_id": k, "v": [k, {"x": None}]}
                                       for k in range(7)])
            sink = f"mongo-snap-{pkg}-{batch_rows}"
            store = p["memory"].get_store(sink)
            store.clear()
            cp = p["coordinator"]()
            t = p["transfer"](
                id=sink, src=p["provider"].MongoSourceParams(
                    host="127.0.0.1", port=srv.port, database="shop",
                    batch_rows=batch_rows),
                dst=p["memory"].MemoryTargetParams(sink_id=sink))
            p["activate"](t, cp, **p["kw"])
            # the two tables load on their own threads: rows in a table
            # keep their order, the tables interleave as they come
            rows = store_rows(store)
            return ({tb: [r for r in rows if r[0] == tb]
                     for tb in ("shop.items", "shop.other")},
                    cp.get_transfer_state(sink), len(store.batches))

        return with_fake(pkg, go)

    got, want = run("port"), run("jax")
    assert got == want
    rows = got[0]["shop.items"] + got[0]["shop.other"]
    assert len(rows) == 32
    by_id = {r[2]["_id"]: r[2]["document"] for r in rows}
    assert by_id["i3"]["tags"] == ["a", "b"] and by_id["i3"]["n"] == {
        "k": 3}


def test_id_range_shards_equal_jax():
    def run(pkg):
        p = PKGS[pkg]

        def go(srv):
            srv.seed("db", "big", [{"_id": i, "v": f"v{i}"}
                                   for i in range(100)])
            srv.seed("db", "mails", [{"_id": f"u{i:03d}@x.io", "v": i}
                                     for i in range(57)])
            srv.seed("db", "mixed", [{"_id": {"k": i}, "v": i}
                                     for i in range(10)])
            out = {}
            for coll, n in (("big", 100), ("mails", 57), ("mixed", 10)):
                params = p["provider"].MongoSourceParams(
                    host="127.0.0.1", port=srv.port, database="db",
                    collections=[coll], batch_rows=10, shard_parts=4)
                parts = p["provider"].MongoStorage(params).shard_table(
                    p["td"](id=p["tid"]("db", coll), eta_rows=n))
                sink = f"mongo-shard-{pkg}-{coll}"
                store = p["memory"].get_store(sink)
                store.clear()
                t = p["transfer"](
                    id=f"mg-{coll}", src=params,
                    dst=p["memory"].MemoryTargetParams(sink_id=sink),
                    runtime=p["runtime"](sharding=p["sharding"](
                        process_count=3)))
                cp = p["coordinator"]()
                p["loader"](t, cp, operation_id=f"op-{coll}",
                            **p["kw"]).upload_tables()
                out[coll] = ([(d.filter, d.eta_rows) for d in parts],
                             sorted(r[2]["_id"] for r in store_rows(store)))
            return out

        return with_fake(pkg, go)

    got, want = run("port"), run("jax")
    assert got == want
    assert len(got["big"][0]) == 4 and len(got["mails"][0]) == 4
    assert got["big"][1] == sorted(str(i) for i in range(100))
    assert len(got["mixed"][0]) == 1 and len(got["mixed"][1]) == 10


def change_events(seed: int, n: int, start: int = 0) -> list[dict]:
    """Seeded change events over a users collection: inserts, updates,
    replaces and deletes of live ids, an update whose document was
    deleted before the lookup, and a drop."""
    rng = np.random.default_rng(seed)
    live, out, nxt = [], [], 1000 + start
    for i in range(n):
        op = rng.choice(["insert", "update", "replace", "delete"],
                        p=[0.4, 0.3, 0.15, 0.15]) if live else "insert"
        if op == "insert":
            key, nxt = f"u{nxt}@x.io", nxt + 1
            live.append(key)
        else:
            key = live[int(rng.integers(len(live)))]
            if op == "delete":
                live.remove(key)
        ev = {"_id": {"_data": f"tok-{start + i:06d}"},
              "operationType": op, "ns": {"db": "app", "coll": "users"},
              "documentKey": {"_id": key}}
        if op != "delete":
            ev["fullDocument"] = {"_id": key, "v": int(rng.integers(1e6)),
                                  "tags": ["t", int(i)]}
        out.append(ev)
    out.insert(n // 2, {"_id": {"_data": f"tok-{start + n:06d}-x"},
                        "operationType": "update",
                        "ns": {"db": "app", "coll": "users"},
                        "documentKey": {"_id": "gone@x.io"},
                        "fullDocument": None})
    out.append({"_id": {"_data": f"tok-{start + n:06d}-y"},
                "operationType": "drop",
                "ns": {"db": "app", "coll": "old"}})
    return out


def stream_until(p, t, cp, done) -> None:
    """run_replication on a thread until `done()` (or the recorded token
    is the string `done`), then stopped through its stop event."""
    if isinstance(done, str):
        token = done

        def done():
            return cp.get_transfer_state(t.id).get(
                "mongo_resume_token") == token

    stop = threading.Event()
    th = threading.Thread(target=p["run"], args=(t, cp), kwargs={
        "stop_event": stop, "backoff": 0.1, **p["kw"]}, daemon=True)
    th.start()
    deadline = time.monotonic() + 30
    while not done() and time.monotonic() < deadline:
        time.sleep(0.02)
    stop.set()
    th.join(timeout=15)
    assert done() and not th.is_alive()


def test_change_stream_and_resume_equal_jax():
    first, second = change_events(3, 60), change_events(4, 25, start=500)

    def run(pkg):
        p = PKGS[pkg]

        def go(srv):
            sink = f"mongo-cs-{pkg}"
            store = p["memory"].get_store(sink)
            store.clear()
            cp = p["coordinator"]()
            t = p["transfer"](
                id=sink, type="INCREMENT_ONLY",
                src=p["provider"].MongoSourceParams(
                    host="127.0.0.1", port=srv.port, database="app",
                    batch_rows=16),
                dst=p["memory"].MemoryTargetParams(sink_id=sink))
            for ev in first:
                srv.feed_event(ev)
            stream_until(p, t, cp, first[-1]["_id"]["_data"])
            after_first = store_rows(store)
            for ev in second:
                srv.feed_event(ev)
            stream_until(p, t, cp, second[-1]["_id"]["_data"])
            return after_first, store_rows(store), \
                cp.get_transfer_state(sink)

        return with_fake(pkg, go)

    got, want = run("port"), run("jax")
    assert got == want
    after_first, rows, state = got
    # the drop and the lost update deliver nothing
    assert len(after_first) == 60 and len(rows) == 85
    assert state == {"mongo_resume_token": "tok-000525-y"}
    kinds = {r[1] for r in rows}
    assert kinds == {"insert", "update", "delete"}


def test_change_stream_resumes_mid_stream_without_loss_or_duplicate():
    """The port's fake replays from the recorded token: a stream stopped
    after some batches resumes where its checkpoint is, and the store
    holds every event once, in order."""
    events = change_events(11, 400)
    srv = port_fake.FakeMongo().start()
    try:
        store = port_memory.get_store("mongo-resume")
        store.clear()
        cp = MemoryCoordinator()
        t = Transfer(id="mongo-resume", type="INCREMENT_ONLY",
                     src=port_provider.MongoSourceParams(
                         host="127.0.0.1", port=srv.port, database="app",
                         batch_rows=32),
                     dst=port_memory.MemoryTargetParams(
                         sink_id="mongo-resume"))
        srv.feed_events(events)
        stream_until(PKGS["port"], t, cp,
                     lambda: store.row_count() >= 150)
        mid = cp.get_transfer_state("mongo-resume")["mongo_resume_token"]
        stream_until(PKGS["port"], t, cp, events[-1]["_id"]["_data"])
        assert srv.resumed_after == [None, mid]
        delivered = [(r[1], r[2].get("_id") or r[4][0]) for r in
                     store_rows(store)]
        want = [("insert" if e["operationType"] == "insert" else
                 "delete" if e["operationType"] == "delete" else "update",
                 e["documentKey"]["_id"]) for e in events
                if e["operationType"] in ("insert", "update", "replace",
                                          "delete")
                and not (e["operationType"] == "update"
                         and e.get("fullDocument") is None)]
        assert delivered == want
    finally:
        srv.stop()
    with pytest.raises(port_wire.MongoError, match="HistoryLost"):
        srv2 = port_fake.FakeMongo().start()
        try:
            conn = port_wire.MongoConnection("127.0.0.1", srv2.port)
            conn.connect().command("app", {
                "aggregate": 1, "cursor": {},
                "pipeline": [{"$changeStream": {
                    "resumeAfter": {"_data": "nope"}}}]})
        finally:
            srv2.stop()


def test_sink_upserts_and_deletes_equal_jax():
    def run(pkg):
        p = PKGS[pkg]
        schema = p["provider"].DOC_SCHEMA

        def it(kind, key, doc=None):
            if kind == "delete":
                return p["item"](kind=p["kind"].DELETE, schema="dw",
                                 table="out", table_schema=schema,
                                 old_keys=p["old_keys"](("_id",), (key,)))
            return p["item"](kind=p["kind"](kind), schema="dw",
                             table="out", column_names=("_id", "document"),
                             column_values=(key, doc), table_schema=schema)

        def go(srv):
            sinker = p["provider"].MongoSinker(
                p["provider"].MongoTargetParams(host="127.0.0.1",
                                                port=srv.port))
            sinker.push([it("insert", f"k{i}", {"v": i, "a": [i]})
                         for i in range(6)])
            sinker.push([it("delete", "k1"), it("insert", "k1", {"v": 9}),
                         it("update", "k2", {"v": 20}), it("delete", "k3"),
                         it("insert", "k9", "scalar")])
            sinker.close()
            return srv.dbs

        return with_fake(pkg, go)

    got, want = run("port"), run("jax")
    assert plain(got) == plain(want)
    out = got["dw"]["out"]
    assert sorted(out) == ["k0", "k1", "k2", "k4", "k5", "k9"]
    assert out["k1"] == {"v": 9, "_id": "k1"}
    assert out["k9"] == {"value": "scalar", "_id": "k9"}


def test_provider_registered_and_pinged():
    from transferia_tpu_torch.providers.registry import get_provider

    srv = port_fake.FakeMongo().start()
    try:
        t = Transfer(id="mp", src=port_provider.MongoSourceParams(
            host="127.0.0.1", port=srv.port, database="app"),
            dst=port_provider.MongoTargetParams(host="127.0.0.1",
                                                port=srv.port))
        prov = get_provider("mongo", t, device="cpu")
        assert type(prov.storage()).__name__ == "MongoStorage"
        assert type(prov.source()).__name__ == "MongoChangeStreamSource"
        assert type(prov.sinker()).__name__ == "MongoSinker"
        assert prov.test().ok
    finally:
        srv.stop()
