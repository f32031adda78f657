"""In-process fake MongoDB server (OP_MSG subset), the port's own: the
commands of ``tests/recipes/fake_mongo.py`` over the port's BSON codec,
and a change stream that resumes.

Every fed change event stays in the fake's log.  An `aggregate`
``$changeStream`` stage with ``resumeAfter: {_data: token}`` serves the
events after that token (an unknown token fails, as a server whose
oplog no longer holds it does: ChangeStreamHistoryLost); without one it
serves the events no stream has been served yet, as the JAX package's
fake does.  A live cursor's `getMore` serves at most `batchSize` events
past its position, waiting up to `maxTimeMS` (at most 0.5 s) for one.
`resumed_after` records each stream's token.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Optional

from transferia_tpu_torch.providers.mongo import bson

OP_MSG = 2013
# a request's size limit (MongoDB's maxMessageSizeBytes)
MAX_MESSAGE = 48_000_000


class FakeMongo:
    def __init__(self, host: str = "127.0.0.1"):
        # db -> collection -> {str(_id): doc}
        self.dbs: dict[str, dict[str, dict]] = {}
        self.events: list[dict] = []
        self.commands: list[dict] = []
        self.resumed_after: list[Optional[str]] = []
        self.lock = threading.RLock()
        self._fed = threading.Condition(self.lock)
        self.host = host
        self.port = 0
        self._srv: Optional[socketserver.ThreadingTCPServer] = None
        self._cursors: dict[int, list] = {}
        self._streams: dict[int, int] = {}   # live cursor -> log position
        self._served = 0                     # log position any stream saw
        self._next_cursor = 100
        # id(document) -> (document, its BSON): a stored document is
        # encoded once, however many cursors serve it
        self._encoded: dict[int, tuple[dict, bytes]] = {}

    def seed(self, db: str, coll: str, docs: list[dict]) -> None:
        with self.lock:
            store = self.dbs.setdefault(db, {}).setdefault(coll, {})
            for d in docs:
                store[str(d.get("_id"))] = d

    def feed_event(self, ev: dict) -> None:
        self.feed_events([ev])

    def feed_events(self, evs: list[dict]) -> None:
        with self.lock:
            self.events.extend(evs)
            self._fed.notify_all()

    def start(self) -> "FakeMongo":
        fake = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                self.request.settimeout(600)
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)

            def handle(self):
                try:
                    while True:
                        ln = struct.unpack("<i", self._recv(4))[0]
                        if not 16 <= ln <= MAX_MESSAGE:
                            return
                        payload = self._recv(ln - 4)
                        req_id = struct.unpack_from("<i", payload, 0)[0]
                        # reqID(4) respTo(4) opCode(4) flags(4) kind(1)
                        doc, _ = bson.decode(payload, 17)
                        resp = fake.dispatch(doc)
                        body = struct.pack("<I", 0) + b"\x00" + (
                            resp if isinstance(resp, bytes)
                            else bson.encode(resp))
                        header = struct.pack(
                            "<iiii", 16 + len(body), 1, req_id, OP_MSG)
                        self.request.sendall(header + body)
                except (ConnectionError, OSError, struct.error):
                    return

            def _recv(self, n):
                buf = bytearray()
                while len(buf) < n:
                    chunk = self.request.recv(min(n - len(buf), 1 << 20))
                    if not chunk:
                        raise ConnectionError()
                    buf += chunk
                return bytes(buf)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((self.host, 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, name="fake-mongo",
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None

    # -- command dispatch ----------------------------------------------------
    def dispatch(self, cmd: dict) -> dict:
        with self.lock:
            self.commands.append(cmd)
        db = cmd.get("$db", "admin")
        if "hello" in cmd or "isMaster" in cmd:
            return {"ok": 1, "maxWireVersion": 17,
                    "saslSupportedMechs": ["SCRAM-SHA-256"]}
        if "ping" in cmd:
            return {"ok": 1}
        if "listCollections" in cmd:
            with self.lock:
                colls = sorted(self.dbs.get(db, {}))
            return {"ok": 1, "cursor": {"id": 0, "ns": f"{db}.$cmd",
                    "firstBatch": [
                        {"name": c, "type": "collection"} for c in colls
                    ]}}
        if "count" in cmd:
            with self.lock:
                n = len(self.dbs.get(db, {}).get(cmd["count"], {}))
            return {"ok": 1, "n": n}
        if "find" in cmd:
            return self._find(db, cmd)
        if "getMore" in cmd:
            return self._get_more(cmd)
        if "aggregate" in cmd:
            return self._change_stream(cmd)
        if "update" in cmd:
            with self.lock:
                store = self.dbs.setdefault(db, {}).setdefault(
                    cmd["update"], {})
                n = 0
                for u in cmd.get("updates", []):
                    doc = u["u"]
                    store[str(doc.get("_id"))] = doc
                    n += 1
            return {"ok": 1, "n": n}
        if "delete" in cmd:
            with self.lock:
                store = self.dbs.setdefault(db, {}).setdefault(
                    cmd["delete"], {})
                n = 0
                for d in cmd.get("deletes", []):
                    key = str(d["q"].get("_id"))
                    if key in store:
                        del store[key]
                        n += 1
            return {"ok": 1, "n": n}
        return {"ok": 0, "errmsg": f"unhandled command {list(cmd)[:1]}",
                "code": 59, "codeName": "CommandNotFound"}

    def _doc_bytes(self, doc: dict) -> bytes:
        hit = self._encoded.get(id(doc))
        if hit is not None and hit[0] is doc:
            return hit[1]
        raw = bson.encode(doc)
        self._encoded[id(doc)] = (doc, raw)
        return raw

    def _cursor_reply(self, cid: int, ns: str, key: str,
                      docs: list) -> bytes:
        """bson.encode({"ok": 1, "cursor": {"id": cid, "ns": ns, key:
        docs}}), each document's bytes from the cache."""
        def document(body: bytes) -> bytes:
            return struct.pack("<i", len(body) + 5) + body + b"\x00"

        arr = b"".join(b"\x03" + str(i).encode() + b"\x00"
                       + self._doc_bytes(d) for i, d in enumerate(docs))
        cursor = document(bson._encode_element("id", cid)
                          + bson._encode_element("ns", ns)
                          + b"\x04" + key.encode() + b"\x00"
                          + document(arr))
        return document(bson._encode_element("ok", 1)
                        + b"\x03cursor\x00" + cursor)

    @staticmethod
    def _id_order(d: dict):
        v = d.get("_id")
        return (str(type(v)),
                v if isinstance(v, (int, float)) else str(v))

    def _find(self, db: str, cmd: dict) -> dict:
        with self.lock:
            docs = list(self.dbs.get(db, {}).get(cmd["find"], {}).values())
        docs.sort(key=self._id_order)
        idc = (cmd.get("filter") or {}).get("_id")
        if isinstance(idc, dict):
            if "$gte" in idc:
                docs = [d for d in docs if d.get("_id") >= idc["$gte"]]
            if "$lt" in idc:
                docs = [d for d in docs if d.get("_id") < idc["$lt"]]
        proj = cmd.get("projection")
        if proj:
            keep = {k for k, v in proj.items() if v}
            docs = [{k: d[k] for k in keep if k in d} for d in docs]
        size = cmd.get("batchSize", 101)
        first, rest = docs[:size], docs[size:]
        cid = 0
        if rest:
            with self.lock:
                cid = self._next_cursor
                self._next_cursor += 1
                self._cursors[cid] = rest
        if proj:
            return {"ok": 1, "cursor": {"id": cid,
                                        "ns": f"{db}.{cmd['find']}",
                                        "firstBatch": first}}
        return self._cursor_reply(cid, f"{db}.{cmd['find']}", "firstBatch",
                                  first)

    def _change_stream(self, cmd: dict) -> dict:
        stage = (cmd.get("pipeline") or [{}])[0].get("$changeStream", {})
        token = (stage.get("resumeAfter") or {}).get("_data")
        with self.lock:
            if token is None:
                pos = self._served
            else:
                pos = next((i + 1 for i, ev in enumerate(self.events)
                            if (ev.get("_id") or {}).get("_data")
                            == token), None)
                if pos is None:
                    return {"ok": 0, "code": 286,
                            "codeName": "ChangeStreamHistoryLost",
                            "errmsg": f"resume token {token!r} is not "
                                      f"in the oplog"}
            self.resumed_after.append(token)
            cid = self._next_cursor
            self._next_cursor += 1
            size = (cmd.get("cursor") or {}).get("batchSize", 101)
            batch = self.events[pos:pos + size]
            self._streams[cid] = pos + len(batch)
            self._served = max(self._served, pos + len(batch))
        return {"ok": 1, "cursor": {"id": cid, "ns": "x",
                                    "firstBatch": batch}}

    def _get_more(self, cmd: dict) -> dict:
        cid = cmd["getMore"]
        size = cmd.get("batchSize", 101)
        with self.lock:
            if cid in self._streams:
                # change stream: the events past this cursor's position,
                # waiting up to maxTimeMS for one; the cursor stays open
                pos = self._streams[cid]
                if pos >= len(self.events):
                    self._fed.wait(min(cmd.get("maxTimeMS", 0), 500)
                                   / 1000.0)
                batch = self.events[pos:pos + size]
                self._streams[cid] = pos + len(batch)
                self._served = max(self._served, pos + len(batch))
                return {"ok": 1, "cursor": {"id": cid, "ns": "x",
                                            "nextBatch": batch}}
            rest = self._cursors.get(cid, [])
            batch, rest = rest[:size], rest[size:]
            if rest:
                self._cursors[cid] = rest
            else:
                self._cursors.pop(cid, None)
        return self._cursor_reply(cid if rest else 0, "x", "nextBatch",
                                  batch)
