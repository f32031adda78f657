"""MongoDB OP_MSG wire client (the port's copy of
``transferia_tpu/providers/mongo/wire.py``).

Message: header (messageLength, requestID, responseTo, opCode=2013) +
flagBits (int32) + section kind 0 (one BSON command document).  Commands
run against the `admin` or target database via the `$db` field; SCRAM
auth uses saslStart/saslContinue.  Exhaustible cursors via find/getMore.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import socket
import struct
import threading
from base64 import b64decode, b64encode
from typing import Any, Iterator, Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.providers.mongo import bson
from transferia_tpu_torch.utils.net import recv_exact

OP_MSG = 2013


class MongoError(CategorizedError):
    def __init__(self, message: str, code: int = 0):
        super().__init__(CategorizedError.SOURCE, message)
        self.code = code


class MongoConnection:
    def __init__(self, host: str = "localhost", port: int = 27017,
                 user: str = "", password: str = "",
                 auth_db: str = "admin", timeout: float = 60.0):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.auth_db = auth_db
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._req = 0
        self._lock = threading.Lock()

    def connect(self) -> "MongoConnection":
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = self.command("admin", {"hello": 1})
        if self.user:
            mechs = hello.get("saslSupportedMechs", [])
            self._scram_auth()
        return self

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    # -- OP_MSG -------------------------------------------------------------
    def command(self, db: str, cmd: dict) -> dict:
        body = dict(cmd)
        body["$db"] = db
        payload = struct.pack("<I", 0) + b"\x00" + bson.encode(body)
        with self._lock:
            self._req += 1
            req = self._req
            header = struct.pack("<iiii", 16 + len(payload), req, 0, OP_MSG)
            # I/O under self._lock is the design: the lock serializes
            # request/response framing on the single wire connection
            try:
                self.sock.sendall(header + payload)  # trtpu: ignore[LCK001]
                resp_len = struct.unpack(
                    "<i", recv_exact(self.sock, 4)  # trtpu: ignore[LCK001]
                )[0]
                resp = recv_exact(  # trtpu: ignore[LCK001]
                    self.sock, resp_len - 4)
            except (OSError, ConnectionError) as e:
                raise MongoError(f"mongo io error: {e}") from e
        # resp: requestID(4) responseTo(4) opCode(4) flags(4) kind(1) doc
        op_code = struct.unpack_from("<i", resp, 8)[0]
        if op_code != OP_MSG:
            raise MongoError(f"unexpected opcode {op_code}")
        doc, _ = bson.decode(resp, 17)
        if doc.get("ok") != 1 and doc.get("ok") != 1.0:
            raise MongoError(
                f"{doc.get('codeName', 'Error')}: "
                f"{doc.get('errmsg', 'command failed')}",
                code=int(doc.get("code", 0)),
            )
        return doc

    # -- auth (SCRAM-SHA-256) ----------------------------------------------
    def _scram_auth(self) -> None:
        nonce = b64encode(os.urandom(18)).decode()
        first_bare = f"n={self.user},r={nonce}"
        start = self.command(self.auth_db, {
            "saslStart": 1,
            "mechanism": "SCRAM-SHA-256",
            "payload": bson.Binary(("n,," + first_bare).encode()),
            "options": {"skipEmptyExchange": True},
        })
        server_first = bytes(
            start["payload"].raw if isinstance(start["payload"], bson.Binary)
            else start["payload"]
        ).decode()
        parts = dict(p.split("=", 1) for p in server_first.split(","))
        r, s, i = parts["r"], parts["s"], int(parts["i"])
        if not r.startswith(nonce):
            raise MongoError("SCRAM nonce mismatch")
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(),
                                     b64decode(s), i)
        client_key = hmac_mod.new(salted, b"Client Key",
                                  hashlib.sha256).digest()
        stored = hashlib.sha256(client_key).digest()
        without_proof = f"c={b64encode(b'n,,').decode()},r={r}"
        auth_msg = ",".join([first_bare, server_first, without_proof])
        sig = hmac_mod.new(stored, auth_msg.encode(),
                           hashlib.sha256).digest()
        proof = b64encode(bytes(
            a ^ b for a, b in zip(client_key, sig)
        )).decode()
        final = self.command(self.auth_db, {
            "saslContinue": 1,
            "conversationId": start.get("conversationId", 1),
            "payload": bson.Binary(
                f"{without_proof},p={proof}".encode()
            ),
        })
        fin_payload = bytes(
            final["payload"].raw
            if isinstance(final["payload"], bson.Binary)
            else final["payload"]
        ).decode()
        server_key = hmac_mod.new(salted, b"Server Key",
                                  hashlib.sha256).digest()
        expect = hmac_mod.new(server_key, auth_msg.encode(),
                              hashlib.sha256).digest()
        got = dict(p.split("=", 1) for p in fin_payload.split(","))
        if b64decode(got.get("v", "")) != expect:
            raise MongoError("SCRAM server signature mismatch")

    # -- cursors ------------------------------------------------------------
    def find_all(self, db: str, collection: str,
                 filter: Optional[dict] = None,
                 sort: Optional[dict] = None,
                 projection: Optional[dict] = None,
                 batch_size: int = 1000) -> Iterator[list[dict]]:
        """Yields batches of documents until the cursor is exhausted."""
        cmd: dict[str, Any] = {
            "find": collection,
            "batchSize": batch_size,
        }
        if filter:
            cmd["filter"] = filter
        if sort:
            cmd["sort"] = sort
        if projection:
            cmd["projection"] = projection
        out = self.command(db, cmd)
        cursor = out["cursor"]
        batch = cursor.get("firstBatch", [])
        if batch:
            yield batch
        cid = cursor.get("id", 0)
        while cid:
            out = self.command(db, {
                "getMore": cid, "collection": collection,
                "batchSize": batch_size,
            })
            cursor = out["cursor"]
            batch = cursor.get("nextBatch", [])
            cid = cursor.get("id", 0)
            if batch:
                yield batch

    def list_collections(self, db: str) -> list[str]:
        out = self.command(db, {"listCollections": 1,
                                "nameOnly": True})
        return sorted(
            c["name"] for c in out["cursor"].get("firstBatch", [])
            if c.get("type", "collection") == "collection"
            and not c["name"].startswith("system.")
        )

    def count(self, db: str, collection: str) -> int:
        out = self.command(db, {"count": collection})
        return int(out.get("n", 0))
