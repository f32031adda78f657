"""PostgreSQL frontend/backend protocol v3 client, pure stdlib (the
port's copy of ``transferia_tpu/providers/postgres/wire.py``).

Implements what the provider needs: startup, auth (trust / cleartext / md5 /
SCRAM-SHA-256), the simple query protocol, and COPY OUT/IN streaming.
Message framing per the PostgreSQL protocol docs: 1-byte type + int32
length (inclusive) + payload.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
from base64 import b64decode, b64encode
from typing import Iterator, Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.utils.net import BufferedSock, recv_exact


class PGError(CategorizedError):
    def __init__(self, message: str, fields: Optional[dict] = None):
        super().__init__(CategorizedError.SOURCE, message)
        self.fields = fields or {}

    @property
    def sqlstate(self) -> str:
        return self.fields.get("C", "")


class PGConnection:
    def __init__(self, host: str = "localhost", port: int = 5432,
                 database: str = "postgres", user: str = "postgres",
                 password: str = "", timeout: float = 60.0,
                 replication: bool = False):
        self.host = host
        self.port = port
        self.database = database
        self.user = user
        self.password = password
        self.timeout = timeout
        self.replication = replication
        self.sock: Optional[socket.socket] = None
        self.parameters: dict[str, str] = {}
        self.backend_pid = 0

    # -- framing ------------------------------------------------------------
    def _send(self, type_byte: bytes, payload: bytes) -> None:
        msg = type_byte + struct.pack("!I", len(payload) + 4) + payload
        self.sock.sendall(msg)

    def _recv_exact(self, n: int) -> bytes:
        try:
            return recv_exact(self.sock, n)
        except ConnectionError as e:
            raise PGError(str(e)) from e

    def _recv_message(self) -> tuple[bytes, bytes]:
        header = self._recv_exact(5)
        type_byte = header[:1]
        length = struct.unpack("!I", header[1:5])[0]
        payload = self._recv_exact(length - 4) if length > 4 else b""
        if type_byte == b"E":
            raise PGError(self._error_text(payload),
                          self._error_fields(payload))
        return type_byte, payload

    @staticmethod
    def _error_fields(payload: bytes) -> dict:
        fields = {}
        for part in payload.split(b"\x00"):
            if part:
                fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
        return fields

    @classmethod
    def _error_text(cls, payload: bytes) -> str:
        f = cls._error_fields(payload)
        return f"{f.get('S', 'ERROR')}: {f.get('M', 'unknown')} " \
               f"(sqlstate {f.get('C', '?')})"

    # -- connection ---------------------------------------------------------
    def connect(self) -> "PGConnection":
        raw = socket.create_connection((self.host, self.port),
                                       timeout=self.timeout)
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # buffered reads: COPY streams arrive as one small frame per row
        self.sock = BufferedSock(raw)
        params = {
            "user": self.user,
            "database": self.database,
            "client_encoding": "UTF8",
            "application_name": "transferia-tpu",
        }
        if self.replication:
            params["replication"] = "database"
        body = b"".join(
            k.encode() + b"\x00" + v.encode() + b"\x00"
            for k, v in params.items()
        ) + b"\x00"
        startup = struct.pack("!II", len(body) + 8, 196608) + body
        self.sock.sendall(startup)
        self._auth_loop()
        return self

    def _auth_loop(self) -> None:
        while True:
            t, payload = self._recv_message()
            if t == b"R":
                code = struct.unpack("!I", payload[:4])[0]
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext
                    self._send(b"p", self.password.encode() + b"\x00")
                elif code == 5:  # md5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        (self.password + self.user).encode()
                    ).hexdigest()
                    digest = "md5" + hashlib.md5(
                        inner.encode() + salt
                    ).hexdigest()
                    self._send(b"p", digest.encode() + b"\x00")
                elif code == 10:  # SASL
                    self._scram(payload[4:])
                elif code in (11, 12):
                    continue  # SASL continue handled in _scram
                else:
                    raise PGError(f"unsupported auth method {code}")
            elif t == b"S":
                k, v, _ = payload.split(b"\x00", 2)
                self.parameters[k.decode()] = v.decode()
            elif t == b"K":
                self.backend_pid = struct.unpack("!I", payload[:4])[0]
            elif t == b"Z":
                return
            # ignore N (notice) and others

    def _scram(self, mechanisms: bytes) -> None:
        """SCRAM-SHA-256 (RFC 5802/7677)."""
        if b"SCRAM-SHA-256" not in mechanisms:
            raise PGError(f"no supported SASL mechanism in {mechanisms!r}")
        nonce = b64encode(os.urandom(18)).decode()
        first_bare = f"n=,r={nonce}"
        init = b"SCRAM-SHA-256\x00" + struct.pack(
            "!I", len(first_bare) + 3
        ) + b"n,," + first_bare.encode()
        self._send(b"p", init)
        t, payload = self._recv_message()
        code = struct.unpack("!I", payload[:4])[0]
        if code != 11:
            raise PGError(f"expected SASLContinue, got {code}")
        server_first = payload[4:].decode()
        parts = dict(p.split("=", 1) for p in server_first.split(","))
        r, s, i = parts["r"], parts["s"], int(parts["i"])
        if not r.startswith(nonce):
            raise PGError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), b64decode(s), i
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c={b64encode(b'n,,').decode()},r={r}"
        auth_message = ",".join([first_bare, server_first, without_proof])
        client_sig = hmac.new(stored_key, auth_message.encode(),
                              hashlib.sha256).digest()
        proof = b64encode(
            bytes(a ^ b for a, b in zip(client_key, client_sig))
        ).decode()
        self._send(b"p", f"{without_proof},p={proof}".encode())
        t, payload = self._recv_message()
        code = struct.unpack("!I", payload[:4])[0]
        if code != 12:
            raise PGError(f"expected SASLFinal, got {code}")
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        expect = hmac.new(server_key, auth_message.encode(),
                          hashlib.sha256).digest()
        final = dict(p.split("=", 1)
                     for p in payload[4:].decode().split(","))
        if b64decode(final.get("v", "")) != expect:
            raise PGError("SCRAM server signature mismatch")

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._send(b"X", b"")
            except OSError:
                pass
            self.sock.close()
            self.sock = None

    # -- simple query protocol ---------------------------------------------
    def query(self, sql: str) -> list[dict]:
        """Run a query; text-format rows as dicts (None for NULL)."""
        self._send(b"Q", sql.encode() + b"\x00")
        columns: list[str] = []
        rows: list[dict] = []
        error: Optional[PGError] = None
        while True:
            try:
                t, payload = self._recv_message()
            except PGError as e:
                error = e
                continue  # drain until ReadyForQuery
            if t == b"T":
                columns = self._parse_row_description(payload)
            elif t == b"D":
                rows.append(dict(zip(
                    columns, self._parse_data_row(payload)
                )))
            elif t == b"Z":
                if error is not None:
                    raise error
                return rows
            # C (complete), N (notice), I (empty) ignored

    @staticmethod
    def _parse_row_description(payload: bytes) -> list[str]:
        n = struct.unpack("!H", payload[:2])[0]
        pos = 2
        cols = []
        for _ in range(n):
            end = payload.index(b"\x00", pos)
            cols.append(payload[pos:end].decode())
            pos = end + 1 + 18  # skip fixed field metadata
        return cols

    @staticmethod
    def _parse_data_row(payload: bytes) -> list[Optional[str]]:
        n = struct.unpack("!H", payload[:2])[0]
        pos = 2
        out = []
        for _ in range(n):
            ln = struct.unpack("!i", payload[pos:pos + 4])[0]
            pos += 4
            if ln < 0:
                out.append(None)
            else:
                out.append(payload[pos:pos + ln].decode("utf-8", "replace"))
                pos += ln
        return out

    def scalar(self, sql: str):
        rows = self.query(sql)
        if not rows:
            return None
        return next(iter(rows[0].values()))

    # -- COPY ---------------------------------------------------------------
    def copy_out(self, sql: str) -> Iterator[bytes]:
        """COPY ... TO STDOUT: yields raw CopyData chunks."""
        self._send(b"Q", sql.encode() + b"\x00")
        error: Optional[PGError] = None
        while True:
            try:
                t, payload = self._recv_message()
            except PGError as e:
                error = e
                continue
            if t == b"d":
                yield payload
            elif t == b"Z":
                if error is not None:
                    raise error
                return
            # H (CopyOutResponse), c (CopyDone), C ignored

    def _drain_until_ready(self, first_error: "PGError") -> None:
        """Consume messages through ReadyForQuery so the connection stays
        usable, then raise — an early raise leaves replies buffered and
        every later query would read the previous query's responses."""
        while True:
            try:
                t, _ = self._recv_message()
            except PGError:
                continue
            if t == b"Z":
                raise first_error

    def copy_in(self, sql: str, chunks) -> None:
        """COPY ... FROM STDIN: send chunks, finish, wait for commit."""
        self._send(b"Q", sql.encode() + b"\x00")
        try:
            t, payload = self._recv_message()
        except PGError as e:
            self._drain_until_ready(e)
        if t != b"G":
            self._drain_until_ready(
                PGError(f"expected CopyInResponse, got {t!r}")
            )
        for chunk in chunks:
            if chunk:
                self._send(b"d", chunk)
        self._send(b"c", b"")
        error: Optional[PGError] = None
        while True:
            try:
                t, payload = self._recv_message()
            except PGError as e:
                error = e
                continue
            if t == b"Z":
                if error is not None:
                    raise error
                return
