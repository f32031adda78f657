"""In-process fake MySQL server (client/server protocol subset): the
port's copy of the query side of ``tests/recipes/fake_mysql.py``.

Handshake v10 with mysql_native_password verification, COM_QUERY with
text-protocol resultsets (EOF framing), COM_PING.  SQL handling is
regex-dispatch over the statements the snapshot source issues, and the
activation cleanup's DROP and TRUNCATE apply to the in-memory tables.
The JAX fake's binlog feed and stream and its other writes (CREATE,
INSERT/REPLACE, UPDATE, DELETE, with their `_conds`/`_match` helpers)
serve the CDC tail and the MySQL target, which the port does not have
yet (ROADMAP.md A7), and are left out.
"""

from __future__ import annotations

import hashlib
import os
import re
import socketserver
import struct
import threading
from typing import Optional


class FakeMyTable:
    def __init__(self, database: str, name: str, columns: list[tuple],
                 rows: list[dict] | None = None):
        # columns: (name, data_type, full_type, is_pk, notnull)
        self.database = database
        self.name = name
        self.columns = columns
        self.rows = rows or []


class FakeMySQL:
    def __init__(self, user: str = "root", password: str = ""):
        self.user = user
        self.password = password
        self.tables: dict[tuple[str, str], FakeMyTable] = {}
        self.queries: list[str] = []
        self.lock = threading.RLock()
        self.port = 0
        self._srv = None

    def add_table(self, t: FakeMyTable) -> None:
        with self.lock:
            self.tables[(t.database, t.name)] = t

    def start(self) -> "FakeMySQL":
        fake = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    _MySession(self.request, fake).run()
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()


def _lenenc(v: Optional[bytes]) -> bytes:
    if v is None:
        return b"\xfb"
    n = len(v)
    if n < 0xFB:
        return bytes([n]) + v
    if n < 0x10000:
        return b"\xfc" + struct.pack("<H", n) + v
    return b"\xfd" + struct.pack("<I", n)[:3] + v


class _MySession:
    def __init__(self, sock, fake: FakeMySQL):
        self.sock = sock
        self.fake = fake
        self.seq = 0

    def recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError()
            out += chunk
        return out

    def read_packet(self) -> bytes:
        header = self.recv_exact(4)
        length = header[0] | (header[1] << 8) | (header[2] << 16)
        self.seq = (header[3] + 1) & 0xFF
        return self.recv_exact(length)

    def send_packet(self, payload: bytes) -> None:
        header = struct.pack("<I", len(payload))[:3] + bytes([self.seq])
        self.seq = (self.seq + 1) & 0xFF
        self.sock.sendall(header + payload)

    def send_ok(self):
        self.send_packet(b"\x00\x00\x00\x02\x00\x00\x00")

    def send_eof(self):
        self.send_packet(b"\xfe\x00\x00\x02\x00")

    def send_err(self, msg: str, errno: int = 1064):
        self.send_packet(
            b"\xff" + struct.pack("<H", errno) + b"#42000"
            + msg.encode()
        )

    # -- handshake ----------------------------------------------------------
    def run(self):
        # real MySQL scrambles are NUL-free printable bytes; a random
        # 0x00 would be ambiguous with the protocol terminator
        nonce = bytes((b % 94) + 33 for b in os.urandom(20))
        greeting = (
            b"\x0a" + b"8.0.0-fake\x00"
            + struct.pack("<I", 1)
            + nonce[:8] + b"\x00"
            + struct.pack("<H", 0xFFFF)      # caps low
            + bytes([33])                     # charset
            + struct.pack("<H", 2)            # status
            + struct.pack("<H", 0x000F)       # caps high (PLUGIN_AUTH…)
            + bytes([21])                     # auth data len
            + b"\x00" * 10
            + nonce[8:] + b"\x00"
            + b"mysql_native_password\x00"
        )
        self.send_packet(greeting)
        resp = self.read_packet()
        # parse username + token
        pos = 4 + 4 + 1 + 23
        nul = resp.index(b"\x00", pos)
        user = resp[pos:nul].decode()
        pos = nul + 1
        tok_len = resp[pos]
        pos += 1
        token = resp[pos:pos + tok_len]
        expect = self._native_token(self.fake.password, nonce)
        if user != self.fake.user or token != expect:
            self.send_err("Access denied", 1045)
            raise ConnectionError()
        self.send_ok()
        while True:
            self.seq = 0
            pkt = self.read_packet()
            cmd = pkt[0]
            if cmd == 0x01:  # QUIT
                return
            if cmd == 0x0E:  # PING
                self.send_ok()
                continue
            if cmd == 0x03:  # QUERY
                sql = pkt[1:].decode("utf-8", "replace")
                with self.fake.lock:
                    self.fake.queries.append(sql)
                try:
                    self.dispatch(sql)
                except Exception as e:
                    self.send_err(str(e))

    @staticmethod
    def _native_token(password: str, nonce: bytes) -> bytes:
        if not password:
            return b""
        h1 = hashlib.sha1(password.encode()).digest()
        h2 = hashlib.sha1(h1).digest()
        h3 = hashlib.sha1(nonce + h2).digest()
        return bytes(a ^ b for a, b in zip(h1, h3))

    # -- resultsets ---------------------------------------------------------
    def send_rows(self, columns: list[str], rows: list[list]):
        self.send_packet(bytes([len(columns)]))  # lenenc int column count
        for c in columns:
            defn = (
                _lenenc(b"def") + _lenenc(b"") + _lenenc(b"")
                + _lenenc(b"") + _lenenc(c.encode()) + _lenenc(c.encode())
                + bytes([0x0C]) + struct.pack("<HIBHB", 33, 255, 0xFD, 0, 0)
                + b"\x00\x00"
            )
            self.send_packet(defn)
        self.send_eof()
        # frame each row as its own packet (protocol requirement) but
        # coalesce socket writes — a sendall per row capped the fake far
        # below what the buffered client ingests
        buf = bytearray()
        for row in rows:
            pkt = b"".join(
                _lenenc(None if v is None else str(v).encode())
                for v in row
            )
            buf += struct.pack("<I", len(pkt))[:3] + bytes([self.seq])
            self.seq = (self.seq + 1) & 0xFF
            buf += pkt
            if len(buf) >= 1 << 18:
                self.sock.sendall(buf)
                buf.clear()
        if buf:
            self.sock.sendall(buf)
        self.send_eof()

    # -- SQL dispatch -------------------------------------------------------
    def dispatch(self, sql: str):
        fake = self.fake
        low = " ".join(sql.lower().split())
        if "from information_schema.tables" in low:
            m = re.search(r"table_schema = '(\w+)'", low)
            db = m.group(1)
            with fake.lock:
                rows = [[t.name, len(t.rows)]
                        for (d, _), t in fake.tables.items() if d == db]
            return self.send_rows(["name", "eta"], rows)
        if "from information_schema.columns" in low:
            m = re.search(r"table_schema = '(\w+)' and table_name = "
                          r"'(\w+)'", low)
            t = fake.tables.get((m.group(1), m.group(2))) if m else None
            rows = [
                [c[0], c[1], c[2], "NO" if c[4] else "YES",
                 "PRI" if c[3] else ""]
                for c in (t.columns if t else [])
            ]
            return self.send_rows(
                ["name", "typ", "full_typ", "nullable", "ckey"], rows
            )
        m = re.match(r"select count\(\*\) from `(\w+)`\.`(\w+)`", low)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            return self.send_rows(["c"], [[len(t.rows) if t else 0]])
        if low.startswith("show master status"):
            return self.send_rows(
                ["File", "Position", "Executed_Gtid_Set"],
                [["binlog.000001", 4242, ""]],
            )
        m = re.match(r"select max\(`(\w+)`\) from `(\w+)`\.`(\w+)`", low)
        if m:
            t = fake.tables.get((m.group(2), m.group(3)))
            vals = [r.get(m.group(1)) for r in (t.rows if t else [])]
            vals = [v for v in vals if v is not None]
            # numeric MAX like real MySQL, not lexicographic
            try:
                best = max(vals, key=float) if vals else None
            except (TypeError, ValueError):
                best = max(vals) if vals else None
            return self.send_rows(["m"], [[best]])
        m = re.match(r"select (.*) from `(\w+)`\.`(\w+)`"
                     r"(?: where (.*?))?(?: order by (.*?))?"
                     r" limit (\d+)(?: offset (\d+))?$", low, re.S)
        if m:
            t = fake.tables.get((m.group(2), m.group(3)))
            if t is None:
                raise ValueError(f"Table {m.group(3)} doesn't exist")
            cols = [c.strip().strip("`")
                    for c in m.group(1).split(",")]
            rows = list(t.rows)
            if m.group(4):
                cm = re.search(r"`(\w+)` > '?([^')]*)'?", m.group(4))
                if cm:
                    field, lit = cm.group(1), cm.group(2)

                    def gt(r):
                        v = r.get(field)
                        if v is None:
                            return False
                        try:
                            return float(v) > float(lit)
                        except (TypeError, ValueError):
                            return str(v) > lit

                    rows = [r for r in rows if gt(r)]
            if m.group(5):
                order_col = m.group(5).split(",")[0].strip().strip("`")

                def key_fn(r):
                    v = r.get(order_col)
                    try:
                        return (0, float(v))
                    except (TypeError, ValueError):
                        return (1, str(v))

                rows.sort(key=key_fn)
            lim = int(m.group(6))
            off = int(m.group(7) or 0)
            window = rows[off:off + lim]
            return self.send_rows(
                cols, [[r.get(c) for c in cols] for r in window]
            )
        if low.startswith(("drop table", "truncate")):
            self.apply_write(sql)
            return self.send_ok()
        raise ValueError(f"fake mysql: unhandled query: {sql[:120]}")

    def apply_write(self, sql: str):
        """The activation cleanup's statements (DROP TABLE IF EXISTS,
        TRUNCATE TABLE)."""
        fake = self.fake
        m = re.match(r"DROP TABLE IF EXISTS `(\w+)`\.`(\w+)`", sql, re.I)
        if m:
            fake.tables.pop((m.group(1), m.group(2)), None)
            return
        m = re.match(r"TRUNCATE TABLE `(\w+)`\.`(\w+)`", sql, re.I)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            if t is None:
                raise ValueError("doesn't exist")
            t.rows = []
            return
        raise ValueError(f"fake mysql: unhandled write: {sql[:120]}")
