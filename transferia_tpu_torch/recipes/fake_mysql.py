"""In-process fake MySQL server (client/server protocol subset): the
port's copy of ``tests/recipes/fake_mysql.py``.

Handshake v10 with mysql_native_password verification, COM_QUERY with
text-protocol resultsets (EOF framing), COM_PING, and the binlog stream:
COM_BINLOG_DUMP and COM_BINLOG_DUMP_GTID serve the events fed through the
builders (GTID, XID, TABLE_MAP, ROWS v2), a GTID dump skipping the
transaction groups its executed set holds.  SQL handling is
regex-dispatch over the statements the provider issues: the catalog,
counts, paging and samples of the snapshot source, and the writes of the
MySQL target and the activation cleanup (CREATE, INSERT/REPLACE, UPDATE,
DELETE, DROP, TRUNCATE) applied to the in-memory tables.
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
        # the write path's key index (FakeMySQL._key_index)
        self.index: dict = {}
        self.index_sig = None


class FakeMySQL:
    def __init__(self, user: str = "root", password: str = ""):
        self.user = user
        self.password = password
        self.tables: dict[tuple[str, str], FakeMyTable] = {}
        self.queries: list[str] = []
        self.lock = threading.RLock()
        self.port = 0
        self._srv = None
        self.binlog_events: list[bytes] = []  # pre-framed event bodies
        self._next_log_pos = 10_000  # past SHOW MASTER STATUS's 4242

    # -- binlog event builders (independent encoder mirroring the client
    # decoder; TABLE_MAP + ROWS v2 for [bigint, varchar(N)] shapes) --------
    def _event(self, etype: int, payload: bytes) -> bytes:
        self._next_log_pos += 19 + len(payload)
        header = struct.pack("<IBIII", 1_700_000_000, etype, 1,
                             19 + len(payload), self._next_log_pos)
        return header[:17] + struct.pack("<H", 0) + payload

    def feed_gtid(self, sid: str, gno: int) -> None:
        """GTID_LOG_EVENT (type 33) opening a transaction group."""
        import uuid as _uuid

        body = b"\x00" + _uuid.UUID(sid).bytes + struct.pack("<Q", gno)
        with self.lock:
            self.binlog_events.append(self._event(33, body))

    def feed_xid(self, xid: int = 1) -> None:
        """XID_EVENT (type 16): transaction commit marker."""
        with self.lock:
            self.binlog_events.append(
                self._event(16, struct.pack("<Q", xid)))

    def feed_table_map(self, table_id: int, schema: str, table: str,
                       col_specs: list[tuple]) -> None:
        """col_specs: (type_byte, meta_bytes) tuples."""
        body = table_id.to_bytes(6, "little") + struct.pack("<H", 1)
        body += bytes([len(schema)]) + schema.encode() + b"\x00"
        body += bytes([len(table)]) + table.encode() + b"\x00"
        body += bytes([len(col_specs)])
        body += bytes(t for t, _ in col_specs)
        meta = b"".join(m for _, m in col_specs)
        body += bytes([len(meta)]) + meta
        body += bytes((len(col_specs) + 7) // 8)  # null-allowed bitmap
        with self.lock:
            self.binlog_events.append(self._event(19, body))

    def feed_rows(self, etype: int, table_id: int, n_cols: int,
                  images: list[bytes]) -> None:
        """images: pre-encoded row images (null bitmap + values)."""
        body = table_id.to_bytes(6, "little") + struct.pack("<H", 1)
        body += struct.pack("<H", 2)  # v2 extra-info length (just itself)
        body += bytes([n_cols])
        bitmap = bytes([0xFF] * ((n_cols + 7) // 8))
        body += bitmap
        if etype == 31:  # update: before+after bitmaps
            body += bitmap
        body += b"".join(images)
        with self.lock:
            self.binlog_events.append(self._event(etype, body))

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
            if cmd == 0x12:  # COM_BINLOG_DUMP
                self.stream_binlog()
                return
            if cmd == 0x1E:  # COM_BINLOG_DUMP_GTID
                # flags(2) server_id(4) name_len(4) name pos(8) dlen(4) set
                name_len = struct.unpack_from("<I", pkt, 7)[0]
                off = 11 + name_len + 8
                dlen = struct.unpack_from("<I", pkt, off)[0]
                gtid_data = pkt[off + 4:off + 4 + dlen]
                from transferia_tpu_torch.providers.mysql.gtid import GtidSet

                self.stream_binlog(skip_set=GtidSet.decode(gtid_data))
                return
            if cmd == 0x03:  # QUERY
                sql = pkt[1:].decode("utf-8", "replace")
                with self.fake.lock:
                    self.fake.queries.append(sql)
                if sql.startswith("SET @master_binlog_checksum"):
                    self.send_ok()
                    continue
                try:
                    self.dispatch(sql)
                except Exception as e:
                    self.send_err(str(e))

    def stream_binlog(self, skip_set=None):
        """Serve fed binlog events as OK-prefixed packets, then poll for
        newly fed events until the client disconnects.  With skip_set
        (COM_BINLOG_DUMP_GTID), transaction groups whose GTID is already
        in the executed set are not re-sent — like a real server."""
        import select
        import time as _time
        import uuid as _uuid

        sent = 0
        skipping = False
        while True:
            with self.fake.lock:
                events = list(self.fake.binlog_events)
            while sent < len(events):
                ev = events[sent]
                sent += 1
                etype = ev[4]
                if skip_set is not None and etype == 33:
                    sid = str(_uuid.UUID(bytes=ev[19 + 1:19 + 17]))
                    gno = struct.unpack_from("<Q", ev, 19 + 17)[0]
                    skipping = skip_set.contains(sid, gno)
                    if skipping:
                        continue
                elif skipping and etype != 33:
                    continue
                self.seq = 1
                self.send_packet(b"\x00" + ev)
            _time.sleep(0.02)
            # a dump client sends nothing but its COM_QUIT before it
            # closes: any byte or the close ends the stream (waiting for
            # the close alone, behind an unread COM_QUIT, never ends)
            r, _, _ = select.select([self.sock], [], [], 0)
            if r:
                raise ConnectionError()

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
        if "@@global.binlog_checksum" in low and low.startswith("select"):
            return self.send_rows(["@@global.binlog_checksum"], [["NONE"]])
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
        if low.startswith(("create table", "drop table", "truncate",
                           "insert", "replace", "update", "delete")):
            self.apply_write(sql)
            return self.send_ok()
        raise ValueError(f"fake mysql: unhandled query: {sql[:120]}")

    def apply_write(self, sql: str):
        fake = self.fake
        m = re.match(r"CREATE TABLE IF NOT EXISTS `(\w+)`\.`(\w+)` "
                     r"\((.*)\)", sql, re.I | re.S)
        if m:
            db, name, body = m.groups()
            if (db, name) in fake.tables:
                return
            pk_cols = set()
            pkm = re.search(r"PRIMARY KEY \((.*?)\)", body)
            if pkm:
                pk_cols = {c.strip().strip("`")
                           for c in pkm.group(1).split(",")}
                body = body[:pkm.start()].rstrip(", \n")
            cols = []
            for part in body.split(","):
                toks = part.strip().split(None, 1)
                if not toks:
                    continue
                cname = toks[0].strip("`")
                full = toks[1] if len(toks) > 1 else "text"
                cols.append((cname, full.split("(")[0].split()[0],
                             full.replace(" NOT NULL", ""), cname in pk_cols,
                             "NOT NULL" in full))
            fake.add_table(FakeMyTable(db, name, cols))
            return
        m = re.match(r"(INSERT|REPLACE) INTO `(\w+)`\.`(\w+)` "
                     r"\((.*?)\) VALUES (.*)", sql, re.I | re.S)
        if m:
            verb, db, name = m.group(1).upper(), m.group(2), m.group(3)
            t = fake.tables.get((db, name))
            if t is None:
                raise ValueError(f"Table {name} doesn't exist")
            cols = [c.strip().strip("`") for c in m.group(4).split(",")]
            values_part = m.group(5).split(" ON DUPLICATE")[0].strip()
            for tup in re.findall(r"\(((?:[^()']|'[^']*')*)\)",
                                  values_part):
                vals = [
                    v.strip().strip("'")
                    if v.strip() != "NULL" else None
                    for v in re.split(
                        r",(?=(?:[^']*'[^']*')*[^']*$)", tup
                    )
                ]
                row = dict(zip(cols, vals))
                pk = [c[0] for c in t.columns if c[3]]
                if pk:
                    # the rows whose key equals the new row's go
                    key = tuple(row.get(k) for k in pk)
                    self._drop_rows(t, pk, [
                        r for r in self._key_index(t, pk).get(
                            tuple(str(v) for v in key), ())
                        if tuple(r.get(k) for k in pk) == key])
                    self._key_index(t, pk).setdefault(
                        tuple(str(v) for v in key), []).append(row)
                t.rows.append(row)
                t.index_sig = (id(t.rows), len(t.rows))
            return
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
        m = re.match(r"DELETE FROM `(\w+)`\.`(\w+)` WHERE (.*)", sql,
                     re.I | re.S)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            cond = self._conds(m.group(3))
            pk = [c[0] for c in t.columns if c[3]]
            if pk and list(cond) == pk:
                self._drop_rows(t, pk, list(self._key_index(t, pk).get(
                    tuple(cond.values()), ())))
                return
            t.rows = [r for r in t.rows if not self._match(r, cond)]
            return
        m = re.match(r"UPDATE `(\w+)`\.`(\w+)` SET (.*) WHERE (.*)", sql,
                     re.I | re.S)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            sets = self._conds(m.group(3), sep=",")
            cond = self._conds(m.group(4))
            pk = [c[0] for c in t.columns if c[3]]
            if pk and list(cond) == pk:
                index = self._key_index(t, pk)
                for r in list(index.get(tuple(cond.values()), ())):
                    old = tuple(str(r.get(k)) for k in pk)
                    r.update(sets)
                    new = tuple(str(r.get(k)) for k in pk)
                    if new != old:
                        index[old].remove(r)
                        index.setdefault(new, []).append(r)
                return
            for r in t.rows:
                if self._match(r, cond):
                    r.update(sets)
            t.index_sig = None
            return
        raise ValueError(f"fake mysql: unhandled write: {sql[:120]}")

    @staticmethod
    def _key_index(t: FakeMyTable, pk: list) -> dict:
        """The table's rows by the text of their key values (what
        `_match` compares), so a statement on one key finds its rows
        without a scan; rebuilt when the rows changed elsewhere."""
        if t.index_sig != (id(t.rows), len(t.rows)):
            t.index = {}
            for r in t.rows:
                t.index.setdefault(tuple(str(r.get(k)) for k in pk),
                                   []).append(r)
            t.index_sig = (id(t.rows), len(t.rows))
        return t.index

    @staticmethod
    def _drop_rows(t: FakeMyTable, pk: list, victims: list) -> None:
        """Remove these rows (found through the key index) in one pass."""
        if not victims:
            return
        gone = {id(r) for r in victims}
        for r in victims:
            t.index[tuple(str(r.get(k)) for k in pk)].remove(r)
        t.rows = [r for r in t.rows if id(r) not in gone]
        t.index_sig = (id(t.rows), len(t.rows))

    @staticmethod
    def _conds(text: str, sep: str = " AND ") -> dict:
        out = {}
        for p in text.split(sep):
            if "=" in p:
                k, v = p.split("=", 1)
                out[k.strip().strip("`")] = v.strip().strip("'")
        return out

    @staticmethod
    def _match(row: dict, cond: dict) -> bool:
        return all(str(row.get(k)) == v for k, v in cond.items())
