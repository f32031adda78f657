"""In-process fake PostgreSQL server, wire protocol v3 subset (the port's
copy of ``tests/recipes/fake_postgres.py``).

Speaks real sockets against the provider's PGConnection: startup, optional
SCRAM-SHA-256 auth, simple queries (matched against the exact catalog/DML
statements the provider issues — a protocol fake, not a SQL engine), and
COPY OUT/IN streaming.

Unlike the JAX fake, a statement's replies go out in one write, on a
socket with TCP_NODELAY (several small writes would wait out the
client's delayed ACK: 40 ms a statement), a transaction's rollback image copies
each row dict (not `copy.deepcopy`), a key-set SELECT matches through a
set, and a statement on one primary key (an INSERT ... ON
CONFLICT on the key, an UPDATE or DELETE whose WHERE is the key) finds
its row through the table's key index instead of a scan, so a CDC tail
into a table of a few hundred thousand rows keeps pace; a DELETE by key
moves the table's last row into the deleted row's place.  The rows
these statements leave are the JAX fake's, as a set
(`tests/test_torch_pg_sink.py`).

A table's rows lie on heap pages of `ROWS_PER_PAGE` rows each (the JAX
fake has one page a table): row i is on page i // ROWS_PER_PAGE,
`relpages` counts the pages, `pg_relation_size` stays 100 bytes a row,
and a `ctid >= '(lo,0)'::tid AND ctid < '(hi,0)'::tid` condition selects
the rows of pages lo..hi-1, so the provider's ctid split reads each row
once.
"""

from __future__ import annotations

import csv
import hashlib
import heapq
import hmac
import io
import json
import re
import socket
import socketserver
import struct
import threading
from base64 import b64decode, b64encode

# rows on one heap page: an 8 KiB page of the 100-byte rows that
# pg_relation_size reports
ROWS_PER_PAGE = 8192 // 100


def _ctid_slice(cond: str) -> slice:
    """The rows of a ctid block range `ctid >= '(lo,0)'::tid AND ctid <
    '(hi,0)'::tid`: pages lo..hi-1."""
    lo = re.search(r"ctid >= '\((\d+),0\)'", cond)
    hi = re.search(r"ctid < '\((\d+),0\)'", cond)
    return slice(int(lo.group(1)) * ROWS_PER_PAGE if lo else None,
                 int(hi.group(1)) * ROWS_PER_PAGE if hi else None)


class _PGStateError(Exception):
    def __init__(self, message: str, code: str = "XX000"):
        super().__init__(message)
        self.code = code


class FakeTable:
    def __init__(self, namespace: str, name: str, columns: list[tuple],
                 rows: list[dict] | None = None):
        # columns: (name, pg_type, is_pk, notnull)
        self.namespace = namespace
        self.name = name
        self.columns = columns
        self.rows = rows or []
        self._index = None   # ((rows id, len, pk), {key text: position})

    def pk(self) -> list[str]:
        return [c[0] for c in self.columns if c[2]]

    def key_of(self, row: dict) -> tuple:
        return tuple(str(row.get(k)) for k in self.pk())

    def key_index(self) -> dict:
        """Primary-key text tuple -> position in `rows`.  Rows appended
        behind it (a COPY, a plain INSERT) are added to it; it is rebuilt
        whenever the rows list was replaced or shrank behind it, or the
        key changed.  (A rebuild a COPY made a CDC tail's mixed pushes
        into a table of 300,000 rows take half a second each.)"""
        pk = tuple(self.pk())
        n = len(self.rows)
        if self._index is not None:
            (rows_id, indexed, index_pk), idx = self._index
            if rows_id == id(self.rows) and index_pk == pk \
                    and indexed <= n:
                for i in range(indexed, n):
                    idx[self.key_of(self.rows[i])] = i
                self._index = ((rows_id, n, pk), idx)
                return idx
        self._index = ((id(self.rows), n, pk),
                       {self.key_of(r): i for i, r in enumerate(self.rows)})
        return self._index[1]

    def index_synced(self) -> None:
        """The index was kept up to date by the caller's change."""
        self._index = ((id(self.rows), len(self.rows), tuple(self.pk())),
                       self._index[1])

    def drop_index(self) -> None:
        self._index = None


class FakePG:
    def __init__(self, password: str = "", scram: bool = False,
                 echo_dml_to_wal: bool = False):
        """echo_dml_to_wal: INSERT/UPDATE/DELETE statements also emit
        wal2json events, like real logical decoding — the DBLog e2e needs
        its signal-table writes echoed into the CDC stream."""
        self.tables: dict[tuple[str, str], FakeTable] = {}
        self.queries: list[str] = []
        self.password = password
        self.scram = scram
        self.echo_dml_to_wal = echo_dml_to_wal
        self.lock = threading.RLock()
        self.port = 0
        self._srv = None
        # replication state
        self.slots: dict[str, str] = {}          # slot -> plugin
        self.wal: list[tuple[int, bytes]] = []   # (lsn, wal2json payload)
        self.flushed_lsn = 0                     # last standby-status flush
        self.wal_event = threading.Event()
        # DDL-object catalog served via pg_indexes/pg_views/pg_sequences
        self.indexes: list[tuple[str, str, str, str]] = []
        #   (schema, table, indexname, indexdef)
        self.views: list[tuple[str, str, str]] = []
        #   (schema, viewname, definition)
        self.sequences: list[tuple[str, str, int, int, int]] = []
        #   (schema, seqname, start, increment, last_value)
        self.executed_ddl: list[str] = []

    def feed_wal(self, payload: bytes, lsn: int | None = None) -> None:
        """Append one wal2json message for streaming to subscribers."""
        with self.lock:
            lsn = lsn if lsn is not None else (
                (self.wal[-1][0] + 8) if self.wal else 0x2000
            )
            self.wal.append((lsn, payload))
        self.wal_event.set()

    def feed_wal_many(self, payloads: list[bytes]) -> None:
        """Append wal2json messages in one go: a streaming client sees
        them together (one burst), not in the increments a feeder
        thread racing the stream would make."""
        with self.lock:
            for payload in payloads:
                lsn = (self.wal[-1][0] + 8) if self.wal else 0x2000
                self.wal.append((lsn, payload))
        self.wal_event.set()

    def add_table(self, table: FakeTable) -> None:
        with self.lock:
            self.tables[(table.namespace, table.name)] = table

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FakePG":
        fake = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # a reply is several small writes: without NODELAY each
                # statement waits out the client's delayed ACK
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                try:
                    _Session(self.request, fake).run()
                except (ConnectionError, OSError):
                    pass

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


def _order_key(v):
    """ORDER BY's key for a value: numbers, then text, then NULLs."""
    if v is None:
        return (2, 0)
    try:
        return (0, float(v))
    except (TypeError, ValueError):
        return (1, str(v))


class _Session:
    def __init__(self, sock: socket.socket, fake: FakePG):
        self.sock = sock
        self.fake = fake
        # a query's replies, held until it ends (or the session waits for
        # the client): one write a statement, not one a message
        self._out: list | None = None

    # -- framing ------------------------------------------------------------
    def send(self, t: bytes, payload: bytes = b"") -> None:
        msg = t + struct.pack("!I", len(payload) + 4) + payload
        if self._out is not None:
            self._out.append(msg)
        else:
            self.sock.sendall(msg)

    def send_raw(self, data: bytes) -> None:
        self.flush()
        self.sock.sendall(data)

    def flush(self) -> None:
        if self._out:
            self.sock.sendall(b"".join(self._out))
            self._out.clear()

    def recv_exact(self, n: int) -> bytes:
        self.flush()
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("client gone")
            out += chunk
        return out

    def recv_msg(self) -> tuple[bytes, bytes]:
        header = self.recv_exact(5)
        ln = struct.unpack("!I", header[1:5])[0]
        return header[:1], self.recv_exact(ln - 4) if ln > 4 else b""

    def ready(self):
        self.send(b"Z", b"I")

    def error(self, message: str, code: str = "XX000"):
        fields = b"SERROR\x00" + f"C{code}".encode() + b"\x00" \
            + f"M{message}".encode() + b"\x00\x00"
        self.send(b"E", fields)

    # -- auth ---------------------------------------------------------------
    def run(self):
        # startup message (untyped)
        ln = struct.unpack("!I", self.recv_exact(4))[0]
        payload = self.recv_exact(ln - 4)
        proto = struct.unpack("!I", payload[:4])[0]
        if proto == 80877103:  # SSLRequest -> deny, expect retry
            self.sock.sendall(b"N")
            return self.run()
        if self.fake.scram:
            self._scram_server()
        elif self.fake.password:
            self.send(b"R", struct.pack("!I", 3))  # cleartext
            t, pw = self.recv_msg()
            if pw.rstrip(b"\x00").decode() != self.fake.password:
                self.error("password authentication failed", "28P01")
                return
            self.send(b"R", struct.pack("!I", 0))
        else:
            self.send(b"R", struct.pack("!I", 0))
        self.send(b"S", b"server_version\x0016.1 (fake)\x00")
        self.send(b"K", struct.pack("!II", 4242, 0))
        self.ready()
        while True:
            t, payload = self.recv_msg()
            if t == b"X":
                return
            if t == b"Q":
                self.handle_query(payload.rstrip(b"\x00").decode())

    def _scram_server(self):
        self.send(b"R", struct.pack("!I", 10) + b"SCRAM-SHA-256\x00\x00")
        t, payload = self.recv_msg()
        # SASLInitialResponse: mech\0 int32 len, body
        mech_end = payload.index(b"\x00")
        body = payload[mech_end + 5:].decode()
        client_first_bare = body.split(",", 2)[2]
        client_nonce = dict(
            p.split("=", 1) for p in client_first_bare.split(",")
        )["r"]
        salt = b"saltsalt"
        iterations = 4096
        server_nonce = client_nonce + "srv"
        server_first = (
            f"r={server_nonce},s={b64encode(salt).decode()},i={iterations}"
        )
        self.send(b"R", struct.pack("!I", 11) + server_first.encode())
        t, payload = self.recv_msg()
        client_final = payload.decode()
        parts = dict(p.split("=", 1) for p in client_final.split(",", 2)
                     if "=" in p)
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.fake.password.encode(), salt, iterations
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = ",".join([
            client_first_bare, server_first, without_proof,
        ])
        client_sig = hmac.new(stored_key, auth_message.encode(),
                              hashlib.sha256).digest()
        expect_proof = b64encode(bytes(
            a ^ b for a, b in zip(client_key, client_sig)
        )).decode()
        if parts.get("p") != expect_proof:
            self.error("SCRAM authentication failed", "28P01")
            raise ConnectionError("bad scram")
        server_key = hmac.new(salted, b"Server Key",
                              hashlib.sha256).digest()
        server_sig = hmac.new(server_key, auth_message.encode(),
                              hashlib.sha256).digest()
        final = f"v={b64encode(server_sig).decode()}"
        self.send(b"R", struct.pack("!I", 12) + final.encode())
        self.send(b"R", struct.pack("!I", 0))

    # -- query dispatch -----------------------------------------------------
    def send_rows(self, columns: list[str], rows: list[list]):
        desc = struct.pack("!H", len(columns))
        for c in columns:
            desc += c.encode() + b"\x00" + struct.pack(
                "!IhIhih", 0, 0, 25, -1, -1, 0
            )
        self.send(b"T", desc)
        for row in rows:
            payload = struct.pack("!H", len(row))
            for v in row:
                if v is None:
                    payload += struct.pack("!i", -1)
                else:
                    b = str(v).encode()
                    payload += struct.pack("!i", len(b)) + b
            self.send(b"D", payload)
        self.send(b"C", b"SELECT\x00")

    def handle_query(self, sql: str):
        with self.fake.lock:
            self.fake.queries.append(sql)
        self._out = []
        try:
            try:
                self.dispatch(sql)
            except _PGStateError as e:
                self.error(str(e), e.code)
            except ConnectionError:
                raise
            except Exception as e:
                self.error(str(e))
            self.ready()
        finally:
            if self._out is not None:
                self.flush()
                self._out = None

    def dispatch(self, sql: str):
        low = " ".join(sql.lower().split())
        fake = self.fake
        # subclass hook (FakeGP external tables etc.): truthy = handled
        hook = getattr(fake, "sql_hook", None)
        if hook is not None and hook(sql, low, self):
            return None
        if low == "select 1":
            return self.send_rows(["?column?"], [[1]])
        if low == "identify_system":
            return self.send_rows(
                ["systemid", "timeline", "xlogpos", "dbname"],
                [["7000", "1", "0/1000", "db"]],
            )
        m = re.match(r"create_replication_slot (\w+) logical (\w+)", low)
        if m:
            with fake.lock:
                if m.group(1) in fake.slots:
                    raise _PGStateError(
                        f'replication slot "{m.group(1)}" already exists',
                        "42710",
                    )
                fake.slots[m.group(1)] = m.group(2)
            return self.send_rows(
                ["slot_name", "consistent_point", "snapshot_name",
                 "output_plugin"],
                [[m.group(1), "0/1000", None, m.group(2)]],
            )
        m = re.match(r"drop_replication_slot (\w+)", low)
        if m:
            with fake.lock:
                fake.slots.pop(m.group(1), None)
            return self.send(b"C", b"DROP_REPLICATION_SLOT\x00")
        if low.startswith("start_replication"):
            return self.stream_replication()
        if "pg_wal_lsn_diff" in low:
            return self.send_rows(["diff"], [[1024]])
        if "from pg_class c join pg_namespace" in low:
            rows = [
                [t.namespace, t.name, len(t.rows)]
                for t in fake.tables.values()
            ]
            return self.send_rows(["ns", "name", "eta"], rows)
        if "from pg_attribute" in low:
            m = re.search(r"'\"?([\w]+)\"?\.\"?([\w]+)\"?'::regclass", sql)
            t = fake.tables.get((m.group(1), m.group(2))) if m else None
            if t is None:
                raise ValueError("relation does not exist")
            rows = [
                [name, typ, "t" if notnull else "f", "t" if pk else "f"]
                for (name, typ, pk, notnull) in t.columns
            ]
            return self.send_rows(["name", "typ", "notnull", "is_pk"], rows)
        m = re.match(r"select count\(\*\) from \"?(\w+)\"?\.\"?(\w+)\"?",
                     low)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            return self.send_rows(["count"], [[len(t.rows) if t else 0]])
        if "pg_current_wal_lsn" in low:
            return self.send_rows(["lsn"], [["0/ABCDEF0"]])
        if "pg_relation_size" in low:
            m = re.search(r"'\"?(\w+)\"?\.\"?(\w+)\"?'", sql)
            t = fake.tables.get((m.group(1), m.group(2))) if m else None
            size = len(t.rows) * 100 if t else 0
            return self.send_rows(["size"], [[size]])
        if "relpages" in low:
            m = re.search(r"'\"?(\w+)\"?\.\"?(\w+)\"?'", sql)
            t = fake.tables.get((m.group(1), m.group(2))) if m else None
            pages = -(-len(t.rows) // ROWS_PER_PAGE) if t else 0
            return self.send_rows(["relpages"], [[pages]])
        if low.startswith("copy (") and "to stdout" in low:
            return self.copy_out(sql)
        if low.startswith("copy ") and "from stdin" in low:
            return self.copy_in(sql)
        if "from pg_indexes" in low:
            with fake.lock:
                rows = [[s_, t_, n_, d_] for s_, t_, n_, d_
                        in fake.indexes]
            return self.send_rows(
                ["schemaname", "tablename", "indexname", "indexdef"],
                rows)
        if "from pg_views" in low:
            with fake.lock:
                rows = [[s_, v_, d_] for s_, v_, d_ in fake.views]
            return self.send_rows(
                ["schemaname", "viewname", "definition"], rows)
        if "from pg_sequences" in low:
            with fake.lock:
                rows = [[s_, n_, st, inc, lv] for s_, n_, st, inc, lv
                        in fake.sequences]
            return self.send_rows(
                ["schemaname", "sequencename", "start_value",
                 "increment_by", "last_value"], rows)
        if low.startswith("select setval("):
            with fake.lock:
                fake.executed_ddl.append(sql)
            return self.send_rows(["setval"], [[1]])
        if low.startswith(("create index", "create unique index",
                           "create or replace view",
                           "create sequence")):
            with fake.lock:
                fake.executed_ddl.append(sql)
            return self.send(b"C", b"OK\x00")
        if low.startswith(("create ", "drop ", "truncate ", "alter ")):
            self.apply_ddl(sql)
            return self.send(b"C", b"OK\x00")
        if low.startswith("begin"):
            return self.apply_transaction(sql)
        if low.startswith(("insert ", "update ", "delete ")):
            self.apply_dml(sql)
            return self.send(b"C", b"OK\x00")
        if low.startswith("select "):
            # generic single-table SELECT (fence reads etc.)
            cols, rows = self._eval_select(sql)
            return self.send_rows(
                cols, [[r.get(c) for c in cols] for r in rows])
        raise ValueError(f"fake PG: unhandled query: {sql[:120]}")

    def apply_transaction(self, sql: str):
        """A `BEGIN; ...; COMMIT` simple-query block: apply the inner
        statements atomically — all table mutations roll back when any
        statement fails, like the implicit transaction a real server
        wraps a multi-statement Q message in."""
        stmts = [s.strip() for s in sql.split(";") if s.strip()]
        fake = self.fake
        with fake.lock:
            # the rollback image: a row's values are str or None, so a
            # copy of each row dict is a deep copy
            snapshot = {
                k: [dict(r) for r in t.rows] for k, t in fake.tables.items()
            }
            try:
                for stmt in stmts:
                    low = stmt.lower()
                    if low in ("begin", "commit", "rollback"):
                        continue
                    if low.startswith(("insert ", "update ", "delete ")):
                        self.apply_dml(stmt)
                    elif low.startswith(("create ", "drop ",
                                         "truncate ")):
                        self.apply_ddl(stmt)
                    else:
                        raise ValueError(
                            f"fake PG: unhandled txn stmt: {stmt[:80]}")
            except Exception:
                for k, rows in snapshot.items():
                    if k in fake.tables:
                        fake.tables[k].rows = rows
                raise
        return self.send(b"C", b"COMMIT\x00")

    # -- replication streaming ---------------------------------------------
    def stream_replication(self):
        import select
        import time as _time

        # the stream writes as it goes
        self.flush()
        self._out = None
        self.send(b"W", struct.pack("!bh", 0, 0))
        sent = 0
        fake = self.fake
        while True:
            with fake.lock:
                wal = list(fake.wal)
            progressed = sent < len(wal)
            # the pending messages in writes of up to 64 KiB, as a
            # walsender batches them: a write a message floods a slow
            # reader's window with small segments
            frames, size = [], 0
            while sent < len(wal):
                lsn, payload = wal[sent]
                msg = b"w" + struct.pack("!QQQ", lsn, lsn, 0) + payload
                frames.append(b"d" + struct.pack("!I", len(msg) + 4) + msg)
                size += len(frames[-1])
                sent += 1
                if size >= 1 << 16 or sent == len(wal):
                    self.sock.sendall(b"".join(frames))
                    frames, size = [], 0
            # keepalive so the client flushes its status
            last = wal[-1][0] if wal else 0
            self.send(b"d", b"k" + struct.pack("!QQB", last, 0, 0))
            readable, _, _ = select.select([self.sock], [], [], 0.05)
            if readable:
                t, payload = self.recv_msg()
                if t == b"d" and payload[:1] == b"r":
                    flushed = struct.unpack("!Q", payload[9:17])[0]
                    with fake.lock:
                        fake.flushed_lsn = flushed - 1
                elif t in (b"X", b"c"):
                    raise ConnectionError("replication client done")
            if not progressed:
                _time.sleep(0.02)

    # -- COPY ---------------------------------------------------------------
    def _eval_select(self, sql: str) -> tuple[list[str], list[dict]]:
        """Evaluate the SELECT shapes the provider emits: plain scans,
        checksum top/bottom UNION ALL samples, random()-filtered samples,
        and ORed key-set lookups with ORDER BY/LIMIT."""
        sql = sql.strip()
        if sql.startswith("(") and " UNION ALL " in sql:
            left, _, right = sql.partition(" UNION ALL ")
            lc, lr = self._eval_select(left.strip()[1:-1])
            _, rr = self._eval_select(right.strip()[1:-1])
            return lc, lr + rr
        m = re.search(r"FROM \"?(\w+)\"?\.\"?(\w+)\"?", sql)
        t = self.fake.tables.get((m.group(1), m.group(2))) if m else None
        if t is None:
            raise ValueError("relation does not exist")
        cols = [c[0] for c in t.columns]
        m2 = re.search(r"SELECT (.*?) FROM", sql, re.S)
        if m2 and m2.group(1).strip() != "*":
            cols = [c.strip().strip('"') for c in m2.group(1).split(",")]
        rows = list(t.rows)
        mw = re.search(
            r"WHERE (.*?)(?: ORDER BY | LIMIT |$)", sql, re.S)
        if mw:
            cond = mw.group(1).strip()
            if "random()" in cond:
                rows = rows[::7]  # deterministic "random" subsample
            elif "ctid" in cond:
                rows = rows[_ctid_slice(cond)]
            elif '" = ' in cond or '"=' in cond:
                keysets = []
                for group in re.findall(r"\(([^()]*)\)", cond):
                    want = {}
                    for eq in group.split(" AND "):
                        mk = re.match(r'\s*"(\w+)"\s*=\s*(.+)\s*', eq)
                        if mk:
                            want[mk.group(1)] = mk.group(2).strip()
                    if want:
                        keysets.append(want)

                def lit(v):
                    if v is None:
                        return "NULL"
                    if isinstance(v, bool):
                        return "TRUE" if v else "FALSE"
                    if isinstance(v, (int, float)):
                        return str(v)
                    return "'" + str(v).replace("'", "''") + "'"

                # a row matches a key set when every named column's
                # literal equals it: one set of value tuples per set of
                # names, so the lookup is linear in the rows
                wanted: dict = {}
                for ks in keysets:
                    names = tuple(sorted(ks))
                    wanted.setdefault(names, set()).add(
                        tuple(ks[k] for k in names))
                rows = [
                    r for r in rows
                    if any(tuple(lit(r.get(k)) for k in names) in vals
                           for names, vals in wanted.items())
                ]
            elif re.match(r'"\w+" > ', cond):
                mk = re.match(r'"(\w+)" > (.+)', cond)
                col, raw = mk.group(1), mk.group(2).strip().strip("'")

                def gt(v):
                    if v is None:
                        return False
                    try:
                        return float(v) > float(raw)
                    except (TypeError, ValueError):
                        return str(v) > raw
                rows = [r for r in rows if gt(r.get(col))]
        mo = re.search(r"ORDER BY (.+?)(?: LIMIT |$)", sql, re.S)
        ml = re.search(r"LIMIT (\d+)", sql)
        if mo and ml and re.fullmatch(r'"\w+"', mo.group(1).strip()):
            # one ascending key and a limit (a keyset page, as the DBLog
            # chunks read): the first `limit` rows without sorting them all
            name = mo.group(1).strip().strip('"')
            return cols, heapq.nsmallest(
                int(ml.group(1)), rows,
                key=lambda r: _order_key(r.get(name)))
        if mo:
            for part in reversed(mo.group(1).split(",")):
                part = part.strip()
                desc = part.upper().endswith(" DESC")
                name = part.split()[0].strip('"')
                rows = sorted(rows, key=lambda r, _n=name: _order_key(
                    r.get(_n)), reverse=desc)
        if ml:
            rows = rows[: int(ml.group(1))]
        return cols, rows

    def copy_out(self, sql: str):
        inner = re.search(r"COPY \((.*)\) TO STDOUT", sql, re.S)
        cols, rows = self._eval_select(inner.group(1) if inner else sql)
        self.send(b"H", struct.pack("!bh", 0, 0))
        # C-speed bulk CSV (csv.writer.writerows quotes + stringifies),
        # framed as record-ALIGNED CopyData chunks: real PG frames on row
        # boundaries and the client's 32MB reflush relies on it.  The
        # previous per-row Python loop capped the fake ~3x below what the
        # client under test can ingest.
        out = io.StringIO()
        w = csv.writer(out, lineterminator="\n")
        chunk_rows = 4096
        for lo in range(0, len(rows), chunk_rows):
            out.seek(0)
            out.truncate()
            w.writerows(
                [["" if row.get(c) is None else row.get(c)
                  for c in cols]
                 for row in rows[lo:lo + chunk_rows]])
            payload = out.getvalue().encode()
            self.send_raw(
                b"d" + struct.pack("!I", len(payload) + 4) + payload)
        self.send(b"c")
        self.send(b"C", b"COPY\x00")

    def copy_in(self, sql: str):
        m = re.search(r"COPY \"?(\w+)\"?\.\"?(\w+)\"? \((.*?)\)", sql)
        t = self.fake.tables.get((m.group(1), m.group(2))) if m else None
        if t is None:
            raise ValueError("relation does not exist")
        cols = [c.strip().strip('"') for c in m.group(3).split(",")]
        self.send(b"G", struct.pack("!bh", 0, 0))
        chunks = []
        while True:
            mt, payload = self.recv_msg()
            if mt == b"d":
                chunks.append(payload)
            elif mt in (b"c", b"f"):
                break
        reader = csv.reader(io.StringIO(b"".join(chunks).decode()))
        with self.fake.lock:
            for row in reader:
                t.rows.append({
                    c: (None if v == "" else v) for c, v in zip(cols, row)
                })
        self.send(b"C", b"COPY\x00")

    # -- naive DDL/DML ------------------------------------------------------
    def apply_ddl(self, sql: str):
        low = sql.lower()
        fake = self.fake
        m = re.match(r'create table if not exists "?(\w+)"?\."?(\w+)"?\s*'
                     r"\((.*)\)", sql, re.I | re.S)
        if m:
            ns, name, body = m.group(1), m.group(2), m.group(3)
            if (ns, name) not in fake.tables:
                cols = []
                pk_cols = set()
                pkm = re.search(r"PRIMARY KEY \((.*?)\)", body)
                if pkm:
                    pk_cols = {c.strip().strip('"')
                               for c in pkm.group(1).split(",")}
                    body = body[:pkm.start()].rstrip(", \n")
                for part in body.split(","):
                    toks = part.strip().split(None, 1)
                    if not toks or toks[0].upper() == "PRIMARY":
                        continue
                    cname = toks[0].strip('"')
                    ctype = toks[1].replace(" NOT NULL", "") \
                        if len(toks) > 1 else "text"
                    cols.append((cname, ctype.strip(), cname in pk_cols,
                                 "NOT NULL" in (toks[1] if len(toks) > 1
                                                else "")))
                fake.add_table(FakeTable(ns, name, cols))
            return
        m = re.match(r'alter table "?(\w+)"?\."?(\w+)"? add column '
                     r'if not exists "?(\w+)"? (\w+)', sql, re.I)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            if t is None:
                raise ValueError("relation does not exist")
            if all(c[0] != m.group(3) for c in t.columns):
                t.columns.append((m.group(3), m.group(4), False, False))
            return
        m = re.match(r'drop table if exists "?(\w+)"?\."?(\w+)"?', sql, re.I)
        if m:
            fake.tables.pop((m.group(1), m.group(2)), None)
            return
        m = re.match(r'truncate table "?(\w+)"?\."?(\w+)"?', sql, re.I)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            if t is None:
                raise ValueError(
                    f'relation "{m.group(1)}.{m.group(2)}" does not exist'
                )
            t.rows = []
            return
        # create schema etc: no-op

    def apply_dml(self, sql: str):
        fake = self.fake
        m = re.match(r'insert into "?(\w+)"?\."?(\w+)"? \((.*?)\) '
                     r'select (.*?) from "?(\w+)"?\."?(\w+)"?\s*$',
                     sql, re.I | re.S)
        if m:
            # INSERT ... SELECT (staged-commit publish): copy the source
            # table's rows, evaluating literal select items ('slug')
            dst = fake.tables.get((m.group(1), m.group(2)))
            src = fake.tables.get((m.group(5), m.group(6)))
            if dst is None or src is None:
                raise ValueError("relation does not exist")
            cols = [c.strip().strip('"') for c in m.group(3).split(",")]
            items = [s.strip() for s in m.group(4).split(",")]
            for row in list(src.rows):
                out = {}
                for col, item in zip(cols, items):
                    if item.startswith("'") and item.endswith("'"):
                        out[col] = item[1:-1].replace("''", "'")
                    else:
                        out[col] = row.get(item.strip('"'))
                dst.rows.append(out)
            return
        m = re.match(r'insert into "?(\w+)"?\."?(\w+)"? \((.*?)\) '
                     r"values \((.*)\)",
                     re.split(r" ON CONFLICT", sql, flags=re.I)[0],
                     re.I | re.S)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            if t is None:
                raise ValueError("relation does not exist")
            cols = [c.strip().strip('"') for c in m.group(3).split(",")]
            vals = [v.strip().strip("'")
                    for v in re.split(r",(?=(?:[^']*'[^']*')*[^']*$)",
                                      m.group(4))]
            mc = re.search(r'ON CONFLICT \(([^)]*)\) DO '
                           r'(NOTHING|UPDATE SET)', sql, re.I)
            if mc and not fake.echo_dml_to_wal and t.pk() and sorted(
                    k.strip().strip('"') for k in mc.group(1).split(",")
            ) == sorted(t.pk()):
                # upsert on the primary key: through the key index
                new = dict(zip(cols, vals))
                idx = t.key_index()
                pos = idx.get(t.key_of(new))
                if pos is not None:
                    if mc.group(2).upper() == "UPDATE SET":
                        t.rows[pos].update(new)
                    return
                t.rows.append(new)
                idx[t.key_of(new)] = len(t.rows) - 1
                t.index_synced()
                return
            if mc:
                # minimal upsert: conflict keys matched by value;
                # DO NOTHING skips, DO UPDATE replaces (fence-table
                # shapes)
                keys = [k.strip().strip('"')
                        for k in mc.group(1).split(",")]
                new = dict(zip(cols, vals))
                for r in t.rows:
                    if all(str(r.get(k)) == str(new.get(k))
                           for k in keys):
                        if mc.group(2).upper() == "UPDATE SET":
                            r.update(new)
                        return
                t.rows.append(new)
                return
            t.rows.append(dict(zip(cols, vals)))
            if fake.echo_dml_to_wal:
                types = {c[0]: c[1] for c in t.columns}
                fake.feed_wal(json.dumps({
                    "action": "I",
                    "schema": m.group(1), "table": m.group(2),
                    "columns": [
                        {"name": c, "type": types.get(c, "text"),
                         "value": v}
                        for c, v in zip(cols, vals)
                    ],
                    "pk": [{"name": c[0], "type": c[1]}
                           for c in t.columns if c[2]],
                }).encode())
            return
        m = re.match(r'delete from "?(\w+)"?\."?(\w+)"? where (.*)', sql,
                     re.I | re.S)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            cond = self._parse_where(m.group(3))
            if not fake.echo_dml_to_wal and t.pk() \
                    and sorted(cond) == sorted(t.pk()):
                # delete by the primary key: the last row moves into the
                # deleted row's place
                idx = t.key_index()
                pos = idx.pop(tuple(cond[k] for k in t.pk()), None)
                if pos is not None:
                    last = t.rows.pop()
                    if pos < len(t.rows):
                        t.rows[pos] = last
                        idx[t.key_of(last)] = pos
                    t.index_synced()
                return
            gone = [r for r in t.rows
                    if all(str(r.get(k)) == v for k, v in cond.items())]
            t.rows = [r for r in t.rows if r not in gone]
            if fake.echo_dml_to_wal:
                types = {c[0]: c[1] for c in t.columns}
                pks = [c[0] for c in t.columns if c[2]]
                for r in gone:
                    fake.feed_wal(json.dumps({
                        "action": "D",
                        "schema": m.group(1), "table": m.group(2),
                        "identity": [
                            {"name": k, "type": types.get(k, "text"),
                             "value": r.get(k)} for k in pks],
                        "pk": [{"name": k, "type": types.get(k, "text")}
                               for k in pks],
                    }).encode())
            return
        m = re.match(r'update "?(\w+)"?\."?(\w+)"? set (.*) where (.*)',
                     sql, re.I | re.S)
        if m:
            t = fake.tables.get((m.group(1), m.group(2)))
            sets = self._parse_where(m.group(3), sep=",")
            cond = self._parse_where(m.group(4))
            if not fake.echo_dml_to_wal and t.pk() \
                    and sorted(cond) == sorted(t.pk()):
                # update by the primary key, through the key index
                idx = t.key_index()
                key = tuple(cond[k] for k in t.pk())
                pos = idx.get(key)
                if pos is not None:
                    r = t.rows[pos]
                    r.update(sets)
                    if t.key_of(r) != key:
                        del idx[key]
                        idx[t.key_of(r)] = pos
                    t.index_synced()
                return
            t.drop_index()   # the scan below may change keys in place
            for r in t.rows:
                if all(str(r.get(k)) == v for k, v in cond.items()):
                    r.update(sets)
                    if fake.echo_dml_to_wal:
                        types = {c[0]: c[1] for c in t.columns}
                        pks = [c[0] for c in t.columns if c[2]]
                        fake.feed_wal(json.dumps({
                            "action": "U",
                            "schema": m.group(1), "table": m.group(2),
                            "columns": [
                                {"name": k,
                                 "type": types.get(k, "text"),
                                 "value": v} for k, v in r.items()],
                            "identity": [
                                {"name": k,
                                 "type": types.get(k, "text"),
                                 "value": r.get(k)} for k in pks],
                            "pk": [{"name": k,
                                    "type": types.get(k, "text")}
                                   for k in pks],
                        }).encode())
            return

    @staticmethod
    def _parse_where(text: str, sep: str = "AND") -> dict:
        out = {}
        parts = text.split(sep if sep == "," else " AND ")
        for p in parts:
            if "=" in p:
                k, v = p.split("=", 1)
                out[k.strip().strip('"')] = v.strip().strip("'")
        return out
