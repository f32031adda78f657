"""In-process fake Oracle server (TNS framing + the client's TTC subset;
the port's own copy of the JAX tests' ``tests/recipes/fake_oracle.py``).

A protocol fake, not a SQL engine: speaks real sockets against the
provider's OracleConnection (CONNECT/ACCEPT, protocol negotiation,
two-phase salted auth, execute/fetch with DESCRIBE + ROW messages and the
ORA-1403 end-of-fetch convention) and pattern-matches the exact SQL the
provider emits (all_tables / all_tab_columns / constraints / v$database /
data SELECTs with AS OF SCN, keyset paging, ORA_HASH shards, samples).

Flashback semantics: every mutation bumps current_scn and snapshots the
table's row list, so ``AS OF SCN n`` reads serve the version that was
current at n — which is what the SCN-consistency e2e asserts.
"""

from __future__ import annotations

import hashlib
import re
import secrets
import socketserver
import struct
import threading

from transferia_tpu_torch.providers.oracle import tns
from transferia_tpu_torch.providers.oracle.tns import (
    ORA_BINARY_DOUBLE,
    ORA_BINARY_FLOAT,
    ORA_BLOB,
    ORA_CHAR,
    ORA_CLOB,
    ORA_DATE,
    ORA_NUMBER,
    ORA_RAW,
    ORA_TIMESTAMP,
    ORA_VARCHAR2,
    PKT_ACCEPT,
    PKT_CONNECT,
    PKT_DATA,
    encode_value,
    read_str,
    read_uint,
    write_str,
    write_uint,
)
from transferia_tpu_torch.providers.oracle.wire import (
    FN_AUTH_PHASE_ONE,
    FN_AUTH_PHASE_TWO,
    FN_EXECUTE,
    FN_FETCH,
    FN_LOGOFF,
    MSG_DESCRIBE,
    MSG_ERROR,
    MSG_FUNCTION,
    MSG_PARAMETER,
    MSG_PROTOCOL,
    MSG_ROW_DATA,
    MSG_STATUS,
    ORA_INVALID_LOGIN,
    ORA_NO_DATA_FOUND,
)

_TYPE_CODES = {
    "VARCHAR2": ORA_VARCHAR2, "NVARCHAR2": ORA_VARCHAR2,
    "CHAR": ORA_CHAR, "NCHAR": ORA_CHAR,
    "NUMBER": ORA_NUMBER, "FLOAT": ORA_NUMBER,
    "BINARY_FLOAT": ORA_BINARY_FLOAT, "BINARY_DOUBLE": ORA_BINARY_DOUBLE,
    "DATE": ORA_DATE, "TIMESTAMP": ORA_TIMESTAMP,
    "RAW": ORA_RAW, "BLOB": ORA_BLOB, "CLOB": ORA_CLOB,
}

_ROWS_PER_BATCH = 100


class FakeOraTable:
    def __init__(self, owner: str, name: str, columns: list[tuple],
                 rows: list[dict] | None = None, scn: int = 0):
        # columns: (name, oracle_type e.g. "NUMBER(10)", is_pk, notnull)
        self.owner = owner
        self.name = name
        self.columns = columns
        self.rows = list(rows or [])
        # flashback versions: (scn, snapshot-of-rows)
        self.versions: list[tuple[int, list[dict]]] = [(scn, list(self.rows))]

    def base_type(self, spec: str) -> str:
        base = spec.split("(")[0].strip().upper()
        return base

    def type_code(self, spec: str) -> int:
        return _TYPE_CODES.get(self.base_type(spec), ORA_VARCHAR2)

    def rows_as_of(self, scn: int | None) -> list[dict]:
        if scn is None:
            return self.rows
        best = self.versions[0][1]
        for vs, rows in self.versions:
            if vs <= scn:
                best = rows
            else:
                break
        return best


class FakeOracle:
    def __init__(self, service_name: str = "XEPDB1", user: str = "scott",
                 password: str = "tiger"):
        self.service_name = service_name
        self.user = user
        self.password = password
        self.tables: dict[tuple[str, str], FakeOraTable] = {}
        self.queries: list[str] = []
        self.current_scn = 1000
        # redo rows served via V$LOGMNR_CONTENTS between START/END_LOGMNR
        self.redo: list[dict] = []
        self.lock = threading.RLock()
        self.port = 0
        self._srv = None

    def add_table(self, table: FakeOraTable) -> None:
        with self.lock:
            table.versions = [(self.current_scn, list(table.rows))]
            self.tables[(table.owner.upper(), table.name.upper())] = table

    def mutate(self, owner: str, name: str, change) -> int:
        """Apply `change(rows)` under a new SCN (flashback versioning)."""
        with self.lock:
            t = self.tables[(owner.upper(), name.upper())]
            self.current_scn += 10
            rows = list(t.rows)
            change(rows)
            t.rows = rows
            t.versions.append((self.current_scn, list(rows)))
            return self.current_scn

    def feed_redo(self, owner: str, table: str, op_code: int,
                  sql_redo: str, xid: str = "1.2.3",
                  csf_parts: int = 1) -> int:
        """Append redo rows for LogMiner mining.  csf_parts > 1 splits the
        statement across continuation rows (CSF=1 on all but the last) the
        way V$LOGMNR_CONTENTS chunks long SQL."""
        import datetime as dt

        with self.lock:
            self.current_scn += 1
            scn = self.current_scn
            ts = dt.datetime(2026, 7, 29, 12, 0, 0)
            rs_id = f"0x{len(self.redo):06x}"
            if csf_parts <= 1:
                self.redo.append({
                    "scn": scn, "ts": ts, "xid": xid, "op": op_code,
                    "owner": owner.upper(), "table": table.upper(),
                    "sql": sql_redo, "csf": 0, "rs_id": rs_id, "ssn": 0,
                })
                return scn
            step = max(1, len(sql_redo) // csf_parts)
            chunks = [sql_redo[i:i + step]
                      for i in range(0, len(sql_redo), step)]
            for i, chunk in enumerate(chunks):
                self.redo.append({
                    "scn": scn, "ts": ts, "xid": xid, "op": op_code,
                    "owner": owner.upper(), "table": table.upper(),
                    "sql": chunk,
                    "csf": 0 if i == len(chunks) - 1 else 1,
                    "rs_id": rs_id, "ssn": i,
                })
            return scn

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FakeOracle":
        fake = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    _Session(fake, self.request).run()
                except (ConnectionError, tns.TNSError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


class _Session:
    def __init__(self, fake: FakeOracle, sock):
        self.fake = fake
        self.sock = sock
        self.salt = secrets.token_bytes(16)
        self.authed = False
        # cursor state: remaining rows + their column type codes
        self.pending_rows: list[list[bytes]] = []

    # -- transport ----------------------------------------------------------
    def send(self, ptype: int, payload: bytes) -> None:
        self.sock.sendall(tns.pack_packet(ptype, payload))

    def send_data(self, payload: bytes) -> None:
        self.send(PKT_DATA, struct.pack(">H", 0) + payload)

    def send_error(self, code: int, message: str) -> None:
        self.send_data(bytes([MSG_ERROR]) + write_uint(code)
                       + write_str(message))

    def run(self) -> None:
        ptype, payload = tns.read_packet(self.sock)
        if ptype != PKT_CONNECT:
            raise tns.TNSError(f"expected CONNECT, got {ptype}")
        desc = tns.parse_connect(payload)
        cd = tns.parse_connect_data(desc)
        want = cd.get("service_name") or cd.get("sid") or ""
        if want.upper() != self.fake.service_name.upper():
            self.send(tns.PKT_REFUSE, tns.build_refuse(
                f"ORA-12514: service {want!r} is not registered"))
            return
        self.send(PKT_ACCEPT, tns.build_accept())
        while True:
            ptype, payload = tns.read_packet(self.sock)
            if ptype != PKT_DATA:
                return
            buf = payload[2:]
            if not buf:
                continue
            if buf[0] == MSG_PROTOCOL:
                self.send_data(bytes([MSG_PROTOCOL]) + b"\x06"
                               + b"fake-oracle\x00")
                continue
            if buf[0] != MSG_FUNCTION:
                self.send_error(600, f"unexpected message 0x{buf[0]:02x}")
                continue
            if not self.dispatch_function(buf):
                return

    def dispatch_function(self, buf: bytes) -> bool:
        fn = buf[1]
        pos = 2
        if fn == FN_LOGOFF:
            return False
        if fn == FN_AUTH_PHASE_ONE:
            user, pos = read_str(buf, pos)
            self.send_data(
                bytes([MSG_PARAMETER]) + write_uint(1)
                + write_str("AUTH_VFR_DATA") + write_str(self.salt.hex()))
            return True
        if fn == FN_AUTH_PHASE_TWO:
            user, pos = read_str(buf, pos)
            verifier, pos = read_str(buf, pos)
            want = hashlib.sha256(
                self.salt + self.fake.password.encode()).hexdigest()
            if user != self.fake.user or verifier != want:
                self.send_error(ORA_INVALID_LOGIN,
                                "ORA-01017: invalid username/password")
                return True
            self.authed = True
            self.send_data(bytes([MSG_STATUS]) + write_uint(0))
            return True
        if not self.authed:
            self.send_error(1012, "ORA-01012: not logged on")
            return True
        if fn == FN_EXECUTE:
            sql, pos = read_str(buf, pos)
            _prefetch, pos = read_uint(buf, pos)
            with self.fake.lock:
                self.fake.queries.append(sql)
                try:
                    self.execute(sql)
                except Exception as e:  # noqa: BLE001 — surface as ORA-
                    self.send_error(900, f"ORA-00900: {e}")
            return True
        if fn == FN_FETCH:
            _cursor, pos = read_uint(buf, pos)
            _n, pos = read_uint(buf, pos)
            self.flush_rows()
            return True
        self.send_error(600, f"unknown function 0x{fn:02x}")
        return True

    # -- SQL dispatch -------------------------------------------------------
    def execute(self, sql: str) -> None:
        low = " ".join(sql.lower().split())
        fake = self.fake
        if low.startswith("begin dbms_logmnr.start_logmnr"):
            m = re.search(r"STARTSCN\s*=>\s*(\d+)", sql, re.I)
            self.logmnr_scn = int(m.group(1)) if m else 0
            self.describe_and_rows([("RESULT", ORA_VARCHAR2)], [])
            return
        if low.startswith("begin dbms_logmnr.end_logmnr"):
            self.logmnr_scn = None
            self.describe_and_rows([("RESULT", ORA_VARCHAR2)], [])
            return
        if "v$logmnr_contents" in low:
            if getattr(self, "logmnr_scn", None) is None:
                raise ValueError(
                    "ORA-01306: START_LOGMNR must be invoked first")
            m = re.search(r"SCN >(=?) (\d+)", sql, re.I)
            floor = int(m.group(2)) if m else 0
            inclusive = bool(m and m.group(1))
            mo = re.search(r"SEG_OWNER = '([^']*)'", sql, re.I)
            owner = mo.group(1) if mo else ""
            mc = re.search(r"OPERATION_CODE IN \(([^)]*)\)", sql, re.I)
            ops = {int(x) for x in mc.group(1).split(",")} if mc else None
            with fake.lock:
                rows = [
                    r for r in fake.redo
                    if (r["scn"] >= floor if inclusive
                        else r["scn"] > floor)
                    and (not owner or r["owner"] == owner)
                    and (ops is None or r["op"] in ops)
                ]
            encoded = [
                [encode_value(ORA_NUMBER, r["scn"]),
                 encode_value(ORA_VARCHAR2, r.get("rs_id", "")),
                 encode_value(ORA_NUMBER, r.get("ssn", 0)),
                 encode_value(ORA_DATE, r["ts"]),
                 encode_value(ORA_VARCHAR2, r["xid"]),
                 encode_value(ORA_NUMBER, r["op"]),
                 encode_value(ORA_VARCHAR2, r["owner"]),
                 encode_value(ORA_VARCHAR2, r["table"]),
                 encode_value(ORA_VARCHAR2, r["sql"]),
                 encode_value(ORA_NUMBER, r["csf"])]
                for r in rows
            ]
            self.describe_and_rows(
                [("SCN", ORA_NUMBER), ("RS_ID", ORA_VARCHAR2),
                 ("SSN", ORA_NUMBER), ("TIMESTAMP", ORA_DATE),
                 ("XID", ORA_VARCHAR2), ("OPERATION_CODE", ORA_NUMBER),
                 ("SEG_OWNER", ORA_VARCHAR2),
                 ("TABLE_NAME", ORA_VARCHAR2),
                 ("SQL_REDO", ORA_VARCHAR2), ("CSF", ORA_NUMBER)],
                encoded)
            return
        if low == "select 1 from dual":
            self.describe_and_rows(
                [("1", ORA_NUMBER)], [[encode_value(ORA_NUMBER, 1)]])
            return
        if "from v$database" in low:
            self.describe_and_rows(
                [("CURRENT_SCN", ORA_NUMBER)],
                [[encode_value(ORA_NUMBER, fake.current_scn)]])
            return
        if "from all_tables" in low:
            m = re.search(r"owner = '([^']*)'", sql, re.I)
            owner = (m.group(1) if m else "").upper()
            rows = [
                [encode_value(ORA_VARCHAR2, t.name),
                 encode_value(ORA_NUMBER, len(t.rows))]
                for (o, _), t in fake.tables.items() if o == owner
            ]
            self.describe_and_rows(
                [("TABLE_NAME", ORA_VARCHAR2), ("NUM_ROWS", ORA_NUMBER)],
                rows)
            return
        if "from all_tab_columns" in low:
            t = self._table_from_filters(sql)
            rows = []
            for (name, spec, _pk, notnull) in t.columns:
                base = t.base_type(spec)
                m = re.search(r"\((\d+)(?:,\s*(-?\d+))?\)", spec)
                prec = int(m.group(1)) if m else 0
                scale = int(m.group(2)) if m and m.group(2) else 0
                rows.append([
                    encode_value(ORA_VARCHAR2, name),
                    encode_value(ORA_VARCHAR2, base),
                    encode_value(ORA_NUMBER, prec),
                    encode_value(ORA_NUMBER, scale),
                    encode_value(ORA_CHAR, "N" if notnull else "Y"),
                ])
            self.describe_and_rows(
                [("COLUMN_NAME", ORA_VARCHAR2), ("DATA_TYPE", ORA_VARCHAR2),
                 ("DATA_PRECISION", ORA_NUMBER), ("DATA_SCALE", ORA_NUMBER),
                 ("NULLABLE", ORA_CHAR)], rows)
            return
        if "from all_constraints" in low or "all_cons_columns" in low:
            t = self._table_from_filters(sql)
            rows = [[encode_value(ORA_VARCHAR2, name)]
                    for (name, _spec, pk, _nn) in t.columns if pk]
            self.describe_and_rows([("COLUMN_NAME", ORA_VARCHAR2)], rows)
            return
        if "from all_segments" in low:
            t = self._table_from_filters(sql, owner_key="owner",
                                         name_key="segment_name")
            self.describe_and_rows(
                [("SUM(BYTES)", ORA_NUMBER)],
                [[encode_value(ORA_NUMBER, len(t.rows) * 100)]])
            return
        m = re.match(r'select count\(\*\) from "([^"]+)"\."([^"]+)"', low)
        if m:
            t = fake.tables.get((m.group(1).upper(), m.group(2).upper()))
            n = len(t.rows) if t else 0
            self.describe_and_rows(
                [("COUNT(*)", ORA_NUMBER)], [[encode_value(ORA_NUMBER, n)]])
            return
        m = re.match(r'SELECT (.+?) FROM "([^"]+)"\."([^"]+)"(.*)$',
                     sql, re.S | re.I)
        if m:
            self.execute_data_select(m.group(1), m.group(2), m.group(3),
                                     m.group(4))
            return
        raise ValueError(f"fake Oracle: unhandled query: {sql[:120]}")

    def _table_from_filters(self, sql: str, owner_key: str = "owner",
                            name_key: str = "table_name") -> FakeOraTable:
        mo = re.search(rf"{owner_key} = '([^']*)'", sql, re.I)
        mn = re.search(rf"(?:{name_key}|cons\.table_name) = '([^']*)'",
                       sql, re.I)
        key = ((mo.group(1) if mo else "").upper(),
               (mn.group(1) if mn else "").upper())
        t = self.fake.tables.get(key)
        if t is None:
            raise ValueError(f"table {key} does not exist")
        return t

    # -- data SELECT evaluation --------------------------------------------
    def execute_data_select(self, collist: str, owner: str, name: str,
                            tail: str) -> None:
        t = self.fake.tables.get((owner.upper(), name.upper()))
        if t is None:
            raise ValueError(f"ORA-00942: table {owner}.{name} not found")
        cols = [c.strip().strip('"') for c in collist.split(",")]
        specs = {n: spec for (n, spec, _pk, _nn) in t.columns}

        scn = None
        m = re.search(r"AS OF SCN (\d+)", tail, re.I)
        if m:
            scn = int(m.group(1))
        rows = list(t.rows_as_of(scn))

        m = re.search(r"WHERE (.*?)(?: ORDER BY | FETCH |$)", tail, re.S)
        if m:
            rows = self._apply_where(m.group(1).strip(), rows)
        m = re.search(r"ORDER BY (.+?)(?: FETCH |$)", tail, re.S)
        if m:
            for part in reversed(m.group(1).split(",")):
                part = part.strip()
                desc = part.upper().endswith(" DESC")
                cname = part.split()[0].strip('"')

                def key_fn(r, _n=cname):
                    v = r.get(_n)
                    if v is None:
                        return (2, 0)
                    try:
                        return (0, float(v))
                    except (TypeError, ValueError):
                        return (1, str(v))
                rows = sorted(rows, key=key_fn, reverse=desc)
        m = re.search(r"FETCH NEXT (\d+) ROWS ONLY", tail, re.I)
        if m:
            rows = rows[: int(m.group(1))]

        header = [(c, t.type_code(specs.get(c, "VARCHAR2"))) for c in cols]
        encoded = [
            [encode_value(code, r.get(cname)) for cname, code in header]
            for r in rows
        ]
        self.describe_and_rows(header, encoded)

    def _apply_where(self, cond: str, rows: list[dict]) -> list[dict]:
        """Apply every recognized predicate of the conjunction in turn
        (shard MOD filters compose with keyset pagination)."""
        m = re.search(r"MOD\(ORA_HASH\(ROWID\), (\d+)\) = (\d+)", cond)
        if m:
            n, i = int(m.group(1)), int(m.group(2))
            rows = [r for idx, r in enumerate(rows) if idx % n == i]
            cond = cond.replace(m.group(0), "").strip()
        if "DBMS_RANDOM.VALUE" in cond:
            return rows[::7]
        if '" = ' in cond:
            keysets = []
            for group in re.findall(r"\(([^()]*)\)", cond):
                want = {}
                for eq in group.split(" AND "):
                    mk = re.match(r'\s*"([^"]+)"\s*=\s*(.+)\s*', eq)
                    if mk:
                        want[mk.group(1)] = mk.group(2).strip().strip("'")
                if want:
                    keysets.append(want)
            return [
                r for r in rows
                if any(all(str(r.get(k)) == v for k, v in ks.items())
                       for ks in keysets)
            ]
        m = re.search(r'"([^"]+)" > (.+)', cond)
        if m:
            cname, raw = m.group(1), m.group(2).strip().strip("'")

            def gt(v):
                if v is None:
                    return False
                try:
                    return float(v) > float(raw)
                except (TypeError, ValueError):
                    return str(v) > raw
            return [r for r in rows if gt(r.get(cname))]
        return rows

    # -- TTC responses ------------------------------------------------------
    def describe_and_rows(self, header: list[tuple[str, int]],
                          encoded_rows: list[list[bytes]]) -> None:
        out = bytes([MSG_DESCRIBE]) + write_uint(1) + write_uint(len(header))
        for name, code in header:
            out += (write_str(name) + write_uint(code) + write_uint(0)
                    + write_uint(0) + write_uint(1) + write_str(""))
        self.send_data(out)
        self.pending_rows = [b"".join(vals) for vals in encoded_rows]
        self.flush_rows()

    def flush_rows(self) -> None:
        batch = self.pending_rows[:_ROWS_PER_BATCH]
        self.pending_rows = self.pending_rows[_ROWS_PER_BATCH:]
        for row in batch:
            self.send_data(bytes([MSG_ROW_DATA]) + row)
        if self.pending_rows:
            self.send_data(bytes([MSG_STATUS]) + write_uint(0))
        else:
            self.send_error(ORA_NO_DATA_FOUND,
                            "ORA-01403: no data found")
