"""In-process fake ClickHouse HTTP endpoint: the port's copy of the parts
of ``tests/recipes/fake_clickhouse.py`` that the port's sink speaks to.

Query param parsing, CREATE/DROP/TRUNCATE TABLE (the ORDER BY kept as
the table's key), INSERT ... FORMAT RowBinary (the payload walked and
counted at insert time and decoded on read with an independent minimal
decoder), what the staged commit speaks (the `system.tables` listing,
`REPLACE`/`DROP PARTITION ID` over the rows' `__trtpu_part` membership,
the fence's `SELECT max(...)` and `SELECT count()`), and what the
ClickHouse storage reads a table with for the checksum task:
`system.columns`, `system.parts`, and `SELECT ... FORMAT RowBinary`
with the WHERE (the `rand()` cut, ORed key equalities), ORDER BY and
LIMIT shapes it emits.  Every query is kept in `queries`.  Runs the
real CHClient against real sockets; only the server side is fake.  The
JAX fake's cluster discovery serves a part the port does not have yet.
"""

from __future__ import annotations

import json
import re
import struct
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _LazyTable(dict):
    """Table entry whose RowBinary inserts decode lazily.

    INSERT bodies are structure-validated and row-COUNTED at insert time
    (cheap walk), but full Python row objects materialize only when
    someone reads ["rows"] — benches poll counts at high frequency and a
    real server never builds Python rows at all."""

    def __getitem__(self, key):
        if key == "rows":
            pend = dict.__getitem__(self, "pending")
            if pend:
                rows = dict.__getitem__(self, "rows")
                for body, col_names, types, _count in pend:
                    decoded = _decode_rowbinary_rows(body, types)
                    rows.extend(dict(zip(col_names, r)) for r in decoded)
                pend.clear()
        return dict.__getitem__(self, key)

    def __setitem__(self, key, value):
        if key == "rows":  # truncate: discard pending blobs too
            dict.__getitem__(self, "pending").clear()
        dict.__setitem__(self, key, value)

    def row_count(self) -> int:
        # materialized rows (tests may mutate that list directly) plus
        # not-yet-decoded inserts
        return (len(dict.__getitem__(self, "rows"))
                + sum(c for _, _, _, c in
                      dict.__getitem__(self, "pending")))


class FakeCH:
    def __init__(self):
        self.tables: dict[str, dict] = {}   # name -> {ddl, columns, rows}
        self.queries: list[str] = []
        self.lock = threading.Lock()
        self._srv: ThreadingHTTPServer | None = None
        self.port = 0

    def total_rows(self) -> int:
        """Inserted-row count without materializing rows (cheap to
        poll).  Staging-plane tables (__trtpu_*: the fence rows, per-part
        staging) are not delivered data and are left out."""
        with self.lock:
            return sum(t.row_count() for n, t in self.tables.items()
                       if not n.startswith("__trtpu"))

    def rows(self, table: str) -> list[dict]:
        with self.lock:
            t = self.tables.get(table)
            if t is None:
                return []
            # index, don't .get: dict.get would bypass _LazyTable and
            # miss pending (undecoded) inserts
            return list(t["rows"])

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FakeCH":
        fake = self

        class Handler(BaseHTTPRequestHandler):
            # real ClickHouse speaks HTTP/1.1 with keep-alive; the client
            # pools per-thread connections, so the fake must match
            protocol_version = "HTTP/1.1"

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                qs = urllib.parse.parse_qs(
                    urllib.parse.urlparse(self.path).query
                )
                query = (qs.get("query") or [""])[0]
                try:
                    out = fake.handle(query, body)
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                except Exception as e:
                    msg = str(e).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_port
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    # -- protocol -----------------------------------------------------------
    def handle(self, query: str, body: bytes) -> bytes:
        with self.lock:
            self.queries.append(query)
        q = query.strip()
        low = q.lower()
        if low == "select 1":
            return b"1\n"
        m = re.match(r"create table if not exists `?(\w+)`?\s*\((.*)\)\s*"
                     r"engine\s*=\s*(.*?)\s+order by", low, re.S)
        if m:
            name = re.match(
                r"CREATE TABLE IF NOT EXISTS `?(\w+)`?", q, re.I
            ).group(1)
            cols = self._parse_ddl_cols(q)
            mo = re.search(r"ORDER BY \(([^)]*)\)", q, re.I)
            order_by = [c.strip().strip("`")
                        for c in mo.group(1).split(",")] if mo else []
            with self.lock:
                if name not in self.tables:
                    self.tables[name] = _LazyTable({
                        "ddl": q, "columns": cols, "rows": [],
                        "pending": [],
                        "order_by": [c for c in order_by if c],
                    })
            return b""
        m = re.match(r"(drop|truncate) table if exists `?(\w+)`?", low)
        if m:
            with self.lock:
                if m.group(1) == "drop":
                    self.tables.pop(m.group(2), None)
                elif m.group(2) in self.tables:
                    self.tables[m.group(2)]["rows"] = []
            return b""
        m = re.match(r"insert into `?(\w+)`?\s*\((.*?)\)\s*format rowbinary",
                     low, re.S)
        if m:
            name = re.match(r"INSERT INTO `?(\w+)`?", q, re.I).group(1)
            col_names = [
                c.strip().strip("`")
                for c in re.search(r"\((.*?)\)", q, re.S).group(1).split(",")
            ]
            with self.lock:
                table = self.tables.get(name)
                if table is None:
                    raise ValueError(f"Table {name} does not exist")
                types = [table["columns"][c] for c in col_names]
                # validate structure + count rows now; decode lazily
                n = _count_rowbinary_rows(body, types)
                table["pending"].append((body, col_names, types, n))
            return b""
        m = re.match(r"alter table `?(\w+)`? replace partition id "
                     r"'([^']*)' from `?(\w+)`?", low)
        if m:
            # the staged-commit publish: partition `slug` of the final
            # table atomically becomes the staging table's rows (rows
            # carry partition membership in their __trtpu_part value)
            final = re.match(r"ALTER TABLE `?(\w+)`?", q, re.I).group(1)
            src_name = re.search(r"FROM `?(\w+)`?\s*$", q, re.I).group(1)
            slug = m.group(2)
            with self.lock:
                dst = self.tables.get(final)
                src = self.tables.get(src_name)
                if dst is None or src is None:
                    raise ValueError("no such table for REPLACE PARTITION")
                moved = []
                for row in src["rows"]:
                    row = dict(row)
                    row["__trtpu_part"] = slug
                    moved.append(row)
                kept = [r for r in dst["rows"]
                        if r.get("__trtpu_part") != slug]
                dst["rows"] = kept + moved
            return b""
        m = re.match(r"alter table `?(\w+)`? drop partition id '([^']*)'",
                     low)
        if m:
            final = re.match(r"ALTER TABLE `?(\w+)`?", q, re.I).group(1)
            slug = m.group(2)
            with self.lock:
                dst = self.tables.get(final)
                if dst is not None:
                    dst["rows"] = [r for r in dst["rows"]
                                   if r.get("__trtpu_part") != slug]
            return b""
        m = re.match(r"select max\(`?(\w+)`?\) from `?(\w+)`? "
                     r"where `?(\w+)`? = '([^']*)'", low)
        if m:
            col_name = re.search(r"max\(`?(\w+)`?\)", q, re.I).group(1)
            tbl = re.search(r"FROM `?(\w+)`?", q, re.I).group(1)
            kcol = re.search(r"WHERE `?(\w+)`?", q, re.I).group(1)
            kval = m.group(4)
            with self.lock:
                t = self.tables.get(tbl)
                vals = []
                if t is not None:
                    for r in t["rows"]:
                        rv = r.get(kcol)
                        if isinstance(rv, bytes):
                            rv = rv.decode()
                        if rv == kval and r.get(col_name) is not None:
                            vals.append(int(r[col_name]))
            best = max(vals) if vals else None
            return json.dumps({"data": [[best]]}).encode()
        m = re.match(r"select (.*) from `?(\w+)`?\s*(.*?)\s*"
                     r"format rowbinary", low, re.S)
        if m:
            name = re.search(r"FROM `?(\w+)`?", q, re.I).group(1)
            with self.lock:
                t = self.tables.get(name)
                if t is None:
                    raise ValueError(f"Table {name} does not exist")
                sel = re.match(r"SELECT (.*?) FROM", q, re.S | re.I).group(1)
                cols = []
                for expr in sel.split(","):
                    expr = expr.strip()
                    mm = re.match(r"toString\(`(\w+)`\) AS", expr)
                    cols.append(mm.group(1) if mm else expr.strip("`"))
                rows = self._filter_rows(t["rows"], q)
                return _encode_rowbinary_rows(
                    rows, cols, [t["columns"][c] for c in cols])
        if "from system.parts" in low:
            m = re.search(r"table = '(\w+)'", q)
            with self.lock:
                t = self.tables.get(m.group(1)) if m else None
                size = t.row_count() * 100 if t else 0
            return json.dumps({"data": [[size]]}).encode()
        if "from system.columns" in low:
            m = re.search(r"table = '(\w+)'", q)
            with self.lock:
                t = self.tables.get(m.group(1)) if m else None
                keys = t.get("order_by", []) if t else []
                data = [
                    {"name": c, "type": typ,
                     "is_in_primary_key": 1 if c in keys else 0}
                    for c, typ in (t["columns"].items() if t else [])
                ]
            return json.dumps({"data": data}).encode()
        if "from system.tables" in low:
            mn = re.search(r"name = '(\w+)'", q)
            with self.lock:
                if mn and low.startswith("select count()"):
                    n = 1 if mn.group(1) in self.tables else 0
                    return json.dumps({"data": [[n]]}).encode()
                data = [
                    {"name": n, "total_rows": len(t["rows"])}
                    for n, t in self.tables.items()
                ]
            return json.dumps({"data": data}).encode()
        m = re.match(r"select count\(\) from `?(\w+)`?", low)
        if m:
            with self.lock:
                t = self.tables.get(m.group(1))
                n = t.row_count() if t is not None else 0
            return json.dumps({"data": [[n]]}).encode()
        raise ValueError(f"fake CH: unhandled query: {q[:120]}")

    @staticmethod
    def _filter_rows(rows: list[dict], sql: str) -> list[dict]:
        """The WHERE/ORDER BY/LIMIT shapes the storage emits: the rand()
        cut (a deterministic every-7th subsample), ORed key equalities
        (matched by literal text, as the JAX fake does, through a set)
        and the top/bottom ordering."""
        rows = list(rows)
        mw = re.search(r"WHERE (.*?)(?: ORDER BY | LIMIT | FORMAT )",
                       sql, re.S | re.I)
        if mw:
            cond = mw.group(1).strip()
            if "rand()" in cond:
                rows = rows[::7]
            elif "` = " in cond:
                wanted: dict[tuple, set] = {}
                for group in re.findall(r"\(([^()]*)\)", cond):
                    want = {}
                    for eq in group.split(" AND "):
                        mk = re.match(r"\s*`(\w+)`\s*=\s*(.+)\s*", eq)
                        if mk:
                            want[mk.group(1)] = mk.group(2).strip()
                    if want:
                        names = tuple(sorted(want))
                        wanted.setdefault(names, set()).add(
                            tuple(want[k] for k in names))
                rows = [r for r in rows
                        if any(tuple(_literal(r.get(k)) for k in names)
                               in vals for names, vals in wanted.items())]
        mo = re.search(r"ORDER BY (.+?)(?: LIMIT | FORMAT )", sql,
                       re.S | re.I)
        if mo:
            for part in reversed(mo.group(1).split(",")):
                part = part.strip()
                desc = part.upper().endswith(" DESC")
                name = part.split()[0].strip("`")
                rows = sorted(
                    rows, key=lambda r: (r.get(name) is None, r.get(name)),
                    reverse=desc)
        ml = re.search(r"LIMIT (\d+)", sql, re.I)
        if ml:
            rows = rows[: int(ml.group(1))]
        return rows

    @staticmethod
    def _parse_ddl_cols(ddl: str) -> dict[str, str]:
        inner = re.search(r"\((.*)\)\s*ENGINE", ddl, re.S | re.I).group(1)
        cols = {}
        depth = 0
        current = ""
        parts = []
        for ch in inner:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(current)
                current = ""
            else:
                current += ch
        if current.strip():
            parts.append(current)
        for p in parts:
            toks = p.strip().split(None, 1)
            cols[toks[0].strip("`")] = toks[1].strip()
        return cols


# -- independent minimal RowBinary decoder (not the framework's) ------------

_FIXED = {
    "Int8": ("<b", 1), "Int16": ("<h", 2), "Int32": ("<i", 4),
    "Int64": ("<q", 8), "UInt8": ("<B", 1), "UInt16": ("<H", 2),
    "UInt32": ("<I", 4), "UInt64": ("<Q", 8), "Float32": ("<f", 4),
    "Float64": ("<d", 8), "Bool": ("<B", 1), "Date32": ("<i", 4),
    "DateTime": ("<I", 4), "DateTime64(6)": ("<q", 8),
}


def _literal(v) -> str:
    """A stored value as the storage writes its literal in a WHERE."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return str(v)
    s = str(v).replace("\\", "\\\\").replace("'", "\\'")
    return f"'{s}'"


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_rowbinary_rows(rows: list[dict], cols: list[str],
                           types: list[str]) -> bytes:
    out = []
    for row in rows:
        for c, t in zip(cols, types):
            v = row.get(c)
            nullable = t.startswith("Nullable(")
            base = t[9:-1] if nullable else t
            if nullable:
                if v is None:
                    out.append(b"\x01")
                    continue
                out.append(b"\x00")
            if base in _FIXED:
                fmt, _ = _FIXED[base]
                if base in ("Float32", "Float64"):
                    v = float(v or 0)
                elif base == "Bool":
                    v = 1 if v in (True, "True", "true", 1) else 0
                else:
                    v = int(v or 0)
                out.append(struct.pack(fmt, v))
            else:
                raw = v if isinstance(v, bytes) else str(v or "").encode()
                out.append(_encode_varint(len(raw)) + raw)
    return b"".join(out)


def _count_rowbinary_rows(data: bytes, types: list[str]) -> int:
    """Walk-only structural validation + row count (no Python objects).
    Raises on malformed payloads exactly where the decoder would."""
    pos = 0
    n = len(data)
    count = 0
    while pos < n:
        for t in types:
            nullable = t.startswith("Nullable(")
            base = t[9:-1] if nullable else t
            if nullable:
                if data[pos] == 1:
                    pos += 1
                    continue
                pos += 1
            if base in _FIXED:
                pos += _FIXED[base][1]
            elif base == "String":
                ln = 0
                shift = 0
                while True:
                    b = data[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                pos += ln
            else:
                raise ValueError(f"fake CH decoder: type {t}")
        if pos > n:
            raise ValueError("rowbinary payload truncated")
        count += 1
    return count


def _decode_rowbinary_rows(data: bytes, types: list[str]) -> list[list]:
    pos = 0
    rows = []
    while pos < len(data):
        row = []
        for t in types:
            nullable = t.startswith("Nullable(")
            base = t[9:-1] if nullable else t
            if nullable:
                flag = data[pos]
                pos += 1
                if flag == 1:
                    row.append(None)
                    continue
            if base in _FIXED:
                fmt, w = _FIXED[base]
                v = struct.unpack_from(fmt, data, pos)[0]
                pos += w
                row.append(bool(v) if base == "Bool" else v)
            elif base == "String":
                ln = 0
                shift = 0
                while True:
                    b = data[pos]
                    pos += 1
                    ln |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                row.append(data[pos:pos + ln])
                pos += ln
            else:
                raise ValueError(f"fake CH decoder: type {t}")
        rows.append(row)
    return rows
