"""Oracle LogMiner CDC source (the port's copy of
``transferia_tpu/providers/oracle/logminer.py``).

Reference parity: pkg/providers/oracle/replication/log_miner/ —
source.go (START_LOGMNR/END_LOGMNR cycle over V$LOGMNR_CONTENTS with
STARTSCN, operation codes 1/2/3, CSF continuation rows, XID transaction
ids), sql_parse.go (redo-SQL statement parser), sql_cast.go (schema-driven
value casting), common/log_position.go (SCN checkpoint state).

Flow per cycle: START_LOGMNR pinned at the checkpointed SCN -> select the
redo rows -> END_LOGMNR -> parse each SQL_REDO into a ChangeItem (values
cast through the table schema) -> push -> after the sink confirms,
checkpoint the high SCN (at-least-once, like every CDC source here).
"""

from __future__ import annotations

import datetime as dt
import logging
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.interfaces import AsyncSink, Source
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.providers.oracle.wire import OracleError

logger = logging.getLogger(__name__)

# V$LOGMNR_CONTENTS operation codes (source.go:46-49)
OP_INSERT = 1
OP_DELETE = 2
OP_UPDATE = 3
OP_COMMIT = 7

_KIND = {OP_INSERT: Kind.INSERT, OP_DELETE: Kind.DELETE,
         OP_UPDATE: Kind.UPDATE}


def _row_pos(r: dict) -> tuple:
    """Redo-row identity (SCN, RS_ID, SSN) — common/log_position.go."""
    return (int(r.get("SCN") or 0), str(r.get("RS_ID") or ""),
            int(r.get("SSN") or 0))


class RedoParseError(Exception):
    pass


@dataclass
class RedoStatement:
    """One parsed redo statement (sql_parse.go ParseResult)."""

    op: Kind
    owner: str
    table: str
    new_values: dict[str, Optional[str]] = field(default_factory=dict)
    conditions: dict[str, Optional[str]] = field(default_factory=dict)

    def table_id(self) -> TableID:
        return TableID(self.owner, self.table)


class _Tokens:
    """Minimal tokenizer over redo SQL: quoted identifiers, string
    literals with '' escapes, bare words, punctuation."""

    def __init__(self, sql: str):
        self.sql = sql
        self.pos = 0
        self.n = len(sql)

    def _skip_ws(self) -> None:
        while self.pos < self.n and self.sql[self.pos] in " \t\r\n;":
            self.pos += 1

    def peek(self) -> str:
        self._skip_ws()
        return self.sql[self.pos] if self.pos < self.n else ""

    def done(self) -> bool:
        self._skip_ws()
        return self.pos >= self.n

    def ident(self) -> str:
        """A "quoted" or bare identifier."""
        self._skip_ws()
        if self.peek() == '"':
            self.pos += 1
            start = self.pos
            while self.pos < self.n and self.sql[self.pos] != '"':
                self.pos += 1
            out = self.sql[start:self.pos]
            self.pos += 1  # closing quote
            return out
        start = self.pos
        while self.pos < self.n and (self.sql[self.pos].isalnum()
                                     or self.sql[self.pos] in "_$#"):
            self.pos += 1
        if start == self.pos:
            raise RedoParseError(
                f"expected identifier at {start} in {self.sql!r}")
        return self.sql[start:self.pos]

    def word(self) -> str:
        return self.ident().lower()

    def expect(self, ch: str) -> None:
        self._skip_ws()
        if self.pos >= self.n or self.sql[self.pos] != ch:
            raise RedoParseError(
                f"expected {ch!r} at {self.pos} in {self.sql!r}")
        self.pos += 1

    def expect_word(self, *words: str) -> None:
        got = self.word()
        if got not in words:
            raise RedoParseError(f"expected {words}, got {got!r}")

    def value(self) -> Optional[str]:
        """A literal: 'string' (with '' escapes), NULL, number, or a
        function-call literal like TO_TIMESTAMP('...', '...')."""
        self._skip_ws()
        if self.pos >= self.n:
            raise RedoParseError("unexpected end of redo sql")
        ch = self.sql[self.pos]
        if ch == "'":
            self.pos += 1
            out = []
            while self.pos < self.n:
                c = self.sql[self.pos]
                if c == "'":
                    if self.pos + 1 < self.n and \
                            self.sql[self.pos + 1] == "'":
                        out.append("'")
                        self.pos += 2
                        continue
                    self.pos += 1
                    return "".join(out)
                out.append(c)
                self.pos += 1
            raise RedoParseError("unterminated string literal")
        # bare token (number / NULL / function literal with parens)
        start = self.pos
        depth = 0
        while self.pos < self.n:
            c = self.sql[self.pos]
            if c == "(":
                depth += 1
            elif c == ")":
                if depth == 0:
                    break
                depth -= 1
            elif c == "'" and depth > 0:
                # string inside a function literal: skip it whole
                self.pos += 1
                while self.pos < self.n:
                    if self.sql[self.pos] == "'":
                        if self.pos + 1 < self.n and \
                                self.sql[self.pos + 1] == "'":
                            self.pos += 1
                        else:
                            break
                    self.pos += 1
            elif depth == 0 and c in ", \t\r\n;":
                break
            self.pos += 1
        raw = self.sql[start:self.pos].strip()
        if raw.upper() == "NULL":
            return None
        return raw


def parse_redo_sql(sql: str) -> RedoStatement:
    """insert/update/delete redo SQL -> RedoStatement (sql_parse.go)."""
    t = _Tokens(sql)
    verb = t.word()
    if verb == "insert":
        t.expect_word("into")
        owner = t.ident()
        t.expect(".")
        table = t.ident()
        t.expect("(")
        cols = [t.ident()]
        while t.peek() == ",":
            t.expect(",")
            cols.append(t.ident())
        t.expect(")")
        t.expect_word("values")
        t.expect("(")
        vals = [t.value()]
        while t.peek() == ",":
            t.expect(",")
            vals.append(t.value())
        t.expect(")")
        if len(cols) != len(vals):
            raise RedoParseError(
                f"{len(cols)} columns vs {len(vals)} values")
        return RedoStatement(Kind.INSERT, owner, table,
                             new_values=dict(zip(cols, vals)))
    if verb == "update":
        owner = t.ident()
        t.expect(".")
        table = t.ident()
        t.expect_word("set")
        new_values: dict[str, Optional[str]] = {}
        while True:
            col = t.ident()
            t.expect("=")
            new_values[col] = t.value()
            if t.peek() != ",":
                break
            t.expect(",")
        conditions = _parse_where(t)
        return RedoStatement(Kind.UPDATE, owner, table,
                             new_values=new_values,
                             conditions=conditions)
    if verb == "delete":
        t.expect_word("from")
        owner = t.ident()
        t.expect(".")
        table = t.ident()
        conditions = _parse_where(t)
        return RedoStatement(Kind.DELETE, owner, table,
                             conditions=conditions)
    raise RedoParseError(f"unsupported redo verb {verb!r}")


def _parse_where(t: _Tokens) -> dict[str, Optional[str]]:
    out: dict[str, Optional[str]] = {}
    if t.done():
        return out
    t.expect_word("where")
    while True:
        col = t.ident()
        t._skip_ws()
        # "C" = 'v'  |  "C" IS NULL
        if t.sql[t.pos:t.pos + 2].lower() == "is":
            t.word()            # IS
            t.expect_word("null")
            out[col] = None
        else:
            t.expect("=")
            out[col] = t.value()
        if t.done():
            return out
        t.expect_word("and")


# NLS mask tokens -> strptime directives, longest first (sql_cast.go
# handles the same masks through godror)
_MASK_TOKENS = [
    ("HH24", "%H"), ("YYYY", "%Y"), ("RRRR", "%Y"), ("MON", "%b"),
    ("MM", "%m"), ("DD", "%d"), ("RR", "%y"), ("YY", "%y"),
    ("HH", "%I"), ("MI", "%M"), ("SS", "%S"), ("AM", "%p"), ("PM", "%p"),
]


def _parse_oracle_datetime(value: str, mask: str) -> Optional[dt.datetime]:
    """Parse a TO_DATE/TO_TIMESTAMP literal using its NLS format mask
    ('29-JUL-26' + 'DD-MON-RR' included — the default-NLS redo form)."""
    mask = mask.strip().upper()
    mask = re.sub(r"\.FF\d?", ".%f", mask)
    fmt = ""
    i = 0
    while i < len(mask):
        for tok, directive in _MASK_TOKENS:
            if mask.startswith(tok, i):
                fmt += directive
                i += len(tok)
                break
        else:
            fmt += mask[i]
            i += 1
    for candidate in (value, value.title()):
        try:
            return dt.datetime.strptime(candidate, fmt)
        except ValueError:
            continue
    return None


def cast_redo_value(cs, raw: Optional[str]) -> Any:
    """Schema-driven cast of a redo literal (sql_cast.go)."""
    if raw is None:
        return None
    t = cs.data_type
    # TO_DATE('29-JUL-26', 'DD-MON-RR') / TO_TIMESTAMP(...) literals:
    # honor the mask argument instead of assuming ISO input
    if raw.upper().startswith(("TO_DATE(", "TO_TIMESTAMP(")):
        inner = _Tokens(raw[raw.index("(") + 1:])
        first = inner.value() or ""
        mask = ""
        if inner.peek() == ",":
            inner.expect(",")
            mask = inner.value() or ""
        if mask:
            parsed = _parse_oracle_datetime(first, mask)
            if parsed is not None:
                epoch = parsed.replace(
                    tzinfo=dt.timezone.utc).timestamp()
                if t == CanonicalType.TIMESTAMP:
                    return int(epoch) * 1_000_000 + parsed.microsecond
                if t == CanonicalType.DATETIME:
                    return int(epoch)
        raw = first
    if t.is_integer:
        try:
            return int(raw)
        except ValueError:
            return raw
    if t.is_float:
        try:
            return float(raw)
        except ValueError:
            return raw
    if t == CanonicalType.BOOLEAN:
        return raw not in ("0", "", "false", "F")
    if t in (CanonicalType.DATETIME, CanonicalType.TIMESTAMP):
        try:
            parsed = dt.datetime.fromisoformat(raw.strip())
        except ValueError:
            return raw
        epoch = parsed.replace(tzinfo=dt.timezone.utc).timestamp()
        if t == CanonicalType.TIMESTAMP:
            return int(epoch) * 1_000_000 + parsed.microsecond
        return int(epoch)
    if t == CanonicalType.STRING:
        return raw.encode()
    return raw


class OracleLogMinerSource(Source):
    """LogMiner polling CDC with post-push SCN checkpointing."""

    STATE_KEY = "oracle_scn"
    BOUNDARY_KEY = "oracle_scn_rows"
    LOGMNR_OPTIONS = ("SYS.DBMS_LOGMNR.DICT_FROM_ONLINE_CATALOG"
                      "+SYS.DBMS_LOGMNR.NO_SQL_DELIMITER"
                      "+SYS.DBMS_LOGMNR.NO_ROWID_IN_STMT"
                      "+SYS.DBMS_LOGMNR.STRING_LITERALS_IN_STMT")

    def __init__(self, params, transfer_id: str,
                 coordinator: Optional[Coordinator] = None,
                 poll_interval: float = 0.5,
                 batch_rows: int = 2048):
        from transferia_tpu_torch.providers.oracle.provider import (
            OracleStorage,
            _conn,
        )

        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.poll_interval = poll_interval
        self.batch_rows = batch_rows
        self._stop = threading.Event()
        # (SCN, RS_ID, SSN) of rows already pushed at the checkpoint SCN
        self._delivered_at_boundary: set[tuple] = set()
        self._make_conn = lambda: _conn(params)
        self._schema_storage = OracleStorage(params)
        self._schemas: dict[TableID, TableSchema] = {}

    def _schema(self, tid: TableID) -> Optional[TableSchema]:
        if tid not in self._schemas:
            try:
                self._schemas[tid] = self._schema_storage.table_schema(tid)
            except OracleError as e:
                logger.warning("no schema for %s: %s", tid, e)
                self._schemas[tid] = None
        return self._schemas[tid]

    def _start_scn(self, conn) -> int:
        if self.cp is not None:
            state = self.cp.get_transfer_state(self.transfer_id)
            if state.get(self.STATE_KEY):
                # boundary rows already delivered before the restart: the
                # >= re-mine must not replay them
                self._delivered_at_boundary = {
                    tuple(pos) for pos in
                    state.get(self.BOUNDARY_KEY) or []
                }
                return int(state[self.STATE_KEY])
            # first replication start after a snapshot: resume from the
            # SCN the snapshot was pinned at, so changes committed during
            # the load are mined, not lost (SNAPSHOT_AND_INCREMENT
            # handoff; common/log_position.go)
            pos = state.get("snapshot_position") or {}
            if pos.get("scn"):
                return int(pos["scn"])
        return int(conn.scalar("SELECT current_scn FROM v$database") or 0)

    def _mine(self, conn, from_scn: int) -> list[dict]:
        """One START_LOGMNR/select/END_LOGMNR cycle (source.go:180-210).

        Mines SCN >= from_scn (not >): Oracle packs many rows of one
        transaction under a shared SCN, and a row at the boundary SCN may
        only become visible after an earlier cycle checkpointed it.  Rows
        already delivered at the boundary are dropped via their
        (SCN, RS_ID, SSN) identity — the reference's position tuple.

        Each statement returned carries under `_POSITIONS` the identity
        of every row it was reassembled from.  The reference remembers
        only the first row of a CSF statement, so a re-mine at that SCN
        glues the statement's remaining continuation rows into a wrong
        statement and delivers it when it parses (ROADMAP.md C9)."""
        conn.execute(
            f"BEGIN DBMS_LOGMNR.START_LOGMNR(STARTSCN => {from_scn}, "
            f"OPTIONS => {self.LOGMNR_OPTIONS}); END;")
        try:
            owner = self.params.owner or self.params.user.upper()
            rows = conn.query(
                "SELECT SCN, RS_ID, SSN, TIMESTAMP, "
                "(XIDUSN||'.'||XIDSLT||'.'||XIDSQN) AS XID, "
                "OPERATION_CODE, SEG_OWNER, TABLE_NAME, SQL_REDO, CSF "
                "FROM V$LOGMNR_CONTENTS "
                f"WHERE SCN >= {from_scn} "
                f"AND OPERATION_CODE IN ({OP_INSERT}, {OP_DELETE}, "
                f"{OP_UPDATE}) "
                f"AND SEG_OWNER = '{owner}'"
            )
        finally:
            conn.execute("BEGIN DBMS_LOGMNR.END_LOGMNR(); END;")
        rows = [r for r in rows
                if _row_pos(r) not in self._delivered_at_boundary]
        # CSF=1 marks a continued statement: concatenate with the next row
        out: list[dict] = []
        pending: Optional[dict] = None
        for r in rows:
            if pending is not None:
                pending["SQL_REDO"] = (pending.get("SQL_REDO") or "") + \
                    (r.get("SQL_REDO") or "")
                pending["CSF"] = r.get("CSF")
                pending["_POSITIONS"].append(_row_pos(r))
                if not int(r.get("CSF") or 0):
                    out.append(pending)
                    pending = None
                continue
            if int(r.get("CSF") or 0):
                pending = dict(r, _POSITIONS=[_row_pos(r)])
                continue
            out.append(dict(r, _POSITIONS=[_row_pos(r)]))
        if pending is not None:
            logger.warning("dropping unterminated CSF redo row")
        return out

    def _to_item(self, row: dict) -> Optional[ChangeItem]:
        try:
            stmt = parse_redo_sql(row.get("SQL_REDO") or "")
        except RedoParseError as e:
            logger.warning("unparsed redo row at scn %s: %s",
                           row.get("SCN"), e)
            return None
        tid = stmt.table_id()
        schema = self._schema(tid)
        if schema is None:
            return None
        ts = row.get("TIMESTAMP")
        commit_ns = 0
        if isinstance(ts, dt.datetime):
            commit_ns = int(ts.replace(
                tzinfo=dt.timezone.utc).timestamp() * 1e9)
        by_name = {c.name: c for c in schema}

        def cast_map(vals: dict) -> dict:
            return {
                k: cast_redo_value(by_name[k], v)
                for k, v in vals.items() if k in by_name
            }

        new_vals = cast_map(stmt.new_values)
        cond_vals = cast_map(stmt.conditions)
        key_cols = [c.name for c in schema.key_columns()] or \
            list(cond_vals)
        old_keys = OldKeys()
        if stmt.op in (Kind.UPDATE, Kind.DELETE):
            old_keys = OldKeys(
                tuple(k for k in key_cols if k in cond_vals),
                tuple(cond_vals[k] for k in key_cols if k in cond_vals),
            )
        if stmt.op == Kind.UPDATE:
            # redo SET lists only changed columns; fill the rest from the
            # WHERE image so the row is complete
            merged = dict(cond_vals)
            merged.update(new_vals)
            new_vals = merged
        names = tuple(n for n in schema.names() if n in new_vals) \
            if stmt.op != Kind.DELETE else ()
        return ChangeItem(
            kind=stmt.op,
            schema=tid.namespace,
            table=tid.name,
            table_schema=schema,
            column_names=names,
            column_values=tuple(new_vals[n] for n in names),
            old_keys=old_keys,
            lsn=int(row.get("SCN") or 0),
            txn_id=str(row.get("XID") or ""),
            commit_time_ns=commit_ns,
        )

    def run(self, sink: AsyncSink) -> None:
        conn = self._make_conn()
        try:
            scn = self._start_scn(conn)
            logger.info("logminer: starting from SCN %d", scn)
            while not self._stop.is_set():
                rows = self._mine(conn, scn)
                if not rows:
                    self._stop.wait(self.poll_interval)
                    continue
                items = []
                high = scn
                for r in rows:
                    item = self._to_item(r)
                    if item is not None:
                        items.append(item)
                    high = max(high, int(r.get("SCN") or 0))
                futures = []
                for i in range(0, len(items), self.batch_rows):
                    futures.append(
                        sink.async_push(items[i:i + self.batch_rows]))
                for f in futures:
                    f.result()
                # confirmed: advance the SCN checkpoint (at-least-once);
                # remember the rows delivered at the new boundary so the
                # >= re-mine never re-delivers them in this run: every row
                # of each statement, and, where the boundary did not move
                # (rows at it that became visible late), the rows delivered
                # at it before too (the reference keeps only this cycle's,
                # ROADMAP.md C9)
                at_high = {
                    pos for r in rows if int(r.get("SCN") or 0) == high
                    for pos in r["_POSITIONS"]
                }
                if high == scn:
                    at_high |= self._delivered_at_boundary
                scn = high
                self._delivered_at_boundary = at_high
                if self.cp is not None:
                    self.cp.set_transfer_state(
                        self.transfer_id,
                        {self.STATE_KEY: scn,
                         self.BOUNDARY_KEY: sorted(
                             list(p) for p in
                             self._delivered_at_boundary)})
        finally:
            conn.close()
            self._schema_storage.close()

    def stop(self) -> None:
        self._stop.set()
