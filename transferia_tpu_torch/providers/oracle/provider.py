"""Oracle provider: snapshot storage over the TNS/TTC wire client (the
port's copy of ``transferia_tpu/providers/oracle/provider.py``).

Reference parity: pkg/providers/oracle/ — model_source.go (connection
types SID/ServiceName/TNS, ConvertNumberToInt64, include/exclude),
snapshot/table_source.go:69 (SCN-consistent reads: ``select ... as of scn
N``), provider/sharding_storage.go (ROWID-range intra-table splits),
schema/ (ALL_TAB_COLUMNS-driven schema, type casts in snapshot/cast.go).
LogMiner CDC replication lives in logminer.py (reference
replication/log_miner/); SCN position checkpointing is shared between
the consistent snapshot and the CDC resume point.
"""

from __future__ import annotations

import calendar
import datetime as dt
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import (
    PositionalStorage,
    Pusher,
    SampleableStorage,
    ShardingStorage,
    SnapshotableStorage,
    Storage,
    TableInfo,
)
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import EndpointParams, register_endpoint
from transferia_tpu_torch.providers.oracle.wire import OracleConnection, OracleError
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)
from transferia_tpu_torch.typesystem.rules import register_source_rules

logger = logging.getLogger(__name__)

# source type rules (schema/ + snapshot/cast.go: NUMBER splits by scale and
# precision; CLOB family is utf8; RAW/BLOB are bytes)
register_source_rules("oracle", {
    "char": CanonicalType.UTF8, "varchar2": CanonicalType.UTF8,
    "nchar": CanonicalType.UTF8, "nvarchar2": CanonicalType.UTF8,
    "long": CanonicalType.UTF8,
    "clob": CanonicalType.UTF8, "nclob": CanonicalType.UTF8,
    "number": CanonicalType.DECIMAL,
    "float": CanonicalType.DOUBLE,
    "binary_float": CanonicalType.FLOAT,
    "binary_double": CanonicalType.DOUBLE,
    "raw": CanonicalType.STRING, "long raw": CanonicalType.STRING,
    "blob": CanonicalType.STRING,
    "date": CanonicalType.DATETIME,
    "timestamp": CanonicalType.TIMESTAMP,
    "timestamp with time zone": CanonicalType.TIMESTAMP,
    "timestamp with local time zone": CanonicalType.TIMESTAMP,
    "interval year to month": CanonicalType.UTF8,
    "interval day to second": CanonicalType.INTERVAL,
    "*": CanonicalType.ANY,
})


@register_endpoint
@dataclass
class OracleSourceParams(EndpointParams):
    PROVIDER = "oracle"
    IS_SOURCE = True

    host: str = "localhost"
    port: int = 1521
    # exactly one of these names the database (model_source.go
    # OracleConnectionType)
    service_name: str = ""
    sid: str = ""
    user: str = ""
    password: str = ""
    # schema (owner) whose tables are transferred
    owner: str = ""
    include_tables: list[str] = field(default_factory=list)
    exclude_tables: list[str] = field(default_factory=list)
    # NUMBER(p<=18, s=0) -> int64 instead of decimal
    # (model_source.go ConvertNumberToInt64)
    convert_number_to_int64: bool = True
    # flashback-consistent reads pinned to the activation SCN; disable
    # when UNDO retention is too small (IsNonConsistentSnapshot)
    consistent_snapshot: bool = True
    batch_rows: int = 65_536
    desired_shards: int = 4


def _conn(params: OracleSourceParams) -> OracleConnection:
    return OracleConnection(
        host=params.host, port=params.port, user=params.user,
        password=params.password, service_name=params.service_name,
        sid=params.sid,
    ).connect()


def _q(name: str) -> str:
    return '"' + name.replace('"', '""') + '"'


def _ora_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return str(v)
    # temporal keys must not depend on the session NLS_DATE_FORMAT:
    # render through explicit TO_DATE/TO_TIMESTAMP masks
    if isinstance(v, dt.datetime):
        if v.microsecond:
            return (f"TO_TIMESTAMP('{v:%Y-%m-%d %H:%M:%S.%f}', "
                    "'YYYY-MM-DD HH24:MI:SS.FF6')")
        return (f"TO_DATE('{v:%Y-%m-%d %H:%M:%S}', "
                "'YYYY-MM-DD HH24:MI:SS')")
    if isinstance(v, dt.date):
        return f"TO_DATE('{v:%Y-%m-%d}', 'YYYY-MM-DD')"
    s = str(v).replace("'", "''")
    return f"'{s}'"


class OracleStorage(Storage, PositionalStorage, ShardingStorage,
                    SampleableStorage, SnapshotableStorage):
    def __init__(self, params: OracleSourceParams):
        self.params = params
        self._c: Optional[OracleConnection] = None
        self._scn: Optional[int] = None
        self._conn_lock = threading.Lock()

    @property
    def conn(self) -> OracleConnection:
        with self._conn_lock:
            if self._c is None:
                self._c = _conn(self.params)
            return self._c

    def close(self) -> None:
        with self._conn_lock:
            c, self._c = self._c, None
        if c is not None:
            c.close()

    def ping(self) -> None:
        self.conn.scalar("SELECT 1 FROM dual")

    @property
    def owner(self) -> str:
        return self.params.owner or self.params.user.upper()

    # -- catalog ------------------------------------------------------------
    def table_list(self, include=None):
        rows = self.conn.query(
            "SELECT table_name, num_rows FROM all_tables "
            f"WHERE owner = {_ora_literal(self.owner)}"
        )
        out = {}
        inc = [t.upper() for t in self.params.include_tables]
        exc = [t.upper() for t in self.params.exclude_tables]
        for r in rows:
            name = r["TABLE_NAME"]
            if inc and name.upper() not in inc:
                continue
            if name.upper() in exc:
                continue
            tid = TableID(self.owner, name)
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(eta_rows=int(r["NUM_ROWS"] or 0))
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        return self._table_schema_on(self.conn, table)

    def _table_schema_on(self, conn: OracleConnection,
                         table: TableID) -> TableSchema:
        from transferia_tpu_torch.typesystem.rules import map_source_type

        rows = conn.query(
            "SELECT column_name, data_type, data_precision, data_scale, "
            "nullable FROM all_tab_columns "
            f"WHERE owner = {_ora_literal(table.namespace)} "
            f"AND table_name = {_ora_literal(table.name)} "
            "ORDER BY column_id"
        )
        pk_cols = self._primary_keys_on(conn, table)
        cols = []
        for r in rows:
            dtype = (r["DATA_TYPE"] or "").lower()
            # TIMESTAMP(6) -> timestamp; INTERVAL DAY(2) TO SECOND(6) ->
            # interval day to second
            base = dtype
            while "(" in base:
                i = base.index("(")
                j = base.index(")", i)
                base = base[:i] + base[j + 1:]
            base = " ".join(base.split())
            ctype = map_source_type("oracle", base)
            if base == "number":
                scale = int(r["DATA_SCALE"] or 0)
                prec = int(r["DATA_PRECISION"] or 0)
                if scale == 0:
                    if 0 < prec <= 18 and self.params.convert_number_to_int64:
                        ctype = CanonicalType.INT64
                    elif prec == 0 and self.params.convert_number_to_int64:
                        # unconstrained NUMBER used as integer is common;
                        # cast.go maps it via ConvertNumberToInt64 too
                        ctype = CanonicalType.INT64
                elif prec and scale > 0:
                    ctype = CanonicalType.DOUBLE
            cols.append(ColSchema(
                name=r["COLUMN_NAME"],
                data_type=ctype,
                primary_key=r["COLUMN_NAME"] in pk_cols,
                required=r["NULLABLE"] == "N",
                original_type=f"oracle:{r['DATA_TYPE']}",
            ))
        return TableSchema(cols)

    def _primary_keys_on(self, conn: OracleConnection,
                         table: TableID) -> set[str]:
        rows = conn.query(
            "SELECT cols.column_name FROM all_constraints cons "
            "JOIN all_cons_columns cols "
            "ON cons.constraint_name = cols.constraint_name "
            "AND cons.owner = cols.owner "
            f"WHERE cons.owner = {_ora_literal(table.namespace)} "
            f"AND cons.table_name = {_ora_literal(table.name)} "
            "AND cons.constraint_type = 'P' ORDER BY cols.position"
        )
        return {r["COLUMN_NAME"] for r in rows}

    def exact_table_rows_count(self, table: TableID) -> int:
        return int(self.conn.scalar(
            f"SELECT COUNT(*) FROM {_q(table.namespace)}.{_q(table.name)}"
        ) or 0)

    def estimate_table_rows_count(self, table: TableID) -> int:
        info = self.table_list([table]).get(table)
        return info.eta_rows if info else 0

    def table_size_in_bytes(self, table: TableID) -> int:
        try:
            return int(self.conn.scalar(
                "SELECT SUM(bytes) FROM all_segments "
                f"WHERE owner = {_ora_literal(table.namespace)} "
                f"AND segment_name = {_ora_literal(table.name)}"
            ) or 0)
        except OracleError:
            return 0

    # -- PositionalStorage: SCN checkpoint (common/log_position.go) ---------
    def position(self) -> dict:
        scn = int(self.conn.scalar("SELECT current_scn FROM v$database")
                  or 0)
        self._scn = scn
        return {"scn": scn}

    def begin_snapshot(self) -> None:
        """Pin the flashback SCN all part reads are AS OF."""
        if self._scn is None:
            self.position()

    def end_snapshot(self) -> None:
        self._scn = None

    # -- snapshot load ------------------------------------------------------
    def _as_of(self) -> str:
        if self.params.consistent_snapshot and self._scn:
            return f" AS OF SCN {self._scn}"
        return ""

    def _select(self, table: TableID, schema: TableSchema,
                where: str = "", order: str = "", limit: int = 0) -> str:
        cols = ", ".join(_q(c.name) for c in schema)
        sql = (f"SELECT {cols} FROM "
               f"{_q(table.namespace)}.{_q(table.name)}{self._as_of()}")
        if where:
            sql += f" WHERE {where}"
        if order:
            sql += f" ORDER BY {order}"
        if limit:
            sql += f" FETCH NEXT {limit} ROWS ONLY"
        return sql

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        # dedicated connection per part: parts load from parallel worker
        # threads, and the shared self.conn socket is not thread-safe —
        # catalog queries for this load must ride the same private socket
        conn = _conn(self.params)
        try:
            schema = self._table_schema_on(conn, table.id)
            keys = schema.key_columns()
            if len(keys) == 1:
                self._load_keyset(conn, table, schema, keys[0], pusher)
            else:
                self._load_plain(conn, table, schema, pusher)
        finally:
            conn.close()

    def _load_keyset(self, conn: OracleConnection, table: TableDescription,
                     schema: TableSchema, key: ColSchema,
                     pusher: Pusher) -> None:
        """Keyset pagination over the PK with FETCH NEXT (12c+), stable
        under concurrent writes and index-driven server-side."""
        last = None
        bs = self.params.batch_rows
        while True:
            conds = []
            if table.filter:
                conds.append(f"({table.filter})")
            if last is not None:
                conds.append(f"{_q(key.name)} > {_ora_literal(last)}")
            sql = self._select(table.id, schema,
                               where=" AND ".join(conds),
                               order=_q(key.name), limit=bs)
            _, rows = conn.execute(sql)
            if not rows:
                return
            self._push_rows(rows, schema, table.id, pusher)
            last = rows[-1][schema.names().index(key.name)]
            if len(rows) < bs:
                return

    def _load_plain(self, conn: OracleConnection, table: TableDescription,
                    schema: TableSchema, pusher: Pusher) -> None:
        sql = self._select(table.id, schema, where=table.filter)
        _, rows = conn.execute(sql)
        if rows:
            self._push_rows(rows, schema, table.id, pusher)

    @staticmethod
    def _coerce(cs: ColSchema, v):
        """Wire value -> columnar representation (epoch ints for temporals,
        per the canonical model in abstract/schema.py)."""
        if v is None:
            return None
        t = cs.data_type
        if t == CanonicalType.DATETIME and isinstance(v, dt.datetime):
            return int(v.replace(tzinfo=dt.timezone.utc).timestamp())
        if t == CanonicalType.TIMESTAMP and isinstance(v, dt.datetime):
            return (calendar.timegm(v.timetuple()) * 1_000_000
                    + v.microsecond)
        if t == CanonicalType.DATE and isinstance(v, (dt.date, dt.datetime)):
            d = v.date() if isinstance(v, dt.datetime) else v
            return (d - dt.date(1970, 1, 1)).days
        if t == CanonicalType.DECIMAL and not isinstance(v, str):
            return str(v)
        if t.is_integer and isinstance(v, float) and v.is_integer():
            return int(v)
        return v

    def _push_rows(self, rows, schema: TableSchema, tid: TableID,
                   pusher: Pusher) -> None:
        names = schema.names()
        cols = {c.name: c for c in schema}
        data = {
            n: [self._coerce(cols[n], r[i]) for r in rows]
            for i, n in enumerate(names)
        }
        pusher(ColumnBatch.from_pydict(tid, schema, data))

    # -- intra-table sharding (provider/sharding_storage.go) ----------------
    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        """ORA_HASH(ROWID) modulo split.  The reference walks dba_extents
        into disjoint ROWID ranges (sharding_storage.go:42 splitByROWID) to
        avoid per-row hashing; the hash split needs no DBA views and keeps
        parts balanced, at full-scan cost per part."""
        n = self.params.desired_shards
        if n <= 1 or table.filter:
            return [table]
        eta = table.eta_rows or self.estimate_table_rows_count(table.id)
        return [
            TableDescription(
                id=table.id,
                filter=f"MOD(ORA_HASH(ROWID), {n}) = {i}",
                eta_rows=eta // n,
            )
            for i in range(n)
        ]

    # -- checksum sampling --------------------------------------------------
    RANDOM_SAMPLE_LIMIT = 2000
    TOP_BOTTOM_LIMIT = 1000

    def _sample_parts(self, tid: TableID):
        schema = self.table_schema(tid)
        order = ", ".join(_q(c.name) for c in schema.key_columns())
        return schema, order

    def load_random_sample(self, table: TableDescription,
                           pusher: Pusher) -> None:
        schema, order = self._sample_parts(table.id)
        sql = self._select(
            table.id, schema, where="DBMS_RANDOM.VALUE <= 0.05",
            order=order, limit=self.RANDOM_SAMPLE_LIMIT)
        _, rows = self.conn.execute(sql)
        if rows:
            self._push_rows(rows, schema, table.id, pusher)

    def load_top_bottom_sample(self, table: TableDescription,
                               pusher: Pusher) -> None:
        schema, order = self._sample_parts(table.id)
        if not order:
            raise OracleError(
                f"no primary key on {table.id.fqtn()}; "
                "cannot take top/bottom sample")
        desc = ", ".join(f"{c} DESC" for c in order.split(", "))
        for by in (order, desc):
            sql = self._select(table.id, schema, order=by,
                               limit=self.TOP_BOTTOM_LIMIT)
            _, rows = self.conn.execute(sql)
            if rows:
                self._push_rows(rows, schema, table.id, pusher)

    # per-statement cap on OR-disjuncts: keeps every generated SELECT
    # well under the 64KB TNS packet limit (tns.pack_packet)
    SAMPLE_SET_CHUNK = 200

    def load_sample_by_set(self, table: TableDescription, key_set,
                           pusher: Pusher) -> None:
        schema, _ = self._sample_parts(table.id)
        key_set = list(key_set)
        if not key_set:
            return
        for i in range(0, len(key_set), self.SAMPLE_SET_CHUNK):
            conds = [
                "(" + " AND ".join(
                    f"{_q(name)} = {_ora_literal(val)}"
                    for name, val in key.items()) + ")"
                for key in key_set[i:i + self.SAMPLE_SET_CHUNK]
            ]
            sql = self._select(table.id, schema,
                               where=" OR ".join(conds))
            _, rows = self.conn.execute(sql)
            if rows:
                self._push_rows(rows, schema, table.id, pusher)


@register_provider
class OracleProvider(Provider):
    NAME = "oracle"

    def storage(self):
        if isinstance(self.transfer.src, OracleSourceParams):
            return OracleStorage(self.transfer.src)
        return None

    def source(self):
        """LogMiner CDC (reference replication/log_miner/)."""
        if isinstance(self.transfer.src, OracleSourceParams):
            from transferia_tpu_torch.providers.oracle.logminer import (
                OracleLogMinerSource,
            )

            return OracleLogMinerSource(
                self.transfer.src, self.transfer.id, self.coordinator)
        return None

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        try:
            storage = OracleStorage(self.transfer.src)
            storage.ping()
            result.add("connect")
            result.add(f"table_list ({len(storage.table_list())} tables)")
            storage.close()
        except (OracleError, OSError) as e:
            result.add("connect", e)
        return result
