"""MySQL storage and sink over the wire client (the port's copy of
``transferia_tpu/providers/mysql/provider.py``): the `mysql` source and
target type rules, the endpoint params, `MySQLStorage` (catalog, counts,
the binlog position, keyset and OFFSET paging, the checksum samples),
`MySQLSinker` (CREATE TABLE through the target type rules, multi-row
INSERT with an upsert when a key exists, REPLACE/UPDATE/DELETE for a
batch with kinds) and the provider's `storage`, `destination_storage`,
`source` (the binlog tail, `binlog.py`), `sinker`, `cleanup` and `test`.

Left out, raising NotImplementedError naming its ROADMAP.md item: the
incremental cursors (`get_increment_state`/`next_increment_state`, A9,
where incremental tables already raise in the snapshot).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    IncrementalStorage,
    PositionalStorage,
    Pusher,
    SampleableStorage,
    Sinker,
    Storage,
    TableInfo,
    is_columnar,
)
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import (
    CleanupPolicy,
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.mysql.wire import (
    MySQLConnection,
    MySQLError,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)
from transferia_tpu_torch.typesystem.rules import (
    map_source_type,
    map_target_type,
    register_source_rules,
    register_target_rules,
)

logger = logging.getLogger(__name__)

register_source_rules("mysql", {
    "tinyint": CanonicalType.INT8, "smallint": CanonicalType.INT16,
    "mediumint": CanonicalType.INT32, "int": CanonicalType.INT32,
    "bigint": CanonicalType.INT64,
    "tinyint unsigned": CanonicalType.UINT8,
    "smallint unsigned": CanonicalType.UINT16,
    "int unsigned": CanonicalType.UINT32,
    "bigint unsigned": CanonicalType.UINT64,
    "float": CanonicalType.FLOAT, "double": CanonicalType.DOUBLE,
    "decimal": CanonicalType.DECIMAL,
    "bit": CanonicalType.UINT64, "bool": CanonicalType.BOOLEAN,
    "char": CanonicalType.UTF8, "varchar": CanonicalType.UTF8,
    "text": CanonicalType.UTF8, "tinytext": CanonicalType.UTF8,
    "mediumtext": CanonicalType.UTF8, "longtext": CanonicalType.UTF8,
    "binary": CanonicalType.STRING, "varbinary": CanonicalType.STRING,
    "blob": CanonicalType.STRING, "tinyblob": CanonicalType.STRING,
    "mediumblob": CanonicalType.STRING, "longblob": CanonicalType.STRING,
    "date": CanonicalType.DATE, "datetime": CanonicalType.TIMESTAMP,
    "timestamp": CanonicalType.TIMESTAMP, "time": CanonicalType.UTF8,
    "year": CanonicalType.INT32, "json": CanonicalType.ANY,
    "enum": CanonicalType.UTF8, "set": CanonicalType.UTF8,
    "*": CanonicalType.ANY,
})

register_target_rules("mysql", {
    CanonicalType.INT8: "tinyint", CanonicalType.INT16: "smallint",
    CanonicalType.INT32: "int", CanonicalType.INT64: "bigint",
    CanonicalType.UINT8: "tinyint unsigned",
    CanonicalType.UINT16: "smallint unsigned",
    CanonicalType.UINT32: "int unsigned",
    CanonicalType.UINT64: "bigint unsigned",
    CanonicalType.FLOAT: "float", CanonicalType.DOUBLE: "double",
    CanonicalType.BOOLEAN: "tinyint(1)", CanonicalType.STRING: "longblob",
    CanonicalType.UTF8: "longtext", CanonicalType.DATE: "date",
    CanonicalType.DATETIME: "datetime", CanonicalType.TIMESTAMP: "datetime(6)",
    CanonicalType.INTERVAL: "bigint", CanonicalType.DECIMAL: "decimal(65,30)",
    CanonicalType.ANY: "json",
})


@register_endpoint
@dataclass
class MySQLSourceParams(EndpointParams):
    PROVIDER = "mysql"
    IS_SOURCE = True

    host: str = "localhost"
    port: int = 3306
    database: str = ""
    user: str = "root"
    password: str = ""
    batch_rows: int = 65_536


@register_endpoint
@dataclass
class MySQLTargetParams(EndpointParams):
    PROVIDER = "mysql"
    IS_TARGET = True

    host: str = "localhost"
    port: int = 3306
    database: str = ""
    user: str = "root"
    password: str = ""


def _conn(params) -> MySQLConnection:
    return MySQLConnection(
        host=params.host, port=params.port, database=params.database,
        user=params.user, password=params.password,
    ).connect()


def _sql_literal(v) -> str:
    """Escaped SQL literal (shared by cursor filters and the sink)."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, bytes):
        return "x'" + v.hex() + "'"
    s = str(v).replace("\\", "\\\\").replace("'", "''")
    return f"'{s}'"


def _coerce(cs: ColSchema, v: Optional[str]):
    if v is None:
        return None
    t = cs.data_type
    if t.is_integer:
        try:
            return int(v)
        except ValueError:
            return v
    if t.is_float:
        try:
            return float(v)
        except ValueError:
            return v
    if t == CanonicalType.BOOLEAN:
        return v not in ("0", "", "false")
    if t == CanonicalType.STRING:
        return v.encode("utf-8", "surrogateescape")
    return v


class MySQLStorage(Storage, PositionalStorage, IncrementalStorage,
                   SampleableStorage):
    def __init__(self, params: MySQLSourceParams):
        self.params = params
        self._c: Optional[MySQLConnection] = None

    @property
    def conn(self) -> MySQLConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def ping(self) -> None:
        self.conn.ping()

    def table_list(self, include=None):
        rows = self.conn.query(
            "SELECT TABLE_NAME AS name, TABLE_ROWS AS eta "
            "FROM information_schema.TABLES "
            f"WHERE TABLE_SCHEMA = '{self.params.database}' "
            "AND TABLE_TYPE = 'BASE TABLE'"
        )
        out = {}
        for r in rows:
            tid = TableID(self.params.database, r["name"])
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(eta_rows=int(r["eta"] or 0))
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        rows = self.conn.query(
            "SELECT COLUMN_NAME AS name, DATA_TYPE AS typ, "
            "COLUMN_TYPE AS full_typ, IS_NULLABLE AS nullable, "
            "COLUMN_KEY AS ckey "
            "FROM information_schema.COLUMNS "
            f"WHERE TABLE_SCHEMA = '{table.namespace}' "
            f"AND TABLE_NAME = '{table.name}' ORDER BY ORDINAL_POSITION"
        )
        cols = []
        for r in rows:
            typ = r["typ"].lower()
            if "unsigned" in (r["full_typ"] or "").lower():
                typ = f"{typ} unsigned"
            cols.append(ColSchema(
                name=r["name"],
                data_type=map_source_type("mysql", typ),
                primary_key=r["ckey"] == "PRI",
                required=r["nullable"] == "NO",
                original_type=f"mysql:{r['full_typ']}",
            ))
        return TableSchema(cols)

    def exact_table_rows_count(self, table: TableID) -> int:
        return int(self.conn.scalar(
            f"SELECT COUNT(*) FROM `{table.namespace}`.`{table.name}`"
        ) or 0)

    def position(self) -> dict:
        """Binlog/gtid position (MysqlGtidState parity).

        MySQL 8.4 removed SHOW MASTER STATUS in favor of SHOW BINARY LOG
        STATUS; try both, and never silently checkpoint an empty position.
        """
        last_err = None
        for stmt in ("SHOW MASTER STATUS", "SHOW BINARY LOG STATUS"):
            try:
                rows = self.conn.query(stmt)
            except MySQLError as e:
                last_err = e
                continue
            if rows:
                r = rows[0]
                return {
                    "binlog_file": r.get("File"),
                    "binlog_pos": r.get("Position"),
                    "gtid_set": r.get("Executed_Gtid_Set", ""),
                }
        logger.warning(
            "could not read binlog position (binary logging off, "
            "insufficient privileges, or unsupported server): %s", last_err,
        )
        return {}

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        schema = self.table_schema(table.id)
        cols = ", ".join(f"`{c.name}`" for c in schema)
        conn = _conn(self.params)
        keys = schema.key_columns()
        ref = f"`{table.id.namespace}`.`{table.id.name}`"
        bs = self.params.batch_rows
        try:
            if len(keys) == 1:
                # keyset pagination: stable under concurrent writes and
                # O(N) server-side, unlike OFFSET scans
                key = keys[0].name
                last = None
                while True:
                    conds = []
                    if table.filter:
                        conds.append(f"({table.filter})")
                    if last is not None:
                        conds.append(f"`{key}` > {_sql_literal(last)}")
                    where = f" WHERE {' AND '.join(conds)}" if conds else ""
                    rows = conn.query(
                        f"SELECT {cols} FROM {ref}{where} "
                        f"ORDER BY `{key}` LIMIT {bs}"
                    )
                    if not rows:
                        return
                    self._push_rows(rows, schema, table.id, pusher)
                    last_raw = rows[-1].get(key)
                    last = _coerce(schema.find(key), last_raw)
                    if len(rows) < bs:
                        return
            else:
                # multi/no-PK fallback: OFFSET paging over a fixed ORDER BY
                # (full pk list) so the scan order is at least deterministic
                order = ", ".join(f"`{k.name}`" for k in keys) if keys \
                    else ""
                order_sql = f" ORDER BY {order}" if order else ""
                where = f" WHERE {table.filter}" if table.filter else ""
                offset = 0
                while True:
                    rows = conn.query(
                        f"SELECT {cols} FROM {ref}{where}{order_sql} "
                        f"LIMIT {bs} OFFSET {offset}"
                    )
                    if not rows:
                        return
                    self._push_rows(rows, schema, table.id, pusher)
                    if len(rows) < bs:
                        return
                    offset += bs
        finally:
            conn.close()

    @staticmethod
    def _push_rows(rows, schema, tid, pusher: Pusher) -> None:
        data = {
            c.name: [_coerce(c, r.get(c.name)) for r in rows]
            for c in schema
        }
        pusher(ColumnBatch.from_pydict(tid, schema, data))

    # -- checksum sampling --------------------------------------------------
    RANDOM_SAMPLE_LIMIT = 2000
    TOP_BOTTOM_LIMIT = 1000

    def table_size_in_bytes(self, table: TableID) -> int:
        v = self.conn.scalar(
            "SELECT DATA_LENGTH + INDEX_LENGTH "
            "FROM information_schema.TABLES "
            f"WHERE TABLE_SCHEMA = '{table.namespace}' "
            f"AND TABLE_NAME = '{table.name}'"
        )
        return int(v or 0)

    def _sample_query(self, tid: TableID, schema: TableSchema, sql: str,
                      pusher: Pusher) -> None:
        rows = self.conn.query(sql)
        if rows:
            self._push_rows(rows, schema, tid, pusher)

    def _sample_parts(self, tid: TableID):
        schema = self.table_schema(tid)
        cols = ", ".join(f"`{c.name}`" for c in schema)
        order = ", ".join(f"`{c.name}`" for c in schema.key_columns())
        ref = f"`{tid.namespace}`.`{tid.name}`"
        return schema, cols, order, ref

    def load_random_sample(self, table: TableDescription,
                           pusher: Pusher) -> None:
        schema, cols, order, ref = self._sample_parts(table.id)
        by = f" ORDER BY {order}" if order else ""
        self._sample_query(
            table.id, schema,
            f"SELECT {cols} FROM {ref} WHERE RAND() <= 0.05{by} "
            f"LIMIT {self.RANDOM_SAMPLE_LIMIT}",
            pusher,
        )

    def load_top_bottom_sample(self, table: TableDescription,
                               pusher: Pusher) -> None:
        schema, cols, order, ref = self._sample_parts(table.id)
        if not order:
            raise MySQLError(f"no primary key on {ref}; "
                             "cannot take top/bottom sample")
        desc = ", ".join(f"{c} DESC" for c in order.split(", "))
        n = self.TOP_BOTTOM_LIMIT
        self._sample_query(
            table.id, schema,
            f"(SELECT {cols} FROM {ref} ORDER BY {order} LIMIT {n}) "
            f"UNION ALL "
            f"(SELECT {cols} FROM {ref} ORDER BY {desc} LIMIT {n})",
            pusher,
        )

    def load_sample_by_set(self, table: TableDescription, key_set,
                           pusher: Pusher) -> None:
        schema, cols, _, ref = self._sample_parts(table.id)
        conds = [
            "(" + " AND ".join(
                f"`{name}` = {_sql_literal(val)}"
                for name, val in key.items()) + ")"
            for key in key_set
        ]
        where = " OR ".join(conds) if conds else "FALSE"
        self._sample_query(
            table.id, schema,
            f"SELECT {cols} FROM {ref} WHERE {where}", pusher)

    # -- IncrementalStorage -------------------------------------------------
    def get_increment_state(self, tables, state):
        raise _waits("MySQL incremental cursors", "A9")

    def next_increment_state(self, tables):
        raise _waits("MySQL incremental cursors", "A9")


class MySQLSinker(Sinker):
    def __init__(self, params: MySQLTargetParams):
        self.params = params
        self._c: Optional[MySQLConnection] = None
        self._created: set[TableID] = set()

    @property
    def conn(self) -> MySQLConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    _literal = staticmethod(_sql_literal)

    def _table_ref(self, tid: TableID) -> str:
        ns = tid.namespace or self.params.database
        return f"`{ns}`.`{tid.name}`"

    def _ensure_table(self, tid: TableID, schema: TableSchema) -> None:
        if tid in self._created:
            return
        cols = []
        for c in schema:
            typ = map_target_type("mysql", c.data_type)
            # TEXT/BLOB key columns need a length-limited index type
            if c.primary_key and typ in ("longtext", "longblob"):
                typ = "varchar(255)" if typ == "longtext" \
                    else "varbinary(255)"
            nn = " NOT NULL" if (c.required or c.primary_key) else ""
            cols.append(f"`{c.name}` {typ}{nn}")
        keys = ", ".join(f"`{c.name}`" for c in schema.key_columns())
        pk = f", PRIMARY KEY ({keys})" if keys else ""
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._table_ref(tid)} "
            f"({', '.join(cols)}{pk})"
        )
        self._created.add(tid)

    def push(self, batch: Batch) -> None:
        if not is_columnar(batch):
            rows = [it for it in batch if it.is_row_event()]
            if not rows:
                return
            batch = ColumnBatch.from_rows(rows)
        self._ensure_table(batch.table_id, batch.schema)
        if batch.kinds is None:
            self._insert(batch, upsert=batch.schema.has_primary_key())
        else:
            for it in batch.to_rows():
                self._apply_row(it)

    def _insert(self, batch: ColumnBatch, upsert: bool) -> None:
        names = list(batch.columns)
        cols = ", ".join(f"`{n}`" for n in names)
        data = batch.to_pydict()
        # multi-row VALUES in chunks to bound statement size
        chunk = 500
        for start in range(0, batch.n_rows, chunk):
            rows_sql = []
            for i in range(start, min(batch.n_rows, start + chunk)):
                rows_sql.append(
                    "(" + ", ".join(
                        self._literal(data[n][i]) for n in names
                    ) + ")"
                )
            sql = f"INSERT INTO {self._table_ref(batch.table_id)} " \
                  f"({cols}) VALUES {', '.join(rows_sql)}"
            if upsert:
                keys = {c.name for c in batch.schema.key_columns()}
                sets = ", ".join(
                    f"`{n}` = VALUES(`{n}`)" for n in names
                    if n not in keys
                )
                if sets:
                    sql += f" ON DUPLICATE KEY UPDATE {sets}"
            self.conn.query(sql)

    def _apply_row(self, it) -> None:
        ref = self._table_ref(it.table_id)
        if it.kind == Kind.INSERT:
            cols = ", ".join(f"`{n}`" for n in it.column_names)
            vals = ", ".join(self._literal(v) for v in it.column_values)
            self.conn.query(
                f"REPLACE INTO {ref} ({cols}) VALUES ({vals})"
            )
        elif it.kind == Kind.UPDATE:
            sets = ", ".join(
                f"`{n}` = {self._literal(v)}"
                for n, v in zip(it.column_names, it.column_values)
            )
            self.conn.query(
                f"UPDATE {ref} SET {sets} WHERE {self._key_where(it)}"
            )
        elif it.kind == Kind.DELETE:
            self.conn.query(
                f"DELETE FROM {ref} WHERE {self._key_where(it)}"
            )

    def _key_where(self, it) -> str:
        names = [c.name for c in it.table_schema.key_columns()]
        return " AND ".join(
            f"`{n}` = {self._literal(v)}"
            for n, v in zip(names, it.effective_key())
        )


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to transferia_tpu_torch yet (ROADMAP.md "
        f"{item})")


@register_provider
class MySQLProvider(Provider):
    NAME = "mysql"

    def storage(self):
        if isinstance(self.transfer.src, MySQLSourceParams):
            return MySQLStorage(self.transfer.src)
        return None

    def destination_storage(self):
        dst = self.transfer.dst
        if isinstance(dst, MySQLTargetParams):
            return MySQLStorage(MySQLSourceParams(
                host=dst.host, port=dst.port, database=dst.database,
                user=dst.user, password=dst.password,
            ))
        return None

    def source(self):
        """Binlog ROW replication."""
        if isinstance(self.transfer.src, MySQLSourceParams):
            from transferia_tpu_torch.providers.mysql.binlog import (
                MySQLBinlogSource,
            )

            return MySQLBinlogSource(
                self.transfer.src, self.transfer.id, self.coordinator
            )
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, MySQLTargetParams):
            return MySQLSinker(self.transfer.dst)
        return None

    def cleanup(self, tables: list) -> None:
        params = self.transfer.dst
        conn = _conn(params)
        try:
            stmt = "DROP TABLE IF EXISTS" \
                if params.cleanup_policy == CleanupPolicy.DROP \
                else "TRUNCATE TABLE"
            for td in tables or []:
                tid = td.id if hasattr(td, "id") else td
                ns = tid.namespace or params.database
                try:
                    conn.query(f"{stmt} `{ns}`.`{tid.name}`")
                except MySQLError as e:
                    if e.errno == 1146:  # table doesn't exist
                        continue
                    raise
        finally:
            conn.close()

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        params = self.transfer.src if isinstance(
            self.transfer.src, MySQLSourceParams) else self.transfer.dst
        try:
            conn = _conn(params)
            conn.ping()
            conn.close()
            result.add("connect")
        except Exception as e:
            result.add("connect", e)
        return result
