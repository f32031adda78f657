"""Postgres snapshot source over the wire client (the port's copy of
the storage half of ``transferia_tpu/providers/postgres/provider.py``): the
`pg` type rules, the endpoint params, `PGStorage` (catalog, counts, the
WAL position, ctid-range sharding, COPY loads, the checksum samples and
the incremental cursors) and the provider's `storage`, `source` (logical
replication, `replication.py`), `deactivate` (the slot drop), `test` and
`cleanup`.

Snapshot loads use COPY TO STDOUT (csv) into the port's own decoder
(`copycsv.py`), which gives the batches the reference's pyarrow reader
gives.  Left out, each raising NotImplementedError naming its ROADMAP.md
item: the sink (`PGSinker`, A6), the PG -> PG `pg_dump` step (A6) and the
DBLog snapshot of the replication source (`dblog_snapshot`, A10).
"""

from __future__ import annotations

import io
import logging
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.interfaces import (
    IncrementalStorage,
    PositionalStorage,
    Pusher,
    SampleableStorage,
    ShardingStorage,
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
from transferia_tpu_torch.models.endpoint import (
    CleanupPolicy,
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.postgres.copycsv import decode_copy_csv
from transferia_tpu_torch.providers.postgres.wire import (
    PGConnection,
    PGError,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    TestResult,
    register_provider,
)
from transferia_tpu_torch.providers.staging import is_meta_name
from transferia_tpu_torch.typesystem.rules import (
    map_source_type,
    register_source_rules,
    register_target_rules,
)

logger = logging.getLogger(__name__)

register_source_rules("pg", {
    "smallint": CanonicalType.INT16, "int2": CanonicalType.INT16,
    "integer": CanonicalType.INT32, "int4": CanonicalType.INT32,
    "bigint": CanonicalType.INT64, "int8": CanonicalType.INT64,
    "real": CanonicalType.FLOAT, "float4": CanonicalType.FLOAT,
    "double precision": CanonicalType.DOUBLE, "float8": CanonicalType.DOUBLE,
    "boolean": CanonicalType.BOOLEAN, "bool": CanonicalType.BOOLEAN,
    "text": CanonicalType.UTF8, "varchar": CanonicalType.UTF8,
    "character varying": CanonicalType.UTF8,
    "character": CanonicalType.UTF8, "bpchar": CanonicalType.UTF8,
    "bytea": CanonicalType.STRING,
    "date": CanonicalType.DATE,
    "timestamp without time zone": CanonicalType.TIMESTAMP,
    "timestamp with time zone": CanonicalType.TIMESTAMP,
    "timestamp": CanonicalType.TIMESTAMP,
    "timestamptz": CanonicalType.TIMESTAMP,
    "interval": CanonicalType.INTERVAL,
    "numeric": CanonicalType.DECIMAL, "decimal": CanonicalType.DECIMAL,
    "json": CanonicalType.ANY, "jsonb": CanonicalType.ANY,
    "uuid": CanonicalType.UTF8,
    "*": CanonicalType.ANY,
})

register_target_rules("pg", {
    CanonicalType.INT8: "smallint", CanonicalType.INT16: "smallint",
    CanonicalType.INT32: "integer", CanonicalType.INT64: "bigint",
    CanonicalType.UINT8: "smallint", CanonicalType.UINT16: "integer",
    CanonicalType.UINT32: "bigint", CanonicalType.UINT64: "numeric",
    CanonicalType.FLOAT: "real", CanonicalType.DOUBLE: "double precision",
    CanonicalType.BOOLEAN: "boolean", CanonicalType.STRING: "bytea",
    CanonicalType.UTF8: "text", CanonicalType.DATE: "date",
    CanonicalType.DATETIME: "timestamp",
    CanonicalType.TIMESTAMP: "timestamp",
    CanonicalType.INTERVAL: "interval", CanonicalType.DECIMAL: "numeric",
    CanonicalType.ANY: "jsonb",
})


@register_endpoint
@dataclass
class PGSourceParams(EndpointParams):
    PROVIDER = "pg"
    IS_SOURCE = True

    host: str = "localhost"
    port: int = 5432
    database: str = "postgres"
    user: str = "postgres"
    password: str = ""
    # failover host list (pkg/pgha): tried in order before `host`; the
    # first host that accepts a connection wins
    hosts: list[str] = field(default_factory=list)
    schemas: list[str] = field(default_factory=lambda: ["public"])
    transfer_ddl: bool = False    # move indexes/views/sequences to a PG
    #                               target post-load (pg_dump.go parity)
    batch_rows: int = 131_072
    desired_part_size_bytes: int = 256 << 20  # ctid split target
    slot_name: str = ""                        # replication slot (CDC)
    # DBLog incremental snapshot (provider.go:443 DBLogUpload): chunked
    # watermark-fenced snapshot interleaved with live replication.
    # Tables need a single-column primary key; empty list = all tables.
    dblog_snapshot: bool = False
    dblog_chunk_rows: int = 10_000
    dblog_tables: list[str] = field(default_factory=list)


@register_endpoint
@dataclass
class PGTargetParams(EndpointParams):
    PROVIDER = "pg"
    IS_TARGET = True

    host: str = "localhost"
    port: int = 5432
    database: str = "postgres"
    user: str = "postgres"
    password: str = ""


def _conn(params) -> PGConnection:
    """Connect with pgha-style failover across the configured host list."""
    candidates = []
    for h in getattr(params, "hosts", None) or []:
        if h.startswith("["):  # [v6]:port or [v6]
            v6, _, rest = h[1:].partition("]")
            port = rest.lstrip(":")
            candidates.append((v6, int(port) if port.isdigit()
                               else params.port))
        elif h.count(":") == 1 and h.rpartition(":")[2].isdigit():
            host, _, port = h.rpartition(":")
            candidates.append((host, int(port)))
        else:
            # bare hostname, unbracketed IPv6 literal, or junk port:
            # default port — a malformed entry must never abort failover
            candidates.append((h, params.port))
    candidates.append((params.host, params.port))
    last: Optional[Exception] = None
    for host, port in candidates:
        try:
            return PGConnection(
                host=host, port=port, database=params.database,
                user=params.user, password=params.password,
            ).connect()
        except (OSError, PGError) as e:
            last = e
            logger.warning("pg host %s:%s unavailable: %s", host, port, e)
    raise PGError(f"no postgres host reachable: {last}")


def _pg_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, bytes):
        return f"'\\x{v.hex()}'::bytea"
    s = str(v).replace("'", "''")
    return f"'{s}'"


class PGStorage(Storage, ShardingStorage, PositionalStorage,
                IncrementalStorage, SampleableStorage):
    def __init__(self, params: PGSourceParams):
        self.params = params
        self._c: Optional[PGConnection] = None

    @property
    def conn(self) -> PGConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def ping(self) -> None:
        self.conn.scalar("SELECT 1")

    # -- catalog ------------------------------------------------------------
    def table_list(self, include=None):
        schemas = ", ".join(f"'{s}'" for s in self.params.schemas)
        rows = self.conn.query(
            "SELECT n.nspname AS ns, c.relname AS name, "
            "c.reltuples::bigint AS eta "
            "FROM pg_class c JOIN pg_namespace n ON n.oid = c.relnamespace "
            f"WHERE c.relkind IN ('r', 'p') AND n.nspname IN ({schemas})"
        )
        out = {}
        for r in rows:
            if is_meta_name(r["name"]):
                continue  # staging/fence tables are not user data
            tid = TableID(r["ns"], r["name"])
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(eta_rows=max(0, int(r["eta"] or 0)))
        return out

    def table_schema(self, table: TableID) -> TableSchema:
        rows = self.conn.query(
            "SELECT a.attname AS name, "
            "format_type(a.atttypid, a.atttypmod) AS typ, "
            "a.attnotnull AS notnull, "
            "COALESCE(( SELECT TRUE FROM pg_index i "
            "  WHERE i.indrelid = a.attrelid AND i.indisprimary "
            "  AND a.attnum = ANY(i.indkey)), FALSE) AS is_pk "
            f"FROM pg_attribute a WHERE a.attrelid = "
            f"'{table.fqtn()}'::regclass "
            "AND a.attnum > 0 AND NOT a.attisdropped ORDER BY a.attnum"
        )
        cols = []
        for r in rows:
            if is_meta_name(r["name"]):
                continue  # hidden staged-commit part column
            cols.append(ColSchema(
                name=r["name"],
                data_type=map_source_type("pg", r["typ"].lower()),
                primary_key=r["is_pk"] in ("t", True, "true"),
                required=r["notnull"] in ("t", True, "true"),
                original_type=f"pg:{r['typ']}",
            ))
        return TableSchema(cols)

    def exact_table_rows_count(self, table: TableID) -> int:
        return int(self.conn.scalar(
            f"SELECT count(*) FROM {table.fqtn()}"
        ) or 0)

    def estimate_table_rows_count(self, table: TableID) -> int:
        info = self.table_list([table]).get(table)
        return info.eta_rows if info else 0

    def position(self) -> dict:
        try:
            lsn = self.conn.scalar("SELECT pg_current_wal_lsn()")
            return {"wal_lsn": lsn}
        except PGError:
            return {}

    # -- IncrementalStorage (storage_incremental.go) ------------------------
    @staticmethod
    def _cursor_literal(v) -> str:
        if isinstance(v, (int, float)):
            return str(v)
        s = str(v).replace("'", "''")
        return f"'{s}'"

    def get_increment_state(self, tables, state):
        out = []
        for t in tables:
            cursor = state.get(str(t.table), t.initial_state or None)
            if cursor in (None, ""):
                out.append(TableDescription(id=t.table))
            else:
                out.append(TableDescription(
                    id=t.table,
                    filter=f'"{t.cursor_field}" > '
                           f"{self._cursor_literal(cursor)}",
                ))
        return out

    def next_increment_state(self, tables):
        out = {}
        for t in tables:
            v = self.conn.scalar(
                f'SELECT max("{t.cursor_field}") FROM {t.table.fqtn()}'
            )
            if v is not None:
                out[str(t.table)] = v
        return out

    # -- intra-table sharding (postgres/splitter: ctid block ranges) --------
    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        try:
            size = int(self.conn.scalar(
                f"SELECT pg_relation_size('{table.id.fqtn()}')"
            ) or 0)
            blocks = int(self.conn.scalar(
                f"SELECT relpages FROM pg_class "
                f"WHERE oid = '{table.id.fqtn()}'::regclass"
            ) or 0)
        except PGError:
            return [table]
        target = self.params.desired_part_size_bytes
        if size <= target or blocks <= 1 or table.filter:
            return [table]
        n_parts = min((size + target - 1) // target, 64)
        per = (blocks + n_parts - 1) // n_parts
        eta_per = 0
        out = []
        for i in range(int(n_parts)):
            lo, hi = i * per, min(blocks + 1, (i + 1) * per)
            out.append(TableDescription(
                id=table.id,
                filter=(
                    f"ctid >= '({lo},0)'::tid AND ctid < '({hi},0)'::tid"
                ),
                eta_rows=table.eta_rows // int(n_parts),
            ))
        return out

    # -- snapshot load ------------------------------------------------------
    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        schema = self.table_schema(table.id)
        cols = ", ".join(f'"{c.name}"' for c in schema)
        where = f" WHERE {table.filter}" if table.filter else ""
        self._copy_select(
            f"SELECT {cols} FROM {table.id.fqtn()}{where}",
            table.id, schema, pusher,
        )

    def _copy_select(self, select_sql: str, tid: TableID,
                     schema: TableSchema, pusher: Pusher) -> None:
        sql = (
            f"COPY ({select_sql}) "
            f"TO STDOUT WITH (FORMAT csv, HEADER false)"
        )
        # dedicated connection: parts stream in parallel threads
        conn = _conn(self.params)
        try:
            buf = io.BytesIO()
            nbytes = 0
            for chunk in conn.copy_out(sql):
                buf.write(chunk)
                nbytes += len(chunk)
                if nbytes >= 32 << 20:
                    self._flush_csv(buf, tid, schema, pusher)
                    buf = io.BytesIO()
                    nbytes = 0
            if buf.tell():
                self._flush_csv(buf, tid, schema, pusher)
        finally:
            conn.close()

    # -- checksum sampling (storage.go:984 LoadTopBottomSample etc.) --------
    RANDOM_SAMPLE_LIMIT = 2000   # reference: "random()<=0.05 … limit 2000"
    TOP_BOTTOM_LIMIT = 1000

    def table_size_in_bytes(self, table: TableID) -> int:
        try:
            return int(self.conn.scalar(
                f"SELECT pg_relation_size('{table.fqtn()}')"
            ) or 0)
        except PGError:
            return 0

    def _sample_parts(self, tid: TableID):
        schema = self.table_schema(tid)
        cols = ", ".join(f'"{c.name}"' for c in schema)
        order = ", ".join(f'"{c.name}"' for c in schema.key_columns())
        return schema, cols, order

    def load_random_sample(self, table: TableDescription,
                           pusher: Pusher) -> None:
        schema, cols, order = self._sample_parts(table.id)
        by = f" ORDER BY {order}" if order else ""
        self._copy_select(
            f"SELECT {cols} FROM {table.id.fqtn()} "
            f"WHERE random() <= 0.05{by} LIMIT {self.RANDOM_SAMPLE_LIMIT}",
            table.id, schema, pusher,
        )

    def load_top_bottom_sample(self, table: TableDescription,
                               pusher: Pusher) -> None:
        schema, cols, order = self._sample_parts(table.id)
        if not order:
            raise PGError(f"no primary key on {table.id.fqtn()}; "
                          "cannot take top/bottom sample")
        desc = ", ".join(f"{c} DESC" for c in order.split(", "))
        n = self.TOP_BOTTOM_LIMIT
        self._copy_select(
            f"(SELECT {cols} FROM {table.id.fqtn()} "
            f"ORDER BY {order} LIMIT {n}) UNION ALL "
            f"(SELECT {cols} FROM {table.id.fqtn()} "
            f"ORDER BY {desc} LIMIT {n})",
            table.id, schema, pusher,
        )

    def load_sample_by_set(self, table: TableDescription, key_set,
                           pusher: Pusher) -> None:
        schema, cols, order = self._sample_parts(table.id)
        conds = []
        for key in key_set:
            conds.append("(" + " AND ".join(
                f'"{name}" = {_pg_literal(val)}'
                for name, val in key.items()) + ")")
        where = " OR ".join(conds) if conds else "FALSE"
        self._copy_select(
            f"SELECT {cols} FROM {table.id.fqtn()} WHERE {where}",
            table.id, schema, pusher,
        )

    def _flush_csv(self, buf: io.BytesIO, tid: TableID,
                   schema: TableSchema, pusher: Pusher) -> None:
        """CSV chunk -> ColumnBatches (copycsv.py: the reference's pyarrow
        batches, values and read_bytes).  Chunks split on CopyData
        boundaries, which align to row ends."""
        for batch in decode_copy_csv(buf.getvalue(), tid, schema,
                                     self.params.batch_rows):
            pusher(batch)


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to transferia_tpu_torch yet (ROADMAP.md "
        f"{item})")


@register_provider
class PostgresProvider(Provider):
    NAME = "pg"

    def storage(self):
        if isinstance(self.transfer.src, PGSourceParams):
            return PGStorage(self.transfer.src)
        return None

    def destination_storage(self):
        dst = self.transfer.dst
        if isinstance(dst, PGTargetParams):
            return PGStorage(PGSourceParams(
                host=dst.host, port=dst.port, database=dst.database,
                user=dst.user, password=dst.password,
            ))
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, PGTargetParams):
            raise _waits("the Postgres sink (PGSinker)", "A6")
        return None

    def source(self):
        """Logical-replication CDC over a wal2json slot."""
        if isinstance(self.transfer.src, PGSourceParams):
            from transferia_tpu_torch.providers.postgres.replication import (
                PGReplicationSource,
            )

            return PGReplicationSource(
                self.transfer.src, self.transfer.id,
                coordinator=self.coordinator,
            )
        return None

    def transfer_ddl_objects(self, dst_params) -> int:
        """Post-upload hook of the activation: the source's indexes, views
        and sequences go to a PG target (PG -> PG only)."""
        src = self.transfer.src
        if not isinstance(src, PGSourceParams) or not src.transfer_ddl:
            return 0
        if not isinstance(dst_params, PGTargetParams):
            logger.warning(
                "transfer_ddl is PG->PG only; destination is %s",
                getattr(dst_params, "PROVIDER", "?"))
            return 0
        raise _waits("transfer_ddl PG -> PG (pg_dump)", "A6")

    def deactivate(self) -> None:
        """Drop the replication slot."""
        from transferia_tpu_torch.providers.postgres.replication import (
            ReplicationConnection,
        )

        src = self.transfer.src
        if not isinstance(src, PGSourceParams):
            return
        slot = src.slot_name or \
            f"transferia_{self.transfer.id}".replace("-", "_")
        conn = ReplicationConnection(
            host=src.host, port=src.port, database=src.database,
            user=src.user, password=src.password, replication=True,
        ).connect()
        try:
            conn.drop_slot(slot)
        except PGError as e:
            logger.warning("drop slot %s: %s", slot, e)
        finally:
            conn.close()

    def cleanup(self, tables: list) -> None:
        params = self.transfer.dst
        conn = _conn(params)
        try:
            stmt = "DROP TABLE IF EXISTS" \
                if params.cleanup_policy == CleanupPolicy.DROP \
                else "TRUNCATE TABLE"
            for td in tables or []:
                tid = td.id if hasattr(td, "id") else td
                try:
                    conn.query(f"{stmt} {tid.fqtn()}")
                except PGError as e:
                    if params.cleanup_policy == CleanupPolicy.TRUNCATE \
                            and e.sqlstate == "42P01":
                        continue  # truncate of a missing table is fine
                    raise
        finally:
            conn.close()

    def test(self) -> TestResult:
        result = TestResult(ok=True)
        params = self.transfer.src if isinstance(
            self.transfer.src, PGSourceParams
        ) else self.transfer.dst
        try:
            conn = _conn(params)
            conn.scalar("SELECT 1")
            conn.close()
            result.add("connect")
        except Exception as e:
            result.add("connect", e)
        return result
