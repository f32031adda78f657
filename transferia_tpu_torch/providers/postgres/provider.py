"""Postgres storage and sink over the wire client (the port's copy of
``transferia_tpu/providers/postgres/provider.py``): the `pg` type rules,
the endpoint params, `PGStorage` (catalog, counts, the WAL position,
ctid-range sharding, COPY loads, the checksum samples and the
incremental cursors), `PGSinker` (table DDL, COPY inserts, the staged
commit, the CDC statements) and the provider's `storage`, `sinker`,
`source` (logical replication, `replication.py`, with the DBLog
incremental snapshot, `dblog.py`), `transfer_ddl_objects` (the PG -> PG
`pg_dump.py` step), `deactivate` (the slot drop), `test` and `cleanup`.

Snapshot loads use COPY TO STDOUT (csv) into the port's own decoder
(`copycsv.py`), which gives the batches the reference's pyarrow reader
gives.
"""

from __future__ import annotations

import io
import logging
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    IncrementalStorage,
    PositionalStorage,
    Pusher,
    SampleableStorage,
    ShardingStorage,
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
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import ColumnBatch
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
from transferia_tpu_torch.providers.staging import (
    COMMITS_TABLE,
    META_COLUMN,
    WireStage,
    is_meta_name,
    publish_guard,
    stage_ident_prefix,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.typesystem.rules import (
    map_source_type,
    map_target_type,
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


class PGSinker(Sinker, StagedSinker):
    """COPY-based insert sink with DDL creation; updates/deletes via
    simple-query statements (CDC slow path).

    Staged-commit capable (abstract/commit.py): with an open part, stage
    batches COPY into a per-(part, epoch) staging table
    (`public.__trtpu_stg_<hash>`), and publish is postgres's own atomic
    primitive — ONE transaction doing DELETE-part-rows + `INSERT ...
    SELECT` from staging + an append-only epoch row into the
    `__trtpu_commits` fence table (PK (part_key, epoch): the fence
    value is max(epoch), monotone by construction — a zombie's row can
    never regress it), so the target flips from "nothing of this part"
    to "exactly this part" with no torn middle state.  The final table
    carries a hidden `__trtpu_part` column (filtered out of every
    PGStorage read) so a republish can address its own rows.  The
    staged rows' keys (the dedup window) are computed on `device`.

    Fence bound: the epoch check reads before the publish transaction,
    so two publishers racing the SAME instant can interleave their
    data flips (last txn wins) — the coordinator's fenced commit_part
    is the primary gate that keeps two live owners from publishing one
    part concurrently; this sink fence is the zombie-PROCESS backstop
    (a stale publisher arriving after the survivor always raises)."""

    def __init__(self, params: PGTargetParams, device: DeviceLike = None):
        self.params = params
        self.device = device
        self._c: Optional[PGConnection] = None
        self._created: set[TableID] = set()
        self._stage: Optional[WireStage] = None
        self._fence_ready = False

    @property
    def conn(self) -> PGConnection:
        if self._c is None:
            self._c = _conn(self.params)
        return self._c

    def close(self) -> None:
        if self._c is not None:
            self._c.close()
            self._c = None

    def _ensure_table(self, tid: TableID, schema: TableSchema,
                      with_part_column: bool = False) -> None:
        if tid in self._created:
            return
        cols = []
        for c in schema:
            pg_type = map_target_type("pg", c.data_type)
            nn = " NOT NULL" if (c.required or c.primary_key) else ""
            cols.append(f'"{c.name}" {pg_type}{nn}')
        if with_part_column:
            cols.append(f'"{META_COLUMN}" text')
        keys = ", ".join(f'"{c.name}"' for c in schema.key_columns())
        pk = f", PRIMARY KEY ({keys})" if keys else ""
        if tid.namespace:
            self.conn.query(
                f'CREATE SCHEMA IF NOT EXISTS "{tid.namespace}"'
            )
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {tid.fqtn()} "
            f"({', '.join(cols)}{pk})"
        )
        self._created.add(tid)

    @staticmethod
    def _csv_cell(v) -> str:
        if v is None:
            return ""
        if isinstance(v, bytes):
            return "\\x" + v.hex()
        if isinstance(v, bool):
            return "t" if v else "f"
        s = str(v)
        if any(ch in s for ch in ',"\n\r'):
            s = '"' + s.replace('"', '""') + '"'
        return s

    def push(self, batch: Batch) -> None:
        if not is_columnar(batch):
            rows = [it for it in batch if it.is_row_event()]
            if not rows:
                return
            batch = ColumnBatch.from_rows(rows)
        if self._stage is not None:
            self._stage_push(batch)
            return
        self._ensure_table(batch.table_id, batch.schema)
        if batch.kinds is None:
            self._copy_insert(batch)
        else:
            for it in batch.to_rows():
                self._apply_row(it)

    def _copy_insert(self, batch: ColumnBatch,
                     target: Optional[str] = None) -> None:
        cols = ", ".join(f'"{n}"' for n in batch.columns)
        data = batch.to_pydict()
        names = list(batch.columns)
        lines = []
        for i in range(batch.n_rows):
            lines.append(",".join(
                self._csv_cell(data[n][i]) for n in names
            ))
        payload = ("\n".join(lines) + "\n").encode()
        self.conn.copy_in(
            f"COPY {target or batch.table_id.fqtn()} ({cols}) "
            f"FROM STDIN WITH (FORMAT csv)",
            [payload],
        )

    # -- StagedSinker (exactly-once publish via one SQL transaction) --------
    @staticmethod
    def _stage_fqtn(stage: WireStage) -> str:
        return f'"public"."{stage.table}"'

    @staticmethod
    def _commits_fqtn() -> str:
        return f'"public"."{COMMITS_TABLE}"'

    def _ensure_fence_table(self) -> None:
        if self._fence_ready:
            return
        # APPEND-ONLY fence: one row per accepted (part, epoch), fence
        # value = max(epoch) per part.  A zombie's publish can add its
        # own (older) row but can never REGRESS the fence the way a
        # keyed-by-part upsert could — monotone by construction
        self.conn.query(
            f"CREATE TABLE IF NOT EXISTS {self._commits_fqtn()} "
            f"(\"part_key\" text, \"epoch\" bigint, "
            f"PRIMARY KEY (\"part_key\", \"epoch\"))"
        )
        self._fence_ready = True

    def begin_part(self, key: str, epoch: int) -> None:
        stage = WireStage(key, epoch, device=self.device)
        # begin replaces — for EVERY epoch of this key: a crashed
        # earlier owner's staging table (different epoch, so a
        # different name) would otherwise leak in the target forever
        pfx = stage_ident_prefix(key)
        rows = self.conn.query(
            "SELECT n.nspname AS ns, c.relname AS name, "
            "c.reltuples::bigint AS eta "
            "FROM pg_class c JOIN pg_namespace n ON n.oid = "
            "c.relnamespace "
            "WHERE c.relkind IN ('r', 'p') AND n.nspname IN ('public')")
        for r in rows:
            if r["name"].startswith(pfx):
                self.conn.query(
                    f"DROP TABLE IF EXISTS \"public\".\"{r['name']}\"")
        self._ensure_fence_table()
        self._stage = stage

    def _stage_push(self, batch: ColumnBatch) -> None:
        stage = self._stage
        staged = stage.state.stage(batch)
        if stage.schema is None:
            stage.tid = batch.table_id
            stage.schema = batch.schema
            cols = ", ".join(
                f'"{c.name}" {map_target_type("pg", c.data_type)}'
                for c in batch.schema)
            self.conn.query(
                f"CREATE TABLE IF NOT EXISTS "
                f"{self._stage_fqtn(stage)} ({cols})")
        if staged.n_rows == 0:
            return
        try:
            self._copy_insert(staged, target=self._stage_fqtn(stage))
        except BaseException:
            # the staging write died after the dedup window recorded
            # this batch: only a full part restage is safe
            stage.state.mark_failed()
            raise

    def _fence_epoch(self, slug: str):
        rows = self.conn.query(
            f"SELECT \"epoch\" FROM {self._commits_fqtn()} "
            f"WHERE (\"part_key\" = '{slug}')")
        epochs = [int(r["epoch"]) for r in rows
                  if r.get("epoch") is not None]
        return max(epochs) if epochs else None

    def publish_part(self, key: str, epoch: int) -> int:
        stage = self._stage
        if stage is None or stage.key != key:
            raise RuntimeError(f"pg sink: no open stage for {key!r}")
        with publish_guard(key, epoch):
            prev = self._fence_epoch(stage.slug)
            if prev is not None and epoch < prev:
                raise StaleEpochPublishError(key, epoch, prev)
            trace.instant("pg_publish_txn", part=key, epoch=epoch,
                          rows=stage.state.rows)
            failpoint("sink.pg.publish")
            stmts = ["BEGIN"]
            if stage.schema is not None:
                self._ensure_table(stage.tid, stage.schema,
                                   with_part_column=True)
                # a final table created by the at-least-once path (or
                # a pre-staged-commit run) lacks the part column; the
                # retrofit is idempotent and outside the publish txn
                self.conn.query(
                    f"ALTER TABLE {stage.tid.fqtn()} ADD COLUMN IF "
                    f"NOT EXISTS \"{META_COLUMN}\" text")
                cols = ", ".join(f'"{c.name}"' for c in stage.schema)
                stmts.append(
                    f"DELETE FROM {stage.tid.fqtn()} "
                    f"WHERE \"{META_COLUMN}\" = '{stage.slug}'")
                stmts.append(
                    f"INSERT INTO {stage.tid.fqtn()} "
                    f"({cols}, \"{META_COLUMN}\") "
                    f"SELECT {cols}, '{stage.slug}' "
                    f"FROM {self._stage_fqtn(stage)}")
            stmts.append(
                f"INSERT INTO {self._commits_fqtn()} "
                f"(\"part_key\", \"epoch\") "
                f"VALUES ('{stage.slug}', {epoch}) "
                f"ON CONFLICT (\"part_key\", \"epoch\") DO NOTHING")
            stmts.append("COMMIT")
            # one Q message = one implicit transaction block: postgres
            # applies all statements atomically or rolls back together
            self.conn.query("; ".join(stmts))
            self.conn.query(
                f"DROP TABLE IF EXISTS {self._stage_fqtn(stage)}")
            self.last_dedup_dropped = stage.state.dedup_dropped
            rows = stage.state.rows
        self._stage = None
        return rows

    def abort_part(self, key: str) -> None:
        stage = self._stage
        if stage is None or stage.key != key:
            return
        self._stage = None
        try:
            self.conn.query(
                f"DROP TABLE IF EXISTS {self._stage_fqtn(stage)}")
        except PGError as e:
            logger.warning("pg staged abort of %s: %s", key, e)

    def note_push_retry(self) -> None:
        if self._stage is not None:
            self._stage.state.note_push_retry()

    # -- CDC slow path: a statement a row ------------------------------------
    def _apply_row(self, it) -> None:
        tid = it.table_id
        if it.kind == Kind.INSERT:
            cols = ", ".join(f'"{n}"' for n in it.column_names)
            vals = ", ".join(_pg_literal(v) for v in it.column_values)
            keys = [c.name for c in it.table_schema.key_columns()] \
                if it.table_schema else []
            conflict = ""
            if keys:
                sets = ", ".join(
                    f'"{n}" = EXCLUDED."{n}"' for n in it.column_names
                    if n not in keys
                )
                kcols = ", ".join(f'"{k}"' for k in keys)
                conflict = f" ON CONFLICT ({kcols}) DO UPDATE SET {sets}" \
                    if sets else f" ON CONFLICT ({kcols}) DO NOTHING"
            self.conn.query(
                f"INSERT INTO {tid.fqtn()} ({cols}) VALUES ({vals})"
                f"{conflict}"
            )
        elif it.kind == Kind.UPDATE:
            sets = ", ".join(
                f'"{n}" = {_pg_literal(v)}'
                for n, v in zip(it.column_names, it.column_values)
            )
            where = self._key_where(it)
            self.conn.query(f"UPDATE {tid.fqtn()} SET {sets} WHERE {where}")
        elif it.kind == Kind.DELETE:
            self.conn.query(
                f"DELETE FROM {tid.fqtn()} WHERE {self._key_where(it)}"
            )

    @staticmethod
    def _key_where(it) -> str:
        key = it.effective_key()
        names = [c.name for c in it.table_schema.key_columns()]
        return " AND ".join(
            f'"{n}" = {_pg_literal(v)}' for n, v in zip(names, key)
        )


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
            return PGSinker(self.transfer.dst, self.device)
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
        from transferia_tpu_torch.providers.postgres.pg_dump import (
            apply_ddl_objects,
            dump_ddl_objects,
        )

        src_conn = _conn(src)
        try:
            statements = dump_ddl_objects(src_conn, src.schemas)
        finally:
            src_conn.close()
        if not statements:
            return 0
        dst_conn = _conn(dst_params)
        try:
            applied = apply_ddl_objects(dst_conn, statements)
        finally:
            dst_conn.close()
        logger.info("transferred %d/%d ddl objects to the target",
                    applied, len(statements))
        return applied

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
