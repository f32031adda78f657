"""ClickHouse on one shard (the port's copy of the sink and storage of
``transferia_tpu/providers/clickhouse/provider.py``): the target params
with their default Bufferer, the DDL generator, the insert-only sink
with its staged commit (a part stages into its own table and publishes
with one `REPLACE PARTITION`, fenced by `__trtpu_commits`), the
activation cleanup, and the storage over SELECT (`CHStorage`: the
table list, schema, counts, streamed reads and the checksum's samples),
which the checksum task reads a target through, and the native
event-model target (`a2.py`, through `event_target`).

Left out, raising NotImplementedError naming ROADMAP.md A7: more than
one shard (several `shards`, `cluster` discovery).  `shard_by` picks a shard among several; on the one shard
the port writes, the reference routes every row there whatever it
names, so the port accepts it and has nothing to read it for.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import struct

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
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
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import (
    CleanupPolicy,
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.clickhouse.client import (
    CHClient,
    CHError,
)
from transferia_tpu_torch.providers.clickhouse.rowbinary import (
    decode_rowbinary_stream,
    encode_rowbinary,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
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

NOT_PORTED = "not ported yet (ROADMAP.md A7: the ClickHouse provider's " \
             "multi-shard part)"

register_target_rules("ch", {
    CanonicalType.INT8: "Int8", CanonicalType.INT16: "Int16",
    CanonicalType.INT32: "Int32", CanonicalType.INT64: "Int64",
    CanonicalType.UINT8: "UInt8", CanonicalType.UINT16: "UInt16",
    CanonicalType.UINT32: "UInt32", CanonicalType.UINT64: "UInt64",
    CanonicalType.FLOAT: "Float32", CanonicalType.DOUBLE: "Float64",
    CanonicalType.BOOLEAN: "Bool", CanonicalType.STRING: "String",
    CanonicalType.UTF8: "String", CanonicalType.DATE: "Date32",
    CanonicalType.DATETIME: "DateTime",
    CanonicalType.TIMESTAMP: "DateTime64(6)",
    CanonicalType.INTERVAL: "Int64", CanonicalType.DECIMAL: "String",
    CanonicalType.ANY: "String",
})

register_source_rules("ch", {
    "int8": CanonicalType.INT8, "int16": CanonicalType.INT16,
    "int32": CanonicalType.INT32, "int64": CanonicalType.INT64,
    "uint8": CanonicalType.UINT8, "uint16": CanonicalType.UINT16,
    "uint32": CanonicalType.UINT32, "uint64": CanonicalType.UINT64,
    "float32": CanonicalType.FLOAT, "float64": CanonicalType.DOUBLE,
    "bool": CanonicalType.BOOLEAN, "string": CanonicalType.STRING,
    "date": CanonicalType.DATE, "date32": CanonicalType.DATE,
    "datetime": CanonicalType.DATETIME,
    "datetime64": CanonicalType.TIMESTAMP,
    "*": CanonicalType.ANY,
})


@register_endpoint
@dataclass
class CHTargetParams(EndpointParams):
    PROVIDER = "ch"
    IS_TARGET = True

    host: str = "localhost"
    port: int = 8123
    database: str = "default"
    user: str = "default"
    password: str = ""
    secure: bool = False
    shards: dict = field(default_factory=dict)   # name -> [host:port,...]
    cluster: str = ""   # discover shards from system.clusters instead
    shard_by: str = ""   # several shards only; one shard takes every row
    engine: str = ""                             # override table engine
    insert_settings: dict = field(default_factory=dict)
    is_shardeable: bool = True
    bufferer: Optional[dict] = field(
        default_factory=lambda: {"trigger_rows": 100_000,
                                 "trigger_interval": 1.0}
    )

    def bufferer_config(self):
        return self.bufferer

    def host_port(self) -> tuple[str, int]:
        """The one shard's address: the port's sink writes one shard."""
        if self.cluster or len(self.shards) > 1:
            raise NotImplementedError(f"ch target over several shards: "
                                      f"{NOT_PORTED}")
        if not self.shards:
            return self.host, self.port
        (hosts,) = self.shards.values()
        h, _, p = hosts[0].partition(":")
        return h, int(p or 8123)


@register_endpoint
@dataclass
class CHSourceParams(EndpointParams):
    PROVIDER = "ch"
    IS_SOURCE = True

    host: str = "localhost"
    port: int = 8123
    database: str = "default"
    user: str = "default"
    password: str = ""
    secure: bool = False
    batch_rows: int = 131_072


def ddl_for_schema(table: TableID, schema: TableSchema,
                   engine: str = "", extra_cols: Optional[list] = None,
                   partition_by: str = "") -> str:
    """CREATE TABLE DDL from the canonical schema.  `extra_cols` ([(name,
    ch type)]) and `partition_by` serve the staged commit: the final
    table carries the hidden `__trtpu_part` column and partitions by
    it, so a publish is one REPLACE PARTITION."""
    cols = []
    for c in schema:
        ch_type = map_target_type("ch", c.data_type)
        if not c.required and not c.primary_key:
            ch_type = f"Nullable({ch_type})"
        cols.append(f"`{c.name}` {ch_type}")
    for name_, ch_type in extra_cols or []:
        cols.append(f"`{name_}` {ch_type}")
    keys = [f"`{c.name}`" for c in schema.key_columns()]
    order = ", ".join(keys) if keys else "tuple()"
    eng = engine or "MergeTree()"
    part = f" PARTITION BY `{partition_by}`" if partition_by else ""
    return (
        f"CREATE TABLE IF NOT EXISTS `{ch_table_name(table)}` "
        f"({', '.join(cols)}) ENGINE = {eng}{part} ORDER BY ({order})"
    )


def ch_table_name(table: TableID) -> str:
    return table.name if not table.namespace \
        else f"{table.namespace}__{table.name}"


class CHSinker(Sinker, StagedSinker):
    """Insert sink on one shard.  Deletes and updates collapse upstream
    (ReplacingMergeTree semantics); the sink itself inserts and refuses
    a batch that carries kinds.

    Staged commit: a part's batches land in a per-(part, epoch) staging
    table; the publish makes the final table's partition `<slug>` (the
    final table is `PARTITION BY` the hidden `__trtpu_part` column)
    exactly the staged rows with one `ALTER TABLE ... REPLACE PARTITION
    ID`, fenced by the persisted max epoch per part in `__trtpu_commits`.
    A final table an at-least-once run created has no partition key, so
    the first staged publish into it fails at REPLACE PARTITION: recreate
    it (CleanupPolicy.DROP does at activation).  The staged rows' keys
    (the dedup window) are computed on `device`."""

    def __init__(self, params: CHTargetParams, device: DeviceLike = None):
        self.params = params
        self.device = device
        host, port = params.host_port()
        self.client = CHClient(
            host=host, port=port, database=params.database,
            user=params.user, password=params.password,
            secure=params.secure, settings=params.insert_settings,
        )
        self._created: set[str] = set()
        self._stage: Optional[WireStage] = None
        self._fence_ready = False

    def close(self) -> None:
        # keep-alive pools hold sockets until released
        self.client.close()

    def ensure_table(self, table_id: TableID, schema: TableSchema) -> None:
        """Create the target table once."""
        name = ch_table_name(table_id)
        if name in self._created:
            return
        self.client.execute(ddl_for_schema(table_id, schema,
                                           self.params.engine))
        self._created.add(name)

    def push(self, batch: Batch) -> None:
        if not is_columnar(batch):
            rows = [it for it in batch if it.is_row_event()]
            for it in batch:
                if it.kind in (Kind.TRUNCATE, Kind.DROP):
                    self._apply_cleanup(it.table_id, it.kind)
            if not rows:
                return
            batch = ColumnBatch.from_rows(rows)
        if batch.kinds is not None:
            raise ValueError(
                "CH sink is insert-only; collapse updates/deletes upstream "
                "or use a ReplacingMergeTree flow with version columns"
            )
        if self._stage is not None:
            self._stage_push(batch)
            return
        if batch.n_rows == 0:
            return  # no DDL and no INSERT, as the reference's shard loop
        nullable = {
            c.name: (not c.required and not c.primary_key)
            for c in batch.schema
        }
        self.ensure_table(batch.table_id, batch.schema)
        payload = encode_rowbinary(batch, nullable)
        self.client.insert_rowbinary(
            ch_table_name(batch.table_id), list(batch.columns), payload
        )

    def _apply_cleanup(self, table: TableID, kind: Kind) -> None:
        stmt = "TRUNCATE TABLE IF EXISTS" if kind == Kind.TRUNCATE \
            else "DROP TABLE IF EXISTS"
        self.client.execute(f"{stmt} `{ch_table_name(table)}`")

    # -- StagedSinker (publish = atomic partition swap) ---------------------
    def staged_commit_available(self) -> bool:
        # one shard: a sharded target (which host_port refuses) would
        # spread a part's rows with no one atomic flip to publish them
        return len(self.params.shards) <= 1

    def _ensure_fence_table(self) -> None:
        if self._fence_ready:
            return
        self.client.execute(
            f"CREATE TABLE IF NOT EXISTS `{COMMITS_TABLE}` "
            f"(`part_key` String, `epoch` Int64) "
            f"ENGINE = MergeTree() ORDER BY (`part_key`)")
        self._fence_ready = True

    def begin_part(self, key: str, epoch: int) -> None:
        stage = WireStage(key, epoch, device=self.device)
        # begin replaces, for every epoch of this key: a crashed earlier
        # owner's staging table would otherwise stay forever
        pfx = stage_ident_prefix(key)
        for r in self.client.query_json(
                "SELECT name, total_rows FROM system.tables "
                f"WHERE database = '{self.params.database}'"):
            if str(r.get("name", "")).startswith(pfx):
                self.client.execute(f"DROP TABLE IF EXISTS `{r['name']}`")
        self._ensure_fence_table()
        self._stage = stage

    def _stage_push(self, batch: ColumnBatch) -> None:
        stage = self._stage
        staged = stage.state.stage(batch)
        if stage.schema is None:
            stage.tid = batch.table_id
            stage.schema = batch.schema
            # the final table's structure and partition key (REPLACE
            # PARTITION needs both); the part column defaults to this
            # part's slug, so the whole staging table is partition <slug>
            self.client.execute(ddl_for_schema(
                TableID("", stage.table), batch.schema, self.params.engine,
                extra_cols=[(META_COLUMN, f"String DEFAULT '{stage.slug}'")],
                partition_by=META_COLUMN))
        if staged.n_rows == 0:
            return
        nullable = {
            c.name: (not c.required and not c.primary_key)
            for c in staged.schema
        }
        try:
            payload = encode_rowbinary(staged, nullable)
            self.client.insert_rowbinary(
                stage.table, list(staged.columns), payload)
        except BaseException:
            # the staging write died after the dedup window took this
            # batch's keys: only a full part restage is safe
            stage.state.mark_failed()
            raise

    def _fence_epoch(self, slug: str) -> Optional[int]:
        v = self.client.scalar(
            f"SELECT max(`epoch`) FROM `{COMMITS_TABLE}` "
            f"WHERE `part_key` = '{slug}'")
        return int(v) if v is not None else None

    @staticmethod
    def _fence_row(slug: str, epoch: int) -> bytes:
        """One RowBinary row (String part_key, Int64 epoch)."""
        raw = slug.encode()
        out = bytearray()
        n = len(raw)
        while True:
            b7 = n & 0x7F
            n >>= 7
            if n:
                out.append(b7 | 0x80)
            else:
                out.append(b7)
                break
        return bytes(out) + raw + struct.pack("<q", epoch)

    def publish_part(self, key: str, epoch: int) -> int:
        stage = self._stage
        if stage is None or stage.key != key:
            raise RuntimeError(f"ch sink: no open stage for {key!r}")
        with publish_guard(key, epoch):
            prev = self._fence_epoch(stage.slug)
            if prev is not None and epoch < prev:
                raise StaleEpochPublishError(key, epoch, prev)
            trace.instant("ch_publish_partition", part=key, epoch=epoch,
                          rows=stage.state.rows)
            failpoint("sink.ch.publish")
            if stage.schema is not None:
                final = ch_table_name(stage.tid)
                self.client.execute(ddl_for_schema(
                    stage.tid, stage.schema, self.params.engine,
                    extra_cols=[(META_COLUMN, "String")],
                    partition_by=META_COLUMN))
                # the atomic flip: this part's partition of the final
                # table becomes exactly the staged rows
                self.client.execute(
                    f"ALTER TABLE `{final}` REPLACE PARTITION ID "
                    f"'{stage.slug}' FROM `{stage.table}`")
            # the fence after visibility: a crash in between republishes
            # idempotently (REPLACE swaps the same rows in)
            self.client.insert_rowbinary(
                COMMITS_TABLE, ["part_key", "epoch"],
                self._fence_row(stage.slug, epoch))
            self.client.execute(f"DROP TABLE IF EXISTS `{stage.table}`")
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
            self.client.execute(f"DROP TABLE IF EXISTS `{stage.table}`")
        except CHError as e:
            logger.warning("ch staged abort of %s: %s", key, e)

    def note_push_retry(self) -> None:
        if self._stage is not None:
            self._stage.state.note_push_retry()


class CHStorage(Storage, SampleableStorage):
    """Storage over SELECT: the table list, schema, exact counts,
    streamed reads and the checksum's samples."""

    # checksum sampling limits (clickhouse/storage_sampleable.go)
    RANDOM_SAMPLE_LIMIT = 2000
    TOP_BOTTOM_LIMIT = 1000

    def __init__(self, params: CHSourceParams):
        self.params = params
        self.client = CHClient(
            host=params.host, port=params.port, database=params.database,
            user=params.user, password=params.password,
            secure=params.secure)
        self._name_cache: dict[TableID, str] = {}

    def close(self) -> None:
        self.client.close()

    def table_list(self, include=None):
        rows = self.client.query_json(
            f"SELECT name, total_rows FROM system.tables "
            f"WHERE database = '{self.params.database}'")
        out = {}
        for r in rows:
            if is_meta_name(r["name"]):
                continue  # staging/fence tables are not user data
            tid = TableID(self.params.database, r["name"])
            if include and not any(tid.include_matches(p) for p in include):
                continue
            out[tid] = TableInfo(eta_rows=int(r.get("total_rows") or 0))
        return out

    def _resolve_name(self, table: TableID) -> str:
        """A foreign TableID's name in this database: the sink flattens
        "ns"."t" into `ns__t` (`ch_table_name`), so a checksum against a
        ClickHouse target finds rows under that name when the bare name
        is absent."""
        name = table.name
        if not table.namespace or table.namespace == self.params.database:
            return name
        cached = self._name_cache.get(table)
        if cached is not None:
            return cached
        flat = f"{table.namespace}__{table.name}"
        n = self.client.scalar(
            "SELECT count() FROM system.tables "
            f"WHERE database = '{self.params.database}' "
            f"AND name = '{flat}'")
        resolved = flat if int(n or 0) else name
        self._name_cache[table] = resolved
        return resolved

    def table_schema(self, table: TableID) -> TableSchema:
        rows = self.client.query_json(
            f"SELECT name, type, is_in_primary_key FROM system.columns "
            f"WHERE database = '{self.params.database}' "
            f"AND table = '{self._resolve_name(table)}'")
        cols = []
        for r in rows:
            if is_meta_name(r["name"]):
                continue  # the hidden staged-commit part column
            ch_type = r["type"]
            nullable = ch_type.startswith("Nullable(")
            base = ch_type[9:-1] if nullable else ch_type
            cols.append(ColSchema(
                name=r["name"],
                data_type=map_source_type("ch", base.lower()),
                primary_key=bool(int(r.get("is_in_primary_key") or 0)),
                required=not nullable,
                original_type=f"ch:{ch_type}"))
        return TableSchema(cols)

    def exact_table_rows_count(self, table: TableID) -> int:
        return int(self.client.scalar(
            f"SELECT count() FROM `{self._resolve_name(table)}`") or 0)

    def estimate_table_rows_count(self, table: TableID) -> int:
        return self.exact_table_rows_count(table)

    @staticmethod
    def _select_expr(c: ColSchema) -> str:
        """Types the decoder cannot take off the wire (anything mapped to
        ANY or DECIMAL) are cast to String on the server."""
        if c.data_type in (CanonicalType.ANY, CanonicalType.DECIMAL):
            return f"toString(`{c.name}`) AS `{c.name}`"
        return f"`{c.name}`"

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        where = f" WHERE {table.filter}" if table.filter else ""
        self._load_select(table.id, where_order_limit=where, pusher=pusher)

    def _load_select(self, tid: TableID, where_order_limit: str,
                     pusher: Pusher) -> None:
        schema = self.table_schema(tid)
        nullable = {c.name: not c.required for c in schema}
        cols = ", ".join(self._select_expr(c) for c in schema)
        read_fn, close_fn = self.client.execute_stream(
            f"SELECT {cols} FROM `{self._resolve_name(tid)}`"
            f"{where_order_limit} FORMAT RowBinary")
        try:
            for batch in decode_rowbinary_stream(
                    read_fn, schema, nullable,
                    batch_rows=self.params.batch_rows):
                out = ColumnBatch(tid, schema, batch.columns)
                out.read_bytes = out.nbytes()
                pusher(out)
        finally:
            close_fn()

    # -- checksum sampling (clickhouse/storage_sampleable.go) ---------------
    def table_size_in_bytes(self, table: TableID) -> int:
        v = self.client.scalar(
            "SELECT sum(bytes_on_disk) FROM system.parts "
            f"WHERE database = '{self.params.database}' "
            f"AND table = '{self._resolve_name(table)}' AND active")
        try:
            return int(v or 0)
        except (TypeError, ValueError):
            return 0

    def _order_cols(self, tid: TableID) -> list[str]:
        return [c.name for c in self.table_schema(tid).key_columns()]

    def load_random_sample(self, table: TableDescription,
                           pusher: Pusher) -> None:
        order = self._order_cols(table.id)
        by = " ORDER BY " + ", ".join(f"`{c}`" for c in order) if order \
            else ""
        # rand() is uniform over UInt32; 0.05 of the range
        cutoff = int(0.05 * 0xFFFFFFFF)
        self._load_select(
            table.id,
            f" WHERE rand() <= {cutoff}{by} LIMIT {self.RANDOM_SAMPLE_LIMIT}",
            pusher)

    def load_top_bottom_sample(self, table: TableDescription,
                               pusher: Pusher) -> None:
        order = self._order_cols(table.id)
        if not order:
            raise CHError(f"no sorting key on {table.id.name}; "
                          "cannot take top/bottom sample")
        asc = ", ".join(f"`{c}`" for c in order)
        desc = ", ".join(f"`{c}` DESC" for c in order)
        n = self.TOP_BOTTOM_LIMIT
        self._load_select(table.id, f" ORDER BY {asc} LIMIT {n}", pusher)
        self._load_select(table.id, f" ORDER BY {desc} LIMIT {n}", pusher)

    @staticmethod
    def _ch_literal(v) -> str:
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, (int, float)):
            return str(v)
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        s = str(v).replace("\\", "\\\\").replace("'", "\\'")
        return f"'{s}'"

    def load_sample_by_set(self, table: TableDescription, key_set,
                           pusher: Pusher) -> None:
        conds = [
            "(" + " AND ".join(
                f"`{name}` = {self._ch_literal(val)}"
                for name, val in key.items()) + ")"
            for key in key_set
        ]
        where = " OR ".join(conds) if conds else "0"
        self._load_select(table.id, f" WHERE {where}", pusher)

    def ping(self) -> None:
        self.client.ping()


@register_provider
class ClickHouseProvider(Provider):
    NAME = "ch"

    def storage(self):
        if isinstance(self.transfer.src, CHSourceParams):
            return CHStorage(self.transfer.src)
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, CHTargetParams):
            return CHSinker(self.transfer.dst, self.device)
        return None

    def event_target(self):
        """The native event-model target (`a2.py`)."""
        if isinstance(self.transfer.dst, CHTargetParams):
            from transferia_tpu_torch.providers.clickhouse.a2 import (
                CHEventTarget,
            )

            return CHEventTarget(self.transfer.dst, self.device)
        return None

    def destination_storage(self):
        """A storage view of the target (the checksum reads it)."""
        dst = self.transfer.dst
        if isinstance(dst, CHTargetParams):
            return CHStorage(CHSourceParams(
                host=dst.host, port=dst.port, database=dst.database,
                user=dst.user, password=dst.password, secure=dst.secure))
        return None

    def cleanup(self, tables: list) -> None:
        """Activation cleanup of the target tables by the endpoint's
        CleanupPolicy (DROP, else TRUNCATE)."""
        params = self.transfer.dst
        sinker = CHSinker(params, self.device)
        kind = Kind.DROP if params.cleanup_policy == CleanupPolicy.DROP \
            else Kind.TRUNCATE
        try:
            for td in tables or []:
                tid = td.id if hasattr(td, "id") else td
                sinker._apply_cleanup(tid, kind)
        finally:
            sinker.close()
