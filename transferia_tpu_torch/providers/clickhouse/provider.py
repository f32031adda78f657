"""ClickHouse sink on one shard (the port's copy of the sink half of
``transferia_tpu/providers/clickhouse/provider.py``): the target params
with their default Bufferer, the DDL generator and the insert-only sink.

Left out, each raising NotImplementedError naming ROADMAP.md A5: more
than one shard (several `shards`, `cluster` discovery), the staged
commit's begin/publish (the reference's REPLACE PARTITION publish; the
capability answers as the reference's does, so a snapshot into a
one-shard target asks to stage and is refused loudly), the snapshot
source (`CHStorage`), the `a2` event target and cleanup.  `shard_by`
picks a shard among several; on the one shard the port writes, the
reference routes every row there whatever it names, so the port
accepts it and has nothing to read it for.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    Sinker,
    is_columnar,
)
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.clickhouse.client import CHClient
from transferia_tpu_torch.providers.clickhouse.rowbinary import (
    encode_rowbinary,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.typesystem.rules import (
    map_target_type,
    register_target_rules,
)

logger = logging.getLogger(__name__)

NOT_PORTED = "not ported yet (ROADMAP.md A5: the ClickHouse provider's " \
             "multi-shard, staged-commit, snapshot-source and a2 parts)"

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


def ddl_for_schema(table: TableID, schema: TableSchema,
                   engine: str = "") -> str:
    """CREATE TABLE DDL from the canonical schema (the reference's, less
    the staged commit's hidden part column and partition key)."""
    cols = []
    for c in schema:
        ch_type = map_target_type("ch", c.data_type)
        if not c.required and not c.primary_key:
            ch_type = f"Nullable({ch_type})"
        cols.append(f"`{c.name}` {ch_type}")
    keys = [f"`{c.name}`" for c in schema.key_columns()]
    order = ", ".join(keys) if keys else "tuple()"
    eng = engine or "MergeTree()"
    return (
        f"CREATE TABLE IF NOT EXISTS `{ch_table_name(table)}` "
        f"({', '.join(cols)}) ENGINE = {eng} ORDER BY ({order})"
    )


def ch_table_name(table: TableID) -> str:
    return table.name if not table.namespace \
        else f"{table.namespace}__{table.name}"


class CHSinker(Sinker, StagedSinker):
    """Insert sink on one shard.  Deletes and updates collapse upstream
    (ReplacingMergeTree semantics); the sink itself inserts and refuses
    a batch that carries kinds."""

    def __init__(self, params: CHTargetParams):
        self.params = params
        host, port = params.host_port()
        self.client = CHClient(
            host=host, port=port, database=params.database,
            user=params.user, password=params.password,
            secure=params.secure, settings=params.insert_settings,
        )
        self._created: set[str] = set()

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

    # -- StagedSinker --------------------------------------------------------
    def staged_commit_available(self) -> bool:
        # the reference stages on one-shard targets, which is all the
        # port's sink writes
        return True

    def begin_part(self, key: str, epoch: int) -> None:
        raise NotImplementedError(f"ch staged commit: {NOT_PORTED}")

    def publish_part(self, key: str, epoch: int) -> int:
        raise NotImplementedError(f"ch staged commit: {NOT_PORTED}")

    def abort_part(self, key: str) -> None:
        """Nothing is ever staged (begin_part raises)."""


@register_provider
class ClickHouseProvider(Provider):
    NAME = "ch"

    def sinker(self):
        if isinstance(self.transfer.dst, CHTargetParams):
            return CHSinker(self.transfer.dst)
        return None
