"""ClickHouse provider of the port: the insert sink on one shard, with
the vectorized RowBinary encoder and the HTTP client.  The snapshot
source, several shards and the staged commit wait (ROADMAP.md A5)."""

from transferia_tpu_torch.providers.clickhouse.provider import (
    CHTargetParams,
    ClickHouseProvider,
)

__all__ = ["CHTargetParams", "ClickHouseProvider"]
