"""ClickHouse provider of the port: the insert sink on one shard with its
staged commit, the vectorized RowBinary encoder and the HTTP client.
The snapshot source and several shards wait (ROADMAP.md A10)."""

from transferia_tpu_torch.providers.clickhouse.provider import (
    CHTargetParams,
    ClickHouseProvider,
)

__all__ = ["CHTargetParams", "ClickHouseProvider"]
