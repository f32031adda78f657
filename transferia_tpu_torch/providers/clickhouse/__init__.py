"""ClickHouse provider of the port: the insert sink on one shard with its
staged commit, the storage over SELECT the checksum reads a target
through, the vectorized RowBinary encoder and the HTTP client.  Several
shards wait (ROADMAP.md A7)."""

from transferia_tpu_torch.providers.clickhouse.provider import (
    CHSourceParams,
    CHStorage,
    CHTargetParams,
    ClickHouseProvider,
)

__all__ = ["CHSourceParams", "CHStorage", "CHTargetParams",
           "ClickHouseProvider"]
