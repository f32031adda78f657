"""Provider plugin registry of the port.

Providers register under a name and expose optional capability
constructors (snapshot storage, sinker, ...); factories resolve them at
transfer build time.  The port ships the `sample` source (snapshot and
replication), the `memory` source and sink, the `kafka` replication
source and sink, the in-memory broker `mq` (source and staged sink),
the `ch` (ClickHouse) sink on one shard and its storage and native
event target, the `fs` Parquet source, the `pg`
(Postgres, its DBLog incremental snapshot included) and `mysql`
sources (snapshot and CDC) and sinks, the `mongo` source (snapshot and
change streams) and sink, the `oracle` source (SCN-pinned snapshot and
LogMiner CDC), the `yt` static-table source and sink and the `yt_dyn`
dynamic-table sink, the `airbyte` source (connectors through the
container runner), the `s3`
object-storage source (snapshot and replication) and sink, the `delta`
(Delta Lake) event-model source, the `coralogix` and `datadog` log
sinks, and the `stdout` and `devnull` sinks; the other providers wait
(ROADMAP.md A7).
"""

from transferia_tpu_torch.providers.registry import (
    Provider,
    get_provider,
    register_provider,
)

__all__ = ["Provider", "get_provider", "register_provider"]


def load_builtin_providers() -> None:
    """Import the built-in providers (idempotent)."""
    from transferia_tpu_torch.providers import (  # noqa: F401
        airbyte,
        clickhouse,
        file,
        kafka,
        memory,
        misc_providers,
        mongo,
        mq,
        mysql,
        oracle,
        postgres,
        s3,
        sample,
        stdout,
        yt,
    )
