"""Provider plugin registry of the port.

Providers register under a name and expose optional capability
constructors (snapshot storage, sinker, ...); factories resolve them at
transfer build time.  The port ships the `sample` source (snapshot and
replication), the `memory` source and sink, the `kafka` replication
source and sink, the `ch` (ClickHouse) sink on one shard, the `fs`
Parquet source, the `pg` (Postgres) and `mysql` snapshot sources and the
`stdout` and `devnull` sinks; the other providers wait (ROADMAP.md A).
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
        clickhouse,
        file,
        kafka,
        memory,
        mysql,
        postgres,
        sample,
        stdout,
    )
