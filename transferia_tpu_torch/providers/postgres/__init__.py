"""PostgreSQL provider of the port over a stdlib implementation of the
v3 wire protocol.  COPY ... TO STDOUT (FORMAT csv) chunks decode straight
into ColumnBatches (`copycsv.py`); logical replication streams wal2json v2
through a replication slot (`replication.py`); the sink COPYs in, with a
staged commit, and `pg_dump.py` moves indexes, views and sequences to a
Postgres target."""

from transferia_tpu_torch.providers.postgres.provider import (
    PGSinker,
    PGSourceParams,
    PGTargetParams,
    PostgresProvider,
)

__all__ = ["PGSinker", "PGSourceParams", "PGTargetParams",
           "PostgresProvider"]
