"""PostgreSQL provider of the port: the snapshot source over a stdlib
implementation of the v3 wire protocol.  COPY ... TO STDOUT (FORMAT csv)
chunks decode straight into ColumnBatches (`copycsv.py`); logical
replication streams wal2json v2 through a replication slot
(`replication.py`).  The sink and pg_dump wait (ROADMAP.md A6)."""

from transferia_tpu_torch.providers.postgres.provider import (
    PGSourceParams,
    PGTargetParams,
    PostgresProvider,
)

__all__ = ["PGSourceParams", "PGTargetParams", "PostgresProvider"]
