"""PostgreSQL provider of the port: the snapshot source over a stdlib
implementation of the v3 wire protocol.  COPY ... TO STDOUT (FORMAT csv)
chunks decode straight into ColumnBatches (`copycsv.py`).  The sink,
logical replication and pg_dump wait (ROADMAP.md A6, A7)."""

from transferia_tpu_torch.providers.postgres.provider import (
    PGSourceParams,
    PGTargetParams,
    PostgresProvider,
)

__all__ = ["PGSourceParams", "PGTargetParams", "PostgresProvider"]
