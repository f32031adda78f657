"""MySQL provider of the port: the snapshot source over a stdlib
implementation of the client/server protocol (handshake v10,
mysql_native_password and the caching_sha2_password fast path, COM_QUERY
text resultsets).  The binlog replication source and the MySQL target
wait (ROADMAP.md A7)."""

from transferia_tpu_torch.providers.mysql.provider import (
    MySQLProvider,
    MySQLSourceParams,
    MySQLTargetParams,
)

__all__ = ["MySQLProvider", "MySQLSourceParams", "MySQLTargetParams"]
