"""MySQL provider of the port: the snapshot source, the binlog ROW
replication source (file+position and executed-GTID checkpoints,
`binlog.py`, `gtid.py`) and the MySQL target, over a stdlib
implementation of the client/server protocol (handshake v10,
mysql_native_password and the caching_sha2_password fast path, COM_QUERY
text resultsets, COM_BINLOG_DUMP and COM_BINLOG_DUMP_GTID)."""

from transferia_tpu_torch.providers.mysql.provider import (
    MySQLProvider,
    MySQLSourceParams,
    MySQLTargetParams,
)

__all__ = ["MySQLProvider", "MySQLSourceParams", "MySQLTargetParams"]
