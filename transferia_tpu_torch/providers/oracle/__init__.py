"""Oracle provider (the port's copy of ``transferia_tpu/providers/oracle/``):
the TNS/TTC wire client, SCN-pinned snapshot storage with ROWID-hash
shards and samples, and LogMiner CDC with SCN checkpoints.
"""

from transferia_tpu_torch.providers.oracle.provider import (
    OracleProvider,
    OracleSourceParams,
    OracleStorage,
)
from transferia_tpu_torch.providers.oracle.wire import OracleConnection, OracleError

__all__ = [
    "OracleConnection",
    "OracleError",
    "OracleProvider",
    "OracleSourceParams",
    "OracleStorage",
]
