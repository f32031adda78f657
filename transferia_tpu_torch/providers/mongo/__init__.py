"""MongoDB provider (the port's copy of
``transferia_tpu/providers/mongo/``): snapshot with per-collection
parallelization units (parallelization_unit*.go), change-stream
replication (change_stream.go), bulk-op sink (sink_bulk_operations.go).
The client is a dependency-free BSON codec + OP_MSG wire implementation
(no pymongo): hello, SCRAM-SHA-256 auth, find/getMore
cursors, insert/update/delete, aggregate (change streams).
"""

from transferia_tpu_torch.providers.mongo.provider import (
    MongoProvider,
    MongoSourceParams,
    MongoTargetParams,
)

__all__ = ["MongoProvider", "MongoSourceParams", "MongoTargetParams"]
