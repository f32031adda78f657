"""Transfer and endpoint models of the port."""

from transferia_tpu_torch.models.endpoint import (
    CleanupPolicy,
    EndpointParams,
    capability,
    endpoint_from_dict,
    register_endpoint,
)
from transferia_tpu_torch.models.transfer import (
    DataObjects,
    IncrementalTableCfg,
    RegularSnapshot,
    Runtime,
    ShardingUploadParams,
    Transfer,
    TransferType,
)

__all__ = [
    "CleanupPolicy", "EndpointParams", "capability", "endpoint_from_dict",
    "register_endpoint", "DataObjects", "IncrementalTableCfg",
    "RegularSnapshot",
    "Runtime", "ShardingUploadParams", "Transfer", "TransferType",
]
