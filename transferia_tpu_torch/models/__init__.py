"""Transfer and endpoint models of the port."""

from transferia_tpu_torch.models.endpoint import (
    CleanupPolicy,
    EndpointParams,
    capability,
    register_endpoint,
)
from transferia_tpu_torch.models.transfer import (
    DataObjects,
    Runtime,
    ShardingUploadParams,
    Transfer,
    TransferType,
)

__all__ = [
    "CleanupPolicy", "EndpointParams", "capability", "register_endpoint",
    "DataObjects",
    "Runtime", "ShardingUploadParams", "Transfer", "TransferType",
]
