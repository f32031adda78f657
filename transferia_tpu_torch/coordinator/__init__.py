"""Coordinator of the port: transfer and operation state, the part queue
and its leases, and the staged-commit decision."""

from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    OperationProgress,
    TransferStatus,
)
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator

__all__ = ["Coordinator", "MemoryCoordinator", "OperationProgress",
           "TransferStatus"]
