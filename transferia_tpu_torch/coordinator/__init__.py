"""Coordinator of the port: transfer and operation state, the part queue
and its leases, the staged-commit decision, the ticket queue, the
observability segments and the MVCC control plane, in one process
(`MemoryCoordinator`), across processes through a shared directory
(`FileStoreCoordinator`) or through a bucket (`S3Coordinator`)."""

from transferia_tpu_torch.coordinator.filestore import FileStoreCoordinator
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    OperationProgress,
    TransferStatus,
)
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator
from transferia_tpu_torch.coordinator.s3store import S3Coordinator

__all__ = ["Coordinator", "FileStoreCoordinator", "MemoryCoordinator",
           "OperationProgress", "S3Coordinator", "TransferStatus",
           "new_coordinator"]


def new_coordinator(kind: str, **kw) -> Coordinator:
    """The CLI's factory (--coordinator memory|filestore|s3)."""
    if kind == "memory":
        return MemoryCoordinator()
    if kind == "filestore":
        return FileStoreCoordinator(**kw)
    if kind == "s3":
        return S3Coordinator(**kw)
    raise ValueError(f"unknown coordinator kind {kind!r}")
