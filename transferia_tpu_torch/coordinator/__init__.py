"""Coordinator of the port: transfer and operation state, the part queue
and its leases, the staged-commit decision, the ticket queue, the
observability segments and the MVCC control plane, in one process
(`MemoryCoordinator`) or across processes through a shared directory
(`FileStoreCoordinator`)."""

from transferia_tpu_torch.coordinator.filestore import FileStoreCoordinator
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    OperationProgress,
    TransferStatus,
)
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator

__all__ = ["Coordinator", "FileStoreCoordinator", "MemoryCoordinator",
           "OperationProgress", "TransferStatus", "new_coordinator"]


def new_coordinator(kind: str, **kw) -> Coordinator:
    """The CLI's factory (--coordinator memory|filestore).  The s3
    coordinator is not ported (ROADMAP.md A7)."""
    if kind == "memory":
        return MemoryCoordinator()
    if kind == "filestore":
        return FileStoreCoordinator(**kw)
    if kind == "s3":
        raise NotImplementedError(
            "the s3 coordinator is not ported to transferia_tpu_torch yet "
            "(ROADMAP.md A7, coordinator/s3store.py)")
    raise ValueError(f"unknown coordinator kind {kind!r}")
