"""Ad-hoc table upload (the port's copy of
``transferia_tpu/tasks/upload.py``)."""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader


def upload(transfer, coordinator: Coordinator,
           tables: list[str],
           metrics: Optional[Metrics] = None,
           operation_id: Optional[str] = None,
           device: DeviceLike = None) -> None:
    """Upload an explicit table list (no incremental-state update) on
    `device` (None = CUDA, which must be present; "cpu" runs the
    kernels' plain versions)."""
    if not tables:
        raise ValueError("upload: explicit table list required")
    descriptions = [
        TableDescription(id=TableID.parse(t)) for t in tables
    ]
    loader = SnapshotLoader(transfer, coordinator, metrics=metrics,
                            operation_id=operation_id, device=device)
    loader.upload_tables(descriptions)
