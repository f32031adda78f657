"""Snapshot tasks of the port: the snapshot loader, the table upload and
the activation."""

from transferia_tpu_torch.tasks.activate import activate_delivery
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
from transferia_tpu_torch.tasks.upload import upload

__all__ = ["SnapshotLoader", "activate_delivery", "upload"]
