"""Snapshot tasks of the port: the snapshot loader and the table
upload."""

from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
from transferia_tpu_torch.tasks.upload import upload

__all__ = ["SnapshotLoader", "upload"]
