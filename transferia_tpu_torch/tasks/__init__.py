"""Tasks of the port: the snapshot loader, the table upload, the
activation, the checksum and the maintenance operations."""

from transferia_tpu_torch.tasks.activate import activate_delivery
from transferia_tpu_torch.tasks.checksum import ChecksumReport, checksum
from transferia_tpu_torch.tasks.operations import (
    add_tables,
    apply_persisted_include_list,
    remove_tables,
    reupload,
)
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
from transferia_tpu_torch.tasks.upload import upload

__all__ = ["ChecksumReport", "SnapshotLoader", "activate_delivery",
           "add_tables", "apply_persisted_include_list", "checksum",
           "remove_tables", "reupload", "upload"]
