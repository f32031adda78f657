"""Tasks of the port: the snapshot loader, the table upload, the
activation and the checksum."""

from transferia_tpu_torch.tasks.activate import activate_delivery
from transferia_tpu_torch.tasks.checksum import ChecksumReport, checksum
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader
from transferia_tpu_torch.tasks.upload import upload

__all__ = ["ChecksumReport", "SnapshotLoader", "activate_delivery",
           "checksum", "upload"]
