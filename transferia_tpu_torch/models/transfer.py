"""Transfer model (the port's copy of ``transferia_tpu/models/transfer.py``).

A Transfer binds source and target endpoint params, the transformation
chain config, an include-list of data objects, the runtime (parallelism),
the pinned typesystem version and the inline validation switch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional

from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    endpoint_from_dict,
)
from transferia_tpu_torch.typesystem.fallbacks import LATEST_VERSION


class TransferType(str, enum.Enum):
    SNAPSHOT_ONLY = "SNAPSHOT_ONLY"
    INCREMENT_ONLY = "INCREMENT_ONLY"
    SNAPSHOT_AND_INCREMENT = "SNAPSHOT_AND_INCREMENT"

    @property
    def has_snapshot(self) -> bool:
        return self in (TransferType.SNAPSHOT_ONLY,
                        TransferType.SNAPSHOT_AND_INCREMENT)

    @property
    def has_replication(self) -> bool:
        return self in (TransferType.INCREMENT_ONLY,
                        TransferType.SNAPSHOT_AND_INCREMENT)


@dataclass
class ShardingUploadParams:
    job_count: int = 1       # processes
    process_count: int = 4   # upload threads per process


@dataclass
class Runtime:
    """current_job is this worker's index in sharded snapshot mode
    (index 0 = the main worker that splits tables and publishes parts)."""

    current_job: int = 0
    sharding: ShardingUploadParams = field(
        default_factory=ShardingUploadParams)
    replication_workers: int = 1

    @property
    def is_main(self) -> bool:
        return self.current_job == 0


@dataclass
class DataObjects:
    """Include-list of objects to transfer."""

    include_object_ids: list[str] = field(default_factory=list)

    def include_ids(self) -> list[TableID]:
        return [TableID.parse(s) for s in self.include_object_ids]


@dataclass
class IncrementalTableCfg:
    namespace: str = ""
    name: str = ""
    cursor_field: str = ""
    initial_state: str = ""


@dataclass
class RegularSnapshot:
    """Cron-driven incremental re-snapshot (`runtime/local.py::
    run_regular_snapshot`; the incremental tables' cursors persist in the
    transfer state)."""

    enabled: bool = False
    cron: str = ""
    incremental: list[IncrementalTableCfg] = field(default_factory=list)


@dataclass
class Transfer:
    id: str = "transfer"
    type: TransferType = TransferType.SNAPSHOT_ONLY
    src: Optional[EndpointParams] = None
    dst: Optional[EndpointParams] = None
    transformation: Optional[dict[str, Any]] = None  # transform chain config
    data_objects: DataObjects = field(default_factory=DataObjects)
    regular_snapshot: RegularSnapshot = field(default_factory=RegularSnapshot)
    runtime: Runtime = field(default_factory=Runtime)
    type_system_version: int = LATEST_VERSION
    labels: dict[str, str] = field(default_factory=dict)
    # {"fingerprint": true}: snapshot workers fingerprint post-transform
    # batches inline, per-part aggregates merge through the coordinator,
    # and the table digests land in the operation state
    validation: Optional[dict[str, Any]] = None

    def fingerprint_validation(self) -> bool:
        return bool(self.validation and self.validation.get("fingerprint"))

    def src_provider(self) -> str:
        return self.src.provider() if self.src else ""

    def dst_provider(self) -> str:
        return self.dst.provider() if self.dst else ""

    def include_ids(self) -> list[TableID]:
        return self.data_objects.include_ids()

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "type": self.type.value,
            "src": self.src.to_dict() if self.src else None,
            "dst": self.dst.to_dict() if self.dst else None,
            "transformation": self.transformation,
            "data_objects": self.data_objects.include_object_ids,
            "regular_snapshot": {
                "enabled": self.regular_snapshot.enabled,
                "cron": self.regular_snapshot.cron,
                "incremental": [vars(i) for i in
                                self.regular_snapshot.incremental],
            },
            "runtime": {
                "current_job": self.runtime.current_job,
                "job_count": self.runtime.sharding.job_count,
                "process_count": self.runtime.sharding.process_count,
                "replication_workers": self.runtime.replication_workers,
            },
            "type_system_version": self.type_system_version,
            "labels": self.labels,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Transfer":
        """The inverse of `to_dict` (which, as the reference's, carries
        no `validation`)."""
        rt = d.get("runtime") or {}
        rs = d.get("regular_snapshot") or {}
        return Transfer(
            id=d.get("id", "transfer"),
            type=TransferType(d.get("type", "SNAPSHOT_ONLY")),
            src=endpoint_from_dict(d["src"], role="source")
            if d.get("src") else None,
            dst=endpoint_from_dict(d["dst"], role="target")
            if d.get("dst") else None,
            transformation=d.get("transformation"),
            data_objects=DataObjects(d.get("data_objects") or []),
            regular_snapshot=RegularSnapshot(
                enabled=rs.get("enabled", False),
                cron=rs.get("cron", ""),
                incremental=[IncrementalTableCfg(**i)
                             for i in rs.get("incremental", [])],
            ),
            runtime=Runtime(
                current_job=rt.get("current_job", 0),
                sharding=ShardingUploadParams(
                    job_count=rt.get("job_count", 1),
                    process_count=rt.get("process_count", 4),
                ),
                replication_workers=rt.get("replication_workers", 1),
            ),
            type_system_version=d.get("type_system_version",
                                      LATEST_VERSION),
            labels=d.get("labels") or {},
        )
