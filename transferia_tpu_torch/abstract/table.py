"""Table work units (the port's copy of ``transferia_tpu/abstract/table.py``):
a table or slice to snapshot, and the sharded-snapshot part."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from transferia_tpu_torch.abstract.schema import TableID


@dataclass
class TableDescription:
    """A table (or a slice of one) to snapshot."""

    id: TableID
    filter: str = ""       # WHERE-like predicate (predicate/ syntax)
    offset: int = 0
    eta_rows: int = 0      # estimated rows (for big-first scheduling)


@dataclass
class OperationTablePart:
    """Sharded-snapshot work unit, claimed through the coordinator.

    A claim is a lease: `assignment_epoch` bumps on every (re)assignment
    and fences stale completions; `lease_expires_at` is a wall-clock
    deadline the worker heartbeat renews (0 = no lease); `stolen_from`
    names the previous holder of a reclaimed part; `commit_epoch` is the
    epoch under which the coordinator granted the staged publish (None =
    never granted); `fingerprint` is the digest of the part's
    post-transform rows.
    """

    operation_id: str = ""
    table_id: TableID = field(default_factory=lambda: TableID("", ""))
    filter: str = ""
    offset: int = 0
    part_index: int = 0
    parts_count: int = 1
    eta_rows: int = 0
    completed_rows: int = 0
    read_bytes: int = 0
    completed: bool = False
    worker_index: Optional[int] = None  # assignee
    assignment_epoch: int = 0
    lease_expires_at: float = 0.0
    stolen_from: Optional[int] = None
    commit_epoch: Optional[int] = None
    fingerprint: str = ""

    def key(self) -> str:
        return f"{self.operation_id}/{self.table_id}/{self.part_index}"

    def part_id(self) -> str:
        """PartID stamped on control events and rows of this part."""
        return f"{self.table_id}_{self.part_index}_{self.parts_count}"

    def to_description(self) -> TableDescription:
        return TableDescription(
            id=self.table_id,
            filter=self.filter,
            offset=self.offset,
            eta_rows=self.eta_rows,
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "operation_id": self.operation_id,
            "schema": self.table_id.namespace,
            "table": self.table_id.name,
            "filter": self.filter,
            "offset": self.offset,
            "part_index": self.part_index,
            "parts_count": self.parts_count,
            "eta_rows": self.eta_rows,
            "completed_rows": self.completed_rows,
            "read_bytes": self.read_bytes,
            "completed": self.completed,
            "worker_index": self.worker_index,
            "assignment_epoch": self.assignment_epoch,
            "lease_expires_at": self.lease_expires_at,
            "stolen_from": self.stolen_from,
            "commit_epoch": self.commit_epoch,
            "fingerprint": self.fingerprint,
        }

    @staticmethod
    def from_json(d: dict[str, Any]) -> "OperationTablePart":
        return OperationTablePart(
            operation_id=d.get("operation_id", ""),
            table_id=TableID(d.get("schema", ""), d.get("table", "")),
            filter=d.get("filter", ""),
            offset=d.get("offset", 0),
            part_index=d.get("part_index", 0),
            parts_count=d.get("parts_count", 1),
            eta_rows=d.get("eta_rows", 0),
            completed_rows=d.get("completed_rows", 0),
            read_bytes=d.get("read_bytes", 0),
            completed=d.get("completed", False),
            worker_index=d.get("worker_index"),
            assignment_epoch=d.get("assignment_epoch", 0),
            lease_expires_at=d.get("lease_expires_at", 0.0),
            stolen_from=d.get("stolen_from"),
            commit_epoch=d.get("commit_epoch"),
            fingerprint=d.get("fingerprint", ""),
        )
