"""Coordinator interface (the port's copy of the transfer, operation,
part-queue, lease, staged-commit, replication (failure, status
message, heartbeat) and MVCC control-plane groups of
``transferia_tpu/coordinator/interface.py``).  The fleet ticket queue
and the observability segments wait for their slices (ROADMAP.md A5,
A7).
"""

from __future__ import annotations

import abc
import enum
import time
from dataclasses import dataclass
from typing import Any, Optional

from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.runtime import knobs

# Part-claim lease TTL (seconds).  A claim is a lease: the holding worker
# renews it from its heartbeat thread, and an expired lease makes the
# part assignable again.  0 disables leasing (permanent claims).
DEFAULT_LEASE_SECONDS = 60.0
ENV_LEASE_SECONDS = "TRANSFERIA_TPU_LEASE_SECONDS"


def default_lease_seconds() -> float:
    return knobs.env_float(ENV_LEASE_SECONDS, DEFAULT_LEASE_SECONDS)


def deadline_expired(expires_at: float,
                     now: Optional[float] = None) -> bool:
    """The single lease-expiry rule (0 = no lease, never expires), on
    the wall clock: leases cross process and host boundaries."""
    if expires_at <= 0:
        return False
    return expires_at < (time.time() if now is None else now)


def lease_expired(part: OperationTablePart,
                  now: Optional[float] = None) -> bool:
    return deadline_expired(part.lease_expires_at, now)


class TransferStatus(str, enum.Enum):
    NEW = "new"
    ACTIVATING = "activating"
    ACTIVATED = "activated"
    RUNNING = "running"
    FAILING = "failing"
    FAILED = "failed"
    COMPLETED = "completed"
    DEACTIVATED = "deactivated"


@dataclass
class OperationProgress:
    """Aggregated snapshot progress."""

    total_parts: int = 0
    completed_parts: int = 0
    total_eta_rows: int = 0
    completed_rows: int = 0

    @property
    def done(self) -> bool:
        return self.total_parts > 0 and \
            self.completed_parts >= self.total_parts


class Coordinator(abc.ABC):
    """Control-plane contract: transfer status, transfer state KV,
    operation state, sharded-snapshot part assignment with leases, the
    staged-commit decision and worker health."""

    @abc.abstractmethod
    def set_status(self, transfer_id: str, status: TransferStatus) -> None:
        ...

    @abc.abstractmethod
    def get_status(self, transfer_id: str) -> TransferStatus:
        ...

    def fail_replication(self, transfer_id: str, error: str) -> None:
        self.set_status(transfer_id, TransferStatus.FAILED)
        self.open_status_message(transfer_id, "replication", error)

    def open_status_message(self, transfer_id: str, category: str,
                            message: str) -> None:
        """A user-visible status message of the transfer."""

    @abc.abstractmethod
    def set_transfer_state(self, transfer_id: str,
                           state: dict[str, Any]) -> None:
        """Merge keys into the transfer's state (checkpoints, cursors)."""

    @abc.abstractmethod
    def get_transfer_state(self, transfer_id: str) -> dict[str, Any]:
        ...

    def set_operation_state(self, operation_id: str,
                            state: dict[str, Any]) -> None:
        """Merge keys into the operation's state."""
        raise NotImplementedError

    def get_operation_state(self, operation_id: str) -> dict[str, Any]:
        raise NotImplementedError

    @abc.abstractmethod
    def create_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]) -> None:
        """The main worker publishes the part work queue."""

    @abc.abstractmethod
    def assign_operation_part(self, operation_id: str,
                              worker_index: int
                              ) -> Optional[OperationTablePart]:
        """Atomically claim the next assignable part (None = nothing
        assignable now): unassigned, or incomplete with an expired lease.
        Every (re)assignment bumps `assignment_epoch` and stamps a fresh
        `lease_expires_at`; a reclaim records `stolen_from`."""

    def renew_lease(self, operation_id: str, worker_index: int) -> int:
        """Heartbeat: extend the lease on every incomplete part this
        worker holds; the number renewed."""
        return 0

    @abc.abstractmethod
    def clear_assigned_parts(self, operation_id: str,
                             worker_index: int) -> int:
        """Unassign this worker's incomplete parts; the number
        released."""

    @abc.abstractmethod
    def update_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]
                               ) -> list[str]:
        """Progress/completion flush, epoch-fenced: an update whose
        `assignment_epoch` differs from the stored part's is rejected.
        Returns the keys of rejected updates."""

    def supports_staged_commits(self) -> bool:
        """True when this backend implements `commit_part`."""
        return type(self).commit_part is not Coordinator.commit_part

    def commit_part(self, operation_id: str,
                    part: OperationTablePart) -> Optional[bool]:
        """The fenced publish decision of the staged commit: True
        (granted, recorded as `commit_epoch`), False (fenced: the part
        was reclaimed since this worker's claim) or None (no support:
        the at-least-once path).  Re-granting the same epoch returns
        True again."""
        return None

    @abc.abstractmethod
    def operation_parts(self, operation_id: str
                        ) -> list[OperationTablePart]:
        ...

    def operation_progress(self, operation_id: str) -> OperationProgress:
        parts = self.operation_parts(operation_id)
        return OperationProgress(
            total_parts=len(parts),
            completed_parts=sum(1 for p in parts if p.completed),
            total_eta_rows=sum(p.eta_rows for p in parts),
            completed_rows=sum(p.completed_rows for p in parts),
        )

    # -- MVCC staging-store control plane (abstract/mvccfence.py) ---------
    #
    # SNAPSHOT_AND_INCREMENT lands snapshot parts as immutable base
    # versions while CDC deltas accumulate as LSN-ordered layers; the
    # cutover (delta LSN high-watermark + staged-commit epoch + source
    # offsets) is ONE atomic decision recorded here.  Columnar layer data
    # never crosses the coordinator: each scope stores a small JSON
    # control doc.  Backends without support keep the defaults (raise);
    # the store then runs unfenced in process (tests only).

    def supports_mvcc(self) -> bool:
        return type(self).mvcc_admit_layer is not \
            Coordinator.mvcc_admit_layer

    def mvcc_admit_layer(self, scope: str, layer: dict) -> dict:
        """Atomically admit one delta-layer metadata record; the decision
        dict {"status": "admitted"|"replaced"|"duplicate"|"fenced", ...}.
        A NEW (worker, seq) after the cutover is "fenced" and must be
        discarded by the caller."""
        raise NotImplementedError

    def mvcc_cutover(self, scope: str, watermark: int, epoch: int,
                     offsets: Optional[dict] = None) -> dict:
        """The single fenced cutover decision: the first caller seals
        (watermark, epoch, offsets); an identical retry is granted; any
        other decision is fenced and handed the sealed values."""
        raise NotImplementedError

    def mvcc_record_base(self, scope: str, base: dict) -> dict:
        """Record one spilled base version in the scope's manifest; an
        older epoch than the recorded one is "fenced"."""
        raise NotImplementedError

    def mvcc_state(self, scope: str) -> dict:
        """Read-only control snapshot: {"layers", "bases", "cutover",
        "watermark"} (abstract/mvccfence.state_view)."""
        raise NotImplementedError

    def mvcc_prune_layers(self, scope: str, keys: list) -> int:
        """Compaction GC: drop layer records by (worker, seq) key;
        idempotent.  Returns records pruned."""
        return 0

    def supports_mvcc_blobs(self) -> bool:
        """Whether the backend can store the MVCC spill's blobs: the
        reference's answer.  The spill needs pyarrow, which the port does
        not import, so the port's store keeps its layers in memory and
        has no blob store to call (ROADMAP.md A7, blocked)."""
        return False

    def operation_health(self, operation_id: str, worker_index: int,
                         payload: Optional[dict] = None) -> None:
        ...

    def get_operation_health(self, operation_id: str) -> dict[int, dict]:
        """Latest heartbeat per worker: {worker_index: {"ts", "payload"}}."""
        return {}

    def transfer_health(self, transfer_id: str, worker_index: int = 0,
                        healthy: bool = True) -> None:
        """The replication loop's heartbeat."""
