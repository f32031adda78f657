"""Coordinator interface (the port's copy of
``transferia_tpu/coordinator/interface.py``): transfer status and state,
operation state, the part queue with its leases, the staged-commit
decision, the fleet ticket queue, the observability segments, the MVCC
control plane and its blobs, and worker health.  A backend offers an
optional group by overriding its methods; `supports_ticket_queue`,
`supports_obs_segments`, `supports_mvcc` and `supports_mvcc_blobs`
probe for the override, as in the reference.
"""

from __future__ import annotations

import abc
import enum
import time
from dataclasses import dataclass
from typing import Any, Optional

from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.abstract.ticket import FleetTicket
from transferia_tpu_torch.runtime import knobs

# Part-claim lease TTL (seconds).  A claim is a lease: the holding worker
# renews it from its heartbeat thread, and an expired lease makes the
# part assignable again.  0 disables leasing (permanent claims).
DEFAULT_LEASE_SECONDS = 60.0
ENV_LEASE_SECONDS = "TRANSFERIA_TPU_LEASE_SECONDS"


def default_lease_seconds() -> float:
    return knobs.env_float(ENV_LEASE_SECONDS, DEFAULT_LEASE_SECONDS)


# terminal fleet tickets older than this are pruned by gc_tickets
DEFAULT_TICKET_RETENTION = 86_400.0
ENV_TICKET_RETENTION = "TRANSFERIA_TPU_TICKET_RETENTION"


def ticket_retention_seconds() -> float:
    return knobs.env_float(ENV_TICKET_RETENTION, DEFAULT_TICKET_RETENTION)


# observability segments: an age bound plus a per-worker count bound, so
# the store stays O(workers)
DEFAULT_OBS_RETENTION = 3_600.0
ENV_OBS_RETENTION = "TRANSFERIA_TPU_OBS_RETENTION"
DEFAULT_OBS_SEGMENTS_PER_WORKER = 8
ENV_OBS_SEGMENTS_PER_WORKER = "TRANSFERIA_TPU_OBS_SEGMENTS_PER_WORKER"


def obs_retention_seconds() -> float:
    return knobs.env_float(ENV_OBS_RETENTION, DEFAULT_OBS_RETENTION)


def obs_segments_per_worker() -> int:
    return max(1, int(knobs.env_float(ENV_OBS_SEGMENTS_PER_WORKER,
                                      DEFAULT_OBS_SEGMENTS_PER_WORKER)))


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

    def add_operation_parts(self, operation_id: str,
                            parts: list[OperationTablePart]) -> None:
        """Append parts to an existing queue (async part discovery
        streams parts while the upload runs)."""
        raise NotImplementedError

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

    # -- MVCC layer blobs ----------------------------------------------------
    #
    # The reference spills encoded base versions and delta layers as
    # opaque blobs; `put` returns a locator the same backend's `get`
    # resolves, and re-putting (scope, name) replaces.  The spill itself
    # needs pyarrow (ROADMAP.md A7, blocked): the port's store keeps its
    # layers in memory, and the blob stores wait for it.

    def supports_mvcc_blobs(self) -> bool:
        return type(self).put_mvcc_blob is not Coordinator.put_mvcc_blob

    def put_mvcc_blob(self, scope: str, name: str, data: bytes) -> str:
        """Durably store one blob under (scope, name); its locator."""
        raise NotImplementedError

    def get_mvcc_blob(self, scope: str, locator: str) -> Optional[bytes]:
        """A stored blob by its locator (None when it is gone)."""
        return None

    def delete_mvcc_blobs(self, scope: str, locators: list) -> int:
        """Blob GC; idempotent.  Returns blobs deleted."""
        return 0

    # -- the fleet's durable admission queue ---------------------------------
    #
    # Tickets share the part queue's lease and epoch-fencing rules
    # (abstract/ticket.py holds the state machine).  Backends without
    # the queue keep the defaults (raise).

    def supports_ticket_queue(self) -> bool:
        return type(self).claim_ticket is not Coordinator.claim_ticket

    def enqueue_ticket(self, queue: str,
                       ticket: FleetTicket) -> FleetTicket:
        """Durably append a ticket with the next queue seq; idempotent by
        ticket_id (an existing id returns the stored ticket)."""
        raise NotImplementedError

    def list_tickets(self, queue: str) -> list[FleetTicket]:
        """Every ticket in the queue (any state), seq-ordered."""
        raise NotImplementedError

    def claim_ticket(self, queue: str, ticket_id: str,
                     worker_id: str) -> Optional[FleetTicket]:
        """Atomically claim one ticket: queued, or claimed with an
        expired lease (recorded as `stolen_from`).  Every claim bumps
        `claim_epoch` and stamps a fresh lease.  None = not claimable."""
        raise NotImplementedError

    def renew_ticket_leases(self, queue: str, worker_id: str,
                            ticket_id: Optional[str] = None,
                            claim_epoch: Optional[int] = None) -> int:
        """Heartbeat: extend the leases of the tickets this worker holds
        (scoped to `ticket_id` and fenced to `claim_epoch` when given);
        the number renewed."""
        return 0

    def complete_ticket(self, queue: str, ticket: FleetTicket,
                        error: str = "") -> bool:
        """Epoch-fenced terminal transition (done, or failed with
        `error`).  False = fenced."""
        raise NotImplementedError

    def release_ticket(self, queue: str, ticket: FleetTicket,
                       failed: bool = False) -> bool:
        """Epoch-fenced return to the queue; `failed=True` counts against
        the retry budget.  False = fenced."""
        raise NotImplementedError

    def revoke_ticket(self, queue: str,
                      ticket_id: str) -> Optional[FleetTicket]:
        """Preemption: a claimed ticket back to the queue with its epoch
        bumped; None when it was not claimed."""
        raise NotImplementedError

    def gc_tickets(self, queue: str,
                   retention_seconds: Optional[float] = None) -> int:
        """Prune terminal tickets older than the retention; the number
        pruned."""
        return 0

    # -- durable observability segments ---------------------------------------
    #
    # Plain JSON dicts keyed by (worker, seq): re-putting the same key
    # replaces.  Readers skip torn segments.  Backends without support
    # keep the defaults, and the export turns itself off.

    def supports_obs_segments(self) -> bool:
        return type(self).put_obs_segment is not \
            Coordinator.put_obs_segment

    def put_obs_segment(self, scope: str, segment: dict) -> None:
        """Store one segment (it carries `worker` and `seq`) under
        `scope`."""
        raise NotImplementedError

    def list_obs_segments(self, scope: str) -> list[dict]:
        """Every readable segment in the scope, (worker, seq)-ordered."""
        return []

    def gc_obs_segments(self, scope: str,
                        retention_seconds: Optional[float] = None) -> int:
        """Prune segments over the age bound and past each worker's count
        bound; the number pruned."""
        return 0

    def operation_health(self, operation_id: str, worker_index: int,
                         payload: Optional[dict] = None) -> None:
        ...

    def get_operation_health(self, operation_id: str) -> dict[int, dict]:
        """Latest heartbeat per worker: {worker_index: {"ts", "payload"}}."""
        return {}

    def transfer_health(self, transfer_id: str, worker_index: int = 0,
                        healthy: bool = True) -> None:
        """The replication loop's heartbeat."""
