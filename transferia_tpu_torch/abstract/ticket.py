"""FleetTicket: one admission-queue entry of the distributed fleet (the
port's copy of ``transferia_tpu/abstract/ticket.py``).

The reference's distributed fleet keeps its queue in the coordinator:
tickets are JSON documents the backends store durably, so N scheduler
replicas share one queue and worker processes claim work without
talking to the scheduler.  The port has no fleet yet (ROADMAP.md A7);
the type and its dict-form helpers come first, for the MVCC compaction
ticket (mvcc/compact.py), so both packages mint identical tickets.

Claims reuse the part-lease design (coordinator/interface.py) verbatim:
a claim is a lease the holding worker renews from its heartbeat;
`claim_epoch` bumps on every (re)claim and revocation, and any
completion/release carrying a stale epoch is fenced — a zombie worker
that wakes after its ticket was reclaimed (crash) or revoked
(preemption) cannot mark the reassigned ticket done.

State machine (see ARCHITECTURE.md "Distributed fleet"):

    queued --claim--> claimed --complete--> done | failed
      ^                  |
      |                  +-- release (drain / transient fault / yield)
      +--- revoke (preemption) / lease expiry (crash reclaim)

Shared helpers (`ticket_claimable`, `claim_in_place`, ...) mutate the
JSON dict form in place so the three backends implement byte-identical
semantics around their own atomicity primitive (lock / flock / CAS).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

# fixed priority order shared with the fleet QoS classes
# (fleet/scheduler.py QosClass values); lower rank = more latency
# sensitive = preempts, never preempted by a higher rank
QOS_RANK = {"interactive": 0, "batch": 1, "scavenger": 2}

TICKET_STATES = ("queued", "claimed", "done", "failed")


@dataclass
class FleetTicket:
    """One schedulable transfer in a durable fleet queue."""

    ticket_id: str
    transfer_id: str = ""
    tenant: str = "default"
    qos: str = "batch"                  # interactive | batch | scavenger
    cost: int = 1                       # deficit units (~parts weight)
    # what to run: a payload the worker's runner registry resolves
    # (fleet/worker.py) — callables can't cross a process boundary
    payload: dict = field(default_factory=dict)
    # -- queue bookkeeping (owned by the coordinator backends) ------------
    seq: int = -1                       # durable admission order
    state: str = "queued"
    claimed_by: str = ""                # worker id ("" = unclaimed)
    claim_epoch: int = 0                # bumps on claim/reclaim/revoke
    lease_expires_at: float = 0.0
    attempts: int = 0                   # claims granted so far
    failures: int = 0                   # failed RUN attempts (a claim
    #                                     after a preemption/drain yield
    #                                     is not a failure — yields must
    #                                     not burn the retry budget)
    stolen_from: str = ""               # prev holder on a crash reclaim
    preempted_from: str = ""            # prev holder on the last revoke
    preemptions: int = 0
    error: str = ""
    enqueued_at: float = 0.0
    completed_at: float = 0.0           # wall clock of the terminal
    #                                     transition (retention GC key)

    def key(self) -> str:
        return self.ticket_id

    @property
    def qos_rank(self) -> int:
        return QOS_RANK.get(self.qos, QOS_RANK["batch"])

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "failed")

    def to_json(self) -> dict:
        return {
            "ticket_id": self.ticket_id,
            "transfer_id": self.transfer_id,
            "tenant": self.tenant,
            "qos": self.qos,
            "cost": self.cost,
            "payload": dict(self.payload),
            "seq": self.seq,
            "state": self.state,
            "claimed_by": self.claimed_by,
            "claim_epoch": self.claim_epoch,
            "lease_expires_at": self.lease_expires_at,
            "attempts": self.attempts,
            "failures": self.failures,
            "stolen_from": self.stolen_from,
            "preempted_from": self.preempted_from,
            "preemptions": self.preemptions,
            "error": self.error,
            "enqueued_at": self.enqueued_at,
            "completed_at": self.completed_at,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FleetTicket":
        return cls(
            ticket_id=d["ticket_id"],
            transfer_id=d.get("transfer_id", ""),
            tenant=d.get("tenant", "default"),
            qos=d.get("qos", "batch"),
            cost=int(d.get("cost", 1)),
            payload=dict(d.get("payload") or {}),
            seq=int(d.get("seq", -1)),
            state=d.get("state", "queued"),
            claimed_by=d.get("claimed_by", ""),
            claim_epoch=int(d.get("claim_epoch", 0)),
            lease_expires_at=float(d.get("lease_expires_at", 0.0)),
            attempts=int(d.get("attempts", 0)),
            failures=int(d.get("failures", 0)),
            stolen_from=d.get("stolen_from", ""),
            preempted_from=d.get("preempted_from", ""),
            preemptions=int(d.get("preemptions", 0)),
            error=d.get("error", ""),
            enqueued_at=float(d.get("enqueued_at", 0.0)),
            completed_at=float(d.get("completed_at", 0.0)),
        )


# -- shared dict-form semantics (one implementation, three backends) ---------

def ticket_lease_expired(d: dict, now: Optional[float] = None) -> bool:
    """Same rule as part leases: 0 = no lease, never expires.  Wall
    clock — tickets cross process/host boundaries."""
    exp = float(d.get("lease_expires_at") or 0.0)
    if exp <= 0:
        return False
    return exp < (time.time() if now is None else now)


def ticket_claimable(d: dict, now: Optional[float] = None) -> bool:
    """Claimable = queued, OR claimed with an expired lease (the holder
    is presumed dead: crash reclaim)."""
    state = d.get("state", "queued")
    if state == "queued":
        return True
    return state == "claimed" and ticket_lease_expired(d, now)


def claim_in_place(d: dict, worker_id: str, lease_seconds: float,
                   now: Optional[float] = None) -> None:
    """Mutate a claimable ticket dict into this worker's claim: bump
    the epoch (fencing), stamp a fresh lease, record a steal when the
    previous holder's lease expired."""
    now = time.time() if now is None else now
    stolen = d.get("state") == "claimed"
    d["stolen_from"] = d.get("claimed_by", "") if stolen else ""
    d["state"] = "claimed"
    d["claimed_by"] = worker_id
    d["claim_epoch"] = int(d.get("claim_epoch", 0)) + 1
    d["attempts"] = int(d.get("attempts", 0)) + 1
    d["lease_expires_at"] = (now + lease_seconds
                             if lease_seconds > 0 else 0.0)


def fence_matches(d: dict, ticket: "FleetTicket") -> bool:
    """The single ticket fence: a completion/release is accepted only
    from the holder of the CURRENT claim epoch."""
    return (d.get("state") == "claimed"
            and d.get("claimed_by") == ticket.claimed_by
            and int(d.get("claim_epoch", 0)) == ticket.claim_epoch)


def complete_is_duplicate(d: dict, ticket: "FleetTicket") -> bool:
    """True when the stored ticket is already TERMINAL under this same
    claim (epoch + holder match): the completion RPC applied but its
    response was lost, and the worker is retrying.  Completion is
    idempotent under one epoch — the retry must be acknowledged, not
    misreported as a zombie fence (complete_in_place keeps claimed_by
    exactly so this check can tell a retry from a reclaim)."""
    return (d.get("state") in ("done", "failed")
            and d.get("claimed_by") == ticket.claimed_by
            and int(d.get("claim_epoch", 0)) == ticket.claim_epoch)


def complete_in_place(d: dict, error: str = "") -> None:
    d["state"] = "failed" if error else "done"
    d["error"] = error
    d["lease_expires_at"] = 0.0
    d["completed_at"] = time.time()


def ticket_expired(d: dict, retention_seconds: float,
                   now: Optional[float] = None) -> bool:
    """Retention rule shared by the three backends' GC: only TERMINAL
    tickets age out, `retention_seconds` after their terminal
    transition (tickets from before the completed_at field fall back
    to enqueued_at — old terminal records, prunable either way)."""
    if d.get("state") not in ("done", "failed"):
        return False
    ts = float(d.get("completed_at") or d.get("enqueued_at") or 0.0)
    return ts + retention_seconds < (time.time() if now is None
                                     else now)


def release_in_place(d: dict, failed: bool = False) -> None:
    """Return a claimed ticket to the queue (graceful drain, transient
    fault, preemption yield).  The attempt stays counted; the epoch is
    NOT bumped here — the next claim bumps it.  `failed=True` records
    a failed RUN attempt: only these count against the retry budget —
    a preemption or drain yield is scheduler-initiated and must not
    walk the ticket toward permanent failure."""
    d["state"] = "queued"
    d["claimed_by"] = ""
    d["lease_expires_at"] = 0.0
    if failed:
        d["failures"] = int(d.get("failures", 0)) + 1


def revoke_in_place(d: dict) -> None:
    """Preemption: force a claimed ticket back to the queue and bump
    the epoch NOW, so the (still running) old holder's completion or
    release is fenced the moment the revoke lands — it yields at its
    next part boundary and the transfer resumes elsewhere from its
    committed parts."""
    d["preempted_from"] = d.get("claimed_by", "")
    d["preemptions"] = int(d.get("preemptions", 0)) + 1
    d["claim_epoch"] = int(d.get("claim_epoch", 0)) + 1
    d["state"] = "queued"
    d["claimed_by"] = ""
    d["lease_expires_at"] = 0.0


def sort_key(d: dict) -> tuple:
    """Stable queue order: QoS rank first, then durable admission seq
    — the deterministic tie-break every picker shares."""
    return (QOS_RANK.get(d.get("qos", "batch"), 1),
            int(d.get("seq", -1)))
