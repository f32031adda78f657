"""Scheduler-replica leader election over the durable ticket queue (the
port's copy of ``transferia_tpu/fleet/leader.py``).

N scheduler replicas may run the preemption/autoscale tick against one
coordinator; the decisions are idempotent but duplicated (every replica
lists the queue, every replica may race a revoke).  `LeaderLease`
elects ONE ticker by reusing the ticket lease/epoch machinery
(abstract/ticket.py) instead of inventing a lock primitive: leadership
is a claim on a well-known ticket (`__leader__`) in a side queue
(`<queue>.leader`), so

- acquisition is `claim_ticket` — atomic on all three backends (memory
  per-queue lock, filestore flock, s3 If-Match CAS), and an expired
  leader's claim is stealable exactly like a crashed worker's ticket
  (`ticket_claimable`), which IS the automatic failover;
- tenure is the ticket lease, renewed by the replica's own tick; a
  renewal scoped by (ticket, epoch) cannot resurrect a lost claim —
  after a steal the old leader's renew matches nothing, it observes 0
  and demotes itself (the "non-leaders fall back on lease expiry"
  half);
- the leader ticket is never completed: it cycles
  claimed -> (lease expiry) -> claimed forever, and the ticket-queue
  GC ignores non-terminal tickets, so election state never ages out.
"""

from __future__ import annotations

import logging
import os
import socket
import uuid
from typing import Optional

from transferia_tpu_torch.abstract.ticket import FleetTicket
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.stats import trace

logger = logging.getLogger(__name__)

LEADER_TICKET_ID = "__leader__"


def default_replica_id() -> str:
    return (f"{socket.gethostname()}-{os.getpid()}-"
            f"{uuid.uuid4().hex[:6]}")


class LeaderLease:
    """One replica's handle on the leader election for a fleet queue.

    `ensure()` is the only call sites need: invoked once per tick, it
    renews a held lease or tries to (re)acquire, and returns whether
    THIS replica is the leader for the tick.  Not thread-safe by
    design — one lease object belongs to one tick loop."""

    def __init__(self, coordinator: Coordinator, queue: str = "fleet",
                 replica_id: Optional[str] = None):
        if not coordinator.supports_ticket_queue():
            raise ValueError(
                f"coordinator {type(coordinator).__name__} has no "
                f"durable ticket queue; leader election needs "
                f"memory/filestore/s3")
        self.cp = coordinator
        self.queue = f"{queue}.leader"
        self.replica_id = replica_id or default_replica_id()
        self._ticket: Optional[FleetTicket] = None

    # -- the per-tick decision ----------------------------------------------
    def ensure(self) -> bool:
        """Renew-or-acquire; True = this replica leads this tick."""
        if self._ticket is not None:
            if self._renew_held():
                return True
            # lease lost (expired + stolen, or a no-TTL backend where
            # renew is a no-op): fall back to the durable truth
            logger.info("replica %s lost the leader lease for %r",
                        self.replica_id, self.queue)
            trace.instant("leader_lost", queue=self.queue,
                          replica=self.replica_id)
            self._ticket = None
        return self._try_acquire()

    def _renew_held(self) -> bool:
        try:
            renewed = self.cp.renew_ticket_leases(
                self.queue, self.replica_id,
                ticket_id=LEADER_TICKET_ID,
                claim_epoch=self._ticket.claim_epoch)
        except Exception as e:
            # transient RPC fault: the lease TTL absorbs it — stay
            # leader for this tick rather than flapping the election
            logger.warning("leader lease renew failed (TTL absorbs "
                           "it): %s", e)
            return True
        if renewed:
            return True
        # a no-TTL coordinator (lease_seconds=0) renews nothing; the
        # claim itself never expires — confirm against the queue
        cur = self._current()
        return (cur is not None and cur.state == "claimed"
                and cur.claimed_by == self.replica_id
                and cur.claim_epoch == self._ticket.claim_epoch)

    def _try_acquire(self) -> bool:
        try:
            self.cp.enqueue_ticket(self.queue, FleetTicket(
                ticket_id=LEADER_TICKET_ID, transfer_id=LEADER_TICKET_ID,
                tenant="__system__", qos="interactive",
                payload={"kind": "leader_lease"}))
            got = self.cp.claim_ticket(self.queue, LEADER_TICKET_ID,
                                       self.replica_id)
        except Exception as e:
            logger.warning("leader acquisition failed: %s", e)
            return False
        if got is None:
            return False  # another live replica holds the lease
        self._ticket = got
        logger.info("replica %s is now the leader for %r (epoch %d%s)",
                    self.replica_id, self.queue, got.claim_epoch,
                    f", stolen from {got.stolen_from}"
                    if got.stolen_from else "")
        trace.instant("leader_acquired", queue=self.queue,
                      replica=self.replica_id, epoch=got.claim_epoch,
                      stolen_from=got.stolen_from or "")
        return True

    # -- introspection / shutdown -------------------------------------------
    def _current(self) -> Optional[FleetTicket]:
        try:
            return next((t for t in self.cp.list_tickets(self.queue)
                         if t.ticket_id == LEADER_TICKET_ID), None)
        except Exception as e:
            logger.warning("leader ticket read failed: %s", e)
            return None

    def is_leader(self) -> bool:
        """Advisory (as of the last ensure())."""
        return self._ticket is not None

    def leader_id(self) -> Optional[str]:
        """Who holds the lease right now (any replica may ask)."""
        cur = self._current()
        return cur.claimed_by if cur is not None \
            and cur.state == "claimed" else None

    def release(self) -> None:
        """Graceful step-down: another replica can acquire on its next
        tick instead of waiting out the lease TTL."""
        if self._ticket is None:
            return
        try:
            self.cp.release_ticket(self.queue, self._ticket)
        except Exception as e:
            logger.warning("leader release failed (lease will "
                           "expire): %s", e)
        trace.instant("leader_released", queue=self.queue,
                      replica=self.replica_id)
        self._ticket = None
