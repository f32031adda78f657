"""Distributed fleet scheduler: a durable, preemptible admission plane
(the port's copy of ``transferia_tpu/fleet/distributed.py``).

The in-process `FleetScheduler` runs worker SLOTS inside one Python process —
one crash loses every queued transfer, and N scheduler replicas can't
share a queue at all.  This module moves the queue into the
COORDINATOR (memory / filestore flock / s3 conditional writes;
`Coordinator.enqueue_ticket`/`claim_ticket`/`complete_ticket`), so:

- a scheduler restart resumes the queue exactly where it left off
  (tickets are durable; `submit` is idempotent by ticket id, which is
  also the no-double-admission guarantee across N replicas);
- workers are real PROCESSES (`trtpu worker`, fleet/worker.py) that
  claim tickets with the same lease + epoch-fencing rules as snapshot
  parts — a kill -9'd worker's ticket is reclaimed by a survivor after
  lease expiry, and the zombie's late completion is fenced;
- QoS priorities mean something: an INTERACTIVE arrival with no free
  lane REVOKES the lease of the lowest-priority in-flight ticket
  (`preempt_if_needed`).  The revoke bumps the claim epoch, the running
  worker notices at its next part boundary (its heartbeat renewal
  returns 0) and yields; part checkpointing + exactly-once sinks mean
  the preempted transfer later resumes from its committed parts with
  nothing lost or duplicated.

The WDRR pick (which claimable ticket a worker runs next) reuses the
in-process scheduler's fair-share semantics — same quantum/weight
deficits, same QoS cost factors (fleet/scheduler.py) — but runs over
the durable queue snapshot, worker-side (`WdrrPicker`), so workers
keep draining even while every scheduler replica is down.

Replay surfaces: `admission_log` (enqueue order), each worker's
`claim_log`, and `preempt_log` — for a fixed submission set and fixed
part boundaries they replay identically.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from transferia_tpu_torch.abstract.ticket import (
    FleetTicket,
    ticket_lease_expired,
)
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.fleet.backpressure import BackpressureController
from transferia_tpu_torch.fleet.scheduler import QOS_COST_FACTOR, QosClass
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.registry import DistributedFleetStats, Metrics

logger = logging.getLogger(__name__)

DEFAULT_QUEUE = "fleet"

# Payload key carrying the admitting scheduler's span context across
# the process boundary (trace.wire_format form).  Payloads are opaque
# JSON the runner registry resolves; the dunder prefix keeps it out of
# any runner's parameter namespace.  FleetWorker._run_ticket adopts it,
# so a ticket's admission (scheduler process) and run (worker process)
# land on ONE trace in the merged fleet timeline (stats/fleetobs.py).
TICKET_TRACE_KEY = "__trace"


def charged_cost(ticket: FleetTicket) -> int:
    """Deficit units one ticket charges: cost x QoS factor — identical
    to FleetTransfer.charged_cost (fleet/scheduler.py), so fair share
    means the same thing in both fleets."""
    try:
        factor = QOS_COST_FACTOR[QosClass(ticket.qos)]
    except ValueError:
        factor = QOS_COST_FACTOR[QosClass.BATCH]
    return max(1, ticket.cost) * factor


class WdrrPicker:
    """Weighted deficit-round-robin pick over a durable queue snapshot.

    Mirrors the in-process scheduler's dispatch loop (same quantum /
    weight / charged-cost semantics), but stateless with respect to the
    queue itself: the caller passes the current claimable tickets and
    the picker only persists per-tenant deficits.  Tenants are visited
    in sorted-name order from a persistent cursor, ties break by
    durable seq — for a fixed queue snapshot the pick is a pure
    function of the picker state, which is what seed-exact chaos
    replay of the claim log relies on.

    `pick` never charges: the caller claims the candidate (CAS against
    the coordinator) and calls `charge` only on a WON claim — a lost
    race must not bill the tenant for a ticket someone else runs.
    """

    def __init__(self, tenant_weights: Optional[dict[str, float]] = None,
                 quantum: float = 1.0):
        self.quantum = quantum
        self._weights = dict(tenant_weights or {})
        self._deficits: dict[str, float] = {}
        self._cursor = 0

    def _weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, 1.0))

    def pick(self, claimable: list[FleetTicket]
             ) -> Optional[FleetTicket]:
        by_tenant: dict[str, list[FleetTicket]] = {}
        for t in claimable:
            by_tenant.setdefault(t.tenant, []).append(t)
        if not by_tenant:
            return None
        for heads in by_tenant.values():
            heads.sort(key=lambda t: (t.qos_rank, t.seq))
        names = sorted(by_tenant)
        start = self._cursor % len(names)
        guard = 0
        while True:
            guard += 1
            if guard > 100_000:  # pathological quantum/cost ratio
                logger.error("distributed DRR guard tripped; picking "
                             "cursor tenant head")
                return by_tenant[names[start]][0]
            idx = start % len(names)
            tenant = names[idx]
            head = by_tenant[tenant][0]
            deficit = self._deficits.get(tenant, 0.0)
            if deficit >= charged_cost(head):
                self._cursor = idx
                return head
            self._deficits[tenant] = deficit + \
                self.quantum * self._weight(tenant)
            start += 1

    def charge(self, ticket: FleetTicket) -> None:
        """Bill the tenant for a WON claim."""
        self._deficits[ticket.tenant] = \
            self._deficits.get(ticket.tenant, 0.0) - charged_cost(ticket)
        self._cursor += 1

    def reset_tenant(self, tenant: str) -> None:
        self._deficits.pop(tenant, None)


class DistributedFleetScheduler:
    """Admission + preemption over a coordinator-backed ticket queue.

    Holds NO queue state of its own: every decision reads the durable
    queue, so any number of replicas can run `submit`/`tick` against
    the same coordinator and a fresh replica picks up exactly where a
    dead one stopped (`resume()` is deliberately a read-only probe).
    """

    def __init__(self, coordinator: Coordinator,
                 queue: str = DEFAULT_QUEUE,
                 metrics: Optional[Metrics] = None,
                 tenant_queue_quota: int = 1024,
                 lanes_per_worker: int = 1,
                 backpressure: "Optional[BackpressureController | bool]"
                 = None,
                 capacity: Optional[Callable[[], int]] = None,
                 name: str = "fleet-dist"):
        if not coordinator.supports_ticket_queue():
            raise ValueError(
                f"coordinator {type(coordinator).__name__} has no "
                f"durable ticket queue; the distributed fleet needs "
                f"memory/filestore/s3")
        self.cp = coordinator
        self.queue = queue
        self.name = name
        self.metrics = metrics or Metrics()
        self.stats = DistributedFleetStats(self.metrics)
        self.tenant_queue_quota = tenant_queue_quota
        self.lanes_per_worker = max(1, lanes_per_worker)
        if backpressure is True:
            backpressure = BackpressureController(self.metrics)
        self.backpressure = backpressure or None
        # free-lane probe for the preemption decision: the supervisor's
        # live worker count x lanes.  None = the free-lane check is
        # SKIPPED and a queued high-priority arrival always preempts —
        # acceptable for single-worker tests, but a real deployment
        # should wire it (FleetAutoscaler does automatically) or idle
        # capacity won't save running work from needless revocation.
        self._capacity = capacity
        self._lock = threading.Lock()
        # replay surfaces (mirrors FleetScheduler.dispatch_log et al)
        self.admission_log: list[str] = []
        self.preempt_log: list[tuple] = []
        self.shed_log: list[tuple] = []
        # terminal-ticket retention GC cadence (tick may run at 1s;
        # pruning is a day-scale policy and on s3 each prune is real
        # DELETE traffic)
        self.gc_interval = 60.0
        self._last_gc = 0.0

    # -- admission -----------------------------------------------------------
    def submit(self, ticket: FleetTicket) -> str:
        """Admission gate + durable enqueue.  Returns "admitted" or a
        shed reason; raises when the enqueue RPC itself fails (the
        `fleet.enqueue` chaos site) — callers retry, and the idempotent
        enqueue makes the retry double-admission-proof."""
        adm_sp = trace.span("fleet_dist_admit",
                            ticket_id=ticket.ticket_id,
                            tenant=ticket.tenant, qos=ticket.qos)
        with adm_sp:
            hot = (self.backpressure.overloaded()
                   if self.backpressure else False)
            if hot:
                self.stats.shed.inc()
                with self._lock:
                    self.shed_log.append(
                        (ticket.ticket_id, "shed-backpressure"))
                if adm_sp:
                    adm_sp.add(decision="shed-backpressure")
                return "shed-backpressure"
            # one queue scan serves the quota check AND the gauge
            # refresh (each list is LIST + N GETs on the s3 backend)
            tickets = self.cp.list_tickets(self.queue)
            queued = sum(1 for t in tickets
                         if t.tenant == ticket.tenant
                         and t.state == "queued")
            if queued >= self.tenant_queue_quota:
                self.stats.shed.inc()
                with self._lock:
                    self.shed_log.append(
                        (ticket.ticket_id, "shed-tenant-quota"))
                if adm_sp:
                    adm_sp.add(decision="shed-tenant-quota")
                return "shed-tenant-quota"
            # stamp the admission trace onto the wire BEFORE the
            # enqueue: whichever worker process claims the ticket
            # adopts this context and joins the trace
            wire = trace.wire_format(trace.current_context())
            if wire and TICKET_TRACE_KEY not in ticket.payload:
                ticket.payload[TICKET_TRACE_KEY] = wire
            failpoint("fleet.enqueue")
            stored = self.cp.enqueue_ticket(self.queue, ticket)
            with self._lock:
                if stored.ticket_id not in self.admission_log:
                    self.admission_log.append(stored.ticket_id)
            if all(t.ticket_id != stored.ticket_id for t in tickets):
                # count only NEW admissions: an idempotent re-submit
                # (RPC-fault retry, replica failover) returns the
                # stored ticket and must not inflate the counter
                self.stats.enqueued.inc()
                tickets = tickets + [stored]
            self._refresh_gauges(tickets)
            if adm_sp:
                adm_sp.add(decision="admitted", seq=stored.seq)
            return "admitted"

    def resume(self) -> dict:
        """Failover probe: what a fresh replica inherits from the
        durable queue (counts only — nothing to rebuild, the queue IS
        the state)."""
        counts = self.counts()
        logger.info("scheduler %s resumed queue %r: %s", self.name,
                    self.queue, counts)
        return counts

    # -- preemption ----------------------------------------------------------
    def preempt_if_needed(self, tickets: Optional[list] = None
                          ) -> Optional[str]:
        """One preemption decision: when a queued ticket outranks some
        in-flight ticket and no lane is free, revoke the LOWEST-
        priority in-flight ticket's lease (ties: latest admitted).  The
        running worker yields at its next part boundary; the revoked
        ticket resumes later from its committed parts.  Returns the
        revoked ticket id, or None (nothing to do / revoke lost a
        race / revoke RPC faulted — dropped for this tick).  `tickets`
        lets a caller reuse a queue snapshot it already fetched (the
        revoke itself re-checks atomically at the coordinator)."""
        if tickets is None:
            tickets = self.cp.list_tickets(self.queue)
        now = time.time()
        queued = [t for t in tickets if t.state == "queued"]
        # only LIVE claims hold lanes: an expired-lease claim is a dead
        # worker's — it occupies nothing (its lane died with it) and
        # revoking it would "preempt" nobody while the actually-running
        # lowest-priority ticket kept its lane; the crash-reclaim path
        # owns expired claims
        claimed = [t for t in tickets
                   if t.state == "claimed"
                   and not ticket_lease_expired(t.to_json(), now)]
        if not queued or not claimed:
            return None
        want = min(t.qos_rank for t in queued)
        victim = max(claimed, key=lambda t: (t.qos_rank, t.seq))
        if victim.qos_rank <= want:
            return None  # nothing in flight outranked by the arrival
        if self._capacity is not None:
            free = self._capacity() * self.lanes_per_worker \
                - len(claimed)
            if free > 0:
                return None  # a lane is free: no need to preempt
        sp = trace.span("fleet_preempt", ticket_id=victim.ticket_id,
                        victim_qos=victim.qos,
                        holder=victim.claimed_by)
        with sp:
            try:
                failpoint("fleet.preempt")
                revoked = self.cp.revoke_ticket(self.queue,
                                                victim.ticket_id)
            except Exception as e:
                # a faulted revoke is dropped whole — never
                # half-applied; the arrival waits one lane-drain longer
                logger.warning("preempt of %s dropped (revoke fault: "
                               "%s)", victim.ticket_id, e)
                if sp:
                    sp.add(outcome="dropped")
                return None
            if revoked is None:
                if sp:
                    sp.add(outcome="lost-race")
                return None  # victim completed/yielded concurrently
            self.stats.preemptions.inc()
            with self._lock:
                self.preempt_log.append(
                    (revoked.ticket_id, revoked.preempted_from,
                     revoked.claim_epoch))
            if sp:
                sp.add(outcome="revoked", epoch=revoked.claim_epoch)
            logger.info(
                "preempted %s (qos=%s) from worker %s for a rank-%d "
                "arrival", revoked.ticket_id, revoked.qos,
                revoked.preempted_from, want)
            return revoked.ticket_id

    # -- introspection / autoscaling ----------------------------------------
    def tick(self) -> None:
        """Periodic maintenance (the autoscaler loop drives this):
        one queue snapshot feeds both the preemption decision and the
        gauge refresh — each list is LIST + N GETs on the s3 backend,
        so a 1s tick must not scan the queue four times.  A revoke
        flips one ticket claimed→queued after the snapshot; pending
        (and so desired_workers) is unchanged by that.  Terminal-ticket
        retention GC rides the same loop at its own (60s) cadence so
        multi-day fleets keep the queue — and every s3 poll — O(active)."""
        tickets = self.cp.list_tickets(self.queue)
        self.preempt_if_needed(tickets)
        self._refresh_gauges(tickets)
        now = time.time()
        if now - self._last_gc >= self.gc_interval:
            self._last_gc = now
            try:
                pruned = self.cp.gc_tickets(self.queue)
            except Exception as e:
                logger.warning("ticket GC failed (retrying next "
                               "cycle): %s", e)
                return
            if pruned:
                self.stats.gc_pruned.inc(pruned)
                logger.info("ticket GC pruned %d terminal ticket(s) "
                            "from %r", pruned, self.queue)
            # observability-segment retention rides the same cadence
            # (stats/fleetobs.py): the SCHEDULER prunes fleet-wide so
            # a crashed worker's final segments still age out even
            # though no exporter of that process will ever GC again
            try:
                from transferia_tpu_torch.stats import fleetobs

                self.cp.gc_obs_segments(fleetobs.default_scope())
            except Exception as e:  # advisory, like all obs work
                logger.debug("obs segment GC failed (retrying next "
                             "cycle): %s", e)

    def counts(self, tickets: Optional[list] = None) -> dict[str, int]:
        out = {"queued": 0, "claimed": 0, "done": 0, "failed": 0}
        if tickets is None:
            tickets = self.cp.list_tickets(self.queue)
        for t in tickets:
            out[t.state] = out.get(t.state, 0) + 1
        return out

    def _desired(self, pending: int) -> int:
        """THE scaling-hint formula (ceil-divide with a floor of one):
        single definition so the gauge, the autoscaler input, and
        /debug/fleet can never silently diverge."""
        return max(1, -(-pending // self.lanes_per_worker))

    def desired_workers(self) -> int:
        """The autoscaling hint: lanes needed for the current pending
        set (queued + claimed), floor 1.  Recomputed from the durable
        queue on EVERY read — completion and the backpressure tick see
        a fresh value, never a stale last-busy one."""
        c = self.counts()
        return self._desired(c["queued"] + c["claimed"])

    def refresh_gauges(self) -> None:
        self._refresh_gauges()

    def _refresh_gauges(self, tickets: Optional[list] = None) -> None:
        c = self.counts(tickets)
        self.stats.queued.set(c["queued"])
        self.stats.inflight.set(c["claimed"])
        self.stats.desired_workers.set(
            self._desired(c["queued"] + c["claimed"]))

    def drain(self, timeout: Optional[float] = None,
              poll: float = 0.05) -> bool:
        """Block until every ticket is terminal.  False on timeout."""
        deadline = (time.monotonic() + timeout) if timeout else None
        while True:
            tickets = self.cp.list_tickets(self.queue)
            # an EMPTY queue is drained (nothing was ever admitted, or
            # everything was shed) — polling it to timeout would report
            # a false failure
            if all(t.terminal for t in tickets):
                self._refresh_gauges(tickets)
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(poll)

    def snapshot(self) -> dict:
        """The /debug/fleet payload for the distributed plane."""
        tickets = self.cp.list_tickets(self.queue)
        tenants: dict[str, dict] = {}
        counts = {"queued": 0, "claimed": 0, "done": 0, "failed": 0}
        for t in tickets:
            counts[t.state] = counts.get(t.state, 0) + 1
            tn = tenants.setdefault(t.tenant, {
                "queued": 0, "claimed": 0, "done": 0, "failed": 0,
                "preemptions": 0, "attempts": 0})
            tn[t.state] = tn.get(t.state, 0) + 1
            tn["preemptions"] += t.preemptions
            tn["attempts"] += t.attempts
        with self._lock:
            adm, pre, shed = (len(self.admission_log),
                              len(self.preempt_log),
                              len(self.shed_log))
        pending = counts["queued"] + counts["claimed"]
        snap = {
            "name": self.name,
            "kind": "distributed",
            "queue": self.queue,
            "tickets": counts,
            "tenants": dict(sorted(tenants.items())),
            "admitted": adm,
            "preemptions": pre,
            "shed": shed,
            "desired_workers": self._desired(pending),
        }
        if self.backpressure is not None:
            snap["backpressure"] = self.backpressure.snapshot()
        return snap

    # the fleet registry (fleet/__init__.py) serves /debug/fleet from
    # live schedulers; distributed ones register the same way
    def register(self) -> "DistributedFleetScheduler":
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.register_scheduler(self)
        return self

    def unregister(self) -> None:
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.unregister_scheduler(self)
