"""Fleet scheduler: admission control + weighted fair-share dispatch
(the port's copy of ``transferia_tpu/fleet/scheduler.py``).

The plane ABOVE operations.  The part leases and epoch fencing recover a
single operation's parts when a worker dies; nothing decided which of
N tenants x M transfers get to run at all.  This module is that
decision: transfers are submitted as `FleetTransfer` tickets, pass an
admission gate (per-tenant queue quotas + data-plane backpressure,
fleet/backpressure.py), queue per tenant, and dispatch onto a bounded
pool of worker slots by deficit round-robin — each dispatched ticket
then runs the EXISTING engine (SnapshotLoader / run_replication),
whose part claims go through the coordinator's lease machinery
unchanged.  The scheduler never touches parts; it decides who runs.

Fair share: every tenant owns a deficit counter.  A visit adds
`quantum * weight` to the tenant's deficit; the head ticket dispatches
when the deficit covers its charged cost (`cost * qos factor` —
INTERACTIVE tickets charge 1x, BATCH 2x, SCAVENGER 4x, so latency-
sensitive work drains proportionally faster without starving anyone:
deficits grow every round, so any queued ticket's dispatch is at most
a bounded number of rounds away regardless of the competing load).

Determinism: every dispatch decision happens under the scheduler
lock, tenants are visited in a fixed rotation, ties break by
submission sequence — so for a fixed submission set the k-th dispatch
is a pure function of k, no matter which worker thread asks or how
the OS schedules them.  `dispatch_log` records the order; the chaos
`scheduler_kill` mode replays it under a seed.  The `fleet.dispatch`
failpoint fires inside that same critical section, which is what
makes kill/rebalance trials replay exactly.

Worker model: `workers` slots x `max_inflight_per_worker` lanes, one
thread per lane.  A `WorkerKilledError` (from the dispatch failpoint
or raised out of a running transfer) kills the SLOT: the raising
lane's in-flight ticket is rebalanced — requeued at the head of its
tenant's queue with the attempt counted — and the slot's lanes exit
at their next dispatch (in-process threads cannot be preempted, so a
sibling lane mid-transfer finishes that transfer before exiting —
work already done is never thrown away).  Surviving slots absorb the
queue; if every slot is dead while work remains, one replacement slot
spawns (the floor the autoscaling hint builds on).

Backpressure wiring: pass `backpressure=True` to gate admission on a
`BackpressureController` over THIS scheduler's metrics registry —
which therefore must be the registry the data plane folds its gauges
into (share one `Metrics` across the pipeline and the scheduler), or
the readahead/sink/ratio signals will read 0.0 and only the
scheduler's own `fleet_queue_depth` can trip.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from transferia_tpu_torch.abstract.errors import is_worker_kill
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.fleet.backpressure import BackpressureController
from transferia_tpu_torch.runtime import lockwatch
from transferia_tpu_torch.stats import hdr, trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import FleetStats, Metrics

logger = logging.getLogger(__name__)

DEFAULT_TICKET_ATTEMPTS = 3  # dispatch attempts per ticket (faults +
#                              rebalances both count; the part-level
#                              retry machinery runs INSIDE each attempt)


class QosClass(str, enum.Enum):
    INTERACTIVE = "interactive"
    BATCH = "batch"
    SCAVENGER = "scavenger"


# deficit charge multipliers: a SCAVENGER ticket spends 4x the deficit
# an INTERACTIVE one does, so interactive work drains ~4x faster under
# contention while scavengers still advance every round
QOS_COST_FACTOR = {
    QosClass.INTERACTIVE: 1,
    QosClass.BATCH: 2,
    QosClass.SCAVENGER: 4,
}

_QOS_ORDER = (QosClass.INTERACTIVE, QosClass.BATCH, QosClass.SCAVENGER)


@dataclass
class FleetTransfer:
    """One schedulable transfer: identity + the engine entry point."""

    transfer_id: str
    tenant: str
    run: Callable[[], Any]
    qos: QosClass = QosClass.BATCH
    cost: int = 1                  # deficit units (~parts / eta weight)
    # -- scheduler bookkeeping (owned by FleetScheduler) ------------------
    state: str = "new"             # queued|running|done|failed|shed
    seq: int = -1
    attempts: int = 0
    worker: Optional[int] = None
    shed_reason: str = ""
    error: Optional[BaseException] = None
    submitted_at: float = 0.0
    queued_at: float = 0.0         # last time the ticket entered a queue
    dispatched_at: float = 0.0
    finished_at: float = 0.0
    # causal anchor: the admission span's context — every later
    # lifecycle span/instant of this ticket (queue wait, dispatch,
    # run, rebalance, kill) links to it, so the whole lifecycle is ONE
    # trace no matter which lane thread touches the ticket
    trace_ctx: Optional["trace.SpanContext"] = None

    @property
    def charged_cost(self) -> int:
        return max(1, self.cost) * QOS_COST_FACTOR[self.qos]

    @property
    def dispatch_latency(self) -> float:
        """Queue wait of the CURRENT attempt: last enqueue -> dispatch
        decision (seconds).  queued_at resets on every requeue
        (rebalance, transient fault, retry) so a rerun never bills the
        prior attempt's wait or run time as queue wait."""
        start = self.queued_at or self.submitted_at
        if self.dispatched_at and start:
            return self.dispatched_at - start
        return 0.0


class _Tenant:
    __slots__ = ("name", "weight", "deficit", "queues", "queued",
                 "charged_queued", "running", "done", "failed", "shed",
                 "service")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = weight
        self.deficit = 0.0
        self.queues: dict[QosClass, deque] = {q: deque()
                                              for q in _QOS_ORDER}
        self.queued = 0
        self.charged_queued = 0  # incremental: gauge reads stay O(1)
        self.running = 0
        self.done = 0
        self.failed = 0
        self.shed = 0
        self.service = 0  # charged cost dispatched (fairness numerator)

    def head(self) -> Optional[FleetTransfer]:
        for q in _QOS_ORDER:
            if self.queues[q]:
                return self.queues[q][0]
        return None

    def pop_head(self) -> FleetTransfer:
        for q in _QOS_ORDER:
            if self.queues[q]:
                t = self.queues[q].popleft()
                self.queued -= 1
                self.charged_queued -= t.charged_cost
                return t
        raise IndexError("pop from empty tenant queue")

    def push(self, ticket: FleetTransfer, front: bool = False) -> None:
        dq = self.queues[ticket.qos]
        (dq.appendleft if front else dq.append)(ticket)
        self.queued += 1
        self.charged_queued += ticket.charged_cost

    def debt(self) -> float:
        """Weighted backlog: charged cost queued, normalized by weight
        — the autoscaling hint's per-tenant term."""
        return self.charged_queued / max(self.weight, 1e-9)


class _WorkerDied(Exception):
    """Internal lane signal: this slot was killed at dispatch time."""


def percentile(values: list[float], p: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(p * (len(vs) - 1)))))
    return vs[idx]


class FleetScheduler:
    """Admission control + DRR dispatch over a bounded worker pool."""

    def __init__(self, workers: int = 4,
                 max_inflight_per_worker: int = 2,
                 tenant_queue_quota: int = 1024,
                 quantum: float = 1.0,
                 tenant_weights: Optional[dict[str, float]] = None,
                 backpressure: "Optional[BackpressureController | bool]"
                 = None,
                 metrics: Optional[Metrics] = None,
                 max_attempts: int = DEFAULT_TICKET_ATTEMPTS,
                 ticket_history_limit: int = 65536,
                 name: str = "fleet"):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if max_inflight_per_worker < 1:
            raise ValueError("max_inflight_per_worker must be >= 1")
        self.name = name
        self.metrics = metrics or Metrics()
        self.stats = FleetStats(self.metrics)
        # backpressure=True builds the controller over THIS registry so
        # the fleet_queue_depth signal (and any data-plane gauges folded
        # into the same registry) are actually read — a controller over
        # a disconnected registry would see 0.0 forever
        if backpressure is True:
            backpressure = BackpressureController(self.metrics)
        self.backpressure = backpressure or None
        if self.backpressure is not None:
            # gauge freshness: the controller's evaluation is the
            # "backpressure tick" — refresh queue_depth/desired_workers
            # right before it reads them, so a drained-then-idle fleet
            # never advertises its last busy desired_workers value
            self.backpressure.add_tick_listener(self.refresh_gauges)
        self.quantum = quantum
        self.tenant_queue_quota = tenant_queue_quota
        self.max_attempts = max_attempts
        self._n_workers = workers
        self._lanes_per_worker = max_inflight_per_worker
        self._tenant_weights = dict(tenant_weights or {})
        self._lock = lockwatch.named_lock("fleet.scheduler")
        self._cond = threading.Condition(self._lock)
        self._tenants: dict[str, _Tenant] = {}
        self._active: deque[str] = deque()   # tenants with queued work
        self._tickets: dict[str, FleetTransfer] = {}
        # terminal tickets are evicted FIFO past this bound so a
        # long-lived scheduler does not hold every transfer it ever ran
        # (its run closure captures the whole Transfer)
        self._history_limit = max(1, ticket_history_limit)
        self._terminal_order: deque[str] = deque()
        self._pending = 0   # admitted minus terminal — drain() waits on 0
        self._seq = 0
        self._running = 0
        self._stopped = False
        self._started = False
        self._threads: list[threading.Thread] = []
        self._dead_workers: set[int] = set()
        self._next_worker = workers          # respawn slot indices
        # audit surfaces (bounded like the latency deques): dispatch
        # order, kill/rebalance log, and any double-admission (a ticket
        # picked while not queued — must stay empty; the chaos auditor
        # asserts on it)
        self.dispatch_log: deque = deque(maxlen=65536)
        self.rebalance_log: deque = deque(maxlen=65536)
        self.kill_log: deque = deque(maxlen=65536)
        self.double_admissions: list[str] = []
        self.dispatch_latencies: deque = deque(maxlen=65536)
        self.pick_seconds: deque = deque(maxlen=65536)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetScheduler":
        with self._lock:
            if self._started:
                return self
            self._started = True
            for w in range(self._n_workers):
                self._spawn_worker_locked(w)
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.register_scheduler(self)
        return self

    def _spawn_worker_locked(self, widx: int) -> None:
        for lane in range(self._lanes_per_worker):
            t = threading.Thread(
                target=self._lane_loop, args=(widx,),
                name=f"{self.name}-w{widx}.{lane}", daemon=True)
            self._threads.append(t)
            t.start()

    def shutdown(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        if self.backpressure is not None:
            # a shared long-lived controller must not keep this dead
            # scheduler alive (or let it overwrite live gauges)
            self.backpressure.remove_tick_listener(self.refresh_gauges)
        from transferia_tpu_torch import fleet as fleet_mod

        fleet_mod.unregister_scheduler(self)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted ticket reaches a terminal state
        (done/failed/shed).  Returns False on timeout."""
        deadline = (time.monotonic() + timeout) if timeout else None
        with self._cond:
            while True:
                if self._pending <= 0:
                    return True
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                self._cond.wait(wait if wait is not None else 1.0)

    # -- admission -----------------------------------------------------------
    def submit(self, ticket: FleetTransfer) -> str:
        """Admission gate.  Returns "admitted" or a shed reason
        ("shed-tenant-quota" / "shed-backpressure"); raises when the
        admission RPC itself fails (the `fleet.admit` chaos site) —
        callers retry, exactly as they would a coordinator call."""
        failpoint("fleet.admit")
        # the ticket's trace root: queue-wait, dispatch, run and any
        # rebalance/kill events all link back to this admission span
        adm_sp = trace.span("fleet_admit",
                            transfer_id=ticket.transfer_id,
                            tenant=ticket.tenant, qos=ticket.qos.value)
        with adm_sp:
            if adm_sp:
                ticket.trace_ctx = adm_sp.context()
            # read the data-plane gauges OUTSIDE the scheduler lock: the
            # controller takes its own lock and reads N metrics
            hot = (self.backpressure.overloaded()
                   if self.backpressure else False)
            with self._cond:
                tn = self._tenant_locked(ticket.tenant)
                if tn.queued >= self.tenant_queue_quota:
                    ticket.state = "shed"
                    ticket.shed_reason = "shed-tenant-quota"
                elif hot:
                    ticket.state = "shed"
                    ticket.shed_reason = "shed-backpressure"
                else:
                    ticket.seq = self._seq
                    self._seq += 1
                    ticket.state = "queued"
                    ticket.submitted_at = time.perf_counter()
                    ticket.queued_at = ticket.submitted_at
                    self._tickets[ticket.transfer_id] = ticket
                    self._pending += 1
                    tn.push(ticket)
                    if ticket.tenant not in self._active:
                        self._active.append(ticket.tenant)
                    self.stats.admitted.inc()
                    self._update_gauges_locked()
                    self._cond.notify()
                    if adm_sp:
                        adm_sp.add(decision="admitted")
                    return "admitted"
                tn.shed += 1
                self.stats.shed.inc()
                # sheds must refresh the gauges too: a shedding fleet
                # is exactly when the autoscaler reads desired_workers
                self._update_gauges_locked()
                if adm_sp:
                    adm_sp.add(decision=ticket.shed_reason)
                return ticket.shed_reason

    def _tenant_locked(self, name: str) -> _Tenant:
        tn = self._tenants.get(name)
        if tn is None:
            tn = self._tenants[name] = _Tenant(
                name, float(self._tenant_weights.get(name, 1.0)))
        return tn

    def tenant_weight(self, name: str) -> float:
        """Current WDRR weight for a tenant (configured default when it
        has not queued work yet)."""
        with self._lock:
            tn = self._tenants.get(name)
            if tn is not None:
                return tn.weight
            return float(self._tenant_weights.get(name, 1.0))

    def set_tenant_weight(self, name: str, weight: float) -> float:
        """Retune a tenant's WDRR weight live (the SLO alert hook's
        escalation lever: a tenant burning latency budget gets a larger
        deficit refill, so its queue drains faster).  Returns the prior
        weight so the caller can restore it on recovery."""
        weight = max(0.01, float(weight))
        with self._lock:
            tn = self._tenants.get(name)
            prior = tn.weight if tn is not None \
                else float(self._tenant_weights.get(name, 1.0))
            self._tenant_weights[name] = weight
            if tn is not None:
                tn.weight = weight
            self._cond.notify_all()
        return prior

    # -- dispatch (DRR) ------------------------------------------------------
    def _pick_locked(self) -> Optional[FleetTransfer]:
        """One deficit-round-robin decision.  Caller holds the lock."""
        guard = 0
        while self._active:
            guard += 1
            if guard > 100_000:  # pathological quantum/cost ratio
                logger.error("fleet DRR guard tripped; dispatching "
                             "front tenant head")
                tn = self._tenants[self._active[0]]
                taken = self._take_locked(tn, tn.pop_head())
                if taken is None:
                    continue
                return taken
            tname = self._active[0]
            tn = self._tenants[tname]
            head = tn.head()
            if head is None:
                self._active.popleft()
                tn.deficit = 0.0
                continue
            if tn.deficit < head.charged_cost:
                tn.deficit += self.quantum * tn.weight
                self._active.rotate(-1)
                continue
            tn.pop_head()
            if not tn.head():
                self._active.popleft()
                tn.deficit = 0.0
            else:
                tn.deficit -= head.charged_cost
            taken = self._take_locked(tn, head)
            if taken is None:
                continue  # double-admission guard dropped the ticket
            return taken
        return None

    def _take_locked(self, tn: _Tenant,
                     ticket: FleetTransfer) -> Optional[FleetTransfer]:
        if ticket.state != "queued":
            # double admission: a ticket reached the dispatch point
            # while not queued — record and DROP it (running it again
            # is exactly the duplicate delivery the guard exists to
            # prevent); the auditor asserts this list stays empty
            self.double_admissions.append(ticket.transfer_id)
            logger.error("fleet: ticket %s picked in state %r; dropped",
                         ticket.transfer_id, ticket.state)
            return None
        ticket.state = "running"
        ticket.attempts += 1
        ticket.dispatched_at = time.perf_counter()
        tn.running += 1
        tn.service += ticket.charged_cost
        self._running += 1
        self.dispatch_log.append(ticket.transfer_id)
        lat = ticket.dispatch_latency
        self.dispatch_latencies.append(lat)
        self.stats.dispatch_time.observe(lat)
        # mergeable log-bucket histogram (stats/hdr.py): the fleet obs
        # segments export this, so N processes' dispatch tails merge
        # into one exact p50/p99/p999; the exemplar on the max bucket
        # is the worst dispatch's trace id
        hdr.observe("fleet_dispatch", lat,
                    trace_id=ticket.trace_ctx.trace_id
                    if ticket.trace_ctx else 0)
        # the queue wait becomes a real span on the ticket trace,
        # recorded retroactively now that it ended (admission →
        # dispatch decision, regardless of which lane thread picked it)
        trace.complete("fleet_queue_wait",
                       t0=ticket.queued_at or ticket.submitted_at,
                       dur=lat, parent=ticket.trace_ctx,
                       transfer_id=ticket.transfer_id,
                       tenant=ticket.tenant, attempt=ticket.attempts)
        return ticket

    def _next_dispatch(self, widx: int) -> Optional[FleetTransfer]:
        """Block until a ticket is available for this worker slot, the
        scheduler stops, or the slot is found dead.  The dispatch
        failpoint fires inside the same critical section as the pick,
        so a kill's position in the dispatch order is seed-exact."""
        with self._cond:
            while True:
                if self._stopped:
                    return None
                if widx in self._dead_workers:
                    raise _WorkerDied()
                t0 = time.perf_counter()
                ticket = self._pick_locked()
                self.pick_seconds.append(time.perf_counter() - t0)
                if ticket is None:
                    self._update_gauges_locked()
                    self._cond.wait(0.5)
                    continue
                ticket.worker = widx
                try:
                    failpoint("fleet.dispatch")
                except BaseException as e:
                    if is_worker_kill(e):
                        self._kill_worker_locked(widx, ticket)
                        raise _WorkerDied() from e
                    # transient dispatch fault: the slot survives, the
                    # ticket goes back and redispatches (attempt spent)
                    self._rebalance_locked(ticket, widx)
                    self._update_gauges_locked()
                    continue
                self._update_gauges_locked()
                # dispatch decision as a point event on the ticket
                # trace: together with the fleet_queue_wait span this
                # marks where the scheduler handed the ticket to a lane
                trace.instant("fleet_dispatch", ctx=ticket.trace_ctx,
                              worker=widx,
                              transfer_id=ticket.transfer_id)
                return ticket

    # -- worker death & rebalance -------------------------------------------
    def _kill_worker_locked(self, widx: int, ticket: FleetTransfer
                            ) -> None:
        if widx not in self._dead_workers:
            # a sibling lane of an already-dead slot raising its own
            # kill must not double-count the slot's death — but its
            # ticket still needs the rebalance below
            self._dead_workers.add(widx)
            self.kill_log.append((widx, ticket.transfer_id))
            self.stats.worker_deaths.inc()
            trace.instant("fleet_worker_kill", ctx=ticket.trace_ctx,
                          worker=widx, transfer_id=ticket.transfer_id)
        logger.warning("fleet worker %d killed holding %s; rebalancing",
                       widx, ticket.transfer_id)
        self._rebalance_locked(ticket, widx)
        live = set(range(self._next_worker)) - self._dead_workers
        if not live and not self._stopped:
            # every slot is dead: spawn the floor replacement
            # UNCONDITIONALLY — a worker-less scheduler is permanently
            # wedged (later submits would be "admitted" with nobody to
            # ever pick them and drain() would block forever), whether
            # or not work is pending right now.  The autoscaling hint
            # asks for anything beyond this floor.
            widx_new = self._next_worker
            self._next_worker += 1
            logger.warning("fleet: all workers dead; spawning "
                           "replacement slot %d", widx_new)
            self._spawn_worker_locked(widx_new)
        self._cond.notify_all()

    def _rebalance_locked(self, ticket: FleetTransfer,
                          dead_worker: int) -> None:
        """Requeue an assigned ticket after its slot died (or its
        dispatch faulted).  The `fleet.rebalance` fault is ABSORBED —
        a failed rebalance RPC must never lose the transfer, so the
        requeue proceeds regardless and the fault only counts."""
        try:
            failpoint("fleet.rebalance")
        except Exception as e:
            logger.warning("fleet rebalance fault for %s (absorbed): %s",
                           ticket.transfer_id, e)
        tn = self._tenant_locked(ticket.tenant)
        tn.running -= 1
        self._running -= 1
        ticket.worker = None
        self.stats.rebalanced.inc()
        trace.instant("fleet_rebalance", ctx=ticket.trace_ctx,
                      transfer_id=ticket.transfer_id,
                      dead_worker=dead_worker,
                      attempt=ticket.attempts)
        LEDGER.add_for(ticket.transfer_id, tenant=ticket.tenant,
                       retries=1)
        self.rebalance_log.append(
            (ticket.transfer_id, dead_worker, ticket.attempts))
        if ticket.attempts >= self.max_attempts:
            ticket.state = "failed"
            ticket.finished_at = time.perf_counter()
            tn.failed += 1
            self.stats.failed.inc()
            self._terminal_locked(ticket)
            logger.error("fleet: %s failed after %d dispatch attempts",
                         ticket.transfer_id, ticket.attempts)
            self._cond.notify_all()
            return
        ticket.state = "queued"
        ticket.dispatched_at = 0.0
        ticket.queued_at = time.perf_counter()
        tn.push(ticket, front=True)
        if ticket.tenant not in self._active:
            self._active.appendleft(ticket.tenant)
        self._cond.notify_all()

    def _terminal_locked(self, ticket: FleetTransfer) -> None:
        """A ticket reached done/failed: count it out of the pending
        set and evict the oldest terminal tickets past the history
        bound (their run closures hold whole Transfer objects)."""
        self._pending -= 1
        self._terminal_order.append(ticket.transfer_id)
        while len(self._tickets) > self._history_limit \
                and self._terminal_order:
            old = self._terminal_order.popleft()
            t = self._tickets.get(old)
            if t is not None and t.state in ("done", "failed"):
                del self._tickets[old]

    # -- lanes ---------------------------------------------------------------
    def _lane_loop(self, widx: int) -> None:
        while True:
            try:
                ticket = self._next_dispatch(widx)
            except _WorkerDied:
                return
            if ticket is None:
                return
            try:
                self._run_ticket(widx, ticket)
            except BaseException as e:
                if is_worker_kill(e):
                    # the transfer died WITH its worker (OOM-kill, pod
                    # eviction mid-run): slot dies, ticket rebalances —
                    # the engine's at-least-once contract absorbs the
                    # partial delivery on the rerun
                    with self._cond:
                        self._kill_worker_locked(widx, ticket)
                        self._update_gauges_locked()
                    return
                self._finish(ticket, error=e)
            else:
                self._finish(ticket)

    def _run_ticket(self, widx: int, ticket: FleetTransfer) -> None:
        """Run one dispatched ticket under its trace + ledger scope:
        the engine's own spans (snapshot_op → part → batch → device)
        flow onto the ticket trace, and every resource the run burns
        bills (transfer_id, tenant) — queue wait included, so `trtpu
        top` shows where a slow transfer's seconds actually went."""
        with trace.adopted(ticket.trace_ctx), \
                LEDGER.context(transfer_id=ticket.transfer_id,
                               tenant=ticket.tenant):
            LEDGER.add(queue_wait_seconds=ticket.dispatch_latency)
            sp = trace.span("fleet_run",
                            transfer_id=ticket.transfer_id,
                            tenant=ticket.tenant, worker=widx,
                            attempt=ticket.attempts)
            with sp:
                ticket.run()

    def _finish(self, ticket: FleetTransfer,
                error: Optional[BaseException] = None) -> None:
        with self._cond:
            tn = self._tenant_locked(ticket.tenant)
            if error is not None and \
                    ticket.attempts < self.max_attempts:
                logger.warning("fleet: %s attempt %d failed (%s); "
                               "requeueing", ticket.transfer_id,
                               ticket.attempts, error)
                tn.running -= 1
                self._running -= 1
                ticket.error = error
                ticket.state = "queued"
                ticket.worker = None
                ticket.dispatched_at = 0.0
                ticket.queued_at = time.perf_counter()
                tn.push(ticket, front=True)
                if ticket.tenant not in self._active:
                    self._active.appendleft(ticket.tenant)
                self._update_gauges_locked()
                self._cond.notify_all()
                return
            tn.running -= 1
            self._running -= 1
            ticket.finished_at = time.perf_counter()
            ticket.worker = None
            if error is None:
                ticket.state = "done"
                tn.done += 1
                self.stats.completed.inc()
            else:
                ticket.state = "failed"
                ticket.error = error
                tn.failed += 1
                self.stats.failed.inc()
                logger.error("fleet: %s failed: %s",
                             ticket.transfer_id, error)
            self._terminal_locked(ticket)
            self._update_gauges_locked()
            self._cond.notify_all()

    # -- introspection / autoscaling ----------------------------------------
    def _update_gauges_locked(self) -> None:
        queued = sum(tn.queued for tn in self._tenants.values())
        self.stats.queue_depth.set(queued)
        self.stats.inflight.set(self._running)
        self.stats.desired_workers.set(self._desired_workers_locked())
        debts = [tn.debt() for tn in self._tenants.values()]
        self.stats.tenant_debt_max.set(max(debts) if debts else 0.0)

    def _desired_workers_locked(self) -> int:
        pending = self._running + sum(
            tn.queued for tn in self._tenants.values())
        per = self._lanes_per_worker
        return max(1, -(-pending // per))

    def refresh_gauges(self) -> None:
        """Recompute queue_depth/inflight/desired_workers NOW.  Called
        from the backpressure tick (and free for any poller): the
        gauges otherwise refresh on scheduler events (submit, dispatch,
        completion), and a fleet that went idle between events would
        keep advertising its last busy desired_workers value."""
        with self._lock:
            self._update_gauges_locked()

    def desired_workers(self) -> int:
        with self._lock:
            return self._desired_workers_locked()

    def live_workers(self) -> int:
        with self._lock:
            return len(set(range(self._next_worker))
                       - self._dead_workers)

    def counts(self) -> dict[str, int]:
        with self._lock:
            out = {"queued": 0, "running": self._running, "done": 0,
                   "failed": 0, "shed": 0}
            for tn in self._tenants.values():
                out["queued"] += tn.queued
                out["done"] += tn.done
                out["failed"] += tn.failed
                out["shed"] += tn.shed
            return out

    def snapshot(self) -> dict:
        """The /debug/fleet payload: admission state, per-tenant debt,
        autoscaling hints, dispatch latency percentiles."""
        with self._lock:
            lats = [v * 1000.0 for v in self.dispatch_latencies]
            tenants = {
                tn.name: {
                    "weight": tn.weight,
                    "queued": tn.queued,
                    "running": tn.running,
                    "done": tn.done,
                    "failed": tn.failed,
                    "shed": tn.shed,
                    "service": tn.service,
                    "debt": round(tn.debt(), 3),
                }
                for tn in sorted(self._tenants.values(),
                                 key=lambda t: t.name)
            }
            snap = {
                "name": self.name,
                "workers": {
                    "configured": self._n_workers,
                    "lanes_per_worker": self._lanes_per_worker,
                    "dead": sorted(self._dead_workers),
                    "live": (self._next_worker
                             - len(self._dead_workers)),
                },
                "queued": sum(tn.queued
                              for tn in self._tenants.values()),
                "running": self._running,
                "dispatched": len(self.dispatch_log),
                "rebalanced": len(self.rebalance_log),
                "double_admissions": len(self.double_admissions),
                "desired_workers": self._desired_workers_locked(),
                "tenants": tenants,
                "dispatch_latency_ms": {
                    "p50": round(percentile(lats, 0.50), 3),
                    "p99": round(percentile(lats, 0.99), 3),
                    "count": len(lats),
                },
            }
        if self.backpressure is not None:
            snap["backpressure"] = self.backpressure.snapshot()
        return snap
