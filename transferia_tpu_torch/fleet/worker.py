"""Fleet worker: a supervised process (or thread) that claims and runs
tickets from a durable coordinator queue (the port's copy of
``transferia_tpu/fleet/worker.py``).

`trtpu worker` (cli/main.py) runs one of these per process: the worker
pulls its next ticket with the shared WDRR pick (fleet/distributed.py),
claims it through the coordinator's fenced `claim_ticket`, runs the
described transfer through the REAL engine (SnapshotLoader — whose part
claims go through the part-lease machinery unchanged), and reports the
fenced completion.  Liveness is the same lease design as parts:

- a heartbeat thread renews the ticket lease every interval and folds
  the worker's phase into coordinator health; a crash (kill -9) stops
  the renewals, the lease expires, and a SURVIVOR reclaims the ticket —
  the transfer resumes from its committed parts;
- a renewal that comes back 0 while a ticket is held means the lease
  was REVOKED (preemption, fleet/distributed.py) — the worker yields at
  its next part boundary (`TransferPreemptedError` out of the loader)
  and moves on to the next pick, which is exactly the higher-priority
  arrival the revoke made room for;
- SIGTERM requests a graceful drain: same part-boundary yield, then the
  claim is released back to the queue and the process exits clean.

Tickets carry a JSON payload instead of a closure (callables can't
cross a process boundary); `RUNNERS` maps payload kinds to runners —
`sample_snapshot` (self-contained sample→memory transfers: benches,
chaos, smokes) and `transfer_yaml` (a transfer config on shared
storage).  `WorkerSupervisor` spawns/supervises workers in either
`thread` mode (tests, chaos determinism) or `process` mode (real
`trtpu worker` subprocesses) and is the actuator the elastic
autoscaler (fleet/autoscaler.py) drives.

`device` is where every ticket's snapshot does its device work (the
chain's fused mask and filter, the staged pushes' keys, the
fingerprint tap): None means CUDA, which must be present; "cpu" runs
the kernels' plain versions.  A kernel that fails to build or launch
fails the ticket like any other error of its run.
"""

from __future__ import annotations

import logging
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from transferia_tpu_torch.abstract.errors import (
    is_preemption,
    is_worker_kill,
)
from transferia_tpu_torch.abstract.ticket import FleetTicket, ticket_claimable
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.fleet.distributed import (
    DEFAULT_QUEUE,
    TICKET_TRACE_KEY,
    WdrrPicker,
)
from transferia_tpu_torch.stats import fleetobs, trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import DistributedFleetStats, Metrics

logger = logging.getLogger(__name__)

DEFAULT_HEARTBEAT_INTERVAL = 1.0
DEFAULT_TICKET_ATTEMPTS = 3   # claims before a failing ticket is failed
COMPLETE_RPC_ATTEMPTS = 5     # retries of the fenced completion RPC


class TicketRunContext:
    """What a payload runner gets next to the ticket: the coordinator
    (part claims, state), a preemption probe the snapshot loader polls
    at part boundaries, whether this claim is a RESUME (the ticket
    ran before — reuse the committed part queue instead of recreating
    it), and the device the run's kernels launch on."""

    def __init__(self, coordinator: Coordinator, metrics: Metrics,
                 preempted: Callable[[], bool], resume: bool,
                 worker_id: str, queue: str, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.coordinator = coordinator
        self.metrics = metrics
        self.preempted = preempted
        self.resume = resume
        self.worker_id = worker_id
        self.queue = queue


def _run_sample_snapshot(ticket: FleetTicket,
                         ctx: TicketRunContext) -> None:
    """Built-in payload: a sample→memory snapshot described entirely by
    the payload (rows/preset/sink/transformation) — the workload of the
    fleet bench, the chaos fleet_distributed mode, and the worker e2e
    smoke; no external services, runnable in any worker process."""
    from transferia_tpu_torch.models import Transfer, TransferType
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.sample import SampleSourceParams
    from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

    p = ticket.payload
    rows = int(p.get("rows", 1024))
    transfer = Transfer(
        id=ticket.transfer_id or ticket.ticket_id,
        type=TransferType.SNAPSHOT_ONLY,
        src=SampleSourceParams(
            preset=p.get("preset", "iot"),
            table=p.get("table", "events"),
            rows=rows,
            batch_rows=int(p.get("batch_rows", max(64, rows // 8))),
            shard_parts=int(p.get("shard_parts", 4))),
        dst=MemoryTargetParams(sink_id=p.get("sink_id",
                                             ticket.ticket_id)),
        transformation=p.get("transformation"),
        validation=p.get("validation"),
    )
    transfer.runtime.sharding.process_count = int(
        p.get("process_count", 1))
    SnapshotLoader(
        transfer, ctx.coordinator,
        operation_id=p.get("operation_id") or None,
        metrics=ctx.metrics, preempted=ctx.preempted,
        resume=ctx.resume, device=ctx.device,
    ).upload_tables()


def _run_transfer_yaml(ticket: FleetTicket,
                       ctx: TicketRunContext) -> None:
    """Payload: a transfer.yaml on storage every worker can reach.
    Snapshot-only — replication is an open-ended process, not a
    drainable queue item (run it under `trtpu replicate`)."""
    from transferia_tpu_torch.cli.config import load_transfer
    from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

    transfer = load_transfer(ticket.payload["path"])
    if transfer.type.has_replication:
        raise ValueError(
            f"ticket {ticket.ticket_id}: fleet tickets run snapshot "
            f"transfers; {transfer.id} has a replication phase")
    SnapshotLoader(
        transfer, ctx.coordinator,
        operation_id=ticket.payload.get("operation_id") or None,
        metrics=ctx.metrics, preempted=ctx.preempted,
        resume=ctx.resume, device=ctx.device,
    ).upload_tables()


def _run_mvcc_compact(ticket: FleetTicket,
                      ctx: TicketRunContext) -> None:
    """Payload: `{"scope", "table", "watermark"}` (mvcc/compact.py).
    SCAVENGER maintenance over an MVCC staging store — the scope
    resolves through the process-local registry, and a miss REBUILDS
    it from the spill manifest through this worker's coordinator
    (mvcc/spill.py): any fleet worker can run the ticket.  Only when
    nothing was ever spilled does the miss raise, so the lease hands
    the ticket to the worker holding the layers."""
    from transferia_tpu_torch.mvcc.compact import make_compact_runner
    from transferia_tpu_torch.mvcc.store import resolve_store

    make_compact_runner(resolve_store)(ticket, ctx)


RUNNERS: dict[str, Callable[[FleetTicket, TicketRunContext], None]] = {
    "sample_snapshot": _run_sample_snapshot,
    "transfer_yaml": _run_transfer_yaml,
    "mvcc_compact": _run_mvcc_compact,
}


class FleetWorker:
    """One worker: claim loop + lease heartbeat + graceful drain."""

    def __init__(self, coordinator: Coordinator,
                 queue: str = DEFAULT_QUEUE,
                 worker_index: int = 0,
                 metrics: Optional[Metrics] = None,
                 runners: Optional[dict] = None,
                 tenant_weights: Optional[dict[str, float]] = None,
                 quantum: float = 1.0,
                 heartbeat_interval: float = DEFAULT_HEARTBEAT_INTERVAL,
                 max_attempts: int = DEFAULT_TICKET_ATTEMPTS,
                 max_tickets: int = 0,
                 idle_exit_seconds: float = 0.0,
                 part_boundary_hook: "Optional[Callable[[FleetTicket, int], None]]" = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cp = coordinator
        self.queue = queue
        self.worker_index = worker_index
        self.worker_id = f"w{worker_index}"
        self.metrics = metrics or Metrics()
        self.stats = DistributedFleetStats(self.metrics)
        self.runners = dict(RUNNERS if runners is None else runners)
        self.picker = WdrrPicker(tenant_weights, quantum)
        self.heartbeat_interval = heartbeat_interval
        self.max_attempts = max_attempts
        self.max_tickets = max_tickets          # 0 = unbounded
        self.idle_exit_seconds = idle_exit_seconds  # 0 = run forever
        # chaos/test instrumentation: called at every part boundary of
        # the running ticket with (ticket, boundary index) BEFORE the
        # preemption probe — lets a trial fire a revoke at an exact,
        # replayable boundary instead of racing a wall clock
        self._part_boundary_hook = part_boundary_hook
        self._health_scope = f"fleet:{queue}"
        # lease-less mode (lease_seconds=0: claims never expire) makes
        # every renewal legitimately return 0 — that must not read as
        # a revocation or every ticket would false-yield each beat.
        # The coordinator may be wrapped (chaos AuditingCoordinator);
        # walk `.inner` to find the knob, defaulting to enabled.
        self._leases_enabled = True
        obj = coordinator
        for _ in range(4):
            ls = getattr(obj, "lease_seconds", None)
            if ls is not None:
                self._leases_enabled = ls > 0
                break
            obj = getattr(obj, "inner", None)
            if obj is None:
                break
        self._lock = threading.Lock()
        self._current: Optional[FleetTicket] = None
        self._revoked = False
        self._boundaries = 0
        self._draining = False
        self._dead = False
        self.tickets_run = 0
        # replay surface: (ticket_id, claim_epoch, stolen_from)
        self.claim_log: list[tuple] = []
        # fleet observability export stream (stats/fleetobs.py): this
        # worker AND every SnapshotLoader it runs (via the ambient
        # exporter around _run_ticket) share one (worker, seq) stream
        import os as _os

        self._obs = fleetobs.exporter_for(
            coordinator,
            worker=f"fleet.{self.worker_id}.{_os.getpid()}")

    # -- drain / liveness ----------------------------------------------------
    def request_drain(self) -> None:
        """SIGTERM path: yield the running transfer at its next part
        boundary, release the claim, exit the loop."""
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def dead(self) -> bool:
        return self._dead

    def _should_yield(self) -> bool:
        """The preemption probe the snapshot loader polls between
        parts: revoked lease (preemption / zombie fencing) or a drain
        request."""
        with self._lock:
            cur = self._current
            self._boundaries += 1
            boundary = self._boundaries
        if cur is not None and self._part_boundary_hook is not None:
            try:
                self._part_boundary_hook(cur, boundary)
            except Exception:
                logger.exception("part boundary hook failed")
        return self._revoked or self._draining

    # -- heartbeat -----------------------------------------------------------
    def _heartbeat_loop(self, stop: threading.Event) -> None:
        """Renew the held ticket's lease and report worker health.
        Transient failures are absorbed by the lease TTL; a
        WorkerKilledError kills the heartbeat — the worker becomes a
        zombie whose ticket a survivor reclaims after expiry.  A
        renewal of 0 for the held ticket means the lease was revoked
        or stolen: flag the yield.

        The renewal is scoped to the ticket captured BEFORE the RPC:
        (a) renewing by worker id alone would also renew a claim
        stranded by a dead predecessor that reused this index, wedging
        that ticket un-reclaimable forever; (b) comparing the result
        against a ticket claimed AFTER the RPC returned would flag a
        fresh claim as revoked."""
        while not stop.wait(self.heartbeat_interval):
            try:
                failpoint("worker.heartbeat")
                with self._lock:
                    held = self._current
                sp = trace.span("worker_heartbeat",
                                worker=self.worker_id)
                with sp:
                    renewed = 0
                    if held is not None:
                        # ticket AND epoch scoped: a same-id twin
                        # (pid-1 containers) must not renew this
                        # worker's claim nor have its own renewed here
                        renewed = self.cp.renew_ticket_leases(
                            self.queue, self.worker_id,
                            ticket_id=held.ticket_id,
                            claim_epoch=held.claim_epoch)
                if sp:
                    sp.add(renewed=renewed)
                with self._lock:
                    if held is not None and renewed == 0 \
                            and self._leases_enabled \
                            and self._current is held:
                        self._revoked = True
                self.cp.operation_health(
                    self._health_scope, self.worker_index, {
                        "state": ("draining" if self._draining else
                                  "running" if held is not None
                                  else "idle"),
                        "ticket": held.ticket_id if held else "",
                        "tickets_run": self.tickets_run,
                    })
                # observability export at heartbeat cadence: a kill -9
                # between beats loses at most one export interval
                self._obs.export("periodic")
            except Exception as e:
                if is_worker_kill(e):
                    logger.error(
                        "worker %s heartbeat killed: lease renewals "
                        "stop, the ticket will be reclaimed after "
                        "expiry", self.worker_id)
                    return
                logger.warning("worker %s heartbeat failed (lease TTL "
                               "absorbs it): %s", self.worker_id, e)

    # -- claim ---------------------------------------------------------------
    def _claim_next(self) -> Optional[FleetTicket]:
        """WDRR pick + fenced claim.  A lost claim race (another worker
        won the CAS) silently moves to the next candidate; a claim RPC
        fault (`fleet.claim`) is absorbed — the ticket stays claimable
        and this worker re-picks on its next loop."""
        sp = trace.span("fleet_claim_pick", worker=self.worker_id)
        with sp:
            tickets = self.cp.list_tickets(self.queue)
            now = time.time()
            claimable = [t for t in tickets
                         if ticket_claimable(t.to_json(), now)]
            excluded: set = set()
            while True:
                pool = [t for t in claimable
                        if t.ticket_id not in excluded]
                cand = self.picker.pick(pool)
                if cand is None:
                    return None
                try:
                    failpoint("fleet.claim")
                    won = self.cp.claim_ticket(
                        self.queue, cand.ticket_id, self.worker_id)
                except Exception as e:
                    logger.warning(
                        "worker %s claim of %s faulted (absorbed; "
                        "re-picking next loop): %s", self.worker_id,
                        cand.ticket_id, e)
                    return None
                if won is None:
                    excluded.add(cand.ticket_id)  # lost the race
                    continue
                self.picker.charge(won)
                if won.attempts == 1 and won.enqueued_at:
                    # distributed dispatch latency (enqueue → first
                    # claim, wall clock — the only shared axis across
                    # processes) into the mergeable histogram the obs
                    # segments export; re-claims after crash/preempt
                    # are recovery, not dispatch, and are excluded
                    from transferia_tpu_torch.stats import hdr

                    hdr.observe("fleet_dispatch",
                                max(0.0, time.time() - won.enqueued_at))
                self.stats.claimed.inc()
                if won.stolen_from:
                    self.stats.steals.inc()
                with self._lock:
                    self.claim_log.append(
                        (won.ticket_id, won.claim_epoch,
                         won.stolen_from))
                if sp:
                    sp.add(ticket=won.ticket_id,
                           epoch=won.claim_epoch,
                           stolen_from=won.stolen_from or "")
                return won

    # -- completion ----------------------------------------------------------
    def _complete(self, ticket: FleetTicket, error: str = "") -> bool:
        """Fenced completion with RPC-fault retries (`fleet.complete`):
        re-asking under the same epoch is idempotent; False means the
        fence rejected a zombie completion."""
        sp = trace.span("fleet_ticket_complete",
                        ticket_id=ticket.ticket_id,
                        epoch=ticket.claim_epoch, error=error or "")
        with sp:
            last: Optional[BaseException] = None
            for _ in range(COMPLETE_RPC_ATTEMPTS):
                try:
                    failpoint("fleet.complete")
                    ok = self.cp.complete_ticket(self.queue, ticket,
                                                 error=error)
                except Exception as e:
                    last = e
                    time.sleep(0.02)
                    continue
                if not ok:
                    self.stats.fenced.inc()
                    logger.warning(
                        "completion of %s (epoch %d) fenced: the "
                        "ticket was reclaimed or revoked",
                        ticket.ticket_id, ticket.claim_epoch)
                elif error:
                    self.stats.failed.inc()
                else:
                    self.stats.completed.inc()
                if sp:
                    sp.add(accepted=bool(ok))
                return bool(ok)
            logger.error("completion RPC for %s kept failing: %s",
                         ticket.ticket_id, last)
            return False

    def _release(self, ticket: FleetTicket,
                 failed: bool = False) -> None:
        try:
            ok = self.cp.release_ticket(self.queue, ticket,
                                        failed=failed)
        except Exception as e:
            # the lease TTL is the backstop: an unreleased claim is
            # reclaimed after expiry
            logger.warning("release of %s faulted (lease TTL will "
                           "reclaim): %s", ticket.ticket_id, e)
            return
        if ok:
            self.stats.released.inc()
        # not ok = already revoked/reclaimed: it is someone else's now

    # -- run -----------------------------------------------------------------
    def _run_ticket(self, ticket: FleetTicket) -> None:
        runner = self.runners.get(
            ticket.payload.get("kind", "sample_snapshot"))
        if runner is None:
            raise ValueError(
                f"ticket {ticket.ticket_id}: unknown payload kind "
                f"{ticket.payload.get('kind')!r}")
        ctx = TicketRunContext(
            coordinator=self.cp, metrics=self.metrics,
            preempted=self._should_yield,
            # a re-claim (crash reclaim, preemption, retry) RESUMES the
            # operation from its committed parts instead of recreating
            # the part queue
            resume=ticket.attempts > 1 or ticket.preemptions > 0,
            worker_id=self.worker_id, queue=self.queue,
            device=self.device)
        # cross-process causal link: the admitting scheduler stamped
        # its span context into the payload (fleet/distributed.py
        # TRACE_KEY) — adopting it parents this worker's run span onto
        # the SAME trace, so the merged fleet timeline shows admission
        # and run as one causally-linked story even across processes
        wctx = trace.parse_wire(
            ticket.payload.get(TICKET_TRACE_KEY, ""))
        sp = trace.span("fleet_ticket_run", ticket_id=ticket.ticket_id,
                        tenant=ticket.tenant, qos=ticket.qos,
                        worker=self.worker_id, epoch=ticket.claim_epoch,
                        attempt=ticket.attempts, resume=ctx.resume,
                        transfer_id=ticket.transfer_id
                        or ticket.ticket_id)
        with trace.adopted(wctx), sp, LEDGER.context(
                transfer_id=ticket.transfer_id or ticket.ticket_id,
                tenant=ticket.tenant), \
                fleetobs.ambient_exporter(self._obs):
            runner(ticket, ctx)

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """The worker main loop: claim → run → complete, until drained
        or stopped.  A WorkerKilledError anywhere kills the WORKER
        (claims left leased for reclamation); everything else is
        handled per ticket."""
        stop = stop or threading.Event()
        hb_stop = threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop,
                              args=(hb_stop,),
                              name=f"fleet-hb-{self.worker_id}",
                              daemon=True)
        hb.start()
        idle_since: Optional[float] = None
        try:
            while not stop.is_set() and not self._draining:
                if self.max_tickets and \
                        self.tickets_run >= self.max_tickets:
                    return
                ticket = self._claim_next()
                if ticket is None:
                    now = time.monotonic()
                    idle_since = idle_since or now
                    if self.idle_exit_seconds and \
                            now - idle_since >= self.idle_exit_seconds:
                        logger.info("worker %s idle %.1fs; exiting",
                                    self.worker_id,
                                    now - idle_since)
                        return
                    stop.wait(0.05)
                    continue
                idle_since = None
                with self._lock:
                    self._current = ticket
                    self._revoked = False
                    self._boundaries = 0
                try:
                    self._run_ticket(ticket)
                except BaseException as e:
                    if is_worker_kill(e):
                        # the worker dies WITH its claim: the lease
                        # strands and a survivor reclaims the ticket
                        self._dead = True
                        logger.error(
                            "worker %s killed running %s; ticket left "
                            "for reclamation", self.worker_id,
                            ticket.ticket_id)
                        return
                    if is_preemption(e):
                        # scheduler-initiated yield: NOT a failure —
                        # it must not burn the retry budget
                        self.stats.preempt_yields.inc()
                        trace.instant("fleet_preempt_yield",
                                      ticket_id=ticket.ticket_id,
                                      worker=self.worker_id)
                        self._release(ticket)
                    elif ticket.failures + 1 >= self.max_attempts:
                        logger.error(
                            "ticket %s failed %d time(s) over %d "
                            "claim(s): %s", ticket.ticket_id,
                            ticket.failures + 1, ticket.attempts, e)
                        self._complete(ticket, error=str(e) or
                                       type(e).__name__)
                    else:
                        logger.warning(
                            "ticket %s failure %d/%d (%s); releasing "
                            "for retry", ticket.ticket_id,
                            ticket.failures + 1, self.max_attempts, e)
                        self._release(ticket, failed=True)
                else:
                    self.tickets_run += 1
                    self._complete(ticket)
                finally:
                    with self._lock:
                        self._current = None
                        self._revoked = False
                    # ticket boundary export: the finished (or failed/
                    # yielded) ticket's spend is durable before the
                    # next claim
                    self._obs.export("ticket")
            # graceful drain: nothing claimed at this point (the yield
            # path released before we got here)
        finally:
            hb_stop.set()
            hb.join(timeout=5.0)
            if not self._dead:
                # SIGTERM-drain / idle-exit flush; a KILLED worker
                # deliberately does NOT flush — that is the crash whose
                # last heartbeat-cadence export the plane survives on
                self._obs.export("final")
            self.stats.worker_exits.inc()


def queue_busy_probe(coordinator: Coordinator,
                     queue: str) -> Callable[[int], bool]:
    """A WorkerSupervisor `busy_probe` answered from the durable
    queue: worker index N is busy iff some claimed ticket names it —
    the only view of a subprocess's state the supervisor has."""
    def probe(index: int) -> bool:
        wid = f"w{index}"
        return any(t.state == "claimed" and t.claimed_by == wid
                   for t in coordinator.list_tickets(queue))

    return probe


# -- supervision --------------------------------------------------------------

class _Handle:
    __slots__ = ("index", "worker", "thread", "stop", "proc",
                 "draining")

    def __init__(self, index, worker=None, thread=None, stop=None,
                 proc=None):
        self.index = index
        self.worker = worker
        self.thread = thread
        self.stop = stop
        self.proc = proc
        self.draining = False

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return bool(self.thread and self.thread.is_alive())


def worker_argv(coordinator_args: list[str], queue: str,
                worker_index: int,
                idle_exit_seconds: float = 0.0,
                log_level: str = "warning",
                device: str = "cuda") -> list[str]:
    """The `trtpu worker` command line for a supervised subprocess.
    `coordinator_args` are the global --coordinator* flags (a memory
    coordinator cannot cross a process boundary — use filestore/s3)."""
    argv = [sys.executable, "-m", "transferia_tpu_torch.cli.main",
            "--device", device,
            "--log-level", log_level, *coordinator_args,
            "worker", "--queue", queue,
            "--worker-index", str(worker_index)]
    if idle_exit_seconds:
        argv += ["--idle-exit", str(idle_exit_seconds)]
    return argv


class WorkerSupervisor:
    """Spawn/supervise fleet workers; the autoscaler's actuator.

    `thread` mode runs FleetWorker instances on daemon threads (tests,
    chaos determinism, single-host fleets over a memory coordinator);
    `process` mode spawns real `trtpu worker` subprocesses from
    `spawn_argv(index)` (filestore/s3 coordinator required).  `reap()`
    collects exited workers; `scale_to(n)` spawns or drains toward a
    target; a crashed (not drained) worker is replaced on the next
    `scale_to`/`ensure` because it no longer counts as live.
    """

    def __init__(self, mode: str = "thread",
                 worker_factory: "Optional[Callable[[int], FleetWorker]]" = None,
                 spawn_argv: "Optional[Callable[[int], list[str]]]" = None,
                 busy_probe: "Optional[Callable[[int], bool]]" = None,
                 metrics: Optional[Metrics] = None,
                 name: str = "fleet-sup"):
        if mode == "thread" and worker_factory is None:
            raise ValueError("thread mode needs worker_factory")
        if mode == "process" and spawn_argv is None:
            raise ValueError("process mode needs spawn_argv")
        self.mode = mode
        self.name = name
        self.worker_factory = worker_factory
        self.spawn_argv = spawn_argv
        # process mode can't see a subprocess's in-memory state; the
        # probe answers "is worker index N running a ticket?" from the
        # durable queue (any claimed ticket with claimed_by == wN) so
        # scale-down drains an IDLE worker there too.  None = process
        # mode retires the newest worker regardless (its SIGTERM drain
        # is still graceful — part-boundary yield + release).
        self.busy_probe = busy_probe
        self.metrics = metrics or Metrics()
        self.stats = DistributedFleetStats(self.metrics)
        self._lock = threading.Lock()
        self._handles: list[_Handle] = []
        self._next_index = 0
        self.spawn_log: list[int] = []

    # -- spawn / retire ------------------------------------------------------
    def spawn(self) -> int:
        """Start one worker; returns its index.  The `worker.spawn`
        fault surfaces to the caller — the autoscaler logs and retries
        on its next step."""
        with self._lock:
            index = self._next_index
            self._next_index += 1
        sp = trace.span("worker_spawn", worker=index, mode=self.mode)
        with sp:
            failpoint("worker.spawn")
            if self.mode == "thread":
                worker = self.worker_factory(index)
                stop = threading.Event()
                th = threading.Thread(
                    target=worker.run, args=(stop,),
                    name=f"{self.name}-w{index}", daemon=True)
                handle = _Handle(index, worker=worker, thread=th,
                                 stop=stop)
                th.start()
            else:
                proc = subprocess.Popen(self.spawn_argv(index))
                handle = _Handle(index, proc=proc)
            with self._lock:
                self._handles.append(handle)
                self.spawn_log.append(index)
            self.stats.worker_spawns.inc()
            logger.info("supervisor %s spawned worker %d (%s)",
                        self.name, index, self.mode)
            return index

    def retire_one(self) -> Optional[int]:
        """Drain the newest idle live worker (scale-down).  Returns its
        index, or None when every live worker is busy."""
        with self._lock:
            candidates = [h for h in self._handles
                          if h.alive() and not h.draining]
        for h in reversed(candidates):
            if self.mode == "thread" and h.worker is not None:
                if h.worker._current is not None:
                    continue  # busy: drain an idle one instead
                h.worker.request_drain()
                h.stop.set()
            else:
                if self.busy_probe is not None:
                    try:
                        if self.busy_probe(h.index):
                            continue  # busy: drain an idle one instead
                    except Exception as e:
                        logger.warning("busy probe for worker %d "
                                       "failed (retiring anyway): %s",
                                       h.index, e)
                import signal as _signal

                try:
                    h.proc.send_signal(_signal.SIGTERM)
                except OSError:
                    continue
            h.draining = True
            trace.instant("worker_retire", worker=h.index)
            logger.info("supervisor %s draining worker %d",
                        self.name, h.index)
            return h.index
        return None

    def reap(self) -> int:
        """Drop exited workers from the live set; returns how many were
        reaped."""
        with self._lock:
            dead = [h for h in self._handles if not h.alive()]
            self._handles = [h for h in self._handles if h.alive()]
        for h in dead:
            logger.info("supervisor %s reaped worker %d%s", self.name,
                        h.index,
                        " (drained)" if h.draining else " (crashed)")
        return len(dead)

    def scale_to(self, target: int) -> None:
        """Move live worker count toward `target`: spawn up, drain
        down.  One drain per call (scale-down is deliberately gradual);
        spawn failures stop the scale-up for this call."""
        target = max(0, target)
        self.reap()
        while self.live_workers() < target:
            try:
                self.spawn()
            except Exception as e:
                logger.warning("supervisor %s spawn failed (autoscaler "
                               "retries next step): %s", self.name, e)
                return
        if self.live_workers() > target:
            self.retire_one()

    # -- introspection -------------------------------------------------------
    def live_workers(self) -> int:
        with self._lock:
            return sum(1 for h in self._handles
                       if h.alive() and not h.draining)

    def draining_workers(self) -> int:
        with self._lock:
            return sum(1 for h in self._handles
                       if h.alive() and h.draining)

    def handles(self) -> list[_Handle]:
        with self._lock:
            return list(self._handles)

    def snapshot(self) -> dict:
        with self._lock:
            workers = []
            for h in self._handles:
                running = ""
                if self.mode == "thread" and h.worker is not None:
                    # single read: _current can flip to None under us
                    cur = h.worker._current
                    running = cur.ticket_id if cur is not None else ""
                workers.append({"index": h.index, "alive": h.alive(),
                                "draining": h.draining,
                                "running": running})
        return {
            "mode": self.mode,
            "live": sum(1 for w in workers
                        if w["alive"] and not w["draining"]),
            "draining": sum(1 for w in workers
                            if w["alive"] and w["draining"]),
            "spawned": len(self.spawn_log),
            "workers": workers,
        }

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain everything and wait."""
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            if self.mode == "thread":
                if h.worker is not None:
                    h.worker.request_drain()
                if h.stop is not None:
                    h.stop.set()
            elif h.proc is not None and h.proc.poll() is None:
                import signal as _signal

                try:
                    h.proc.send_signal(_signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for h in handles:
            remain = max(0.1, deadline - time.monotonic())
            if h.thread is not None:
                h.thread.join(timeout=remain)
            elif h.proc is not None:
                try:
                    h.proc.wait(timeout=remain)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
        self.reap()
