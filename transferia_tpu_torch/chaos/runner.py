"""Seeded chaos trials over the built-in sample transfers (the port's
copy of ``transferia_tpu/chaos/runner.py``).

`trtpu chaos` (cli/main.py) drives this module: for each trial it arms
a seed-derived fault schedule across the instrumented sites, runs the
built-in snapshot (sample -> memory) and/or replication (mq -> memory)
transfer through the REAL engine paths (SnapshotLoader with part
retries, run_replication with the restart loop, the full sink
middleware stack), then audits the target against a fault-free
reference run with the delivery invariants (chaos/invariants.py).

Everything is derived from `--seed`: the per-trial schedule (which
sites are armed, their after/every/times triggers, torn-write
fractions) comes from `random.Random(f"{seed}:{mode}:{trial}")`, and
the armed failpoints draw from per-site PRNGs seeded the same way — so
a failing trial replays exactly with its seed.

Trials shrink the retry backoff constants (middlewares Retrier, part
retry) for the duration of the run: the schedule and the recovery
machinery are under test, not the production sleep lengths.

In the port every trial runs on one device, which `run_trials` resolves
once: CUDA unless the caller passes `device="cpu"`, and without a card
it raises.  The fused mask+filter step is forced to its device placement
on that device (the kernels on a card, their plain versions on the
CPU), so the `device.dispatch` site is on every snapshot-shaped trial's
path and the schedules are letter for letter the reference's.  The row
keys of every audit run on the same device (K10 in keys mode).

What waits under ROADMAP.md A7 is reported skipped, never passed: the
`arrow_ipc` mode and exactly-once backend (pyarrow), the `ydb`
backend (no YDB provider yet; chaos/wire_backends.py), and the S&I pump
scenario, whose crash rebuild needs the MVCC spill (`mvcc/spill.py`,
pyarrow).
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.chaos import failpoints
from transferia_tpu_torch.chaos.invariants import (
    AuditingCoordinator,
    AuditVerdict,
    DeliveryReference,
    MonotonicityTracker,
    Violation,
    audit_delivery,
)
from transferia_tpu_torch.coordinator.memory import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

SNAPSHOT_ROWS = 4096
REPLICATION_MESSAGES = 300
TRIAL_TIMEOUT = 60.0
MAX_SNAPSHOT_RUNS = 6  # outer re-activations after coordinator faults
# worker_crash mode: tiny leases so reclamation happens at trial speed
TRIAL_LEASE_SECONDS = 0.25
TRIAL_HEARTBEAT_INTERVAL = 0.05

# sites armed per mode (subset of chaos/sites.py that sits on each
# trial's actual path; `spec=` on the CLI overrides the whole schedule)
SNAPSHOT_SITES = (
    "storage.part.open",
    "storage.part.read",
    "transform.chain",
    "device.dispatch",
    "sink.push",
    "sink.push.torn",
    "coordinator.set_op_state",
)
REPLICATION_SITES = (
    "replication.pump",
    "parsequeue.parse",
    "transform.chain",
    "sink.push",
    "sink.push.torn",
)
ARROW_IPC_SITES = (
    "interchange.ipc.read",
    "flight.substream",
    "region.seal",
    "transform.chain",
    "device.dispatch",
    "sink.push",
    "sink.push.torn",
    "coordinator.set_op_state",
)


@dataclass
class TrialResult:
    mode: str
    trial: int
    seed: int
    spec: str
    verdict: AuditVerdict
    fire_counts: dict[str, int] = field(default_factory=dict)
    fire_log: dict[str, list[int]] = field(default_factory=dict)
    restarts: int = 0
    seconds: float = 0.0
    # worker_crash mode: deliberate worker deaths, the reclaim log
    # [(part key, dead worker, new epoch)], and fenced zombie updates
    kills: int = 0
    steal_log: list = field(default_factory=list)
    fence_rejected: int = 0
    # scheduler_kill mode: the fleet dispatch order (ticket ids) — the
    # per-seed replay surface alongside fire_log/steal_log
    dispatch_order: list = field(default_factory=list)
    # exactly_once mode: which staged-commit sink backend the trial ran
    # against, the coordinator's commit-decision log [(part key, epoch,
    # granted)] — the third per-seed replay surface — and rows the
    # staging dedup window dropped before publish
    backend: str = ""
    commit_log: list = field(default_factory=list)
    dedup_dropped: int = 0
    # fleet_distributed mode: preemption revokes observed (the claim /
    # admission logs ride in steal_log / dispatch_order)
    preempts: int = 0
    # scenarios of the trial that did not run, each with its reason
    # (the S&I pump scenario: ROADMAP.md A7)
    skipped: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return self.verdict.passed

    def to_dict(self) -> dict:
        return {
            "mode": self.mode, "trial": self.trial, "seed": self.seed,
            "spec": self.spec, "passed": self.passed,
            "restarts": self.restarts,
            "seconds": round(self.seconds, 3),
            "kills": self.kills,
            "steal_log": [list(s) for s in self.steal_log],
            "fence_rejected": self.fence_rejected,
            "dispatch_order": list(self.dispatch_order),
            "backend": self.backend,
            "commit_log": [list(c) for c in self.commit_log],
            "dedup_dropped": self.dedup_dropped,
            "preempts": self.preempts,
            "skipped": list(self.skipped),
            "fire_counts": {k: v for k, v in self.fire_counts.items()
                            if v},
            "fire_log": {k: v for k, v in self.fire_log.items() if v},
            "violations": [str(v) for v in self.verdict.violations],
            "delivered_rows": self.verdict.delivered_rows,
            "duplicate_rows": self.verdict.duplicate_rows,
        }


@dataclass
class ChaosReport:
    results: list[TrialResult] = field(default_factory=list)
    # what run_trials left out, as {"what": ..., "reason": ...}; a skip
    # never counts as a passed trial
    skipped: list[dict] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return bool(self.results) and all(r.passed for r in self.results)

    def sites_fired(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.results:
            for site, n in r.fire_counts.items():
                if n:
                    out[site] = out.get(site, 0) + n
        return out

    def to_dict(self) -> dict:
        return {
            "passed": self.passed,
            "trials": len(self.results),
            "failed_trials": [r.trial for r in self.results
                              if not r.passed],
            "sites_fired": self.sites_fired(),
            "skipped": [dict(s) for s in self.skipped],
            "results": [r.to_dict() for r in self.results],
        }

    def format_summary(self) -> str:
        lines = []
        by_mode: dict[str, list[TrialResult]] = {}
        for r in self.results:
            by_mode.setdefault(r.mode, []).append(r)
        for mode, rs in sorted(by_mode.items()):
            ok = sum(1 for r in rs if r.passed)
            dup = sum(r.verdict.duplicate_rows for r in rs)
            restarts = sum(r.restarts for r in rs)
            line = (f"{mode}: {ok}/{len(rs)} trials passed, "
                    f"{restarts} restart(s), {dup} duplicate row(s) "
                    f"absorbed")
            if mode == "worker_crash":
                kills = sum(r.kills for r in rs)
                steals = sum(len(r.steal_log) for r in rs)
                fenced = sum(r.fence_rejected for r in rs)
                line += (f", {kills} worker(s) killed, {steals} part(s) "
                         f"reclaimed, {fenced} zombie update(s) fenced")
            if mode == "scheduler_kill":
                kills = sum(r.kills for r in rs)
                rebalances = sum(len(r.steal_log) for r in rs)
                line += (f", {kills} worker slot(s) killed, "
                         f"{rebalances} transfer(s) rebalanced")
            if mode == "fleet_distributed":
                kills = sum(r.kills for r in rs)
                steals = sum(
                    1 for r in rs for c in r.steal_log if c[3])
                preempts = sum(r.preempts for r in rs)
                line += (f", {kills} worker(s) killed, {steals} "
                         f"ticket(s) reclaimed, {preempts} "
                         f"preemption(s), logs replayed x2")
            if mode == "snapshot_and_increment":
                kills = sum(r.kills for r in rs)
                fenced = sum(r.fence_rejected for r in rs)
                cutovers = sum(
                    1 for r in rs for c in r.commit_log if c[2])
                line += (f", {kills} injected abort(s) retried, "
                         f"{cutovers} cutover(s) sealed, {fenced} "
                         f"zombie publish(es) fenced, logs replayed x2")
            if mode == "exactly_once":
                kills = sum(r.kills for r in rs)
                steals = sum(len(r.steal_log) for r in rs)
                fenced = sum(r.fence_rejected for r in rs)
                granted = sum(
                    1 for r in rs for c in r.commit_log if c[2])
                dedup = sum(r.dedup_dropped for r in rs)
                backends = sorted({r.backend for r in rs if r.backend})
                line += (f" [{'/'.join(backends)}], {kills} worker(s) "
                         f"killed, {steals} part(s) reclaimed, "
                         f"{granted} publish(es) granted, {fenced} "
                         f"stale publish(es) fenced, {dedup} replayed "
                         f"row(s) dropped pre-publish")
            lines.append(line)
            for r in rs:
                if not r.passed:
                    lines.append(f"  trial {r.trial} (seed {r.seed}"
                                 f"{', ' + r.backend if r.backend else ''}"
                                 f") FAILED [{r.spec}]")
                    for v in r.verdict.violations:
                        lines.append(f"    - {v}")
        for sk in self.skipped:
            lines.append(f"skipped (not run, not counted): {sk['what']} "
                         f"-- {sk['reason']}")
        fired = self.sites_fired()
        lines.append(f"sites fired: {len(fired)}")
        for site, n in sorted(fired.items()):
            lines.append(f"  {site}: {n}")
        verdict = "PASS" if self.passed else "FAIL"
        lines.append(f"chaos verdict: {verdict}")
        return "\n".join(lines)


@contextlib.contextmanager
def _fast_retries():
    """Shrink retry sleeps and snapshot deadlines for trial wall time
    (restored on exit).  The schedules and the liveness machinery are
    under test, not the production sleep lengths: leases/heartbeats run
    at millisecond scale so a 20-trial run finishes in seconds."""
    from transferia_tpu_torch.middlewares import sync as sync_mod
    from transferia_tpu_torch.tasks import snapshot as snapshot_mod

    old_sink = sync_mod.RETRY_BASE_DELAY
    old_part = snapshot_mod.PART_RETRY_BASE_DELAY
    old_tuning = snapshot_mod.TUNING
    sync_mod.RETRY_BASE_DELAY = 0.01
    snapshot_mod.PART_RETRY_BASE_DELAY = 0.01
    snapshot_mod.TUNING = snapshot_mod.SnapshotTuning(
        secondary_bootstrap_timeout=10.0,
        wait_poll=0.02,
        wait_timeout=TRIAL_TIMEOUT,
        stall_timeout=3.0,
        heartbeat_interval=TRIAL_HEARTBEAT_INTERVAL,
    )
    try:
        yield
    finally:
        sync_mod.RETRY_BASE_DELAY = old_sink
        snapshot_mod.PART_RETRY_BASE_DELAY = old_part
        snapshot_mod.TUNING = old_tuning


@contextlib.contextmanager
def _forced_device_placement():
    """Route the fused mask+filter chain through its device placement so
    the device.dispatch site sits on the trial path (the kernels on a
    card, their plain versions on the CPU); restored on exit.  Yields
    whether the fused step runs: only `TRANSFERIA_TPU_DEVICE=0` turns it
    off, as in the reference.  Nothing here swallows an error: a missing
    card has already raised in `run_trials`."""
    from transferia_tpu_torch.transform.fused import (
        device_fusion_enabled,
        placement_mode,
        set_placement,
    )

    if not device_fusion_enabled():
        yield False
        return
    prev = placement_mode()
    set_placement("device")
    try:
        yield True
    finally:
        set_placement(prev)


# -- schedules ---------------------------------------------------------------

def default_schedule(mode: str, trial: int, seed: int,
                     device_ok: bool = True) -> str:
    """Derive one trial's spec string from the seed.  Count-based
    triggers only (after/every/times): the fire sequence is then exact
    per site-hit-index, which is what `--seed` replay promises."""
    rng = random.Random(f"{seed}:{mode}:{trial}")
    sites = {
        "snapshot": SNAPSHOT_SITES,
        "replication": REPLICATION_SITES,
        "arrow_ipc": ARROW_IPC_SITES,
    }.get(mode, SNAPSHOT_SITES)
    clauses = []
    for site in sites:
        if site == "device.dispatch" and not device_ok:
            continue
        if site == "sink.push.torn":
            frac = rng.choice((0.25, 0.5, 0.75))
            clauses.append(
                f"{site}=after:{rng.randrange(0, 3)},times:1,"
                f"truncate:{frac}")
            continue
        # low-traffic sites (a handful of hits per attempt) need small
        # `after` gates or they never fire; the whole replication
        # pipeline is low-traffic (a 300-message topic drains in ~one
        # fetched batch per partition per attempt)
        low_traffic = mode in ("replication", "arrow_ipc") or site in (
            "coordinator.set_op_state", "storage.part.open")
        after = rng.randrange(0, 3 if low_traffic else 8)
        times = 1 if low_traffic else rng.randrange(1, 3)
        err = rng.choice(("ConnectionError", "TimeoutError",
                          "ChaosInjectedError"))
        if site == "transform.chain" and rng.random() < 0.3:
            clauses.append(f"{site}=after:{after},times:{times},delay:2")
        else:
            clauses.append(
                f"{site}=after:{after},times:{times},raise:{err}")
    return ";".join(clauses)


# -- snapshot mode -----------------------------------------------------------

def _snapshot_transfer(rows: int, sink_id: str, dst=None) -> Transfer:
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.sample import SampleSourceParams

    t = Transfer(
        id="chaos-snapshot",
        type=TransferType.SNAPSHOT_ONLY,
        src=SampleSourceParams(preset="iot", table="events", rows=rows,
                               batch_rows=max(64, rows // 8),
                               shard_parts=4),
        dst=dst if dst is not None else MemoryTargetParams(
            sink_id=sink_id),
        transformation={"transformers": [
            {"mask_field": {"columns": ["device_id"], "salt": "chaos"}},
            {"filter_rows": {"filter": "temperature > -1000"}},
        ]},
        validation={"fingerprint": True},
    )
    # single upload worker: part claim order (and so per-site hit
    # order) is deterministic, which --seed replay relies on
    t.runtime.sharding.process_count = 1
    return t


def _run_snapshot_once(transfer, cp, device: DeviceLike) -> None:
    from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

    SnapshotLoader(transfer, cp, device=device).upload_tables()


def _snapshot_reference(rows: int,
                        device: DeviceLike = None) -> DeliveryReference:
    from transferia_tpu_torch.providers.memory import get_store

    store = get_store("chaos-snap-ref")
    store.clear()
    _run_snapshot_once(_snapshot_transfer(rows, "chaos-snap-ref"),
                       MemoryCoordinator(), device)
    ref = DeliveryReference.from_batches(store.batches, device)
    store.clear()
    return ref


def run_snapshot_trial(trial: int, seed: int, rows: int,
                       reference: DeliveryReference,
                       spec: Optional[str] = None,
                       device_ok: bool = True,
                       device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.providers.memory import get_store
    from transferia_tpu_torch.tasks.snapshot import PART_RETRIES

    sink_id = "chaos-snap-trial"
    store = get_store(sink_id)
    store.clear()
    spec = spec if spec is not None else default_schedule(
        "snapshot", trial, seed, device_ok)
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(MemoryCoordinator(), tracker)
    transfer = _snapshot_transfer(rows, sink_id)
    restarts = 0
    run_error: Optional[BaseException] = None
    t0 = time.monotonic()
    with failpoints.active(spec, seed=seed * 1000 + trial):
        # the outer re-activation loop an operator/controller provides
        # in production: coordinator faults kill a whole run, and the
        # at-least-once contract is exactly that re-running is safe
        for attempt in range(MAX_SNAPSHOT_RUNS):
            try:
                _run_snapshot_once(transfer, cp, device)
                run_error = None
                break
            except Exception as e:
                run_error = e
                restarts += 1
                logger.info("chaos snapshot run %d failed (%s); "
                            "re-activating", attempt + 1, e)
        fires = failpoints.fire_counts()
        log = failpoints.fire_log()
    seconds = time.monotonic() - t0
    from transferia_tpu_torch.middlewares.sync import SINK_PUSH_ATTEMPTS

    # sink Retrier x part retries x completed runs
    bound = (restarts + 1) * PART_RETRIES * SINK_PUSH_ATTEMPTS
    verdict = audit_delivery(reference, store.batches, bound, tracker,
                             device=device)
    if run_error is not None:
        verdict.passed = False
        verdict.violations.append(Violation(
            "run-completed",
            f"snapshot never completed in {MAX_SNAPSHOT_RUNS} runs: "
            f"{run_error}"))
    store.clear()
    return TrialResult(mode="snapshot", trial=trial, seed=seed,
                       spec=spec, verdict=verdict, fire_counts=fires,
                       fire_log=log, restarts=restarts, seconds=seconds)


# -- arrow_ipc mode ----------------------------------------------------------
#
# The reference audits the same snapshot over an `arrow_ipc` stream
# directory and drives the Flight substreams and shm regions under the
# schedule.  That plane needs pyarrow, which the port does not import:
# `run_trials` reports the mode as skipped (ROADMAP.md A7).  Its site
# list stays, so `default_schedule("arrow_ipc", ...)` gives the
# reference's strings.

ARROW_IPC_SKIPPED = ("ROADMAP.md A7: the Arrow interchange plane "
                     "(interchange/, the arrow_ipc provider) needs "
                     "pyarrow, which the port does not import (blocked)")


# -- worker_crash mode -------------------------------------------------------
#
# Kills a sharded-secondary worker mid-part and proves the lease plane
# recovers: the dead worker's lease expires, a surviving worker reclaims
# and completes the part (real assign/steal path), the sharded main's
# join observes completion, and a zombie replay of the dead worker's
# completion is fenced by its stale assignment epoch.
#
# Determinism: the victim uploads ALONE (the runner plays the main's
# control-plane role: split + publish parts), so its batch sequence —
# and therefore which part is mid-flight when `snapshot.part.batch`
# fires — is a pure function of the seed.  The survivor starts only
# after the victim is dead, so the steal log replays exactly.

def worker_crash_schedule(trial: int, seed: int) -> str:
    """Seed-derived spec: a kill-worker action at a seeded batch index,
    plus (sometimes) transient lease-renewal failures the heartbeat must
    absorb without anyone dying."""
    rng = random.Random(f"{seed}:worker_crash:{trial}")
    clauses = [
        # 4 parts x 2 batches = 8 victim batch hits; after<=5 guarantees
        # the kill fires mid-queue with work left for the survivor
        f"snapshot.part.batch=after:{rng.randrange(0, 6)},times:1,"
        f"raise:WorkerKilledError",
    ]
    if rng.random() < 0.5:
        clauses.append(
            f"snapshot.lease_renew=after:{rng.randrange(0, 2)},times:1,"
            f"raise:ChaosInjectedError")
    return ";".join(clauses)


def run_worker_crash_trial(trial: int, seed: int, rows: int,
                           reference: DeliveryReference,
                           spec: Optional[str] = None,
                           device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.abstract.errors import is_worker_kill
    from transferia_tpu_torch.abstract.table import OperationTablePart
    from transferia_tpu_torch.chaos.invariants import fencing_violations
    from transferia_tpu_torch.factories import new_storage
    from transferia_tpu_torch.middlewares.sync import SINK_PUSH_ATTEMPTS
    from transferia_tpu_torch.providers.memory import get_store
    from transferia_tpu_torch.stats.registry import LeaseStats, Metrics
    from transferia_tpu_torch.tasks.snapshot import (
        PART_RETRIES,
        SnapshotLoader,
    )
    from transferia_tpu_torch.tasks.table_splitter import split_tables

    sink_id = "chaos-crash-trial"
    store = get_store(sink_id)
    store.clear()
    spec = spec if spec is not None else worker_crash_schedule(trial, seed)
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(
        MemoryCoordinator(lease_seconds=TRIAL_LEASE_SECONDS), tracker)
    op_id = "op-chaos-crash"
    metrics = Metrics()
    lease_stats = LeaseStats(metrics)

    def mk_transfer(job: int):
        t = _snapshot_transfer(rows, sink_id)
        t.id = "chaos-crash"
        t.runtime.current_job = job
        t.runtime.sharding.job_count = 3
        return t

    def mk_loader(job: int) -> SnapshotLoader:
        return SnapshotLoader(mk_transfer(job), cp, operation_id=op_id,
                              metrics=metrics, device=device)

    # the main's control-plane role: split and publish the part queue
    # (keeping the main out of the claim pool keeps the victim's batch
    # sequence deterministic; its join loop is exercised below)
    main_t = mk_transfer(0)
    storage = new_storage(main_t, metrics)
    try:
        tables = mk_loader(0).filtered_table_list(storage)
        parts = split_tables(storage, tables, main_t, op_id)
    finally:
        storage.close()
    cp.create_operation_parts(op_id, parts)
    cp.set_operation_state(op_id, {"parts_discovery_done": True})

    def run_loader(job: int, errs: list):
        try:
            mk_loader(job).upload_tables()
        except BaseException as e:
            errs.append(e)

    violations: list[Violation] = []
    kills = 0
    fence_rejected = 0
    t0 = time.monotonic()
    with failpoints.active(spec, seed=seed * 1000 + trial):
        # phase 1: the victim secondary drains the queue alone until the
        # armed kill fires mid-part
        victim_errs: list = []
        vt = threading.Thread(target=run_loader, args=(1, victim_errs),
                              name="chaos-victim", daemon=True)
        vt.start()
        vt.join(TRIAL_TIMEOUT)
        victim_killed = bool(victim_errs) and is_worker_kill(
            victim_errs[0])
        kills = int(victim_killed)
        if victim_errs and not victim_killed:
            violations.append(Violation(
                "run-completed",
                f"victim died of a non-kill error: {victim_errs[0]}"))
        # the victim's mid-flight parts: leased to worker 1, incomplete
        inflight = [p for p in cp.operation_parts(op_id)
                    if not p.completed and p.worker_index == 1]
        if victim_killed and not inflight:
            violations.append(Violation(
                "worker-crash",
                "victim died but left no leased in-flight part"))
        # phase 2: a surviving secondary drains the rest — including the
        # victim's parts once their leases expire (real reclaim path)
        survivor_errs: list = []
        st = threading.Thread(target=run_loader, args=(2, survivor_errs),
                              name="chaos-survivor", daemon=True)
        st.start()
        st.join(TRIAL_TIMEOUT)
        if survivor_errs:
            violations.append(Violation(
                "run-completed",
                f"survivor failed: {survivor_errs[0]}"))
        # phase 3: the sharded main's join must observe completion fast
        # (lease-aware wait), not spin out its timeout
        try:
            mk_loader(0)._wait_all_parts_done()
        except Exception as e:
            violations.append(Violation(
                "main-join", f"main wait failed: {e}"))
        # phase 4: the zombie wakes — replay the dead worker's
        # completion with its stale epoch; the fence must reject it
        for p in inflight:
            zombie = OperationTablePart.from_json(p.to_json())
            zombie.completed = True
            zombie.completed_rows = 1
            rejected = cp.update_operation_parts(op_id, [zombie])
            fence_rejected += len(rejected)
            if not rejected:
                violations.append(Violation(
                    "epoch-fencing",
                    f"zombie completion of {zombie.key()} (epoch "
                    f"{zombie.assignment_epoch}) was accepted"))
        lease_stats.fence_rejected.inc(fence_rejected)
        fires = failpoints.fire_counts()
        log = failpoints.fire_log()
    seconds = time.monotonic() - t0

    final_parts = cp.operation_parts(op_id)
    steal_log = sorted(
        (p.key(), p.stolen_from, p.assignment_epoch)
        for p in final_parts if p.stolen_from is not None)
    if victim_killed and inflight and not steal_log:
        violations.append(Violation(
            "reclamation",
            f"victim's in-flight part(s) "
            f"{[p.key() for p in inflight]} were never reclaimed"))
    if not all(p.completed for p in final_parts):
        violations.append(Violation(
            "run-completed",
            f"{sum(1 for p in final_parts if not p.completed)} part(s) "
            f"never completed"))
    violations.extend(fencing_violations(cp.completions))

    # per-part deliveries: (kill + 1) x the retry machinery per run
    bound = (kills + 1) * PART_RETRIES * SINK_PUSH_ATTEMPTS
    verdict = audit_delivery(reference, store.batches, bound, tracker,
                             device=device)
    if violations:
        verdict.passed = False
        verdict.violations.extend(violations)
    store.clear()
    return TrialResult(mode="worker_crash", trial=trial, seed=seed,
                       spec=spec, verdict=verdict, fire_counts=fires,
                       fire_log=log, seconds=seconds, kills=kills,
                       steal_log=steal_log,
                       fence_rejected=fence_rejected)


# -- exactly_once mode -------------------------------------------------------
#
# The staged two-phase commit gauntlet (abstract/commit.py,
# ARCHITECTURE.md "Exactly-once commits"): the worker_crash scenario —
# a victim secondary killed at a seeded point, the survivor reclaiming
# through the real steal path, a zombie replay fenced — run against
# staged-commit capable sinks with torn writes and transient
# stage/publish/commit-RPC faults armed, and the delivery audit
# TIGHTENED to exactly-once: the delivered multiset must EQUAL the
# fault-free reference (zero duplicate AND zero lost row keys).
#
# Each trial runs per backend — the in-memory store and the WIRE
# targets (postgres, clickhouse, kafka, s3 objects) against the port's
# protocol fakes (chaos/wire_backends.py; arrow_ipc and ydb wait under
# ROADMAP.md A7 and are skipped) — and replays identically
# under a seed on three surfaces: the failpoint fire log, the steal
# log, and the coordinator's commit-decision log.  The zombie replay
# is proved at BOTH fences: the coordinator's `commit_part` denies the
# stale epoch, and a direct sink-layer publish at the stale epoch
# raises StaleEpochPublishError instead of clobbering the survivor's
# data — for the wire targets that second fence is the TARGET's own
# primitive (pg/ch/ydb `__trtpu_commits` rows, kafka producer fencing,
# the s3 conditional marker object).

EXACTLY_ONCE_BACKENDS = ("memory", "arrow_ipc", "postgres",
                         "clickhouse", "ydb", "kafka", "s3")

# backend -> its wire-publish failpoint site (chaos/sites.py): a
# transient fault here lands between the fence read and the target's
# atomic flip — the retried part must republish idempotently
_EO_PUBLISH_SITES = {
    "postgres": "sink.pg.publish",
    "clickhouse": "sink.ch.publish",
    "ydb": "sink.ydb.publish",
    "kafka": "sink.kafka.publish",
    "s3": "sink.s3.publish",
}


def exactly_once_schedule(trial: int, seed: int, backend: str) -> str:
    """Seed-derived spec: one torn write into staging (the dedup window
    must drop the replayed prefix), a victim kill either mid-part or
    mid-publish, and (sometimes) transient staging / commit-RPC /
    wire-publish faults the retry machinery must absorb by restaging
    from scratch."""
    rng = random.Random(f"{seed}:exactly_once:{backend}:{trial}")
    frac = rng.choice((0.25, 0.5, 0.75))
    clauses = [
        f"sink.push.torn=after:{rng.randrange(0, 4)},times:1,"
        f"truncate:{frac}",
    ]
    if rng.random() < 0.5:
        # mid-part kill: the victim dies between staged batches
        clauses.append(
            f"snapshot.part.batch=after:{rng.randrange(0, 6)},times:1,"
            f"raise:WorkerKilledError")
    else:
        # mid-publish kill: the victim dies between the coordinator's
        # grant and visibility — nothing of its part may be seen
        clauses.append(
            f"sink.publish=after:{rng.randrange(0, 3)},times:1,"
            f"raise:WorkerKilledError")
    if rng.random() < 0.5:
        clauses.append(
            f"sink.stage=after:{rng.randrange(0, 4)},times:1,"
            f"raise:ChaosInjectedError")
    if rng.random() < 0.5:
        clauses.append(
            f"coordinator.commit_part=after:{rng.randrange(0, 3)},"
            f"times:1,raise:ChaosInjectedError")
    site = _EO_PUBLISH_SITES.get(backend)
    if site is not None and rng.random() < 0.5:
        # transient wire fault between the fence read and the target's
        # atomic flip: the part retries and republishes idempotently
        clauses.append(
            f"{site}=after:{rng.randrange(0, 2)},times:1,"
            f"raise:ChaosInjectedError")
    return ";".join(clauses)


def _exactly_once_reference(rows: int, backend: str,
                            device: DeviceLike = None) -> DeliveryReference:
    from transferia_tpu_torch.chaos import wire_backends

    harness = wire_backends.make_backend(backend, "chaos-eo-ref", device)
    try:
        t = _snapshot_transfer(rows, "chaos-eo-ref", dst=harness.dst())
        _run_snapshot_once(t, MemoryCoordinator(), device)
        return DeliveryReference.from_batches(harness.observed(), device)
    finally:
        harness.close()


def run_exactly_once_trial(trial: int, seed: int, rows: int,
                           reference: DeliveryReference,
                           backend: str = "memory",
                           spec: Optional[str] = None,
                           device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.abstract.errors import (
        StaleEpochPublishError,
        is_worker_kill,
    )
    from transferia_tpu_torch.abstract.table import OperationTablePart
    from transferia_tpu_torch.chaos import wire_backends
    from transferia_tpu_torch.chaos.invariants import fencing_violations
    from transferia_tpu_torch.factories import new_storage
    from transferia_tpu_torch.middlewares.sync import SINK_PUSH_ATTEMPTS
    from transferia_tpu_torch.stats.registry import Metrics
    from transferia_tpu_torch.tasks.snapshot import (
        PART_RETRIES,
        SnapshotLoader,
    )
    from transferia_tpu_torch.tasks.table_splitter import split_tables

    sink_id = f"chaos-eo-{backend}-trial"
    harness = wire_backends.make_backend(backend, sink_id, device)
    spec = spec if spec is not None else exactly_once_schedule(
        trial, seed, backend)
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(
        MemoryCoordinator(lease_seconds=TRIAL_LEASE_SECONDS), tracker)
    op_id = f"op-chaos-eo-{backend}"
    metrics = Metrics()

    def mk_transfer(job: int):
        t = _snapshot_transfer(rows, sink_id, dst=harness.dst())
        t.id = "chaos-eo"
        t.runtime.current_job = job
        t.runtime.sharding.job_count = 3
        return t

    def mk_loader(job: int) -> SnapshotLoader:
        return SnapshotLoader(mk_transfer(job), cp, operation_id=op_id,
                              metrics=metrics, device=device)

    # the main's control-plane role: split and publish the part queue
    # (the victim then uploads ALONE, so its batch/stage/publish hit
    # sequence — and which part is mid-flight at the kill — replays
    # exactly under the seed)
    main_t = mk_transfer(0)
    storage = new_storage(main_t, metrics)
    try:
        tables = mk_loader(0).filtered_table_list(storage)
        parts = split_tables(storage, tables, main_t, op_id)
    finally:
        storage.close()
    cp.create_operation_parts(op_id, parts)
    cp.set_operation_state(op_id, {"parts_discovery_done": True})

    def run_loader(job: int, errs: list):
        try:
            mk_loader(job).upload_tables()
        except BaseException as e:
            errs.append(e)

    violations: list[Violation] = []
    kills = 0
    fence_rejected = 0
    t0 = time.monotonic()
    try:
        with failpoints.active(spec, seed=seed * 1000 + trial):
            # phase 1: the victim secondary stages/publishes alone
            # until the armed kill fires (mid-part or mid-publish)
            victim_errs: list = []
            vt = threading.Thread(target=run_loader,
                                  args=(1, victim_errs),
                                  name="chaos-eo-victim", daemon=True)
            vt.start()
            vt.join(TRIAL_TIMEOUT)
            victim_killed = bool(victim_errs) and is_worker_kill(
                victim_errs[0])
            kills = int(victim_killed)
            if victim_errs and not victim_killed:
                violations.append(Violation(
                    "run-completed",
                    f"victim died of a non-kill error: "
                    f"{victim_errs[0]}"))
            inflight = [p for p in cp.operation_parts(op_id)
                        if not p.completed and p.worker_index == 1]
            # phase 2: the survivor drains the rest, stealing the
            # victim's parts on lease expiry and REPLACING whatever the
            # victim staged or published for them
            survivor_errs: list = []
            st = threading.Thread(target=run_loader,
                                  args=(2, survivor_errs),
                                  name="chaos-eo-survivor", daemon=True)
            st.start()
            st.join(TRIAL_TIMEOUT)
            if survivor_errs:
                violations.append(Violation(
                    "run-completed",
                    f"survivor failed: {survivor_errs[0]}"))
            # phase 3: the sharded main's lease-aware join
            try:
                mk_loader(0)._wait_all_parts_done()
            except Exception as e:
                violations.append(Violation(
                    "main-join", f"main wait failed: {e}"))
            # phase 4: zombie replay, fenced at every layer.
            for p in inflight:
                cur = next((c for c in cp.operation_parts(op_id)
                            if c.key() == p.key()), None)
                if cur is None or cur.assignment_epoch <= \
                        p.assignment_epoch:
                    continue  # never reclaimed: nothing to fence
                zombie = OperationTablePart.from_json(p.to_json())
                # 4a. engine-level completion replay (stale epoch)
                zombie.completed = True
                zombie.completed_rows = 1
                rejected = cp.update_operation_parts(op_id, [zombie])
                fence_rejected += len(rejected)
                if not rejected:
                    violations.append(Violation(
                        "epoch-fencing",
                        f"zombie completion of {zombie.key()} (epoch "
                        f"{zombie.assignment_epoch}) was accepted"))
                # 4b. the coordinator's commit fence: the publish
                # decision for the stolen epoch must be denied
                granted = None
                for _ in range(5):
                    try:
                        granted = cp.commit_part(op_id, zombie)
                        break
                    except Exception as e:  # trtpu: ignore[EXC001] — armed chaos faults are the point
                        logger.debug("zombie commit_part fault: %s", e)
                        continue
                if granted is not False:
                    violations.append(Violation(
                        "commit-fencing",
                        f"zombie commit_part of {zombie.key()} (epoch "
                        f"{zombie.assignment_epoch}) returned "
                        f"{granted!r}, expected False"))
                fence_rejected += int(granted is False)
                # 4c. the sink's own fence: a direct stale-epoch
                # publish must raise, never replace the survivor's data
                try:
                    harness.zombie_publish(zombie.key(),
                                           zombie.assignment_epoch)
                    violations.append(Violation(
                        "sink-fencing",
                        f"stale-epoch sink publish of {zombie.key()} "
                        f"(epoch {zombie.assignment_epoch}) was "
                        f"accepted"))
                except StaleEpochPublishError:
                    fence_rejected += 1
            fires = failpoints.fire_counts()
            log = failpoints.fire_log()
        seconds = time.monotonic() - t0

        final_parts = cp.operation_parts(op_id)
        steal_log = sorted(
            (p.key(), p.stolen_from, p.assignment_epoch)
            for p in final_parts if p.stolen_from is not None)
        if victim_killed and inflight and not steal_log:
            violations.append(Violation(
                "reclamation",
                f"victim's in-flight part(s) "
                f"{[p.key() for p in inflight]} were never reclaimed"))
        if not all(p.completed for p in final_parts):
            violations.append(Violation(
                "run-completed",
                f"{sum(1 for p in final_parts if not p.completed)} "
                f"part(s) never completed"))
        violations.extend(fencing_violations(cp.completions))
        for p in final_parts:
            if p.completed and p.commit_epoch != p.assignment_epoch:
                violations.append(Violation(
                    "commit-epoch",
                    f"{p.key()} completed at epoch "
                    f"{p.assignment_epoch} but its publish was granted "
                    f"at {p.commit_epoch}"))

        observed = harness.observed()
        bound = (kills + 1) * PART_RETRIES * SINK_PUSH_ATTEMPTS
        verdict = audit_delivery(reference, observed, bound, tracker,
                                 exactly_once=True, device=device)
        if violations:
            verdict.passed = False
            verdict.violations.extend(violations)
        return TrialResult(
            mode="exactly_once", trial=trial, seed=seed, spec=spec,
            verdict=verdict, fire_counts=fires, fire_log=log,
            seconds=seconds, kills=kills, steal_log=steal_log,
            fence_rejected=fence_rejected, backend=backend,
            commit_log=list(cp.commit_log),
            dedup_dropped=int(metrics.value(
                "commit_dedup_rows_dropped")))
    finally:
        harness.close()


# -- scheduler_kill mode -----------------------------------------------------
#
# The fleet-level extension of worker_crash: N transfers from M tenants
# run through the FleetScheduler (fleet/scheduler.py) on a 3-slot
# worker pool; a seeded `fleet.dispatch` kill takes a slot down at a
# dispatch decision, and the scheduler must rebalance the in-flight
# transfer to a survivor.  The delivery auditor then asserts that no
# transfer was lost or double-admitted and every target matches the
# fault-free reference.
#
# Determinism: every ticket is submitted BEFORE the worker pool starts,
# and both the DRR pick and the `fleet.dispatch` failpoint fire inside
# the scheduler's lock — so the k-th dispatch (and therefore which
# ticket the kill lands on) is a pure function of the seed.  The trial
# records the dispatch order + rebalance log for replay checks.

SCHEDULER_TRANSFERS = 10
SCHEDULER_WORKERS = 3


def scheduler_kill_schedule(trial: int, seed: int) -> str:
    """Seed-derived spec: one worker-slot kill at a seeded dispatch
    index, plus (sometimes) a transient admission fault the submitter
    must retry through and a rebalance fault the scheduler must absorb
    without losing the transfer."""
    rng = random.Random(f"{seed}:scheduler_kill:{trial}")
    # SCHEDULER_TRANSFERS dispatch hits; after<=7 keeps the kill inside
    # the queue with work left to rebalance
    clauses = [
        f"fleet.dispatch=after:{rng.randrange(0, 8)},times:1,"
        f"raise:WorkerKilledError",
    ]
    if rng.random() < 0.5:
        clauses.append(
            f"fleet.admit=after:{rng.randrange(0, 4)},times:1,"
            f"raise:ChaosInjectedError")
    if rng.random() < 0.5:
        clauses.append(
            "fleet.rebalance=after:0,times:1,raise:ChaosInjectedError")
    return ";".join(clauses)


def run_scheduler_kill_trial(trial: int, seed: int, rows: int,
                             reference: DeliveryReference,
                             spec: Optional[str] = None,
                             transfers: int = SCHEDULER_TRANSFERS,
                             device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.fleet.scheduler import (
        FleetScheduler,
        FleetTransfer,
        QosClass,
    )
    from transferia_tpu_torch.middlewares.sync import SINK_PUSH_ATTEMPTS
    from transferia_tpu_torch.providers.memory import get_store
    from transferia_tpu_torch.stats.registry import Metrics
    from transferia_tpu_torch.tasks.snapshot import (
        PART_RETRIES,
        SnapshotLoader,
    )

    spec = spec if spec is not None else scheduler_kill_schedule(
        trial, seed)
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(MemoryCoordinator(), tracker)
    qos_cycle = (QosClass.BATCH, QosClass.INTERACTIVE,
                 QosClass.SCAVENGER)
    tickets: dict[str, FleetTransfer] = {}
    sink_ids: dict[str, str] = {}
    violations: list[Violation] = []
    t0 = time.monotonic()
    with failpoints.active(spec, seed=seed * 1000 + trial):
        sched = FleetScheduler(
            workers=SCHEDULER_WORKERS, max_inflight_per_worker=1,
            metrics=Metrics(), name=f"chaos-fleet-{trial}")
        for i in range(transfers):
            sink_id = f"chaos-fleet-{trial}-{i:03d}"
            get_store(sink_id).clear()
            transfer = _snapshot_transfer(rows, sink_id)
            transfer.id = f"chaos-fleet-{i:03d}"
            def run(t=transfer):
                SnapshotLoader(t, cp, device=device).upload_tables()
            ticket = FleetTransfer(
                transfer_id=transfer.id, tenant=f"tenant-{i % 3}",
                run=run, qos=qos_cycle[i % len(qos_cycle)])
            tickets[ticket.transfer_id] = ticket
            sink_ids[ticket.transfer_id] = sink_id
            # admission faults are the submitter's to retry (the same
            # contract as any coordinator RPC)
            for _ in range(5):
                try:
                    decision = sched.submit(ticket)
                    break
                except Exception as e:
                    logger.info("chaos fleet admit fault for %s: %s",
                                ticket.transfer_id, e)
            else:
                violations.append(Violation(
                    "fleet-admission",
                    f"{ticket.transfer_id} never admitted"))
                continue
            if decision != "admitted":
                violations.append(Violation(
                    "fleet-admission",
                    f"{ticket.transfer_id} shed: {decision}"))
        # workers start only after every ticket is queued: the DRR pick
        # sequence is then a pure function of the seed
        sched.start()
        drained = sched.drain(timeout=TRIAL_TIMEOUT)
        sched.shutdown()
        fires = failpoints.fire_counts()
        log = failpoints.fire_log()
    seconds = time.monotonic() - t0
    if not drained:
        violations.append(Violation(
            "run-completed", "fleet did not drain in time"))
    if sched.double_admissions:
        violations.append(Violation(
            "double-admission",
            f"tickets dispatched while not queued: "
            f"{sched.double_admissions}"))

    # per-transfer delivery audit against the shared reference
    total_dup = 0
    delivered = 0
    for tid, ticket in sorted(tickets.items()):
        store = get_store(sink_ids[tid])
        if ticket.state != "done":
            violations.append(Violation(
                "transfer-lost",
                f"{tid} ended {ticket.state!r} after "
                f"{ticket.attempts} attempt(s): {ticket.error}"))
            store.clear()
            continue
        bound = max(1, ticket.attempts) * PART_RETRIES \
            * SINK_PUSH_ATTEMPTS
        v = audit_delivery(reference, store.batches, bound, None,
                           device=device)
        delivered += v.delivered_rows
        total_dup += v.duplicate_rows
        if not v.passed:
            for viol in v.violations:
                violations.append(Violation(
                    viol.invariant, f"{tid}: {viol.detail}"))
        store.clear()
    verdict = AuditVerdict(passed=not violations,
                           violations=violations,
                           delivered_rows=delivered,
                           duplicate_rows=total_dup)
    # monotonicity over the shared coordinator's checkpoint streams
    for detail in tracker.violations:
        verdict.passed = False
        verdict.violations.append(
            Violation("checkpoint-monotonicity", detail))
    return TrialResult(
        mode="scheduler_kill", trial=trial, seed=seed, spec=spec,
        verdict=verdict, fire_counts=fires, fire_log=log,
        seconds=seconds, kills=len(sched.kill_log),
        steal_log=[(tid, attempt)
                   for tid, _w, attempt in sched.rebalance_log],
        dispatch_order=list(sched.dispatch_log))


# -- fleet_distributed mode --------------------------------------------------
#
# The distributed-fleet gauntlet (fleet/distributed.py, fleet/worker.py;
# ARCHITECTURE.md "Distributed fleet"): tickets are admitted into the
# COORDINATOR-backed durable queue by scheduler replica A, which then
# dies; replica B fails over onto the same queue (no ticket lost, the
# idempotent enqueue makes re-submission double-admission-proof).  A
# victim worker is killed mid-part (armed `snapshot.part.batch` kill):
# its ticket lease expires and a survivor RECLAIMS the ticket, resuming
# the transfer from its committed parts.  Mid-run, an INTERACTIVE
# ticket arrives with no free lane and replica B revokes the running
# low-priority ticket's lease — the survivor yields at a part boundary,
# runs the interactive arrival first, then resumes the preempted
# transfer.  The audit is EXACTLY-ONCE per ticket (staged memory sink):
# every delivered multiset must equal the fault-free reference.  The
# whole scenario runs TWICE per trial under the same seed and the three
# queue logs (admission order, won claims, preemption revokes) must
# replay byte-identically.

FLEET_DIST_TICKETS = 5
FLEET_DIST_ROWS = 1024


def fleet_distributed_schedule(trial: int, seed: int) -> str:
    """Seed-derived spec: one mid-part worker kill, plus (sometimes)
    transient admission / claim / completion / heartbeat RPC faults the
    retry machinery must absorb."""
    rng = random.Random(f"{seed}:fleet_distributed:{trial}")
    clauses = [
        # each ticket is 4 parts x 2 batches = 8 victim batch hits;
        # after<=5 guarantees the kill fires inside the victim's first
        # ticket with work left for the survivor
        f"snapshot.part.batch=after:{rng.randrange(0, 6)},times:1,"
        f"raise:WorkerKilledError",
    ]
    if rng.random() < 0.5:
        clauses.append(
            f"fleet.enqueue=after:{rng.randrange(0, 3)},times:1,"
            f"raise:ChaosInjectedError")
    if rng.random() < 0.5:
        clauses.append(
            f"fleet.claim=after:{rng.randrange(0, 3)},times:1,"
            f"raise:ChaosInjectedError")
    if rng.random() < 0.5:
        clauses.append(
            f"fleet.complete=after:{rng.randrange(0, 2)},times:1,"
            f"raise:ChaosInjectedError")
    if rng.random() < 0.5:
        # observability exports are best-effort: transient export
        # faults must never fail the part/ticket they rode on, and the
        # post-trial merge must still pass on the surviving segments
        clauses.append("obs.export=prob:0.3,raise:ChaosInjectedError")
    return ";".join(clauses)


def _fleet_dist_scenario(trial: int, seed: int, rows: int, spec: str,
                         run_tag: str, device: DeviceLike = None) -> dict:
    """One full scenario execution (a trial runs this twice and diffs
    the logs).  Returns the logs, ticket end states, per-sink observed
    batches and fire accounting."""
    from transferia_tpu_torch.abstract.ticket import FleetTicket
    from transferia_tpu_torch.fleet.distributed import (
        DistributedFleetScheduler,
    )
    from transferia_tpu_torch.fleet.worker import FleetWorker
    from transferia_tpu_torch.providers.memory import get_store
    from transferia_tpu_torch.stats.registry import Metrics

    queue = f"chaos-fd-{trial}"
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(
        MemoryCoordinator(lease_seconds=TRIAL_LEASE_SECONDS), tracker)
    violations: list[Violation] = []
    qos_cycle = ("batch", "scavenger")

    def mk_ticket(i: int, qos: str) -> FleetTicket:
        sink_id = f"chaos-fd-{trial}-{run_tag}-{i:02d}"
        get_store(sink_id).clear()
        return FleetTicket(
            ticket_id=f"tk-{i:02d}", transfer_id=f"chaos-fd-{i:02d}",
            tenant=f"tenant-{i % 2}", qos=qos,
            payload={
                "kind": "sample_snapshot", "rows": rows,
                "shard_parts": 4, "sink_id": sink_id,
                "operation_id": f"op-fd-{i:02d}",
                "transformation": {"transformers": [
                    {"mask_field": {"columns": ["device_id"],
                                    "salt": "chaos"}},
                    {"filter_rows": {"filter": "temperature > -1000"}},
                ]},
                "validation": {"fingerprint": True},
            })

    with failpoints.active(spec, seed=seed * 1000 + trial):
        # replica A admits the batch/scavenger load, then "crashes"
        # (dropped on the floor — the queue is durable, A holds nothing)
        sched_a = DistributedFleetScheduler(
            cp, queue=queue, metrics=Metrics(),
            name=f"chaos-fd-a-{trial}")
        for i in range(FLEET_DIST_TICKETS):
            ticket = mk_ticket(i, qos_cycle[i % 2])
            for _ in range(5):
                # admission faults are the submitter's to retry; the
                # idempotent enqueue makes the retry safe
                try:
                    decision = sched_a.submit(ticket)
                    break
                except Exception as e:
                    logger.info("chaos fd admit fault for %s: %s",
                                ticket.ticket_id, e)
            else:
                violations.append(Violation(
                    "fleet-admission",
                    f"{ticket.ticket_id} never admitted"))
                continue
            if decision != "admitted":
                violations.append(Violation(
                    "fleet-admission",
                    f"{ticket.ticket_id} shed: {decision}"))
        del sched_a
        # replica B fails over onto the durable queue
        sched_b = DistributedFleetScheduler(
            cp, queue=queue, metrics=Metrics(), capacity=lambda: 1,
            name=f"chaos-fd-b-{trial}")
        inherited = sched_b.resume()
        if inherited.get("queued", 0) != FLEET_DIST_TICKETS:
            violations.append(Violation(
                "scheduler-failover",
                f"replica B inherited {inherited} — expected "
                f"{FLEET_DIST_TICKETS} queued ticket(s)"))

        # phase 1: the victim worker drains alone until the armed
        # mid-part kill fires; its claimed ticket stays leased
        victim = FleetWorker(cp, queue=queue, worker_index=1,
                             metrics=Metrics(),
                             heartbeat_interval=TRIAL_HEARTBEAT_INTERVAL,
                             idle_exit_seconds=0.5, device=device)
        victim.run(threading.Event())
        killed_ticket = None
        if victim.dead:
            held = [t for t in cp.list_tickets(queue)
                    if t.state == "claimed" and t.claimed_by == "w1"]
            if not held:
                violations.append(Violation(
                    "worker-crash",
                    "victim died but left no leased ticket"))
            else:
                killed_ticket = held[0]
        # let the dead worker's lease expire BEFORE the survivor starts:
        # the reclaim is then part of one deterministic WDRR sequence
        time.sleep(TRIAL_LEASE_SECONDS + 0.15)

        # phase 2: the survivor drains everything; at a fixed part
        # boundary an INTERACTIVE ticket arrives and replica B preempts
        # the running low-priority transfer
        preempt_state = {"fired": False}

        def boundary_hook(running, boundary):
            if preempt_state["fired"] or boundary != 2:
                return
            if running.qos == "interactive":
                return
            preempt_state["fired"] = True
            ticket = mk_ticket(90, "interactive")
            ticket.ticket_id = "tk-int"
            ticket.transfer_id = "chaos-fd-int"
            for _ in range(5):
                try:
                    sched_b.submit(ticket)
                    break
                except Exception as e:
                    logger.info("chaos fd interactive admit fault: %s",
                                e)
            sched_b.preempt_if_needed()

        survivor = FleetWorker(
            cp, queue=queue, worker_index=2, metrics=Metrics(),
            heartbeat_interval=TRIAL_HEARTBEAT_INTERVAL,
            idle_exit_seconds=1.5, part_boundary_hook=boundary_hook,
            device=device)
        survivor.run(threading.Event())

        drained = sched_b.drain(timeout=TRIAL_TIMEOUT)
        if not drained:
            violations.append(Violation(
                "run-completed", "fleet queue did not drain in time"))
        # zombie fence: the killed worker's completion replay with its
        # dead claim epoch must be rejected
        if killed_ticket is not None:
            accepted = cp.complete_ticket(queue, killed_ticket)
            if accepted:
                violations.append(Violation(
                    "ticket-fencing",
                    f"zombie completion of {killed_ticket.ticket_id} "
                    f"(epoch {killed_ticket.claim_epoch}) was "
                    f"accepted"))
        fires = failpoints.fire_counts()
        log = failpoints.fire_log()

    # fleet observability survives the worker kill: segments exported
    # through the coordinator (heartbeat cadence + ticket boundaries +
    # the survivor's final flush) outlive the victim process, and the
    # merged pane must render with cross-process conservation intact
    # even when some exports were chaos-faulted away
    from transferia_tpu_torch.stats import fleetobs

    obs_segments = cp.list_obs_segments(fleetobs.default_scope())
    if not obs_segments:
        violations.append(Violation(
            "fleet-observability",
            "no obs segments survived the trial (export plane dark)"))
    else:
        obs_view = fleetobs.merge_segments(obs_segments)
        if not obs_view["conservation"]["ok"]:
            violations.append(Violation(
                "fleet-observability",
                f"merged obs conservation drifted: "
                f"{obs_view['conservation']['drift']}"))
        if "obs.export" not in spec and \
                not any(label.startswith("fleet.w2.")
                        for label in obs_view["workers"]):
            # only asserted on schedules that don't fault the export
            # plane itself: with obs.export armed, a seed could fault
            # every one of the survivor's exports legitimately
            violations.append(Violation(
                "fleet-observability",
                "survivor worker exported no obs segment (final "
                "flush on drain missing)"))
        if obs_view["totals"].get("rows_in", 0) <= 0:
            violations.append(Violation(
                "fleet-observability",
                "merged fleet ledger shows zero rows for a trial "
                "that delivered data"))
        # watermark monotonicity across the kill: per (process,
        # transfer, table) the published event watermark must be
        # non-decreasing in segment order, and the merged (max-merge)
        # view must dominate every individual segment — a SIGKILLed
        # worker's lost final segment may lose PROGRESS but can never
        # REGRESS what was already published
        from transferia_tpu_torch.stats import watermark as wmks

        per_proc: dict = {}
        for seg in sorted(
                (s for s in obs_segments if isinstance(s, dict)),
                key=lambda s: (str(s.get("host", "")),
                               int(s.get("pid", 0) or 0),
                               int(s.get("seq", 0) or 0))):
            proc = (str(seg.get("host", "")),
                    int(seg.get("pid", 0) or 0))
            cur = wmks.merge_maps([seg.get("watermarks")])
            prev = per_proc.get(proc, {})
            for tid, tables in prev.items():
                for table, entry in tables.items():
                    now_e = cur.get(tid, {}).get(table)
                    if now_e is not None and \
                            now_e["event_ns"] < entry["event_ns"]:
                        violations.append(Violation(
                            "watermark-monotonicity",
                            f"{proc} regressed watermark "
                            f"{tid}/{table}: {entry['event_ns']} -> "
                            f"{now_e['event_ns']}"))
            per_proc[proc] = wmks.merge_maps([prev, cur])
        merged_wm = obs_view.get("watermarks", {})
        for proc_map in per_proc.values():
            for tid, tables in proc_map.items():
                for table, entry in tables.items():
                    got = merged_wm.get(tid, {}).get(table)
                    if got is None or \
                            got["event_ns"] < entry["event_ns"]:
                        violations.append(Violation(
                            "watermark-monotonicity",
                            f"merged view regressed watermark "
                            f"{tid}/{table} below a segment's value"))

    tickets = cp.list_tickets(queue)
    by_id = {t.ticket_id: t for t in tickets}
    if len(tickets) != len(by_id):
        violations.append(Violation(
            "double-admission",
            "duplicate ticket ids in the durable queue"))
    for t in tickets:
        if t.state != "done":
            violations.append(Violation(
                "transfer-lost",
                f"{t.ticket_id} ended {t.state!r} after {t.attempts} "
                f"attempt(s): {t.error}"))
    if preempt_state["fired"] and not cp.ticket_revoke_log:
        violations.append(Violation(
            "preemption",
            "interactive arrival with no free lane never revoked a "
            "running low-priority ticket"))
    sinks = {t.ticket_id: t.payload.get("sink_id") for t in tickets}
    return {
        "violations": violations,
        "tracker": tracker,
        "kills": int(victim.dead),
        "steals": sum(1 for c in cp.ticket_claim_log if c[3]),
        "preempts": len(cp.ticket_revoke_log),
        "fires": fires,
        "fire_log": log,
        "sinks": sinks,
        "logs": {
            "admission": list(cp.enqueue_log),
            "claims": list(cp.ticket_claim_log),
            "preempts": list(cp.ticket_revoke_log),
        },
    }


def run_fleet_distributed_trial(trial: int, seed: int, rows: int,
                                reference: DeliveryReference,
                                spec: Optional[str] = None,
                                device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.providers.memory import get_store

    rows = min(rows, FLEET_DIST_ROWS)
    spec = spec if spec is not None else fleet_distributed_schedule(
        trial, seed)
    t0 = time.monotonic()
    # the same seeded scenario runs twice; the queue decision logs must
    # replay byte-identically (the acceptance bar for this mode)
    first = _fleet_dist_scenario(trial, seed, rows, spec, "r1", device)
    second = _fleet_dist_scenario(trial, seed, rows, spec, "r2", device)
    seconds = time.monotonic() - t0
    violations = list(first["violations"])
    for name in ("admission", "claims", "preempts"):
        if first["logs"][name] != second["logs"][name]:
            violations.append(Violation(
                "seed-replay",
                f"{name} log diverged between two runs of seed {seed}: "
                f"{first['logs'][name]} vs {second['logs'][name]}"))
    for v in second["violations"]:
        violations.append(Violation(v.invariant, f"replay run: "
                                    f"{v.detail}"))

    # exactly-once delivery audit per ticket against the shared
    # fault-free reference (staged memory sink: the delivered multiset
    # must EQUAL the reference even across kill, reclaim and preempt).
    # BOTH scenario runs are audited — a timing-dependent duplication
    # in the replay run must fail the trial even when the decision
    # logs still matched.
    total_dup = 0
    delivered = 0
    for label, run in (("", first), ("replay run: ", second)):
        for tid, sink_id in sorted(run["sinks"].items()):
            store = get_store(sink_id)
            v = audit_delivery(reference, store.batches, 1, None,
                               exactly_once=True, device=device)
            delivered += v.delivered_rows
            total_dup += v.duplicate_rows
            if not v.passed:
                for viol in v.violations:
                    violations.append(Violation(
                        viol.invariant,
                        f"{label}{tid}: {viol.detail}"))
            store.clear()
    for detail in first["tracker"].violations:
        violations.append(Violation("checkpoint-monotonicity", detail))
    verdict = AuditVerdict(passed=not violations,
                           violations=violations,
                           delivered_rows=delivered,
                           duplicate_rows=total_dup)
    return TrialResult(
        mode="fleet_distributed", trial=trial, seed=seed, spec=spec,
        verdict=verdict, fire_counts=first["fires"],
        fire_log=first["fire_log"], seconds=seconds,
        kills=first["kills"], preempts=first["preempts"],
        steal_log=first["logs"]["claims"],
        dispatch_order=[tid for tid, _seq in
                        first["logs"]["admission"]])


# -- lock_order mode ----------------------------------------------------------
#
# The fleet_distributed gauntlet re-run with the runtime lock-order
# sentinel armed (runtime/lockwatch.py): every named production lock
# created during the scenario — scheduler, backpressure latch,
# coordinator maps and per-op locks, obs exporter, ledger — becomes a
# watched lock recording per-thread acquisition order.  The acceptance
# bar is ZERO lock-order inversions per seed on top of the mode's own
# exactly-once + byte-identical-replay audits.  Long holds and
# blocking-calls-under-a-lock are timing-dependent under CI load, so
# they are logged and folded into metrics but do not fail the trial.


def run_lock_order_trial(trial: int, seed: int, rows: int,
                         reference: DeliveryReference,
                         spec: Optional[str] = None,
                         metrics=None,
                         device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.runtime import lockwatch

    already_armed = lockwatch.active()
    watch = lockwatch.arm()
    try:
        result = run_fleet_distributed_trial(trial, seed, rows,
                                             reference, spec=spec,
                                             device=device)
    finally:
        if already_armed is None:
            lockwatch.disarm()
    result.mode = "lock_order"
    counters = watch.counters()
    for inv in watch.inversions():
        first, second = inv["first"], inv["second"]
        result.verdict.violations.append(Violation(
            "lock-order", (
                f"inversion between {inv['locks'][0]} and "
                f"{inv['locks'][1]} on thread {inv['thread']}: "
                f"order {' -> '.join(first['order'])} established at "
                f"{first['held_site']} -> {first['acquire_site']}, "
                f"reversed {' -> '.join(second['order'])} at "
                f"{second['held_site']} -> {second['acquire_site']}")))
    if result.verdict.violations:
        result.verdict.passed = False
    for f in watch.findings("long_hold"):
        logger.info("chaos lock_order trial %d: long hold on %s "
                    "(%.1f ms > %.1f ms) acquired at %s", trial,
                    f["lock"], f["held_ms"], f["threshold_ms"],
                    f["acquire_site"])
    for f in watch.findings("blocking_in_lock"):
        logger.info("chaos lock_order trial %d: blocking call %s under "
                    "%s at %s", trial, f["call"], f["lock"],
                    f["call_site"])
    logger.info(
        "chaos lock_order trial %d: %d acquisitions over %d order "
        "edges, %d inversion(s), %d long hold(s), %d blocking call(s) "
        "under a lock", trial, counters["acquisitions"],
        watch.edge_count(), counters["inversions"],
        counters["long_holds"], counters["blocking_in_lock"])
    if metrics is not None:
        watch.fold_into(metrics)
    return result


# -- replication mode --------------------------------------------------------

_REPL_PARSER = {"json": {
    "schema": [
        {"name": "id", "type": "int64", "key": True},
        {"name": "payload", "type": "utf8"},
        {"name": "amount", "type": "double"},
    ],
    "table": "chaos_events",
    # no _timestamp/_partition/_offset system columns: row identity must
    # be pure message content so the reference run (its own broker,
    # seeded at a different wall-clock) and every trial agree on keys
    "add_system_cols": False,
}}


def _replication_transfer(broker_id: str, sink_id: str) -> Transfer:
    from transferia_tpu_torch.providers.memory import MemoryTargetParams
    from transferia_tpu_torch.providers.mq import MQSourceParams

    return Transfer(
        id="chaos-replication",
        type=TransferType.INCREMENT_ONLY,
        src=MQSourceParams(broker_id=broker_id, topic="chaos-topic",
                           parser=_REPL_PARSER, n_partitions=2,
                           parallelism=1),
        dst=MemoryTargetParams(sink_id=sink_id),
        transformation={"transformers": [
            {"mask_field": {"columns": ["payload"], "salt": "chaos"}},
        ]},
    )


def _seed_broker(broker_id: str, messages: int):
    import json as _json

    from transferia_tpu_torch.providers.mq import get_broker

    broker = get_broker(broker_id, n_partitions=2)
    if broker.size("chaos-topic") == 0:
        for i in range(messages):
            broker.produce("chaos-topic", str(i).encode(), _json.dumps({
                "id": i, "payload": f"evt-{i}", "amount": i * 0.5,
            }).encode(), partition=i % 2)
    return broker


def _run_replication(transfer, cp, store, expected_distinct: int,
                     timeout: float, device: DeviceLike = None
                     ) -> tuple[int, Optional[BaseException]]:
    """Run the real retry loop on `device` until the target holds every
    expected row (or timeout); returns (restarts, error)."""
    from transferia_tpu_torch.chaos.invariants import _batches_to_counter
    from transferia_tpu_torch.runtime.local import run_replication
    from transferia_tpu_torch.stats.registry import Metrics

    metrics = Metrics()
    stop = threading.Event()
    err: list[BaseException] = []

    def target():
        try:
            run_replication(transfer, cp, metrics=metrics,
                            stop_event=stop, backoff=0.05, device=device)
        except BaseException as e:
            err.append(e)

    th = threading.Thread(target=target, daemon=True,
                          name="chaos-replication")
    th.start()
    deadline = time.monotonic() + timeout
    done = False
    while time.monotonic() < deadline and not err:
        with store.lock:
            total = sum(
                b.n_rows if hasattr(b, "n_rows") else len(b)
                for b in store.batches)
        if total >= expected_distinct:
            if len(_batches_to_counter(store.batches, device)) >= \
                    expected_distinct:
                done = True
                break
        time.sleep(0.05)
    stop.set()
    th.join(timeout=10)
    restarts = int(metrics.value("replication_restarts"))
    if err:
        return restarts, err[0]
    if not done:
        return restarts, TimeoutError(
            f"target incomplete after {timeout:.0f}s")
    return restarts, None


def _replication_reference(messages: int,
                           device: DeviceLike = None) -> DeliveryReference:
    from transferia_tpu_torch.providers.memory import get_store

    _seed_broker("chaos-repl-ref", messages)
    store = get_store("chaos-repl-ref-store")
    store.clear()
    transfer = _replication_transfer("chaos-repl-ref",
                                     "chaos-repl-ref-store")
    restarts, err = _run_replication(
        transfer, MemoryCoordinator(), store, messages, TRIAL_TIMEOUT,
        device)
    if err is not None:
        raise RuntimeError(
            f"clean replication reference run failed: {err}") from err
    ref = DeliveryReference.from_batches(store.batches, device)
    store.clear()
    return ref


def run_replication_trial(trial: int, seed: int, messages: int,
                          reference: DeliveryReference,
                          spec: Optional[str] = None,
                          device: DeviceLike = None) -> TrialResult:
    from transferia_tpu_torch.providers.memory import get_store

    broker_id = f"chaos-repl-{seed}-{trial}"
    broker = _seed_broker(broker_id, messages)
    sink_id = "chaos-repl-trial"
    store = get_store(sink_id)
    store.clear()
    spec = spec if spec is not None else default_schedule(
        "replication", trial, seed)
    tracker = MonotonicityTracker()
    orig_commit = broker.commit

    def audited_commit(group, topic, partition, offset):
        tracker.record(f"commit:{topic}:{partition}", offset)
        return orig_commit(group, topic, partition, offset)

    broker.commit = audited_commit
    transfer = _replication_transfer(broker_id, sink_id)
    t0 = time.monotonic()
    with failpoints.active(spec, seed=seed * 1000 + trial):
        restarts, err = _run_replication(
            transfer, MemoryCoordinator(), store, reference.rows,
            TRIAL_TIMEOUT, device)
        fires = failpoints.fire_counts()
        log = failpoints.fire_log()
    seconds = time.monotonic() - t0
    # resume-from-checkpoint redelivers at most once per attempt
    bound = restarts + 1
    verdict = audit_delivery(reference, store.batches, bound, tracker,
                             device=device)
    if err is not None:
        verdict.passed = False
        verdict.violations.append(Violation(
            "run-completed", f"replication trial errored: {err}"))
    store.clear()
    return TrialResult(mode="replication", trial=trial, seed=seed,
                       spec=spec, verdict=verdict, fire_counts=fires,
                       fire_log=log, restarts=restarts, seconds=seconds)


# -- snapshot_and_increment mode ---------------------------------------------
#
# The MVCC consistent-cutover gauntlet (transferia_tpu/mvcc/ in the
# reference), two seeded scenarios per trial:
#
# * LAYERED — snapshot parts land as base versions while seeded CDC
#   layers stack as deltas, the cutover seals one (watermark, epoch)
#   decision, compaction folds the layers.
# * PUMP — the crash-survivable path: a LIVE MvccPump fetches a seeded
#   broker feed into delta layers while the base part lands; every
#   injected raise is a worker SIGKILL, and the survivor REBUILDS the
#   scope from the spill manifest (mvcc/spill.py) and resumes the pump
#   from the admitted-layer offsets; the cutover seals the source
#   offsets inside the fence and only the sealed values commit back.
#
# Seeded aborts fire at every mvcc.* site plus replication.pump (a
# raise at the site IS the kill: each site sits before its state
# change, so the retrying "next worker attempt" must be idempotent).
# The acceptance bar: the final merged read is EXACTLY the fault-free
# reference (zero lost, zero duplicate rows), zombie publishes are
# fenced at both epochs AND at the pump, a fresh-store rebuild reads
# byte-identically, the compacted read equals the layered read, and
# the fire / admission / cutover logs replay byte-identically across
# two runs of the same seed.
#
# The port runs the LAYERED scenario whole.  The PUMP scenario's
# survivor rebuilds from the spill (mvcc/spill.py), which needs pyarrow
# and waits under ROADMAP.md A7: the trial reports it skipped.

SAI_SITES = ("mvcc.append", "mvcc.cutover", "mvcc.compact",
             "mvcc.spill", "mvcc.rebuild", "replication.pump",
             "mvcc.offset_commit")
SAI_ROWS = 1024
SAI_PARTS = 3
SAI_ATTEMPTS = 10
SAI_PUMP_SKIPPED = ("ROADMAP.md A7: the S&I pump scenario rebuilds a "
                    "killed worker's store from the MVCC spill "
                    "(mvcc/spill.py), which needs pyarrow (blocked)")


def snapshot_and_increment_schedule(trial: int, seed: int) -> str:
    rng = random.Random(f"{seed}:snapshot_and_increment:{trial}")
    clauses = []
    for site in SAI_SITES:
        # cutover/compact/rebuild/offset_commit are hit ~once per run
        # outside their own retries: only after:0 guarantees a fire.
        # append/spill/pump see the whole feed, so they can afford a
        # gate
        if site in ("mvcc.append", "mvcc.spill", "replication.pump"):
            after = rng.randrange(0, 4)
            times = rng.randrange(1, 3)
        else:
            after = 0
            times = 1
        err = rng.choice(("ConnectionError", "TimeoutError",
                          "ChaosInjectedError"))
        clauses.append(f"{site}=after:{after},times:{times},raise:{err}")
    return ";".join(clauses)


def _sai_dataset(seed: int, trial: int, rows: int):
    """Deterministic dict-heavy base parts + LSN-ordered CDC layers for
    one (seed, trial): the reference and both faulted runs share it."""
    import numpy as np

    from transferia_tpu_torch.abstract.kinds import KIND_CODES, Kind
    from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
    from transferia_tpu_torch.columnar.batch import ColumnBatch

    rng = random.Random(f"{seed}:snapshot_and_increment:{trial}:data")
    schema = new_table_schema([("id", "int64", True),
                               ("segment", "utf8"),
                               ("amount", "double")])
    tid = TableID("chaos", "sai_events")
    per = (rows + SAI_PARTS - 1) // SAI_PARTS
    parts = []
    for p in range(SAI_PARTS):
        lo, hi = p * per, min(rows, (p + 1) * per)
        ids = list(range(lo, hi))
        parts.append([ColumnBatch.from_pydict(tid, schema, {
            "id": ids,
            "segment": [f"s{i % 6}" for i in ids],  # dict-heavy
            "amount": [i * 0.5 for i in ids],
        })])
    layers = []
    n_layers = 4 + rng.randrange(0, 3)
    lsn = 100
    next_insert = rows
    for seq in range(n_layers):
        n_ops = 8 + rng.randrange(0, 8)
        ids, segs, amts, kinds, lsns = [], [], [], [], []
        for _ in range(n_ops):
            roll = rng.random()
            if roll < 0.5:
                ids.append(rng.randrange(rows))
                kinds.append(KIND_CODES[Kind.UPDATE])
            elif roll < 0.75:
                ids.append(rng.randrange(rows))
                kinds.append(KIND_CODES[Kind.DELETE])
            else:
                ids.append(next_insert)
                next_insert += 1
                kinds.append(KIND_CODES[Kind.INSERT])
            segs.append(f"s{rng.randrange(6)}")
            amts.append(round(rng.random() * 100, 3))
            lsns.append(lsn)
            lsn += 1
        # out-of-order WITHIN the layer: the merge resolves by per-row
        # lsn, not arrival position — shuffle to prove it
        order = list(range(n_ops))
        rng.shuffle(order)
        batch = ColumnBatch.from_pydict(tid, schema, {
            "id": [ids[i] for i in order],
            "segment": [segs[i] for i in order],
            "amount": [amts[i] for i in order],
        }, kinds=np.array([kinds[i] for i in order], dtype=np.int8),
            lsns=np.array([lsns[i] for i in order], dtype=np.int64))
        layers.append(("w0", seq, [batch]))
    return str(tid), schema, tid, parts, layers


def _sai_scenario(trial: int, seed: int, rows: int,
                  spec: Optional[str], label: str,
                  device: DeviceLike = None) -> dict:
    """One full S&I run over the MVCC store on `device`.  `spec=None` =
    the fault-free reference."""
    from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
    from transferia_tpu_torch.abstract.kinds import KIND_CODES, Kind
    from transferia_tpu_torch.columnar.batch import ColumnBatch
    from transferia_tpu_torch.mvcc.compact import compact_table
    from transferia_tpu_torch.mvcc.store import MvccStore

    import numpy as np

    table, schema, tid, parts, layers = _sai_dataset(seed, trial, rows)
    tracker = MonotonicityTracker()
    cp = AuditingCoordinator(MemoryCoordinator(), tracker)
    store = MvccStore(f"chaos-sai-{label}", cp, device=device)
    rng = random.Random(f"{seed}:snapshot_and_increment:{trial}:ops")
    violations: list[Violation] = []
    kills = 0
    fence_rejected = 0

    def attempt(op, desc):
        nonlocal kills
        for _ in range(SAI_ATTEMPTS):
            try:
                return op()
            except Exception as e:
                # an injected raise at the site is the kill; the retry
                # is the next worker attempt and must be idempotent
                kills += 1
                logger.debug("chaos sai %s: %s aborted (%s); retrying",
                             label, desc, e)
        violations.append(Violation(
            "run-completed",
            f"{desc} never succeeded in {SAI_ATTEMPTS} attempts"))
        return None

    def run():
        nonlocal fence_rejected
        # interleave: part, then a delta layer that arrived during it
        li = 0
        for pi, batches in enumerate(parts):
            attempt(lambda b=batches, i=pi: store.put_base(
                table, f"p{i}", 1, b), f"put_base p{pi}")
            if rng.random() < 0.3:
                # lost ack: the worker re-lands the same part at the
                # same epoch — replace, never duplicate
                attempt(lambda b=batches, i=pi: store.put_base(
                    table, f"p{i}", 1, b), f"put_base p{pi} (redo)")
            if li < len(layers):
                w, s, lb = layers[li]
                li += 1
                d = attempt(lambda: store.append_delta(table, w, s, lb),
                            f"append ({w},{s})")
                if d is not None:
                    tracker.record("mvcc:watermark", store.watermark())
                if d is not None and rng.random() < 0.3:
                    # lost ack on the admission RPC: the re-append must
                    # REPLACE under the (worker, seq) convention
                    d2 = attempt(
                        lambda: store.append_delta(table, w, s, lb),
                        f"append ({w},{s}) (redo)")
                    if d2 is not None and d2.get("status") != "replaced":
                        violations.append(Violation(
                            "idempotent-append",
                            f"pre-cutover re-append of ({w},{s}) got "
                            f"{d2.get('status')!r}, want 'replaced'"))
        # mid-snapshot zombie: a pre-reclaim worker re-publishes part 0
        # at a STALE epoch after the survivor landed epoch 2
        attempt(lambda: store.put_base(table, "p0", 2, parts[0]),
                "put_base p0 (reclaimed)")
        try:
            store.put_base(table, "p0", 1, parts[0])
            violations.append(Violation(
                "zombie-fenced",
                "stale-epoch put_base of p0 was NOT fenced"))
        except StaleEpochPublishError:
            fence_rejected += 1
        # remaining deltas land after the snapshot finished
        while li < len(layers):
            w, s, lb = layers[li]
            li += 1
            if attempt(lambda: store.append_delta(table, w, s, lb),
                       f"append ({w},{s})") is not None:
                tracker.record("mvcc:watermark", store.watermark())
        # the cutover: ONE fenced decision; the retry after an injected
        # abort must re-seal identically
        d = attempt(lambda: store.cutover(epoch=2), "cutover")
        if d is not None and not d.get("granted"):
            violations.append(Violation(
                "cutover-granted", f"cutover not granted: {d}"))
        sealed = store.sealed()
        if sealed is not None:
            tracker.record("mvcc:watermark", sealed[0])
        # post-cutover zombie delta: a NEW layer must be fenced...
        zb = ColumnBatch.from_pydict(tid, schema, {
            "id": [10 ** 9], "segment": ["s0"], "amount": [0.0]},
            kinds=np.array([KIND_CODES[Kind.INSERT]], dtype=np.int8),
            lsns=np.array([10 ** 6], dtype=np.int64))
        z = attempt(lambda: store.append_delta(table, "w9", 0, [zb]),
                    "zombie append")
        if z is not None:
            if z.get("status") == "fenced":
                fence_rejected += 1
            else:
                violations.append(Violation(
                    "zombie-fenced",
                    f"post-cutover NEW layer got {z.get('status')!r}, "
                    f"want 'fenced'"))
        # ...while a re-put of a layer that WAS in the decision is an
        # idempotent ack
        w, s, lb = layers[0]
        dup = attempt(lambda: store.append_delta(table, w, s, lb),
                      "duplicate append")
        if dup is not None and dup.get("status") != "duplicate":
            violations.append(Violation(
                "idempotent-append",
                f"post-cutover re-append of ({w},{s}) got "
                f"{dup.get('status')!r}, want 'duplicate'"))
        layered = store.read_at(table)
        # compaction folds the layers; the read must not change
        attempt(lambda: compact_table(store, table), "compact")
        compacted = store.read_at(table)
        if [b.to_pydict() for b in layered] != \
                [b.to_pydict() for b in compacted]:
            violations.append(Violation(
                "compaction-equivalence",
                "read_at differs between layered and compacted state"))
        return layered

    if spec:
        with failpoints.active(spec, seed=seed * 1000 + trial):
            read = run()
            fires = failpoints.fire_counts()
            log = failpoints.fire_log()
    else:
        read = run()
        fires, log = {}, {}
    return {
        "read": read, "fires": fires, "fire_log": log,
        "violations": violations, "kills": kills,
        "fence_rejected": fence_rejected, "tracker": tracker,
        "logs": {"admit": list(cp.mvcc_admit_log),
                 "cutover": list(cp.mvcc_cutover_log)},
    }


def run_snapshot_and_increment_trial(trial: int, seed: int, rows: int,
                                     spec: Optional[str] = None,
                                     device: DeviceLike = None
                                     ) -> TrialResult:
    rows = min(rows, SAI_ROWS)
    spec = spec if spec is not None else snapshot_and_increment_schedule(
        trial, seed)
    t0 = time.monotonic()
    violations: list[Violation] = []
    delivered = 0
    total_dup = 0
    kills = 0
    restarts = 0
    fence_rejected = 0
    fires: dict = {}
    fire_logs: dict = {}
    commit_log: list = []
    # each scenario runs its own reference + two seeded replays; the
    # fire + admission + cutover logs of r1/r2 must be byte-identical
    # per seed, and both faulted reads must equal the fault-free one
    # (the pump scenario is skipped: SAI_PUMP_SKIPPED)
    scenarios = (
        ("layered", lambda sp, lbl: _sai_scenario(
            trial, seed, rows, sp, lbl, device)),
    )
    for sname, scenario in scenarios:
        ref_run = scenario(None, f"{sname}-ref")
        for v in ref_run["violations"]:
            violations.append(Violation(
                v.invariant,
                f"{sname}: fault-free reference run: {v.detail}"))
        reference = DeliveryReference.from_batches(ref_run["read"], device)
        first = scenario(spec, f"{sname}-r1")
        second = scenario(spec, f"{sname}-r2")
        for v in first["violations"]:
            violations.append(Violation(
                v.invariant, f"{sname}: {v.detail}"))
        for v in second["violations"]:
            violations.append(Violation(
                v.invariant, f"{sname}: replay run: {v.detail}"))
        if first["fire_log"] != second["fire_log"]:
            violations.append(Violation(
                "seed-replay",
                f"{sname}: fire log diverged between two runs of "
                f"seed {seed}: {first['fire_log']} vs "
                f"{second['fire_log']}"))
        for name in ("admit", "cutover"):
            if first["logs"][name] != second["logs"][name]:
                violations.append(Violation(
                    "seed-replay",
                    f"{sname}: mvcc {name} log diverged between two "
                    f"runs of seed {seed}: {first['logs'][name]} vs "
                    f"{second['logs'][name]}"))
        # exactly-once: retries, lost acks, kills, rebuilds, zombies
        # and the compaction fold may not duplicate or lose a row
        for label, run in (("", first), ("replay run: ", second)):
            v = audit_delivery(reference, run["read"], 1,
                               run["tracker"], exactly_once=True,
                               device=device)
            delivered += v.delivered_rows
            total_dup += v.duplicate_rows
            if not v.passed:
                for viol in v.violations:
                    violations.append(Violation(
                        viol.invariant, f"{sname}: {label}{viol.detail}"))
        for site, n in first["fires"].items():
            fires[site] = fires.get(site, 0) + n
        fire_logs.update({f"{sname}:{k}": v
                          for k, v in first["fire_log"].items()})
        kills += first["kills"] + second["kills"]
        restarts += first["kills"]
        fence_rejected += first["fence_rejected"] + \
            second["fence_rejected"]
        commit_log.extend(first["logs"]["cutover"])
    seconds = time.monotonic() - t0
    verdict = AuditVerdict(passed=not violations, violations=violations,
                           delivered_rows=delivered,
                           duplicate_rows=total_dup)
    return TrialResult(
        mode="snapshot_and_increment", trial=trial, seed=seed,
        spec=spec, verdict=verdict, fire_counts=fires,
        fire_log=fire_logs, seconds=seconds,
        kills=kills, restarts=restarts,
        fence_rejected=fence_rejected,
        commit_log=commit_log,
        skipped=[{"what": "snapshot_and_increment pump scenario",
                  "reason": SAI_PUMP_SKIPPED}])


# -- entry point -------------------------------------------------------------

def run_trials(trials: int = 5, seed: int = 7, mode: str = "both",
               rows: int = SNAPSHOT_ROWS,
               messages: int = REPLICATION_MESSAGES,
               spec: Optional[str] = None,
               metrics=None,
               device: DeviceLike = None) -> ChaosReport:
    """Run N seeded chaos trials per requested mode and audit each, on
    `device` (CUDA unless the caller passes "cpu"; without a card this
    raises before any trial runs)."""
    dev = resolve_device(device)
    failpoints.reset()  # trials own the registry for their duration
    report = ChaosReport()
    if mode == "both":
        modes = ("snapshot", "replication")
    elif mode == "all":
        modes = ("snapshot", "replication", "worker_crash",
                 "scheduler_kill", "fleet_distributed", "lock_order",
                 "arrow_ipc", "exactly_once", "snapshot_and_increment")
    else:
        modes = (mode,)
    if "arrow_ipc" in modes:
        logger.warning("chaos: skipping arrow_ipc mode (%s)",
                       ARROW_IPC_SKIPPED)
        report.skipped.append({"what": "arrow_ipc mode",
                               "reason": ARROW_IPC_SKIPPED})
        modes = tuple(m for m in modes if m != "arrow_ipc")
    with _fast_retries(), _forced_device_placement() as device_ok:
        if "snapshot" in modes:
            ref = _snapshot_reference(rows, dev)
            for t in range(trials):
                r = run_snapshot_trial(t, seed, rows, ref, spec=spec,
                                       device_ok=bool(device_ok),
                                       device=dev)
                report.results.append(r)
                logger.info("chaos snapshot trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
        if "worker_crash" in modes:
            ref = _snapshot_reference(rows, dev)
            for t in range(trials):
                r = run_worker_crash_trial(t, seed, rows, ref, spec=spec,
                                           device=dev)
                report.results.append(r)
                logger.info("chaos worker_crash trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
        if "scheduler_kill" in modes:
            ref = _snapshot_reference(rows, dev)
            for t in range(trials):
                r = run_scheduler_kill_trial(t, seed, rows, ref,
                                             spec=spec, device=dev)
                report.results.append(r)
                logger.info("chaos scheduler_kill trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
        if "fleet_distributed" in modes:
            ref = _snapshot_reference(min(rows, FLEET_DIST_ROWS), dev)
            for t in range(trials):
                r = run_fleet_distributed_trial(t, seed, rows, ref,
                                                spec=spec, device=dev)
                report.results.append(r)
                logger.info("chaos fleet_distributed trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
        if "lock_order" in modes:
            ref = _snapshot_reference(min(rows, FLEET_DIST_ROWS), dev)
            for t in range(trials):
                r = run_lock_order_trial(t, seed, rows, ref, spec=spec,
                                         metrics=metrics, device=dev)
                report.results.append(r)
                logger.info("chaos lock_order trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
        if "exactly_once" in modes:
            from transferia_tpu_torch.chaos import wire_backends

            backends = []
            for b in EXACTLY_ONCE_BACKENDS:
                ok, reason = wire_backends.backend_available(b)
                if ok:
                    backends.append(b)
                else:
                    logger.warning("chaos: exactly_once skipping %s "
                                   "(%s)", b, reason)
                    report.skipped.append({
                        "what": f"exactly_once backend {b}",
                        "reason": reason})
            for backend in backends:
                ref = _exactly_once_reference(rows, backend, dev)
                for t in range(trials):
                    r = run_exactly_once_trial(t, seed, rows, ref,
                                               backend=backend,
                                               spec=spec, device=dev)
                    report.results.append(r)
                    logger.info(
                        "chaos exactly_once[%s] trial %d: %s", backend,
                        t, r.verdict.summary().splitlines()[0])
        if "snapshot_and_increment" in modes:
            logger.warning("chaos: snapshot_and_increment skipping the "
                           "pump scenario (%s)", SAI_PUMP_SKIPPED)
            report.skipped.append({
                "what": "snapshot_and_increment pump scenario",
                "reason": SAI_PUMP_SKIPPED})
            for t in range(trials):
                r = run_snapshot_and_increment_trial(t, seed, rows,
                                                     spec=spec,
                                                     device=dev)
                report.results.append(r)
                logger.info("chaos snapshot_and_increment trial %d: %s",
                            t, r.verdict.summary().splitlines()[0])
        if "replication" in modes:
            ref = _replication_reference(messages, dev)
            for t in range(trials):
                r = run_replication_trial(t, seed, messages, ref,
                                          spec=spec, device=dev)
                report.results.append(r)
                logger.info("chaos replication trial %d: %s", t,
                            r.verdict.summary().splitlines()[0])
    if metrics is not None:
        _fold_report(report, metrics)
    return report


def _fold_report(report: ChaosReport, metrics) -> None:
    from transferia_tpu_torch.stats.registry import ChaosStats

    stats = ChaosStats(metrics)
    stats.trials.inc(len(report.results))
    for r in report.results:
        if not r.passed:
            stats.invariant_failures.inc()
        stats.duplicates_absorbed.inc(r.verdict.duplicate_rows)
        stats.restarts.inc(r.restarts)
    for site, n in report.sites_fired().items():
        stats.record_site(site, n)
