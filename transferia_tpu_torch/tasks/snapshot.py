"""SnapshotLoader: the snapshot engine (the port's copy of the main-worker
flow of ``transferia_tpu/tasks/snapshot.py``).

`process_count` upload threads pull parts from the coordinator's queue
(a claim is a lease, renewed by a heartbeat thread); each part gets a
fresh sink pipeline from the factory with snapshot-stage retries, its
rows bracketed by Init/DoneTableLoad control events, and — where both
the sink and the coordinator can — a staged two-phase commit: the rows
stage invisibly and publish only after the coordinator's fenced
`commit_part`.  With `validation: {fingerprint: true}` each part's
post-transform rows stream through a fingerprint tap on the loader's
device and the per-part digests merge into per-table digests in the
operation state.

`device` is where every part's pipeline runs its device work (the
chain's fused steps, the tap, the staged-row keys): None means CUDA,
which must be present; "cpu" runs the kernels' plain versions.

Sharded across processes (`runtime.sharding.job_count` > 1 on a
coordinator every worker reaches, the filestore one): job 0, the main,
splits the tables and publishes the part queue, uploads with the others
and waits for the queue to drain; jobs 1..N-1, the secondaries, wait for
the queue, apply the main's sharded source state, release their own
stale claims and upload.  `resume=True` reuses an incomplete queue as
the checkpoint and uploads only what is not committed.  A storage that
discovers its parts asynchronously (AsyncPartDiscovery: the s3 source,
one part an object) publishes them from a thread of its own while the
upload runs, in flushes of 64 parts or 0.1 s; the workers wait on the
queue until `parts_discovery_done` flips.  Under a fleet worker
(fleet/worker.py) `preempted` is polled before every part claim: when
it answers True the upload threads stop at the part boundary and the
loader raises TransferPreemptedError, leaving the committed parts as
the point a later `resume=True` claim continues from.  A
PositionalStorage's position at the
start lands in the transfer state as `snapshot_position`; the
regular snapshot's incremental tables read only the rows past their
persisted cursors (`incremental_state`, stored after a whole run).

Telemetry as in the reference: the `snapshot_op` root span and the
operation's ledger scope, adopted by the upload threads and the
heartbeat; a `part` span and ledger scope per part with a `batch` span
per pushed batch (`snapshot.part.batch` failpoint), the retry, steal,
fence and publish instants with their ledger counts, the
`part_upload` histogram and the device-counter and ledger folds at
part completion, and the fleet observability export (stats/fleetobs.py)
at each part, each heartbeat and the end of the run, on coordinators
that keep obs segments.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from transferia_tpu_torch.abstract.change_item import (
    done_sharded_table_load,
    done_table_load,
    init_sharded_table_load,
    init_table_load,
)
from transferia_tpu_torch.abstract.commit import find_staged_sink
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.abstract.errors import (
    CodedError,
    Codes,
    StaleEpochPublishError,
    TableUploadError,
    TransferPreemptedError,
    WorkerKilledError,
    is_preemption,
    is_retriable,
)
from transferia_tpu_torch.abstract.interfaces import (
    AsyncPartDiscovery,
    IncrementalStorage,
    IncrementalTable,
    PositionalStorage,
    ShardedStateStorage,
    SnapshotableStorage,
    Storage,
    resolve_all,
)
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import (
    OperationTablePart,
    TableDescription,
)
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    lease_expired,
)
from transferia_tpu_torch.factories import make_async_sink, new_storage
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import fleetobs, hdr, trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import (
    CommitStats,
    LeaseStats,
    Metrics,
    TableStats,
)
from transferia_tpu_torch.tasks.table_splitter import split_tables
from transferia_tpu_torch.utils.backoff import retry_with_backoff

logger = logging.getLogger(__name__)

PART_RETRIES = 3
PART_RETRY_BASE_DELAY = 1.0

# Staged two-phase sink commits: on by default wherever both the sink
# and the coordinator are capable; "off"/"0" forces every sink back to
# the at-least-once path.
ENV_STAGED_COMMIT = "TRANSFERIA_TPU_STAGED_COMMIT"


def staged_commits_enabled() -> bool:
    return knobs.env_str(ENV_STAGED_COMMIT, "auto").lower() not in (
        "off", "0", "false", "no")


@dataclass
class SnapshotTuning:
    """Deadline/poll knobs, overridable through the environment."""

    # secondary waiting for the main to publish the part queue
    secondary_bootstrap_timeout: float = 600.0
    # main's join loop over secondaries draining the queue
    wait_poll: float = 0.5
    wait_timeout: float = 24 * 3600.0
    # no progress and no live lease for this long: every worker holding
    # work is dead and nobody is reclaiming
    stall_timeout: float = 600.0
    # lease-renewal heartbeat period
    heartbeat_interval: float = 5.0

    @classmethod
    def from_env(cls) -> "SnapshotTuning":
        return cls(
            secondary_bootstrap_timeout=knobs.env_float(
                "TRANSFERIA_TPU_SNAPSHOT_BOOTSTRAP_TIMEOUT", 600.0),
            wait_poll=knobs.env_float(
                "TRANSFERIA_TPU_SNAPSHOT_WAIT_POLL", 0.5),
            wait_timeout=knobs.env_float(
                "TRANSFERIA_TPU_SNAPSHOT_WAIT_TIMEOUT", 24 * 3600.0),
            stall_timeout=knobs.env_float(
                "TRANSFERIA_TPU_SNAPSHOT_STALL_TIMEOUT", 600.0),
            heartbeat_interval=knobs.env_float(
                "TRANSFERIA_TPU_HEARTBEAT_INTERVAL", 5.0),
        )


TUNING = SnapshotTuning.from_env()


class SnapshotLoader:
    def __init__(self, transfer, coordinator: Coordinator,
                 operation_id: Optional[str] = None,
                 metrics: Optional[Metrics] = None,
                 preempted: "Optional[Callable[[], bool]]" = None,
                 resume: bool = False,
                 device: DeviceLike = None):
        # fleet preemption probe (fleet/worker.py): polled between
        # parts; True = stop claiming and raise TransferPreemptedError
        # (the committed parts stay, the transfer resumes elsewhere)
        self._preempted = preempted
        # resume a previous attempt's operation: reuse an existing part
        # queue instead of recreating it (recreating would reset the
        # completed flags and replay the whole snapshot)
        self.resume = resume
        self.transfer = transfer
        self.cp = coordinator
        self.device = resolve_device(device)
        # deterministic default: workers agree on the operation id
        # without a side channel
        self.operation_id = operation_id or f"op-{transfer.id}"
        self.metrics = metrics or Metrics()
        self.table_stats = TableStats(self.metrics)
        self.lease_stats = LeaseStats(self.metrics)
        self.commit_stats = CommitStats(self.metrics)
        # staged commits need a coordinator that can fence the publish
        # decision; the sink side is probed per part
        self._staged_commits = staged_commits_enabled() and \
            coordinator.supports_staged_commits()
        self.worker_index = transfer.runtime.current_job
        self.process_count = max(1, transfer.runtime.sharding.process_count)
        self.is_main = transfer.runtime.is_main
        self._progress_lock = threading.Lock()
        # heartbeat-visible progress (folded into operation_health)
        self._phase = "init"
        self._local_parts_done = 0
        self._local_rows_done = 0
        # tables whose scan predicate has been computed
        self._pushdown_done: set = set()
        # fleet observability export stream (stats/fleetobs.py): under a
        # fleet worker this joins the worker's ambient stream; a bare
        # loader exports under its own label; a no-op on coordinators
        # without obs segments
        self._obs = fleetobs.exporter_for(
            coordinator, worker=f"snap.w{self.worker_index}."
                                f"{os.getpid()}")

    # -- entry points ---------------------------------------------------------
    def upload_tables(self, tables: Optional[list[TableDescription]] = None
                      ) -> None:
        """Snapshot the given tables (None = all tables passing the
        transfer's include filter)."""
        storage = new_storage(self.transfer, self.metrics)
        # the operation root: every part/batch/device span of this
        # snapshot nests (or flows, across worker threads) under it,
        # and every resource event bills this transfer in the ledger
        op_sp = trace.span("snapshot_op", transfer_id=self.transfer.id,
                           operation_id=self.operation_id,
                           worker=self.worker_index)
        try:
            with op_sp, LEDGER.context(transfer_id=self.transfer.id):
                if tables is None:
                    tables = self.filtered_table_list(storage)
                if self.is_main:
                    self._main_flow(storage, tables)
                else:
                    self._secondary_flow(storage)
        finally:
            storage.close()
            # final observability flush: what this operation spent
            # survives the process even if it exits right after
            self._obs.export("final")

    def filtered_table_list(self, storage: Storage
                            ) -> list[TableDescription]:
        """Apply the transfer's include-list."""
        include = self.transfer.include_ids() or None
        infos = storage.table_list(include)
        out = [
            TableDescription(id=tid, eta_rows=info.eta_rows)
            for tid, info in infos.items()
        ]
        out.sort(key=lambda t: -t.eta_rows)
        return out

    # -- incremental cursors -------------------------------------------------
    def _incremental_tables(self) -> list[IncrementalTable]:
        return [
            IncrementalTable(TableID(c.namespace, c.name), c.cursor_field,
                             c.initial_state)
            for c in self.transfer.regular_snapshot.incremental
        ]

    def _apply_incremental(self, storage: Storage,
                           tables: list[TableDescription]
                           ) -> tuple[list[TableDescription], Optional[dict]]:
        inc = self._incremental_tables()
        if not inc or not isinstance(storage, IncrementalStorage):
            return tables, None
        # capture the next cursor BEFORE loading: rows arriving during the
        # snapshot are read again next time instead of being skipped
        next_state = storage.next_increment_state(inc)
        state = self.cp.get_transfer_state(self.transfer.id).get(
            "incremental_state", {}
        )
        filtered = {td.id: td for td in
                    storage.get_increment_state(inc, state)}
        merged = [filtered.get(td.id, td) for td in tables]
        return merged, next_state

    # -- main worker ----------------------------------------------------------
    def _main_flow(self, storage: Storage,
                   tables: list[TableDescription]) -> None:
        if isinstance(storage, SnapshotableStorage):
            storage.begin_snapshot()
        try:
            if isinstance(storage, PositionalStorage):
                pos = storage.position()
                if pos:
                    self.cp.set_transfer_state(
                        self.transfer.id, {"snapshot_position": pos})
            tables, next_inc_state = self._apply_incremental(storage, tables)
            # main-worker restart detection: an incomplete queue means a
            # previous main crashed mid-operation with secondaries
            # possibly still attached; a completed one is the previous
            # activation, recreated.  Under `resume` an existing queue is
            # reused instead: its committed parts are the checkpoint
            existing = self.cp.operation_parts(self.operation_id) \
                if (self.job_count() > 1 or self.resume) else []
            resume_queue = bool(self.resume and existing)
            if existing and not resume_queue \
                    and not all(p.completed for p in existing):
                raise CodedError(
                    Codes.MAIN_WORKER_RESTART,
                    f"operation {self.operation_id} has incomplete parts: "
                    f"the main worker restarted mid-operation",
                )
            if isinstance(storage, ShardedStateStorage) and \
                    self.job_count() > 1:
                # consistent-point handoff to secondaries' storages
                self.cp.set_operation_state(self.operation_id, {
                    "sharded_state": storage.sharded_state(),
                })
            if resume_queue:
                # release the claims a previous attempt of this worker
                # index left leased (its later updates are epoch-fenced),
                # then upload whatever is incomplete
                released = self.cp.clear_assigned_parts(
                    self.operation_id, self.worker_index)
                done = sum(1 for p in existing if p.completed)
                trace.instant("snapshot_resume",
                              operation_id=self.operation_id,
                              parts=len(existing), completed=done,
                              released=released)
                logger.info(
                    "resuming operation %s: %d/%d part(s) already "
                    "committed (%d stale claim(s) released)",
                    self.operation_id, done, len(existing), released)
                self.cp.set_operation_state(
                    self.operation_id, {"parts_discovery_done": True})
                multi_part = {
                    p.table_id for p in existing if p.parts_count > 1
                }
                # the first attempt sent the init brackets
                self._upload_publish_tail(storage, tables, multi_part,
                                          None, next_inc_state,
                                          send_init=False)
                return
            # a fresh run must reset the discovery flag (a re-activation
            # would otherwise see the previous run's True and drain early)
            self.cp.set_operation_state(self.operation_id,
                                        {"parts_discovery_done": False})
            discovery = None
            if isinstance(storage, AsyncPartDiscovery):
                # reset the queue (re-activation leftovers) before parts
                # stream in via add_operation_parts
                self.cp.create_operation_parts(self.operation_id, [])
                discovery = self._start_async_discovery(storage, tables)
                multi_part = {td.id for td in tables}
            else:
                parts = split_tables(storage, tables, self.transfer,
                                     self.operation_id)
                self.cp.create_operation_parts(self.operation_id, parts)
                self.cp.set_operation_state(self.operation_id,
                                            {"parts_discovery_done": True})
                self.table_stats.total_parts.set(len(parts))
                self.table_stats.eta_rows.set(
                    sum(p.eta_rows for p in parts))
                multi_part = {p.table_id for p in parts
                              if p.parts_count > 1}
            self._upload_publish_tail(storage, tables, multi_part,
                                      discovery, next_inc_state,
                                      send_init=True)
        finally:
            if isinstance(storage, SnapshotableStorage):
                storage.end_snapshot()

    def _upload_publish_tail(self, storage: Storage, tables,
                             multi_part: set, discovery, next_inc_state,
                             send_init: bool) -> None:
        """Upload, sharded join, done-brackets, incremental cursors,
        fingerprints: the back half of both the fresh and the resumed
        run.  `send_init=False` on resume: re-sending the init brackets
        could reset sink-side sharded-table state."""
        schemas = {td.id: storage.table_schema(td.id) for td in tables}
        sink = make_async_sink(self.transfer, self.metrics,
                               snapshot_stage=True, device=self.device)
        try:
            if send_init:
                futs = [
                    sink.async_push([init_sharded_table_load(
                        tid, schemas.get(tid))])
                    for tid in multi_part
                ]
                resolve_all(futs)
            self._do_upload_tables(storage, schemas)
            if discovery is not None:
                discovery.join()
                if self._discovery_error:
                    raise self._discovery_error
            if self.job_count() > 1:
                self._wait_all_parts_done()
            futs = [
                sink.async_push([done_sharded_table_load(
                    tid, schemas.get(tid))])
                for tid in multi_part
            ]
            resolve_all(futs)
        finally:
            sink.close()
        if next_inc_state is not None:
            # persist cursors only after the whole snapshot succeeded
            self.cp.set_transfer_state(
                self.transfer.id,
                {"incremental_state": next_inc_state},
            )
        self._publish_fingerprints()

    def _publish_fingerprints(self) -> None:
        """Merge per-part fingerprints into per-table snapshot digests
        (order-independent) and record them in the operation state."""
        if not self.transfer.fingerprint_validation():
            return
        from transferia_tpu_torch.ops.rowhash import FingerprintAggregate

        per_table: dict[str, FingerprintAggregate] = {}
        for part in self.cp.operation_parts(self.operation_id):
            if not part.fingerprint:
                continue
            if part.fingerprint.startswith("{"):
                # JSON mapping of output-table fqtn -> digest (renaming
                # chains); the compact form means output == source
                try:
                    mapping = json.loads(part.fingerprint)
                except ValueError:
                    logger.warning(
                        "part %s carries a malformed fingerprint map",
                        part.key())
                    continue
            else:
                mapping = {part.table_id.fqtn(): part.fingerprint}
            for fqtn, dg in mapping.items():
                agg = per_table.setdefault(fqtn, FingerprintAggregate())
                try:
                    agg.merge(FingerprintAggregate.parse(dg))
                except ValueError:
                    logger.warning(
                        "part %s carries a malformed fingerprint",
                        part.key())
        if not per_table:
            return
        digests = {t: a.digest() for t, a in per_table.items()}
        self.cp.set_operation_state(self.operation_id,
                                    {"table_fingerprints": digests})
        for t, d in sorted(digests.items()):
            logger.info("snapshot fingerprint %s: %s", t, d)

    def job_count(self) -> int:
        return max(1, self.transfer.runtime.sharding.job_count)

    # -- async part discovery (tpp_setter_async.go) -------------------------
    def _start_async_discovery(self, storage: AsyncPartDiscovery,
                               tables: list[TableDescription]
                               ) -> threading.Thread:
        """Publish parts concurrently with the upload: huge table or
        object lists must not serialize activation.  Upload workers wait
        on the part queue until parts_discovery_done flips."""
        self._discovery_error: Optional[BaseException] = None
        op_ctx = trace.current_context()

        def discover():
            total = 0
            eta = 0
            try:
                with trace.adopted(op_ctx):
                    for td in tables:
                        batch: list[OperationTablePart] = []
                        last_flush = time.monotonic()
                        for part_td in storage.iter_table_parts(td):
                            batch.append(OperationTablePart(
                                operation_id=self.operation_id,
                                table_id=td.id,
                                part_index=total,
                                parts_count=0,  # unknown until drained
                                eta_rows=part_td.eta_rows,
                                filter=part_td.filter,
                            ))
                            total += 1
                            eta += part_td.eta_rows
                            # flush by count OR age: workers must see
                            # parts promptly even when discovery trickles
                            if len(batch) >= 64 or \
                                    time.monotonic() - last_flush > 0.1:
                                self.cp.add_operation_parts(
                                    self.operation_id, batch)
                                batch = []
                                last_flush = time.monotonic()
                        if batch:
                            self.cp.add_operation_parts(self.operation_id,
                                                        batch)
                self.table_stats.total_parts.set(total)
                self.table_stats.eta_rows.set(eta)
                trace.instant("parts_discovered",
                              operation_id=self.operation_id, parts=total)
                logger.info("async discovery: %d parts published", total)
            except BaseException as e:  # re-raised in the main flow
                self._discovery_error = e
            finally:
                self.cp.set_operation_state(
                    self.operation_id, {"parts_discovery_done": True})

        t = threading.Thread(target=discover, name="part-discovery",
                             daemon=True)
        t.start()
        return t

    def _discovery_open(self) -> bool:
        return not self.cp.get_operation_state(self.operation_id).get(
            "parts_discovery_done")

    def _wait_all_parts_done(self, poll: Optional[float] = None,
                             timeout: Optional[float] = None) -> None:
        """The main worker waits for secondaries to drain the queue.

        Lease-aware: while a pending part carries a live lease (or
        progress advances) somebody is working.  When nothing has a live
        lease and nothing changes for `stall_timeout`, every worker
        holding work is dead: fail fast naming the orphaned parts."""
        poll = TUNING.wait_poll if poll is None else poll
        timeout = TUNING.wait_timeout if timeout is None else timeout
        self._phase = "waiting"
        deadline = time.monotonic() + timeout
        last_sig = None
        last_change = time.monotonic()
        while time.monotonic() < deadline:
            parts = self.cp.operation_parts(self.operation_id)
            pending = [p for p in parts if not p.completed]
            if not pending and (parts or not self._discovery_open()):
                return
            now = time.time()
            sig = (
                len(parts),
                sum(1 for p in parts if p.completed),
                sum(p.completed_rows for p in parts),
                sum(p.assignment_epoch for p in parts),
                max((p.lease_expires_at for p in pending), default=0.0),
            )
            if sig != last_sig:
                last_sig = sig
                last_change = time.monotonic()
            # a claim without a lease deadline gives no liveness signal
            live = [p for p in pending
                    if p.worker_index is not None
                    and not lease_expired(p, now)]
            # fail fast only for a fleet that was here and died: an
            # entirely unclaimed queue means secondaries are slow to start
            claimed_ever = any(p.assignment_epoch > 0 for p in pending)
            stalled = time.monotonic() - last_change
            if not live and claimed_ever and \
                    stalled > TUNING.stall_timeout:
                raise CodedError(
                    Codes.SNAPSHOT_PARTS_ORPHANED,
                    self._orphan_diagnostic(pending, now, stalled),
                )
            self.cp.operation_health(self.operation_id, self.worker_index,
                                     {"phase": "waiting",
                                      "pending_parts": len(pending)})
            time.sleep(poll)
        raise TimeoutError(
            f"operation {self.operation_id}: parts not drained in time"
        )

    def _orphan_diagnostic(self, pending: list[OperationTablePart],
                           now: float, stalled: float) -> str:
        """Name each orphaned part, its last-seen worker and that
        worker's last heartbeat."""
        health = {}
        try:
            health = self.cp.get_operation_health(self.operation_id)
        except Exception:  # diagnostics must not mask the failure
            logger.exception("operation health read failed")
        lines = []
        for p in sorted(pending, key=lambda p: p.key()):
            holder = p.worker_index if p.worker_index is not None \
                else p.stolen_from
            if holder is None:
                lines.append(f"{p.key()}: never claimed")
                continue
            age = now - p.lease_expires_at if p.lease_expires_at > 0 \
                else None
            beat = (health.get(holder) or {}).get("ts")
            lines.append(
                f"{p.key()}: last seen on worker {holder}"
                + (f", lease expired {age:.1f}s ago" if age is not None
                   else ", no lease")
                + (f", last heartbeat {now - beat:.1f}s ago"
                   if beat else ", no heartbeat on record"))
        return (
            f"operation {self.operation_id}: {len(lines)} part(s) "
            f"orphaned — no live lease and no progress for "
            f"{stalled:.1f}s, and no surviving worker reclaimed them: "
            + "; ".join(lines)
        )

    # -- secondary worker -----------------------------------------------------
    def _secondary_flow(self, storage: Storage) -> None:
        """A sharded secondary: wait for the part queue, apply the main's
        sharded source state, release this worker's stale claims
        (restart recovery), pull and upload."""
        self._phase = "bootstrap"
        deadline = time.monotonic() + TUNING.secondary_bootstrap_timeout
        while not self.cp.operation_parts(self.operation_id):
            if self.cp.get_operation_state(self.operation_id).get(
                    "parts_discovery_done"):
                # discovery found zero parts: nothing to upload
                logger.info("secondary %d: discovery done with empty "
                            "part queue", self.worker_index)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"operation {self.operation_id}: main worker never "
                    f"published parts"
                )
            time.sleep(0.2)
        if isinstance(storage, ShardedStateStorage):
            state = self.cp.get_operation_state(self.operation_id).get(
                "sharded_state")
            if state is not None:
                # read from the main's consistent point
                storage.set_sharded_state(state)
        released = self.cp.clear_assigned_parts(self.operation_id,
                                                self.worker_index)
        if released:
            logger.info("secondary %d: released %d stale parts after "
                        "restart", self.worker_index, released)
        self._do_upload_tables(storage, {})

    # -- the hot loop ---------------------------------------------------------
    def _setup_scan_pushdown(self, storage: Storage,
                             schemas: dict) -> None:
        """Push the chain's leading row filter into the scan when the
        storage supports it (ScanPredicateStorage).  Advisory: the chain
        re-applies the predicate."""
        for tid, schema in schemas.items():
            self._push_scan_predicate(storage, tid, schema)

    def _push_scan_predicate(self, storage: Storage, tid,
                             schema) -> None:
        """Install the pushable predicate for one table (set-once)."""
        from transferia_tpu_torch.abstract.interfaces import (
            ScanPredicateStorage,
        )

        if not isinstance(storage, ScanPredicateStorage):
            return
        if tid in self._pushdown_done:
            return
        self._pushdown_done.add(tid)
        from transferia_tpu_torch.transform.chain import build_chain

        chain = build_chain(self.transfer.transformation,
                            device=self.device)
        if chain is None or schema is None:
            return
        try:
            node = chain.pushable_predicate(tid, schema)
        except Exception:
            return
        if node is not None and storage.set_scan_predicate(tid, node):
            logger.info("scan pushdown for %s: %s", tid, node)

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        """Renew this worker's part leases and fold phase/progress into
        the coordinator's operation_health reports; transient failures
        are tolerated (the lease TTL absorbs missed beats)."""
        while not stop.wait(TUNING.heartbeat_interval):
            try:
                failpoint("snapshot.lease_renew")
                sp = trace.span("lease_renew", worker=self.worker_index)
                with sp:
                    renewed = self.cp.renew_lease(self.operation_id,
                                                  self.worker_index)
                if sp:
                    sp.add(renewed=renewed)
                self.lease_stats.renewals.inc(renewed)
                with self._progress_lock:
                    payload = {
                        "phase": self._phase,
                        "parts_done": self._local_parts_done,
                        "rows": self._local_rows_done,
                        "leases": renewed,
                    }
                self.cp.operation_health(self.operation_id,
                                         self.worker_index, payload)
                # observability export at heartbeat cadence: a SIGKILL
                # between beats loses at most one export interval
                self._obs.export("periodic")
            except WorkerKilledError:
                logger.error(
                    "worker %d heartbeat killed: lease renewals stop, "
                    "parts will be reclaimed after expiry",
                    self.worker_index)
                return
            except Exception as e:
                self.lease_stats.heartbeat_failures.inc()
                logger.warning("worker %d heartbeat failed "
                               "(lease TTL absorbs it): %s",
                               self.worker_index, e)

    def _do_upload_tables(self, storage: Storage, schemas: dict) -> None:
        """ProcessCount workers pull parts from the coordinator until the
        queue drains.  A claim is a lease: drained workers linger while
        other workers hold live leases and reclaim their parts if the
        leases expire."""
        self._setup_scan_pushdown(storage, schemas)
        self._phase = "uploading"
        errors: list[BaseException] = []
        err_lock = threading.Lock()

        def linger_wait() -> bool:
            """Nothing assignable now.  True = keep looping (other
            workers hold live leases that may expire), False = done."""
            pending = [p for p in
                       self.cp.operation_parts(self.operation_id)
                       if not p.completed]
            if not pending:
                return False
            if all(p.worker_index == self.worker_index
                   for p in pending):
                # held by this worker's own sibling threads
                return False
            now = time.time()
            expiries = [p.lease_expires_at - now for p in pending
                        if p.lease_expires_at > 0]
            if not expiries:
                if any(p.worker_index is None for p in pending):
                    # assign race: claimable on the next pass
                    time.sleep(0.05)
                    return True
                # lease-less claims never expire: nothing to reclaim
                return False
            time.sleep(min(1.0, max(0.05, min(expiries))))
            return True

        # causal hop: upload worker threads (and the heartbeat) adopt the
        # submitting scope, so part spans parent to the operation span
        # and their resource events bill the right transfer
        op_ctx = trace.current_context()
        op_lkey = LEDGER.current_key()

        def worker():
            with trace.adopted(op_ctx), LEDGER.adopted(op_lkey):
                worker_loop()

        discovery_done = [False]  # latched: the flag never reverts

        def worker_loop():
            idle_sleep = 0.05
            while True:
                with err_lock:
                    if errors:
                        return
                # part-boundary preemption (fleet lease revocation or a
                # graceful drain): stop claiming before the next part; a
                # sibling thread mid-part finishes its part first
                if self._preempted is not None and self._preempted():
                    with self._progress_lock:
                        done = self._local_parts_done
                    trace.instant("snapshot_preempt_yield",
                                  operation_id=self.operation_id,
                                  parts_done=done)
                    with err_lock:
                        errors.append(TransferPreemptedError(
                            f"transfer {self.transfer.id} yielded at a "
                            f"part boundary ({done} part(s) committed "
                            f"by this worker)"))
                    return
                part = self.cp.assign_operation_part(
                    self.operation_id, self.worker_index
                )
                if part is None:
                    if not discovery_done[0]:
                        if not self._discovery_open():
                            discovery_done[0] = True
                            continue  # drain race: one last assign pass
                        # async discovery still streaming parts in; back
                        # off so a slow listing doesn't turn N drained
                        # workers into a coordinator hot loop
                        time.sleep(idle_sleep)
                        idle_sleep = min(1.0, idle_sleep * 2)
                        continue
                    if linger_wait():
                        continue
                    return
                idle_sleep = 0.05
                if part.stolen_from is not None:
                    self.lease_stats.steals.inc()
                    LEDGER.add(lease_steals=1)
                    trace.instant("lease_steal", part=part.key(),
                                  stolen_from=part.stolen_from,
                                  epoch=part.assignment_epoch)
                    logger.warning(
                        "part %s reclaimed from worker %d (lease "
                        "expired; epoch now %d)", part.key(),
                        part.stolen_from, part.assignment_epoch)
                try:
                    self._upload_part_with_retry(storage, part, schemas)
                except BaseException as e:
                    with err_lock:
                        errors.append(e)
                    return

        hb_stop = threading.Event()

        def heartbeat():
            with trace.adopted(op_ctx), LEDGER.adopted(op_lkey):
                self._heartbeat_loop(hb_stop)

        hb = threading.Thread(target=heartbeat,
                              name=f"heartbeat-{self.worker_index}",
                              daemon=True)
        hb.start()
        try:
            threads = [
                threading.Thread(target=worker, name=f"upload-{i}",
                                 daemon=True)
                for i in range(self.process_count)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            hb_stop.set()
            hb.join(timeout=5.0)
        if errors:
            if is_preemption(errors[0]):
                # yield cleanly: release any claim a sibling left, so the
                # resuming claimer never waits out this worker's leases
                self.cp.clear_assigned_parts(self.operation_id,
                                             self.worker_index)
            raise errors[0]

    def _upload_part_with_retry(self, storage: Storage,
                                part: OperationTablePart,
                                schemas: dict) -> None:
        def attempt():
            # always-on per-part latency distribution (stats/hdr.py):
            # per-part granularity, so the cost is one bucket add
            t0 = time.perf_counter()
            self._upload_part(storage, part, schemas)
            hdr.observe("part_upload", time.perf_counter() - t0)

        def on_retry(i, e):
            with LEDGER.context(part=part.key()):
                LEDGER.add(retries=1)
            trace.instant("part_retry", part=part.key(), attempt=i,
                          error=type(e).__name__)
            logger.warning("part %s retry %d/%d: %s", part.key(), i,
                           PART_RETRIES, e)

        retry_with_backoff(
            attempt,
            attempts=PART_RETRIES,
            base_delay=PART_RETRY_BASE_DELAY,
            retriable=is_retriable,
            on_retry=on_retry,
        )

    def _commit_and_publish(self, staged, part: OperationTablePart
                            ) -> bool:
        """Phase 2 of the staged commit: the coordinator's fenced publish
        decision, then the publish.  True = published; False = fenced
        (the caller aborts and drops the result)."""
        granted = self.cp.commit_part(self.operation_id, part)
        if granted is False:
            self.commit_stats.commit_fenced.inc()
            LEDGER.add(commit_fences=1)
            trace.instant("commit_fenced", part=part.key(),
                          epoch=part.assignment_epoch)
            return False
        if granted is None:
            # the coordinator cannot fence: publishing unfenced degrades
            # this part to at-least-once rather than strand its rows
            logger.warning(
                "coordinator cannot fence commit of %s; publishing "
                "unfenced (at-least-once for this part)", part.key())
        else:
            part.commit_epoch = part.assignment_epoch
            self.commit_stats.commit_granted.inc()
        try:
            published = staged.publish_part(part.key(),
                                            part.assignment_epoch)
        except StaleEpochPublishError as e:
            # the sink's own fence caught a grant/steal race
            self.commit_stats.publish_stale_rejected.inc()
            LEDGER.add(commit_fences=1)
            trace.instant("publish_stale_rejected", part=part.key(),
                          epoch=part.assignment_epoch)
            logger.warning("publish of %s rejected by sink fence: %s",
                           part.key(), e)
            return False
        self.commit_stats.published_parts.inc()
        dropped = getattr(staged, "last_dedup_dropped", 0)
        if dropped:
            self.commit_stats.dedup_rows_dropped.inc(dropped)
        LEDGER.add(commits=1)
        trace.instant("part_published", part=part.key(),
                      epoch=part.assignment_epoch, rows=published,
                      dedup_dropped=dropped)
        return True

    def _upload_part(self, storage: Storage, part: OperationTablePart,
                     schemas: dict) -> None:
        """One part: fresh sink pipeline, init/rows/done, staged commit,
        progress flush."""
        tid = part.table_id
        schema = schemas.get(tid)
        if schema is None:
            schema = storage.table_schema(tid)
            schemas[tid] = schema
        self._push_scan_predicate(storage, tid, schema)
        part_id = part.part_id() if part.parts_count > 1 else ""
        tap = None
        wrap = None
        if self.transfer.fingerprint_validation():
            from transferia_tpu_torch.middlewares.fingerprint_tap import (
                FingerprintTap,
            )

            def wrap(inner):
                nonlocal tap
                tap = FingerprintTap(inner, device=self.device)
                return tap

        sink = make_async_sink(self.transfer, self.metrics,
                               snapshot_stage=True,
                               post_transform_wrap=wrap,
                               device=self.device)
        # staged two-phase commit: when both ends are capable, this
        # part's batches stage invisibly and publish only after the
        # coordinator grants a fenced commit_part decision
        staged = find_staged_sink(sink) if self._staged_commits else None
        publish_fenced = False
        rows_done = 0
        read_bytes = 0
        batch_seq = 0
        # root span per part: every stage span a batch triggers on this
        # thread (source decode, transform, device dispatch, sink) nests
        # under it in the exported timeline
        part_sp = trace.span("part")
        if part_sp:
            part_sp.add(transfer_id=self.transfer.id, table=str(tid),
                        part=part.key())
        futures: deque = deque()
        try:
            with part_sp, LEDGER.context(part=part.key()):
                if staged is not None:
                    # a retried part restages from scratch: begin
                    # replaces anything a previous attempt staged
                    staged.begin_part(part.key(), part.assignment_epoch)
                    self.commit_stats.staged_parts.inc()
                sink.async_push(
                    [init_table_load(tid, schema, part_id)]).result()

                def pusher(batch):
                    nonlocal rows_done, read_bytes, batch_seq
                    # worker-death injection point: a raise here kills
                    # the part mid-load, as a crashed worker would
                    failpoint("snapshot.part.batch")
                    sp = trace.span("batch")
                    with sp:
                        if hasattr(batch, "n_rows"):
                            batch.part_id = part_id
                            rows_done += batch.n_rows
                            read_bytes += (batch.read_bytes
                                           or batch.nbytes())
                            LEDGER.add(rows_in=batch.n_rows,
                                       bytes_in=batch.read_bytes
                                       or batch.nbytes())
                            if sp:
                                sp.add(table=str(tid), part=part.key(),
                                       batch_seq=batch_seq,
                                       rows=batch.n_rows,
                                       bytes=batch.nbytes())
                        else:
                            rows_done += len(batch)
                            LEDGER.add(rows_in=len(batch))
                            if sp:
                                sp.add(table=str(tid), part=part.key(),
                                       batch_seq=batch_seq,
                                       rows=len(batch))
                        batch_seq += 1
                        futures.append(sink.async_push(batch))
                        # bounded in-flight window
                        while len(futures) > 32:
                            futures.popleft().result()

                storage.load_table(part.to_description(), pusher)
                resolve_all(futures)
                sink.async_push(
                    [done_table_load(tid, schema, part_id)]).result()
                if staged is not None:
                    publish_fenced = not self._commit_and_publish(
                        staged, part)
        except BaseException as e:
            if staged is not None:
                # discard this attempt's staging; a retry re-begins
                try:
                    staged.abort_part(part.key())
                except Exception as abort_err:
                    logger.warning("staged abort of %s failed: %s",
                                   part.key(), abort_err)
            raise TableUploadError(
                f"part {part.key()} failed after {rows_done} rows: {e}",
                cause=e,
            ) from e
        finally:
            # drain/cancel in-flight pushes before close: close() must
            # not race pushes still running in the sink
            while futures:
                f = futures.popleft()
                if not f.cancel():
                    try:
                        f.result(timeout=60.0)
                    # deliberate swallow: the error path's drain, the
                    # first failure is already propagating as
                    # TableUploadError and a later push error would
                    # only mask it
                    except Exception:  # trtpu: ignore[EXC001]
                        pass
            sink.close()
        if publish_fenced:
            # the part was reclaimed since our claim (or our publish lost
            # to a newer epoch at the sink): the new owner's publish is
            # authoritative; drop the result, do not fail the worker
            try:
                staged.abort_part(part.key())
            except Exception as abort_err:
                logger.warning("staged abort of %s failed: %s",
                               part.key(), abort_err)
            self.commit_stats.aborted_parts.inc()
            self.lease_stats.fence_rejected.inc()
            logger.warning(
                "part %s publish fenced (stale epoch %d): the part was "
                "reclaimed; staged data discarded, nothing published",
                part.key(), part.assignment_epoch)
            return
        part.completed = True
        part.completed_rows = rows_done
        part.read_bytes = read_bytes
        part.worker_index = self.worker_index
        if tap is not None:
            # digests are keyed by output table (transforms may rename):
            # a single output matching the source keeps the compact
            # form, anything else a JSON mapping
            aggs = tap.aggregates()
            if len(aggs) == 1 and next(iter(aggs)) == tid:
                part.fingerprint = next(iter(aggs.values())).digest()
            elif aggs:
                part.fingerprint = json.dumps(
                    {out.fqtn(): a.digest() for out, a in aggs.items()},
                    sort_keys=True)
        with self._progress_lock:
            rejected = self.cp.update_operation_parts(
                self.operation_id, [part])
            if not rejected:
                self.table_stats.completed_parts.inc()
                self.table_stats.completed_rows.inc(rows_done)
                self._local_parts_done += 1
                self._local_rows_done += rows_done
        if rejected:
            # epoch fence: our lease expired mid-part and the part was
            # reclaimed; drop the stale result and claim the next part
            self.lease_stats.fence_rejected.inc(len(rejected))
            logger.warning(
                "part %s completion fenced (stale epoch %d): lease "
                "expired and the part was reclaimed; dropping result",
                part.key(), part.assignment_epoch)
            return
        # device counters surface on this pipeline's metrics as parts
        # complete; the attribution ledger folds alongside
        trace.TELEMETRY.fold_into(self.metrics)
        LEDGER.fold_into(self.metrics)
        # part completion is an export trigger (coalesced inside the
        # exporter): the committed part's spend is durable at once
        self._obs.export("part")
        logger.info("part %s done: %d rows, %d bytes",
                    part.key(), rows_done, read_bytes)
