"""Delivery-invariant verification for chaos trials (the port's copy of
``transferia_tpu/chaos/invariants.py``).

The engine's contract is at-least-once delivery with checkpointed
resume; this module turns that sentence into checkable predicates over
a faulted run:

- **at-least-once**: every row the reference (fault-free) run delivered
  is present in the faulted run's target;
- **no inventions**: the faulted target contains no row the reference
  never produced (retries may duplicate, never fabricate);
- **post-retry fingerprint equality**: deduplicating the faulted target
  by row content and reducing with the order-independent table
  fingerprint (ops/rowhash.py) reproduces the reference digest exactly;
- **bounded duplication**: no single row is delivered more often than
  the retry machinery can explain (sink-push retries x part retries x
  run restarts for snapshots; one redelivery per restart whose resume
  checkpoint precedes the row for replication);
- **checkpoint monotonicity**: commit offsets / snapshot progress never
  move backwards (`MonotonicityTracker`, fed by `AuditingCoordinator`
  and the broker-commit hook in the runner);
- **epoch fencing**: no part's completion is accepted under two
  different assignment epochs — a reclaimed part is completed exactly
  once, by its latest owner, and a zombie's stale-epoch completion is
  rejected (`fencing_violations` over the accepted-completion log the
  `AuditingCoordinator` records);
- **exactly-once** (staged-commit sinks only, `exactly_once=True`):
  the delivered multiset EQUALS the reference multiset — every row key
  appears exactly as many times as the fault-free run produced it, no
  duplicate survives the stage → fenced-publish pipeline
  (ARCHITECTURE.md "Exactly-once commits").  The bounded-duplication
  check collapses to multiplicity == reference multiplicity.

Row identity reuses the fingerprint canonicalization itself
(`ops/rowhash.row_lanes`): a row's key is its two finalized 32-bit
lanes — so "same row" here means exactly what the table digest means by
it, and the dedup-then-reduce check is internally consistent with the
per-part digests the snapshot engine already publishes.  Dictionary-
encoded batches key DICT-NATIVELY (pool accumulators gathered by code,
no flat materialization — ARCHITECTURE.md "Dict-native reductions");
the keys are byte-identical either route.

In the port a row's key is kernel K10 in keys mode
(`ops/rowhash.py::batch_row_keys`) on the device the caller names:
`DeliveryReference.from_batches` and `audit_delivery` take `device`
(CUDA unless the caller passes "cpu", where the plain version runs;
without a card they raise).
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional

from transferia_tpu_torch.abstract.interfaces import is_columnar
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.ops.rowhash import (
    FingerprintAggregate,
    batch_row_keys,
)
from transferia_tpu_torch.runtime.device import DeviceLike


def keys_fingerprint(counter: "Counter[int]") -> FingerprintAggregate:
    """Order-independent aggregate over a DEDUPLICATED key multiset —
    by construction equal to `fingerprint_host` over the distinct rows
    (sum/xor of the finalized lanes is all the reduction does)."""
    agg = FingerprintAggregate()
    for key in counter:
        r1 = (key >> 32) & 0xFFFFFFFF
        r2 = key & 0xFFFFFFFF
        agg.merge(FingerprintAggregate(sum1=r1, sum2=r2, xor1=r1,
                                       xor2=r2, count=1))
    return agg


def _batches_to_counter(batches,
                        device: DeviceLike = None) -> "Counter[int]":
    """Key multiset of a batch list (ChangeItem lists pivot first), each
    batch keyed on `device`."""
    out: Counter = Counter()
    for b in batches:
        if not is_columnar(b):
            rows = [it for it in b if it.is_row_event()]
            if not rows:
                continue
            for run in _homogeneous_runs(rows):
                b2 = ColumnBatch.from_rows(run)
                out.update(batch_row_keys(b2, device=device).tolist())
            continue
        if b.n_rows:
            out.update(batch_row_keys(b, device=device).tolist())
    return out


def _homogeneous_runs(items):
    runs, key = [], None
    for it in items:
        k = (it.table_id, it.table_schema.fingerprint()
             if it.table_schema is not None else None)
        if not runs or k != key:
            runs.append([])
            key = k
        runs[-1].append(it)
    return runs


@dataclass
class DeliveryReference:
    """What a fault-free run delivered: the ground truth multiset."""

    keys: "Counter[int]"
    fingerprint: str
    rows: int

    @classmethod
    def from_batches(cls, batches,
                     device: DeviceLike = None) -> "DeliveryReference":
        keys = _batches_to_counter(batches, device)
        return cls(keys=keys,
                   fingerprint=keys_fingerprint(keys).digest(),
                   rows=sum(keys.values()))


@dataclass
class Violation:
    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"{self.invariant}: {self.detail}"


@dataclass
class AuditVerdict:
    passed: bool
    violations: list[Violation]
    delivered_rows: int = 0
    distinct_rows: int = 0
    duplicate_rows: int = 0
    max_multiplicity: int = 0

    def summary(self) -> str:
        head = "PASS" if self.passed else "FAIL"
        s = (f"{head}: {self.delivered_rows} delivered, "
             f"{self.distinct_rows} distinct, "
             f"{self.duplicate_rows} duplicate(s), "
             f"max multiplicity {self.max_multiplicity}")
        for v in self.violations:
            s += f"\n  - {v}"
        return s


def audit_delivery(reference: DeliveryReference, observed_batches,
                   max_multiplicity: int,
                   checkpoints: Optional["MonotonicityTracker"] = None,
                   exactly_once: bool = False,
                   device: DeviceLike = None,
                   ) -> AuditVerdict:
    """Check every delivery invariant of a faulted run against the
    fault-free reference.  `max_multiplicity` is the retry-machinery
    bound the caller derives from its run (attempts x retries).
    `exactly_once=True` (staged-commit capable sinks) tightens the
    duplication bound to zero: observed multiplicity must EQUAL the
    reference multiplicity per row key.  The observed rows are keyed on
    `device`."""
    observed = _batches_to_counter(observed_batches, device)
    violations: list[Violation] = []

    if exactly_once:
        extra = {k: n for k, n in observed.items()
                 if k in reference.keys and n > reference.keys[k]}
        if extra:
            worst_k = max(extra, key=lambda k: extra[k])
            violations.append(Violation(
                "exactly-once",
                f"{len(extra)} row key(s) delivered more often than the "
                f"reference (worst {extra[worst_k]}x vs "
                f"{reference.keys[worst_k]}x): a duplicate survived the "
                f"stage -> fenced-publish pipeline"))
        # under-delivery of a multiplicity > 1 key: the at-least-once
        # check below only proves >= 1 copy, exactly-once needs EQUAL
        under = {k: n for k, n in observed.items()
                 if k in reference.keys and 0 < n < reference.keys[k]}
        if under:
            violations.append(Violation(
                "exactly-once",
                f"{len(under)} row key(s) delivered fewer times than "
                f"the reference: the dedup window or a publish replace "
                f"dropped legitimate copies"))

    missing = {k: n for k, n in reference.keys.items()
               if observed.get(k, 0) < 1}
    if missing:
        violations.append(Violation(
            "at-least-once",
            f"{len(missing)} source row(s) never reached the sink"))

    invented = {k: n for k, n in observed.items()
                if k not in reference.keys}
    if invented:
        violations.append(Violation(
            "no-inventions",
            f"{len(invented)} sink row(s) match no source row"))

    dupes = {k: n for k, n in observed.items()
             if n > reference.keys.get(k, 0) and k in reference.keys}
    worst = max(observed.values(), default=0)
    # the bound scales with the REFERENCE multiplicity: a source whose
    # fault-free run legitimately delivers identical content m times may
    # see m * bound copies under retry, not bound.  Keys absent from the
    # reference are already reported as inventions above.
    over = {k: n for k, n in observed.items()
            if k in reference.keys
            and n > reference.keys[k] * max_multiplicity}
    if over:
        violations.append(Violation(
            "bounded-duplication",
            f"{len(over)} row(s) delivered more than the retry bound "
            f"({max_multiplicity}x reference multiplicity) allows; "
            f"worst {worst}x"))

    if not missing and not invented:
        got = keys_fingerprint(observed).digest()
        if got != reference.fingerprint:
            violations.append(Violation(
                "fingerprint-equality",
                f"deduplicated sink fingerprint {got} != reference "
                f"{reference.fingerprint}"))

    if checkpoints is not None:
        for detail in checkpoints.violations:
            violations.append(Violation("checkpoint-monotonicity",
                                        detail))

    return AuditVerdict(
        passed=not violations,
        violations=violations,
        delivered_rows=sum(observed.values()),
        distinct_rows=len(observed),
        duplicate_rows=sum(n - reference.keys.get(k, 0)
                           for k, n in dupes.items()),
        max_multiplicity=worst,
    )


class MonotonicityTracker:
    """Named watermarks that must never decrease (commit offsets,
    completed-part counts).  Violations collect instead of raising —
    the auditor reports them with everything else at trial end."""

    def __init__(self):
        self._lock = threading.Lock()
        self._marks: dict[str, Any] = {}
        self.violations: list[str] = []

    def record(self, name: str, value) -> None:
        with self._lock:
            prev = self._marks.get(name)
            if prev is not None and value < prev:
                self.violations.append(
                    f"{name} moved backwards: {prev!r} -> {value!r}")
            else:
                self._marks[name] = value

    def reset_mark(self, name: str) -> None:
        """A legitimate epoch reset (e.g. re-activation recreating the
        part queue) re-bases the watermark."""
        with self._lock:
            self._marks.pop(name, None)


def fencing_violations(completions: list[tuple]) -> list[Violation]:
    """Epoch-fencing invariant over the accepted-completion log
    (`AuditingCoordinator.completions`): a part may be completed under
    exactly one assignment epoch.  Two accepted completions with
    different epochs mean a zombie slipped past the fence."""
    out: list[Violation] = []
    seen: dict[str, tuple] = {}
    for key, epoch, worker in completions:
        prev = seen.get(key)
        if prev is not None and prev[0] != epoch:
            out.append(Violation(
                "epoch-fencing",
                f"part {key} completed under epoch {prev[0]} (worker "
                f"{prev[1]}) and again under epoch {epoch} (worker "
                f"{worker})"))
        else:
            seen[key] = (epoch, worker)
    return out


class AuditingCoordinator(Coordinator):
    """Transparent coordinator proxy feeding a MonotonicityTracker.

    Watches the two checkpoint-shaped streams the snapshot engine
    produces: completed-part progress per operation (must only grow
    within an operation epoch; `create_operation_parts` starts a new
    epoch) and state-KV write counts, plus the accepted-completion log
    (part key, assignment epoch, worker) that `fencing_violations`
    audits.  Everything else forwards as-is.
    """

    def __init__(self, inner: Coordinator,
                 tracker: Optional[MonotonicityTracker] = None):
        self.inner = inner
        self.tracker = tracker or MonotonicityTracker()
        self.state_writes = 0
        self._lock = threading.Lock()
        # accepted completions: (part key, assignment_epoch, worker)
        self.completions: list[tuple] = []
        self.fence_rejections = 0
        # staged-commit decisions: (part key, epoch, granted) — the
        # per-seed replay surface for exactly_once trials
        self.commit_log: list[tuple] = []
        # durable fleet queue decisions — the three replay surfaces of
        # fleet_distributed trials: accepted enqueues in call order,
        # won claims, and preemption revokes
        self.enqueue_log: list[tuple] = []
        self.ticket_claim_log: list[tuple] = []
        self.ticket_revoke_log: list[tuple] = []
        # MVCC staging decisions — the replay surfaces of
        # snapshot_and_increment trials: layer admissions (worker, seq,
        # status) in decision order and the sealed cutovers (watermark,
        # epoch, granted, first)
        self.mvcc_admit_log: list[tuple] = []
        self.mvcc_cutover_log: list[tuple] = []

    # -- watched methods ----------------------------------------------------
    def create_operation_parts(self, operation_id, parts):
        self.tracker.reset_mark(f"op:{operation_id}:completed_parts")
        return self.inner.create_operation_parts(operation_id, parts)

    def update_operation_parts(self, operation_id, parts):
        rejected = self.inner.update_operation_parts(operation_id, parts)
        rejected_keys = set(rejected or [])
        with self._lock:
            self.fence_rejections += len(rejected_keys)
            for p in parts:
                if p.completed and p.key() not in rejected_keys:
                    self.completions.append(
                        (p.key(), p.assignment_epoch, p.worker_index))
        progress = self.inner.operation_progress(operation_id)
        self.tracker.record(f"op:{operation_id}:completed_parts",
                            progress.completed_parts)
        return rejected

    def commit_part(self, operation_id, part):
        granted = self.inner.commit_part(operation_id, part)
        with self._lock:
            self.commit_log.append(
                (part.key(), part.assignment_epoch, bool(granted)))
        return granted

    def supports_staged_commits(self):
        return self.inner.supports_staged_commits()

    # -- durable fleet queue (watched: the replay surfaces) -----------------
    def supports_ticket_queue(self):
        return self.inner.supports_ticket_queue()

    def enqueue_ticket(self, queue, ticket):
        stored = self.inner.enqueue_ticket(queue, ticket)
        with self._lock:
            self.enqueue_log.append((stored.ticket_id, stored.seq))
        return stored

    def claim_ticket(self, queue, ticket_id, worker_id):
        won = self.inner.claim_ticket(queue, ticket_id, worker_id)
        if won is not None:
            with self._lock:
                self.ticket_claim_log.append(
                    (won.ticket_id, worker_id, won.claim_epoch,
                     won.stolen_from))
        return won

    def revoke_ticket(self, queue, ticket_id):
        revoked = self.inner.revoke_ticket(queue, ticket_id)
        if revoked is not None:
            with self._lock:
                self.ticket_revoke_log.append(
                    (revoked.ticket_id, revoked.preempted_from,
                     revoked.claim_epoch))
        return revoked

    def list_tickets(self, queue):
        return self.inner.list_tickets(queue)

    def renew_ticket_leases(self, queue, worker_id, ticket_id=None,
                            claim_epoch=None):
        return self.inner.renew_ticket_leases(
            queue, worker_id, ticket_id=ticket_id,
            claim_epoch=claim_epoch)

    def complete_ticket(self, queue, ticket, error=""):
        return self.inner.complete_ticket(queue, ticket, error=error)

    def release_ticket(self, queue, ticket, failed=False):
        return self.inner.release_ticket(queue, ticket, failed=failed)

    def gc_tickets(self, queue, retention_seconds=None):
        return self.inner.gc_tickets(
            queue, retention_seconds=retention_seconds)

    # -- MVCC staging control plane (watched: the replay surfaces) ----------
    def supports_mvcc(self):
        return self.inner.supports_mvcc()

    def mvcc_admit_layer(self, scope, layer):
        res = self.inner.mvcc_admit_layer(scope, layer)
        with self._lock:
            self.mvcc_admit_log.append(
                (str(layer.get("worker", "")),
                 int(layer.get("seq", -1)),
                 res.get("status", "")))
        return res

    def mvcc_cutover(self, scope, watermark, epoch, offsets=None):
        res = self.inner.mvcc_cutover(scope, watermark, epoch,
                                      offsets=offsets)
        with self._lock:
            self.mvcc_cutover_log.append(
                (int(res.get("watermark", -1)),
                 int(res.get("epoch", -1)),
                 bool(res.get("granted")),
                 bool(res.get("first")),
                 tuple(sorted(
                     (res.get("offsets") or {}).items()))))
        return res

    def mvcc_record_base(self, scope, base):
        return self.inner.mvcc_record_base(scope, base)

    def mvcc_state(self, scope):
        return self.inner.mvcc_state(scope)

    def mvcc_prune_layers(self, scope, keys):
        return self.inner.mvcc_prune_layers(scope, keys)

    def supports_mvcc_blobs(self):
        return self.inner.supports_mvcc_blobs()

    def put_mvcc_blob(self, scope, name, data):
        return self.inner.put_mvcc_blob(scope, name, data)

    def get_mvcc_blob(self, scope, locator):
        return self.inner.get_mvcc_blob(scope, locator)

    def delete_mvcc_blobs(self, scope, locators):
        return self.inner.delete_mvcc_blobs(scope, locators)

    def set_transfer_state(self, transfer_id, state):
        self.state_writes += 1
        return self.inner.set_transfer_state(transfer_id, state)

    def set_operation_state(self, operation_id, state):
        self.state_writes += 1
        return self.inner.set_operation_state(operation_id, state)

    # -- plain forwards ------------------------------------------------------
    def set_status(self, transfer_id, status):
        return self.inner.set_status(transfer_id, status)

    def get_status(self, transfer_id):
        return self.inner.get_status(transfer_id)

    def open_status_message(self, transfer_id, category, message):
        return self.inner.open_status_message(transfer_id, category,
                                              message)

    def close_status_messages(self, transfer_id, category):
        return self.inner.close_status_messages(transfer_id, category)

    def get_transfer_state(self, transfer_id):
        return self.inner.get_transfer_state(transfer_id)

    def remove_transfer_state(self, transfer_id, keys):
        return self.inner.remove_transfer_state(transfer_id, keys)

    def get_operation_state(self, operation_id):
        return self.inner.get_operation_state(operation_id)

    def add_operation_parts(self, operation_id, parts):
        return self.inner.add_operation_parts(operation_id, parts)

    def assign_operation_part(self, operation_id, worker_index):
        return self.inner.assign_operation_part(operation_id,
                                                worker_index)

    def renew_lease(self, operation_id, worker_index):
        return self.inner.renew_lease(operation_id, worker_index)

    def clear_assigned_parts(self, operation_id, worker_index):
        return self.inner.clear_assigned_parts(operation_id,
                                               worker_index)

    def operation_parts(self, operation_id):
        return self.inner.operation_parts(operation_id)

    def supports_obs_segments(self):
        return self.inner.supports_obs_segments()

    def put_obs_segment(self, scope, segment):
        return self.inner.put_obs_segment(scope, segment)

    def list_obs_segments(self, scope):
        return self.inner.list_obs_segments(scope)

    def gc_obs_segments(self, scope, retention_seconds=None):
        return self.inner.gc_obs_segments(
            scope, retention_seconds=retention_seconds)

    def operation_health(self, operation_id, worker_index, payload=None):
        return self.inner.operation_health(operation_id, worker_index,
                                           payload)

    def get_operation_health(self, operation_id):
        return self.inner.get_operation_health(operation_id)

    def transfer_health(self, transfer_id, worker_index=0, healthy=True):
        return self.inner.transfer_health(transfer_id, worker_index,
                                          healthy)
