"""In-process coordinator (the port's copy of
``transferia_tpu/coordinator/memory.py``: operations, leases, the
staged-commit decision, the fleet ticket queue, the observability
segments, the MVCC control plane and its blobs, and the replication
loop's status messages and heartbeats).

Thread-safe; used for single-process runs and tests.  One lock per
operation guards its part queue and state, one per fleet queue its
tickets, one the transfer-scoped maps, one the health stream, one the
obs segments, one the MVCC control docs and blobs; each is a
`lockwatch.named_lock`.  The state
writes and the part commit carry the reference's `coordinator.*`
failpoints and `coord_*` spans.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Optional

from transferia_tpu_torch.abstract import mvccfence
from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.abstract.ticket import (
    FleetTicket,
    claim_in_place,
    complete_in_place,
    complete_is_duplicate,
    fence_matches,
    release_in_place,
    revoke_in_place,
    ticket_claimable,
    ticket_expired,
)
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    TransferStatus,
    default_lease_seconds,
    lease_expired,
    obs_retention_seconds,
    obs_segments_per_worker,
    ticket_retention_seconds,
)
from transferia_tpu_torch.runtime import lockwatch
from transferia_tpu_torch.stats import trace

# bounded health history: the latest report per (scope, worker) plus a
# small rolling window
HEALTH_HISTORY_LIMIT = 256


class _OpState:
    """One operation's slice: its lock, part queue and state KV."""

    __slots__ = ("lock", "parts", "state")

    def __init__(self):
        self.lock = lockwatch.named_lock("coordinator.op", kind="rlock")
        self.parts: list[OperationTablePart] = []
        self.state: dict[str, Any] = {}


class _QueueState:
    """One fleet admission queue's slice: its lock, the ticket list (dict
    form, mutated in place by the abstract/ticket.py helpers) and the
    durable seq counter."""

    __slots__ = ("lock", "tickets", "next_seq")

    def __init__(self):
        self.lock = lockwatch.named_lock("coordinator.queue",
                                         kind="rlock")
        self.tickets: list[dict] = []
        self.next_seq = 0


def _copy(p: OperationTablePart) -> OperationTablePart:
    return OperationTablePart.from_json(p.to_json())


class MemoryCoordinator(Coordinator):
    def __init__(self, lease_seconds: Optional[float] = None):
        self._lock = lockwatch.named_lock("coordinator.transfers",
                                          kind="rlock")
        self._status: dict[str, TransferStatus] = {}
        self._state: dict[str, dict[str, Any]] = {}
        self._messages: dict[str, list[tuple[str, str]]] = {}
        self._ops_lock = lockwatch.named_lock("coordinator.ops_map")
        self._ops: dict[str, _OpState] = {}
        # fleet admission queues: per-queue locks, same pattern
        self._queues_lock = lockwatch.named_lock("coordinator.queues_map")
        self._queues: dict[str, _QueueState] = {}
        self.lease_seconds = (default_lease_seconds()
                              if lease_seconds is None else lease_seconds)
        self._health_lock = lockwatch.named_lock(
            "coordinator.health")
        self.health_reports: deque = deque(maxlen=HEALTH_HISTORY_LIMIT)
        self._health_latest: dict[tuple[str, int], dict] = {}
        # observability segments: scope -> {(worker, seq): segment},
        # trimmed per worker at put time
        self._obs_lock = lockwatch.named_lock("coordinator.obs")
        self._obs: dict[str, dict[tuple[str, int], dict]] = {}
        self._mvcc_lock = lockwatch.named_lock("coordinator.mvcc")
        self._mvcc: dict[str, dict] = {}
        # MVCC blobs: heap bytes keyed by locator, for the process's life
        self._mvcc_blobs: dict[str, dict[str, bytes]] = {}

    def _op(self, operation_id: str) -> _OpState:
        """Get-or-create the operation's slot (never replaced)."""
        with self._ops_lock:
            st = self._ops.get(operation_id)
            if st is None:
                st = self._ops[operation_id] = _OpState()
            return st

    def _op_peek(self, operation_id: str) -> Optional[_OpState]:
        """Non-creating lookup for read paths."""
        with self._ops_lock:
            return self._ops.get(operation_id)

    # -- status and state ---------------------------------------------------
    def set_status(self, transfer_id: str, status: TransferStatus) -> None:
        with self._lock:
            self._status[transfer_id] = status

    def get_status(self, transfer_id: str) -> TransferStatus:
        with self._lock:
            return self._status.get(transfer_id, TransferStatus.NEW)

    def open_status_message(self, transfer_id: str, category: str,
                            message: str) -> None:
        with self._lock:
            self._messages.setdefault(transfer_id, []).append(
                (category, message))

    def status_messages(self, transfer_id: str) -> list[tuple[str, str]]:
        with self._lock:
            return list(self._messages.get(transfer_id, []))

    def set_transfer_state(self, transfer_id: str,
                           state: dict[str, Any]) -> None:
        failpoint("coordinator.set_state")  # before the lock: may sleep
        # the span covers the lock wait too: coordinator contention
        # shows up as coord_set_state time
        with trace.span("coord_set_state", transfer=transfer_id), \
                self._lock:
            self._state.setdefault(transfer_id, {}).update(state)

    def get_transfer_state(self, transfer_id: str) -> dict[str, Any]:
        with self._lock:
            return dict(self._state.get(transfer_id, {}))

    def set_operation_state(self, operation_id: str,
                            state: dict[str, Any]) -> None:
        failpoint("coordinator.set_op_state")  # before the lock: may sleep
        op = self._op(operation_id)
        with trace.span("coord_set_op_state", operation=operation_id), \
                op.lock:
            op.state.update(state)

    def get_operation_state(self, operation_id: str) -> dict[str, Any]:
        op = self._op_peek(operation_id)
        if op is None:
            return {}
        with op.lock:
            return dict(op.state)

    # -- operation parts ----------------------------------------------------
    def create_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]) -> None:
        op = self._op(operation_id)
        copies = [_copy(p) for p in parts]
        with op.lock:
            op.parts[:] = copies

    def add_operation_parts(self, operation_id: str,
                            parts: list[OperationTablePart]) -> None:
        op = self._op(operation_id)
        copies = [_copy(p) for p in parts]
        with op.lock:
            op.parts.extend(copies)

    def assign_operation_part(self, operation_id: str, worker_index: int
                              ) -> Optional[OperationTablePart]:
        now = time.time()
        op = self._op_peek(operation_id)
        if op is None:
            return None
        with op.lock:
            for p in op.parts:
                if p.completed:
                    continue
                stolen = p.worker_index is not None \
                    and lease_expired(p, now)
                if p.worker_index is not None and not stolen:
                    continue
                p.stolen_from = p.worker_index if stolen else None
                p.worker_index = worker_index
                p.assignment_epoch += 1
                # unconditional: with leasing off a stale deadline would
                # look expired forever
                p.lease_expires_at = (now + self.lease_seconds
                                      if self.lease_seconds > 0 else 0.0)
                return _copy(p)
            return None

    def renew_lease(self, operation_id: str, worker_index: int) -> int:
        if self.lease_seconds <= 0:
            return 0
        renewed = 0
        now = time.time()
        op = self._op_peek(operation_id)
        if op is None:
            return 0
        with op.lock:
            for p in op.parts:
                if p.worker_index == worker_index and not p.completed:
                    p.lease_expires_at = now + self.lease_seconds
                    renewed += 1
        return renewed

    def clear_assigned_parts(self, operation_id: str,
                             worker_index: int) -> int:
        released = 0
        op = self._op_peek(operation_id)
        if op is None:
            return 0
        with op.lock:
            for p in op.parts:
                if p.worker_index == worker_index and not p.completed:
                    p.worker_index = None
                    p.lease_expires_at = 0.0
                    released += 1
        return released

    def commit_part(self, operation_id: str,
                    part: OperationTablePart) -> Optional[bool]:
        # before the lock: may sleep/raise (a coordinator fault here
        # must surface as a failed — retriable — commit RPC, with
        # nothing published)
        failpoint("coordinator.commit_part")
        op = self._op_peek(operation_id)
        if op is None:
            return False
        with trace.span("coord_commit_part", operation=operation_id,
                        part=part.key(), epoch=part.assignment_epoch), \
                op.lock:
            for cur in op.parts:
                if cur.key() != part.key():
                    continue
                if part.assignment_epoch != cur.assignment_epoch:
                    return False  # reclaimed since this worker's claim
                cur.commit_epoch = part.assignment_epoch
                return True
            return False

    def update_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]
                               ) -> list[str]:
        rejected: list[str] = []
        op = self._op_peek(operation_id)
        if op is None:
            return rejected
        with op.lock:
            by_key = {p.key(): p for p in op.parts}
            for upd in parts:
                cur = by_key.get(upd.key())
                if cur is None:
                    continue
                if upd.assignment_epoch != cur.assignment_epoch:
                    # the part was reclaimed since this worker's claim
                    rejected.append(upd.key())
                    continue
                cur.completed_rows = upd.completed_rows
                cur.read_bytes = upd.read_bytes
                cur.completed = upd.completed
                cur.worker_index = upd.worker_index
                cur.fingerprint = upd.fingerprint
        return rejected

    def operation_parts(self, operation_id: str
                        ) -> list[OperationTablePart]:
        op = self._op_peek(operation_id)
        if op is None:
            return []
        with op.lock:
            return [_copy(p) for p in op.parts]

    # -- durable fleet admission queue --------------------------------------
    def _queue(self, queue: str) -> _QueueState:
        with self._queues_lock:
            st = self._queues.get(queue)
            if st is None:
                st = self._queues[queue] = _QueueState()
            return st

    def enqueue_ticket(self, queue: str,
                       ticket: FleetTicket) -> FleetTicket:
        q = self._queue(queue)
        with q.lock:
            for d in q.tickets:
                if d["ticket_id"] == ticket.ticket_id:
                    # idempotent: the no-double-admission guarantee
                    return FleetTicket.from_json(d)
            d = ticket.to_json()
            d["seq"] = q.next_seq
            q.next_seq += 1
            d["state"] = "queued"
            d["enqueued_at"] = time.time()
            q.tickets.append(d)
            return FleetTicket.from_json(d)

    def list_tickets(self, queue: str) -> list[FleetTicket]:
        q = self._queue(queue)
        with q.lock:
            return [FleetTicket.from_json(d)
                    for d in sorted(q.tickets, key=lambda t: t["seq"])]

    def claim_ticket(self, queue: str, ticket_id: str,
                     worker_id: str) -> Optional[FleetTicket]:
        q = self._queue(queue)
        now = time.time()
        with q.lock:
            for d in q.tickets:
                if d["ticket_id"] != ticket_id:
                    continue
                if not ticket_claimable(d, now):
                    return None
                claim_in_place(d, worker_id, self.lease_seconds, now)
                return FleetTicket.from_json(d)
            return None

    def renew_ticket_leases(self, queue: str, worker_id: str,
                            ticket_id: Optional[str] = None,
                            claim_epoch: Optional[int] = None) -> int:
        if self.lease_seconds <= 0:
            return 0
        q = self._queue(queue)
        renewed = 0
        now = time.time()
        with q.lock:
            for d in q.tickets:
                if ticket_id is not None and d["ticket_id"] != ticket_id:
                    continue
                if claim_epoch is not None \
                        and d["claim_epoch"] != claim_epoch:
                    continue
                if d["state"] == "claimed" and d["claimed_by"] == worker_id:
                    d["lease_expires_at"] = now + self.lease_seconds
                    renewed += 1
        return renewed

    def complete_ticket(self, queue: str, ticket: FleetTicket,
                        error: str = "") -> bool:
        q = self._queue(queue)
        with q.lock:
            for d in q.tickets:
                if d["ticket_id"] != ticket.ticket_id:
                    continue
                if complete_is_duplicate(d, ticket):
                    return True  # idempotent retry of a lost response
                if not fence_matches(d, ticket):
                    return False  # zombie: reclaimed or revoked since
                complete_in_place(d, error)
                return True
            return False

    def release_ticket(self, queue: str, ticket: FleetTicket,
                       failed: bool = False) -> bool:
        q = self._queue(queue)
        with q.lock:
            for d in q.tickets:
                if d["ticket_id"] != ticket.ticket_id:
                    continue
                if not fence_matches(d, ticket):
                    return False
                release_in_place(d, failed=failed)
                return True
            return False

    def revoke_ticket(self, queue: str,
                      ticket_id: str) -> Optional[FleetTicket]:
        q = self._queue(queue)
        with q.lock:
            for d in q.tickets:
                if d["ticket_id"] != ticket_id:
                    continue
                if d["state"] != "claimed":
                    return None  # nothing to preempt
                revoke_in_place(d)
                return FleetTicket.from_json(d)
            return None

    def gc_tickets(self, queue: str,
                   retention_seconds: Optional[float] = None) -> int:
        retention = ticket_retention_seconds() \
            if retention_seconds is None else retention_seconds
        q = self._queue(queue)
        now = time.time()
        with q.lock:
            keep = [d for d in q.tickets
                    if not ticket_expired(d, retention, now)]
            pruned = len(q.tickets) - len(keep)
            q.tickets = keep
        return pruned

    # -- durable observability segments --------------------------------------
    def put_obs_segment(self, scope: str, segment: dict) -> None:
        # json round trip: deep-copies (the exporter keeps mutating its
        # buffers) and fails here on what the file backends could not
        # serialize
        seg = json.loads(json.dumps(segment))
        worker = str(seg.get("worker", ""))
        seq = int(seg.get("seq", 0))
        bound = obs_segments_per_worker()
        with self._obs_lock:
            store = self._obs.setdefault(scope, {})
            store[(worker, seq)] = seg
            mine = sorted(k for k in store if k[0] == worker)
            for key in mine[:-bound]:
                del store[key]

    def list_obs_segments(self, scope: str) -> list[dict]:
        with self._obs_lock:
            store = self._obs.get(scope, {})
            items = [store[k] for k in sorted(store)]
        return [json.loads(json.dumps(s)) for s in items]

    def gc_obs_segments(self, scope: str,
                        retention_seconds: Optional[float] = None) -> int:
        retention = obs_retention_seconds() \
            if retention_seconds is None else retention_seconds
        now = time.time()
        pruned = 0
        with self._obs_lock:
            store = self._obs.get(scope, {})
            for key in list(store):
                ts = store[key].get("ts", 0.0)
                if isinstance(ts, (int, float)) and now - ts > retention:
                    del store[key]
                    pruned += 1
        return pruned

    # -- MVCC staging-store control plane -------------------------------------
    def mvcc_admit_layer(self, scope: str, layer: dict) -> dict:
        # json round trip: validates serializability and deep-copies
        # (callers keep mutating their dicts)
        lay = json.loads(json.dumps(layer))
        with self._mvcc_lock:
            doc = self._mvcc.setdefault(scope, mvccfence.new_mvcc_doc())
            return mvccfence.admit_layer_in_place(doc, lay)

    def mvcc_cutover(self, scope: str, watermark: int, epoch: int,
                     offsets=None) -> dict:
        with self._mvcc_lock:
            doc = self._mvcc.setdefault(scope, mvccfence.new_mvcc_doc())
            return mvccfence.cutover_in_place(doc, watermark, epoch,
                                              offsets=offsets)

    def mvcc_record_base(self, scope: str, base: dict) -> dict:
        rec = json.loads(json.dumps(base))
        with self._mvcc_lock:
            doc = self._mvcc.setdefault(scope, mvccfence.new_mvcc_doc())
            return mvccfence.record_base_in_place(doc, rec)

    def mvcc_state(self, scope: str) -> dict:
        with self._mvcc_lock:
            return mvccfence.state_view(self._mvcc.get(scope))

    def mvcc_prune_layers(self, scope: str, keys: list) -> int:
        with self._mvcc_lock:
            doc = self._mvcc.get(scope)
            if doc is None:
                return 0
            return mvccfence.prune_layers_in_place(doc, keys)

    # -- MVCC blobs -----------------------------------------------------------
    def put_mvcc_blob(self, scope: str, name: str, data: bytes) -> str:
        locator = f"heap://{scope}/{name}"
        with self._mvcc_lock:
            self._mvcc_blobs.setdefault(scope, {})[locator] = bytes(data)
        return locator

    def get_mvcc_blob(self, scope: str, locator: str):
        with self._mvcc_lock:
            return self._mvcc_blobs.get(scope, {}).get(locator)

    def delete_mvcc_blobs(self, scope: str, locators: list) -> int:
        deleted = 0
        with self._mvcc_lock:
            blobs = self._mvcc_blobs.get(scope, {})
            for loc in locators:
                if blobs.pop(loc, None) is not None:
                    deleted += 1
        return deleted

    # -- worker health ------------------------------------------------------
    def operation_health(self, operation_id: str, worker_index: int,
                         payload: Optional[dict] = None) -> None:
        with self._health_lock:
            self.health_reports.append((operation_id, worker_index,
                                        payload))
            self._health_latest[(operation_id, worker_index)] = {
                "ts": time.time(), "payload": payload,
            }

    def get_operation_health(self, operation_id: str) -> dict[int, dict]:
        with self._health_lock:
            return {
                widx: dict(rep)
                for (scope, widx), rep in self._health_latest.items()
                if scope == operation_id
            }

    def transfer_health(self, transfer_id: str, worker_index: int = 0,
                        healthy: bool = True) -> None:
        with self._health_lock:
            self.health_reports.append((transfer_id, worker_index,
                                        healthy))
            self._health_latest[(transfer_id, worker_index)] = {
                "ts": time.time(), "payload": {"healthy": healthy},
            }
