"""Shared-directory coordinator (the port's copy of
``transferia_tpu/coordinator/filestore.py``): serverless and
multi-process.  Sharded snapshot workers in separate processes (or
hosts sharing an NFS or hostPath directory) coordinate through JSON
documents under one root, each read-modify-write under `fcntl.flock` on
`<file>.lock` and published with `os.replace` of a `<path>.tmp.<pid>`
file.  Threads of one process share the pid, so the lock is what keeps
two writers of one document from clashing on its temporary name; a
segment or blob has one writer and takes no lock.

Layout:
    <root>/transfers/<id>/status.json     {"status": ...}
    <root>/transfers/<id>/state.json      {...checkpoints...}
    <root>/transfers/<id>/messages.jsonl
    <root>/operations/<op>/parts.json     [OperationTablePart...]
    <root>/health/<scope>.json
    <root>/fleet/<queue>.json             {"next_seq": N, "tickets": [...]}
    <root>/obs/<scope>/<worker>-<seq>.json
    <root>/mvcc/<scope>.json, <root>/mvcc/blobs/<scope>/<name>.bin
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import time
import urllib.parse
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
from transferia_tpu_torch.coordinator.interface import (
    Coordinator,
    TransferStatus,
    deadline_expired,
    default_lease_seconds,
    obs_retention_seconds,
    obs_segments_per_worker,
    ticket_retention_seconds,
)

# health files keep latest-per-worker plus a bounded rolling history —
# long operations must not grow them without limit
HEALTH_HISTORY_LIMIT = 128


class FileStoreCoordinator(Coordinator):
    def __init__(self, root: str,
                 lease_seconds: Optional[float] = None):
        self.root = root
        self.lease_seconds = (default_lease_seconds()
                              if lease_seconds is None else lease_seconds)
        os.makedirs(os.path.join(root, "transfers"), exist_ok=True)
        os.makedirs(os.path.join(root, "operations"), exist_ok=True)
        os.makedirs(os.path.join(root, "health"), exist_ok=True)
        os.makedirs(os.path.join(root, "fleet"), exist_ok=True)
        os.makedirs(os.path.join(root, "obs"), exist_ok=True)
        os.makedirs(os.path.join(root, "mvcc"), exist_ok=True)

    # -- file helpers -------------------------------------------------------
    def _tdir(self, transfer_id: str) -> str:
        d = os.path.join(self.root, "transfers", transfer_id)
        os.makedirs(d, exist_ok=True)
        return d

    def _odir(self, operation_id: str) -> str:
        d = os.path.join(self.root, "operations", operation_id)
        os.makedirs(d, exist_ok=True)
        return d

    @contextlib.contextmanager
    def _locked(self, path: str):
        """flock-guarded critical section for read-modify-write."""
        lock_path = path + ".lock"
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    @staticmethod
    def _read_json(path: str, default):
        try:
            with open(path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return default

    @staticmethod
    def _write_json(path: str, value) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(value, fh)
        os.replace(tmp, path)  # atomic publish

    # -- status -------------------------------------------------------------
    def set_status(self, transfer_id: str, status: TransferStatus) -> None:
        p = os.path.join(self._tdir(transfer_id), "status.json")
        with self._locked(p):
            self._write_json(p, {"status": status.value, "ts": time.time()})

    def get_status(self, transfer_id: str) -> TransferStatus:
        p = os.path.join(self._tdir(transfer_id), "status.json")
        d = self._read_json(p, {"status": "new"})
        return TransferStatus(d["status"])

    def open_status_message(self, transfer_id: str, category: str,
                            message: str) -> None:
        p = os.path.join(self._tdir(transfer_id), "messages.jsonl")
        with self._locked(p), open(p, "a") as fh:
            fh.write(json.dumps({
                "category": category, "message": message, "ts": time.time(),
            }) + "\n")

    # -- state KV -----------------------------------------------------------
    def set_transfer_state(self, transfer_id: str,
                           state: dict[str, Any]) -> None:
        p = os.path.join(self._tdir(transfer_id), "state.json")
        with self._locked(p):
            cur = self._read_json(p, {})
            cur.update(state)
            self._write_json(p, cur)

    def get_transfer_state(self, transfer_id: str) -> dict[str, Any]:
        p = os.path.join(self._tdir(transfer_id), "state.json")
        return self._read_json(p, {})

    def remove_transfer_state(self, transfer_id: str,
                              keys: list[str]) -> None:
        p = os.path.join(self._tdir(transfer_id), "state.json")
        with self._locked(p):
            cur = self._read_json(p, {})
            for k in keys:
                cur.pop(k, None)
            self._write_json(p, cur)

    # -- operation state ----------------------------------------------------
    def set_operation_state(self, operation_id: str,
                            state: dict[str, Any]) -> None:
        p = os.path.join(self._odir(operation_id), "state.json")
        with self._locked(p):
            cur = self._read_json(p, {})
            cur.update(state)
            self._write_json(p, cur)

    def get_operation_state(self, operation_id: str) -> dict[str, Any]:
        p = os.path.join(self._odir(operation_id), "state.json")
        return self._read_json(p, {})

    # -- operation parts ----------------------------------------------------
    def _parts_path(self, operation_id: str) -> str:
        return os.path.join(self._odir(operation_id), "parts.json")

    def add_operation_parts(self, operation_id: str,
                            parts: list[OperationTablePart]) -> None:
        p = self._parts_path(operation_id)
        with self._locked(p):
            cur = self._read_json(p, [])
            cur.extend(x.to_json() for x in parts)
            self._write_json(p, cur)

    def create_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]) -> None:
        p = self._parts_path(operation_id)
        with self._locked(p):
            self._write_json(p, [x.to_json() for x in parts])

    def assign_operation_part(self, operation_id: str, worker_index: int
                              ) -> Optional[OperationTablePart]:
        p = self._parts_path(operation_id)
        now = time.time()
        with self._locked(p):
            parts = self._read_json(p, [])
            for d in parts:
                if d.get("completed"):
                    continue
                holder = d.get("worker_index")
                stolen = holder is not None and deadline_expired(
                    d.get("lease_expires_at") or 0.0, now)
                if holder is not None and not stolen:
                    continue
                d["stolen_from"] = holder if stolen else None
                d["worker_index"] = worker_index
                d["assignment_epoch"] = d.get("assignment_epoch", 0) + 1
                # unconditional: a stale stamp under disabled leasing
                # would look expired forever and re-steal every assign
                d["lease_expires_at"] = (now + self.lease_seconds
                                         if self.lease_seconds > 0
                                         else 0.0)
                self._write_json(p, parts)
                return OperationTablePart.from_json(d)
            return None

    def renew_lease(self, operation_id: str, worker_index: int) -> int:
        if self.lease_seconds <= 0:
            return 0
        p = self._parts_path(operation_id)
        renewed = 0
        now = time.time()
        with self._locked(p):
            parts = self._read_json(p, [])
            for d in parts:
                if d.get("worker_index") == worker_index \
                        and not d.get("completed"):
                    d["lease_expires_at"] = now + self.lease_seconds
                    renewed += 1
            if renewed:
                self._write_json(p, parts)
        return renewed

    def clear_assigned_parts(self, operation_id: str,
                             worker_index: int) -> int:
        p = self._parts_path(operation_id)
        released = 0
        with self._locked(p):
            parts = self._read_json(p, [])
            for d in parts:
                if d.get("worker_index") == worker_index \
                        and not d.get("completed"):
                    d["worker_index"] = None
                    d["lease_expires_at"] = 0.0
                    released += 1
            if released:
                self._write_json(p, parts)
        return released

    def commit_part(self, operation_id: str,
                    part: OperationTablePart) -> Optional[bool]:
        p = self._parts_path(operation_id)
        with self._locked(p):
            parts = self._read_json(p, [])
            for d in parts:
                if (d["operation_id"], d["schema"], d["table"],
                        d["part_index"]) != (
                            part.operation_id, part.table_id.namespace,
                            part.table_id.name, part.part_index):
                    continue
                if part.assignment_epoch != d.get("assignment_epoch", 0):
                    return False  # epoch fence (coordinator/interface)
                d["commit_epoch"] = part.assignment_epoch
                self._write_json(p, parts)
                return True
            return False

    def update_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]
                               ) -> list[str]:
        p = self._parts_path(operation_id)
        rejected: list[str] = []
        with self._locked(p):
            cur = self._read_json(p, [])
            by_key = {
                (d["operation_id"], d["schema"], d["table"],
                 d["part_index"]): d
                for d in cur
            }
            for upd in parts:
                k = (upd.operation_id, upd.table_id.namespace,
                     upd.table_id.name, upd.part_index)
                if k not in by_key:
                    continue
                d = by_key[k]
                if upd.assignment_epoch != d.get("assignment_epoch", 0):
                    # epoch fence (see coordinator/interface.py)
                    rejected.append(upd.key())
                    continue
                d["completed_rows"] = upd.completed_rows
                d["read_bytes"] = upd.read_bytes
                d["completed"] = upd.completed
                d["worker_index"] = upd.worker_index
                d["fingerprint"] = upd.fingerprint
            self._write_json(p, cur)
        return rejected

    def operation_parts(self, operation_id: str) -> list[OperationTablePart]:
        return [
            OperationTablePart.from_json(d)
            for d in self._read_json(self._parts_path(operation_id), [])
        ]

    # -- durable fleet admission queue --------------------------------------
    # One flock'd JSON document per queue ({"next_seq": N, "tickets":
    # [...]}) — claims/completions are read-modify-write under the same
    # exclusive lock the part queue uses, so two worker PROCESSES can
    # never claim the same ticket.

    def _queue_path(self, queue: str) -> str:
        safe = queue.replace(os.sep, "_")
        return os.path.join(self.root, "fleet", f"{safe}.json")

    def _queue_doc(self, path: str) -> dict:
        doc = self._read_json(path, {})
        if not isinstance(doc, dict) or "tickets" not in doc:
            doc = {"next_seq": 0, "tickets": []}
        return doc

    def enqueue_ticket(self, queue: str,
                       ticket: FleetTicket) -> FleetTicket:
        p = self._queue_path(queue)
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if d["ticket_id"] == ticket.ticket_id:
                    # idempotent: the no-double-admission guarantee
                    return FleetTicket.from_json(d)
            d = ticket.to_json()
            d["seq"] = doc["next_seq"]
            doc["next_seq"] += 1
            d["state"] = "queued"
            d["enqueued_at"] = time.time()
            doc["tickets"].append(d)
            self._write_json(p, doc)
            return FleetTicket.from_json(d)

    def list_tickets(self, queue: str) -> list[FleetTicket]:
        doc = self._queue_doc(self._queue_path(queue))
        return [FleetTicket.from_json(d)
                for d in sorted(doc["tickets"], key=lambda t: t["seq"])]

    def claim_ticket(self, queue: str, ticket_id: str,
                     worker_id: str) -> Optional[FleetTicket]:
        p = self._queue_path(queue)
        now = time.time()
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if d["ticket_id"] != ticket_id:
                    continue
                if not ticket_claimable(d, now):
                    return None
                claim_in_place(d, worker_id, self.lease_seconds, now)
                self._write_json(p, doc)
                return FleetTicket.from_json(d)
            return None

    def renew_ticket_leases(self, queue: str, worker_id: str,
                            ticket_id: Optional[str] = None,
                            claim_epoch: Optional[int] = None) -> int:
        if self.lease_seconds <= 0:
            return 0
        p = self._queue_path(queue)
        renewed = 0
        now = time.time()
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if ticket_id is not None \
                        and d["ticket_id"] != ticket_id:
                    continue
                if claim_epoch is not None \
                        and d.get("claim_epoch", 0) != claim_epoch:
                    continue
                if d["state"] == "claimed" \
                        and d["claimed_by"] == worker_id:
                    d["lease_expires_at"] = now + self.lease_seconds
                    renewed += 1
            if renewed:
                self._write_json(p, doc)
        return renewed

    def complete_ticket(self, queue: str, ticket: FleetTicket,
                        error: str = "") -> bool:
        p = self._queue_path(queue)
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if d["ticket_id"] != ticket.ticket_id:
                    continue
                if complete_is_duplicate(d, ticket):
                    return True  # idempotent retry of a lost response
                if not fence_matches(d, ticket):
                    return False  # zombie: reclaimed/revoked since
                complete_in_place(d, error)
                self._write_json(p, doc)
                return True
            return False

    def release_ticket(self, queue: str, ticket: FleetTicket,
                       failed: bool = False) -> bool:
        p = self._queue_path(queue)
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if d["ticket_id"] != ticket.ticket_id:
                    continue
                if not fence_matches(d, ticket):
                    return False
                release_in_place(d, failed=failed)
                self._write_json(p, doc)
                return True
            return False

    def revoke_ticket(self, queue: str,
                      ticket_id: str) -> Optional[FleetTicket]:
        p = self._queue_path(queue)
        with self._locked(p):
            doc = self._queue_doc(p)
            for d in doc["tickets"]:
                if d["ticket_id"] != ticket_id:
                    continue
                if d["state"] != "claimed":
                    return None  # nothing to preempt
                revoke_in_place(d)
                self._write_json(p, doc)
                return FleetTicket.from_json(d)
            return None

    def gc_tickets(self, queue: str,
                   retention_seconds: Optional[float] = None) -> int:
        retention = ticket_retention_seconds() \
            if retention_seconds is None else retention_seconds
        p = self._queue_path(queue)
        now = time.time()
        with self._locked(p):
            doc = self._queue_doc(p)
            keep = [d for d in doc["tickets"]
                    if not ticket_expired(d, retention, now)]
            pruned = len(doc["tickets"]) - len(keep)
            if pruned:
                doc["tickets"] = keep
                self._write_json(p, doc)
        return pruned

    # -- durable observability segments --------------------------------------
    # One file per segment (`obs/<scope>/<worker>-<seq>.json`): the put
    # is an atomic tmp+rename (under the flock for write-write
    # convention with the other doc stores), so a reader can never see
    # a torn file from a healthy writer — torn segments come from
    # crashed writers and the merge plane tolerates them.

    def _obs_dir(self, scope: str) -> str:
        d = os.path.join(self.root, "obs", urllib.parse.quote(scope, safe=""))
        os.makedirs(d, exist_ok=True)
        return d

    @staticmethod
    def _obs_name(worker: str, seq: int) -> str:
        return f"{urllib.parse.quote(worker, safe='')}-{seq:08d}.json"

    def put_obs_segment(self, scope: str, segment: dict) -> None:
        d = self._obs_dir(scope)
        worker = str(segment.get("worker", ""))
        seq = int(segment.get("seq", 0))
        p = os.path.join(d, self._obs_name(worker, seq))
        # no flock: _write_json is an atomic tmp+rename and each
        # (worker, seq) has exactly one writer — a lock FILE here
        # would leak one `.lock` per export forever (seq is always
        # fresh), growing the obs dir O(history)
        self._write_json(p, segment)

    def _obs_files(self, scope: str) -> list[str]:
        d = self._obs_dir(scope)
        return sorted(
            os.path.join(d, name) for name in os.listdir(d)
            if name.endswith(".json"))

    def list_obs_segments(self, scope: str) -> list[dict]:
        out = []
        for p in self._obs_files(scope):
            seg = self._read_json(p, None)
            if isinstance(seg, dict):
                out.append(seg)
            # torn/unparseable files are skipped: the merge renders
            # from the survivors (a crashed writer's last segment)
        return out

    def gc_obs_segments(self, scope: str,
                        retention_seconds: Optional[float] = None
                        ) -> int:
        retention = obs_retention_seconds() \
            if retention_seconds is None else retention_seconds
        bound = obs_segments_per_worker()
        now = time.time()
        per_worker: dict[str, list[str]] = {}
        pruned = 0
        for p in self._obs_files(scope):
            name = os.path.basename(p)
            worker = name[:-5].rsplit("-", 1)[0]
            seg = self._read_json(p, None)
            ts = seg.get("ts") if isinstance(seg, dict) else None
            if not isinstance(ts, (int, float)):
                try:  # torn segment: fall back to the file clock
                    ts = os.path.getmtime(p)
                except OSError:
                    continue
            if now - ts > retention:
                try:
                    os.remove(p)
                    pruned += 1
                except OSError:
                    pass
                continue
            per_worker.setdefault(worker, []).append(p)
        for paths in per_worker.values():
            for p in sorted(paths)[:-bound]:
                try:
                    os.remove(p)
                    pruned += 1
                except OSError:
                    pass
        # hygiene: crashed writers (or older code) may leave stray
        # tmp/lock files next to the segments — they are never listed,
        # so only GC can reclaim them
        d = self._obs_dir(scope)
        for name in os.listdir(d):
            if name.endswith(".lock") or ".tmp." in name:
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass
        return pruned

    # -- MVCC staging-store control plane -------------------------------------
    def _mvcc_path(self, scope: str) -> str:
        return os.path.join(self.root, "mvcc",
                            f"{urllib.parse.quote(scope, safe='')}.json")

    def _mvcc_doc(self, path: str) -> dict:
        doc = self._read_json(path, {})
        if not isinstance(doc, dict) or "layers" not in doc:
            doc = mvccfence.new_mvcc_doc()
        return doc

    def mvcc_admit_layer(self, scope: str, layer: dict) -> dict:
        p = self._mvcc_path(scope)
        with self._locked(p):
            doc = self._mvcc_doc(p)
            res = mvccfence.admit_layer_in_place(doc, layer)
            self._write_json(p, doc)
            return res

    def mvcc_cutover(self, scope: str, watermark: int,
                     epoch: int, offsets=None) -> dict:
        p = self._mvcc_path(scope)
        with self._locked(p):
            doc = self._mvcc_doc(p)
            res = mvccfence.cutover_in_place(doc, watermark, epoch,
                                             offsets=offsets)
            self._write_json(p, doc)
            return res

    def mvcc_record_base(self, scope: str, base: dict) -> dict:
        p = self._mvcc_path(scope)
        with self._locked(p):
            doc = self._mvcc_doc(p)
            res = mvccfence.record_base_in_place(doc, base)
            if res.get("status") != mvccfence.FENCED:
                self._write_json(p, doc)
            return res

    def mvcc_state(self, scope: str) -> dict:
        return mvccfence.state_view(
            self._mvcc_doc(self._mvcc_path(scope)))

    def mvcc_prune_layers(self, scope: str, keys: list) -> int:
        p = self._mvcc_path(scope)
        with self._locked(p):
            doc = self._mvcc_doc(p)
            pruned = mvccfence.prune_layers_in_place(doc, keys)
            if pruned:
                self._write_json(p, doc)
            return pruned

    # -- MVCC spill blobs ----------------------------------------------------
    # One file per blob under mvcc/blobs/<scope>/; the atomic
    # tmp+rename publish (same as _write_json) makes a retried spill
    # an idempotent replace and a SIGKILL mid-put invisible.  Each
    # (scope, name) has exactly one writer — the worker holding the
    # layer — so no flock is needed (the obs-segment rule).
    def _mvcc_blob_path(self, scope: str, name: str) -> str:
        d = os.path.join(self.root, "mvcc", "blobs",
                         urllib.parse.quote(scope, safe=""))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{urllib.parse.quote(name, safe='')}.bin")

    def put_mvcc_blob(self, scope: str, name: str,
                      data: bytes) -> str:
        p = self._mvcc_blob_path(scope, name)
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, p)
        return f"file://{p}"

    def get_mvcc_blob(self, scope: str, locator: str):
        if not locator.startswith("file://"):
            return None
        try:
            with open(locator[len("file://"):], "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def delete_mvcc_blobs(self, scope: str, locators: list) -> int:
        deleted = 0
        for loc in locators:
            if not str(loc).startswith("file://"):
                continue
            try:
                os.remove(str(loc)[len("file://"):])
                deleted += 1
            except FileNotFoundError:
                pass
        return deleted

    def _write_health(self, path: str, worker_index: int,
                      payload) -> None:
        """Latest-per-worker + bounded history (never an unbounded
        append: a long operation heartbeats for hours)."""
        entry = {"worker": worker_index, "ts": time.time(),
                 "payload": payload}
        with self._locked(path):
            cur = self._read_json(path, {})
            if not isinstance(cur, dict):  # pre-lease .jsonl era file
                cur = {}
            cur.setdefault("workers", {})[str(worker_index)] = entry
            hist = cur.setdefault("history", [])
            hist.append(entry)
            del hist[:-HEALTH_HISTORY_LIMIT]
            self._write_json(path, cur)

    def operation_health(self, operation_id: str, worker_index: int,
                         payload: Optional[dict] = None) -> None:
        p = os.path.join(self.root, "health", f"op_{operation_id}.json")
        self._write_health(p, worker_index, payload)

    def get_operation_health(self, operation_id: str) -> dict[int, dict]:
        p = os.path.join(self.root, "health", f"op_{operation_id}.json")
        cur = self._read_json(p, {})
        workers = cur.get("workers", {}) if isinstance(cur, dict) else {}
        return {
            int(w): {"ts": rep.get("ts"), "payload": rep.get("payload")}
            for w, rep in workers.items()
        }

    def transfer_health(self, transfer_id: str, worker_index: int = 0,
                        healthy: bool = True) -> None:
        p = os.path.join(self.root, "health", f"tr_{transfer_id}.json")
        self._write_health(p, worker_index, {"healthy": healthy})
