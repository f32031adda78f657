"""Object-store (S3-API) coordinator, the multi-pod control plane: the
port's copy of ``transferia_tpu/coordinator/s3store.py``.

Reference parity: pkg/coordinator/s3coordinator/coordinator_s3.go.
Sharded multi-pod runs coordinate through JSON objects in a shared
bucket, no server.  Unlike the filestore coordinator (a directory that
every worker mounts), it works against any S3-compatible endpoint, so
pods of a k8s Indexed Job split a snapshot with no shared volume.

Layout (per-part objects so claims don't contend on one blob):
    <prefix>transfers/<id>/status.json
    <prefix>transfers/<id>/state.json
    <prefix>transfers/<id>/messages/<ts>-<pid>.json
    <prefix>operations/<op>/state.json
    <prefix>operations/<op>/parts/<schema>.<table>.<idx>.json
    <prefix>health/<scope>/<worker>.json
    <prefix>fleet/<queue>/tickets/<seq>.json, .../ids/<ticket>.json
    <prefix>obs/<scope>/<worker>-<seq>.json
    <prefix>mvcc/<scope>.json, <prefix>mvccblob/<scope>/<name>

Atomicity: part claims and state merges use S3 conditional writes
(If-Match on the read ETag; PreconditionFailed -> somebody else won, move
on).  Endpoints without conditional-write support degrade to the
reference's last-writer-wins puts (coordinator_s3.go:236-268 accepts the
same race; snapshot parts are idempotent at-least-once units).
Credentials come from the arguments or from AWS_ACCESS_KEY_ID and
AWS_SECRET_ACCESS_KEY.
"""

from __future__ import annotations

import json
import logging
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
from transferia_tpu_torch.coordinator.s3client import (
    ConditionalUnsupported,
    PreconditionFailed,
    S3Client,
)

logger = logging.getLogger(__name__)

# enqueue id-guard staleness: a guard this old whose ticket object
# never appeared belongs to a replica that died between winning the
# guard and writing the ticket — safe to take over.  Generous on
# purpose: a merely slow owner must never be raced (that re-opens the
# double admission the guard exists to close); a submitter that can't
# wait simply gets a retriable TimeoutError.
ENQUEUE_GUARD_STALE_SECONDS = 30.0


class S3Coordinator(Coordinator):
    def __init__(self, bucket: str, endpoint: str = "",
                 region: str = "us-east-1", access_key: str = "",
                 secret_key: str = "", prefix: str = "",
                 lease_seconds: Optional[float] = None):
        access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        self.client = S3Client(bucket, endpoint=endpoint, region=region,
                               access_key=access_key,
                               secret_key=secret_key)
        self.prefix = prefix.rstrip("/") + "/" if prefix else ""
        self.lease_seconds = (default_lease_seconds()
                              if lease_seconds is None else lease_seconds)
        self._conditional = True  # flips off on ConditionalUnsupported
        # (queue, ticket_id) -> object key memo: lets the per-ticket
        # paths (heartbeat renew, complete, release) do one GET instead
        # of LIST + N GETs over the whole queue.  Purely a cache — a
        # miss or a stale entry falls back to the listing.
        self._ticket_keys: dict[tuple, str] = {}
        # key -> terminal ticket body: done/failed never reverts, so a
        # queue listing skips the GET for every ticket this instance
        # has already seen terminal — per-poll cost stays O(active),
        # not O(history) (full GC/retention is a roadmap item)
        self._terminal_tickets: dict[str, dict] = {}
        self._done_keys: dict[str, set] = {}  # op -> completed part keys
        # op -> part keys THIS instance claimed and still holds: the
        # heartbeat renews only these (O(claimed) GET+PUT per beat, not
        # a LIST + GET over the whole queue).  One coordinator instance
        # per worker process, so the memo is authoritative for renewal.
        self._claimed: dict[str, set] = {}

    # -- helpers ------------------------------------------------------------
    def _key(self, *parts: str) -> str:
        return self.prefix + "/".join(parts)

    def _get_json(self, key: str, default):
        got = self.client.get(key)
        if got is None:
            return default, None
        body, etag = got
        try:
            return json.loads(body), etag
        except json.JSONDecodeError:
            return default, etag

    def _put_json(self, key: str, value,
                  if_match: Optional[str] = None,
                  if_none_match: bool = False) -> None:
        body = json.dumps(value).encode()
        if not self._conditional:
            if_match, if_none_match = None, False
        try:
            self.client.put(key, body, if_match=if_match,
                            if_none_match=if_none_match)
        except ConditionalUnsupported:
            logger.warning(
                "endpoint has no conditional writes; degrading to "
                "last-writer-wins (reference semantics)")
            self._conditional = False
            self.client.put(key, body)

    def _merge_json(self, key: str, update_fn) -> dict:
        """Read-modify-write with If-Match retry (optimistic CAS loop)."""
        for _ in range(16):
            cur, etag = self._get_json(key, {})
            new = update_fn(dict(cur))
            try:
                self._put_json(key, new, if_match=etag,
                               if_none_match=etag is None)
                return new
            except PreconditionFailed:
                time.sleep(0.05)
        raise TimeoutError(f"CAS loop on {key} did not converge")

    # -- status -------------------------------------------------------------
    def set_status(self, transfer_id: str, status: TransferStatus) -> None:
        self._put_json(self._key("transfers", transfer_id, "status.json"),
                       {"status": status.value, "ts": time.time()})

    def get_status(self, transfer_id: str) -> TransferStatus:
        d, _ = self._get_json(
            self._key("transfers", transfer_id, "status.json"),
            {"status": "new"})
        return TransferStatus(d["status"])

    def open_status_message(self, transfer_id: str, category: str,
                            message: str) -> None:
        key = self._key("transfers", transfer_id, "messages",
                        f"{time.time():.6f}-{os.getpid()}.json")
        self._put_json(key, {"category": category, "message": message,
                             "ts": time.time()})

    # -- state KV -----------------------------------------------------------
    def set_transfer_state(self, transfer_id: str,
                           state: dict[str, Any]) -> None:
        key = self._key("transfers", transfer_id, "state.json")

        def merge(cur: dict) -> dict:
            cur.update(state)
            return cur

        self._merge_json(key, merge)

    def get_transfer_state(self, transfer_id: str) -> dict[str, Any]:
        d, _ = self._get_json(
            self._key("transfers", transfer_id, "state.json"), {})
        return d

    def remove_transfer_state(self, transfer_id: str,
                              keys: list[str]) -> None:
        key = self._key("transfers", transfer_id, "state.json")

        def drop(cur: dict) -> dict:
            for k in keys:
                cur.pop(k, None)
            return cur

        self._merge_json(key, drop)

    # -- operation state ----------------------------------------------------
    def set_operation_state(self, operation_id: str,
                            state: dict[str, Any]) -> None:
        key = self._key("operations", operation_id, "state.json")

        def merge(cur: dict) -> dict:
            cur.update(state)
            return cur

        self._merge_json(key, merge)

    def get_operation_state(self, operation_id: str) -> dict[str, Any]:
        d, _ = self._get_json(
            self._key("operations", operation_id, "state.json"), {})
        return d

    # -- operation parts ----------------------------------------------------
    def add_operation_parts(self, operation_id: str,
                            parts: list[OperationTablePart]) -> None:
        # per-part objects: appending IS creating more objects.  Unlike
        # the JAX package's (which calls create_operation_parts and so
        # deletes every part an earlier discovery flush published),
        # this keeps the queue: ROADMAP.md C
        for part in parts:
            key = self._part_key_for(
                operation_id, part.table_id.namespace,
                part.table_id.name, part.part_index)
            self._put_json(key, part.to_json())

    def _part_key_for(self, operation_id: str, schema: str, table: str,
                      part_index: int) -> str:
        name = (f"{urllib.parse.quote(schema, safe='')}."
                f"{urllib.parse.quote(table, safe='')}.{part_index:06d}.json")
        return self._key("operations", operation_id, "parts", name)

    def create_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]) -> None:
        # create REPLACES the queue: clear leftovers from a previous
        # activation of the same operation id first (memory/filestore
        # overwrite wholesale; per-part objects need explicit deletion)
        prefix = self._key("operations", operation_id, "parts", "")
        for obj in self.client.list(prefix):
            self.client.delete(obj.key)
        self._done_keys.pop(operation_id, None)
        self._claimed.pop(operation_id, None)
        for part in parts:
            key = self._part_key_for(
                operation_id, part.table_id.namespace,
                part.table_id.name, part.part_index)
            self._put_json(key, part.to_json())

    def _list_parts_raw(self, operation_id: str,
                        skip: Optional[set] = None
                        ) -> list[tuple[str, dict, str]]:
        prefix = self._key("operations", operation_id, "parts", "")
        out = []
        for obj in self.client.list(prefix):
            if skip is not None and obj.key in skip:
                continue
            got = self.client.get(obj.key)
            if got is None:
                continue
            body, etag = got
            try:
                out.append((obj.key, json.loads(body), etag))
            except json.JSONDecodeError:
                continue
        return out

    def assign_operation_part(self, operation_id: str, worker_index: int
                              ) -> Optional[OperationTablePart]:
        # memo completed parts: completion never reverts, so skipping
        # their GETs keeps claim cost O(in-flight), not O(all parts)
        done = self._done_keys.setdefault(operation_id, set())
        now = time.time()
        for key, d, etag in self._list_parts_raw(operation_id, skip=done):
            if d.get("completed"):
                done.add(key)
                continue
            holder = d.get("worker_index")
            stolen = holder is not None and deadline_expired(
                d.get("lease_expires_at") or 0.0, now)
            if holder is not None and not stolen:
                continue
            d["stolen_from"] = holder if stolen else None
            d["worker_index"] = worker_index
            d["assignment_epoch"] = d.get("assignment_epoch", 0) + 1
            # unconditional: a stale stamp under disabled leasing would
            # look expired forever and re-steal on every assign
            d["lease_expires_at"] = (now + self.lease_seconds
                                     if self.lease_seconds > 0 else 0.0)
            try:
                self._put_json(key, d, if_match=etag)
            except PreconditionFailed:
                continue  # another worker claimed/stole it first
            self._claimed.setdefault(operation_id, set()).add(key)
            if not self._conditional:
                # make the duplicate-part risk visible on every claim,
                # not only at degrade time (e.g. legacy MinIO endpoints)
                logger.warning(
                    "part claim %s by worker %d is last-writer-wins "
                    "(no conditional writes): a racing worker may "
                    "duplicate this part on non-idempotent sinks",
                    key, worker_index)
            return OperationTablePart.from_json(d)
        return None

    def renew_lease(self, operation_id: str, worker_index: int) -> int:
        if self.lease_seconds <= 0:
            return 0
        claimed = self._claimed.get(operation_id)
        if not claimed:
            return 0
        renewed = 0
        now = time.time()
        for key in sorted(claimed):
            got = self.client.get(key)
            if got is None:
                claimed.discard(key)
                continue
            body, etag = got
            try:
                d = json.loads(body)
            except json.JSONDecodeError:
                continue
            if d.get("completed") or d.get("worker_index") != worker_index:
                claimed.discard(key)  # finished or stolen: not ours
                continue
            d["lease_expires_at"] = now + self.lease_seconds
            try:
                self._put_json(key, d, if_match=etag)
                renewed += 1
            except PreconditionFailed:
                continue  # updated under us: re-examined next beat
        return renewed

    def clear_assigned_parts(self, operation_id: str,
                             worker_index: int) -> int:
        released = 0
        for key, d, etag in self._list_parts_raw(operation_id):
            if d.get("worker_index") == worker_index \
                    and not d.get("completed"):
                d["worker_index"] = None
                d["lease_expires_at"] = 0.0
                try:
                    self._put_json(key, d, if_match=etag)
                    released += 1
                    self._claimed.get(operation_id, set()).discard(key)
                except PreconditionFailed:
                    continue
        return released

    def commit_part(self, operation_id: str,
                    part: OperationTablePart) -> Optional[bool]:
        key = self._part_key_for(
            operation_id, part.table_id.namespace, part.table_id.name,
            part.part_index)
        for _ in range(16):
            d, etag = self._get_json(key, None)
            if d is None:
                return False  # unknown part: never grant a publish
            if part.assignment_epoch != d.get("assignment_epoch", 0):
                return False  # epoch fence (coordinator/interface)
            d["commit_epoch"] = part.assignment_epoch
            try:
                # conditional on the read ETag: a steal racing this
                # grant bumps the epoch, and the retry re-reads and
                # fences instead of granting a publish to a zombie
                self._put_json(key, d, if_match=etag)
                return True
            except PreconditionFailed:
                time.sleep(0.05)
        raise TimeoutError(f"commit_part CAS on {key} did not converge")

    def update_operation_parts(self, operation_id: str,
                               parts: list[OperationTablePart]
                               ) -> list[str]:
        rejected: list[str] = []
        for upd in parts:
            # part keys are derivable — no listing, one GET+PUT per part
            key = self._part_key_for(
                operation_id, upd.table_id.namespace,
                upd.table_id.name, upd.part_index)
            fenced = False
            applied = False
            for _ in range(16):
                d, etag = self._get_json(key, None)
                if d is None:
                    applied = True  # unknown part: nothing to fence
                    break
                if upd.assignment_epoch != d.get("assignment_epoch", 0):
                    fenced = True  # epoch fence (coordinator/interface)
                    break
                d["completed_rows"] = upd.completed_rows
                d["read_bytes"] = upd.read_bytes
                d["completed"] = upd.completed
                d["worker_index"] = upd.worker_index
                d["fingerprint"] = upd.fingerprint
                try:
                    # conditional on the read ETag: a steal racing this
                    # flush bumps the epoch, and the retry re-reads and
                    # fences instead of clobbering the new owner
                    self._put_json(key, d, if_match=etag)
                    applied = True
                except PreconditionFailed:
                    time.sleep(0.05)
                    continue
                if upd.completed:
                    self._done_keys.setdefault(operation_id,
                                               set()).add(key)
                    self._claimed.get(operation_id, set()).discard(key)
                break
            if fenced:
                rejected.append(upd.key())
            elif not applied:
                # CAS contention is NOT a fence: reporting it as one
                # would make the caller silently drop a legitimately
                # owned completion — surface it as a retriable failure
                raise TimeoutError(
                    f"part update CAS on {key} did not converge")
        return rejected

    def operation_parts(self, operation_id: str) -> list[OperationTablePart]:
        return [OperationTablePart.from_json(d)
                for _, d, _ in self._list_parts_raw(operation_id)]

    # -- durable fleet admission queue --------------------------------------
    # Per-ticket objects (<prefix>fleet/<queue>/tickets/<seq>-<id>.json)
    # so claims never contend on one blob: a claim is a single
    # conditional PUT on the ticket's own object (If-Match on the read
    # ETag; PreconditionFailed = another worker won the race).  Seq
    # assignment uses If-None-Match object creation — two scheduler
    # replicas racing the same seq slot see exactly one winner, the
    # loser re-lists and takes the next slot.

    def _ticket_prefix(self, queue: str) -> str:
        return self._key("fleet", urllib.parse.quote(queue, safe=""), "tickets",
                         "")

    def _ticket_id_guard(self, queue: str, ticket_id: str) -> str:
        return self._key("fleet", urllib.parse.quote(queue, safe=""), "ids",
                         f"{urllib.parse.quote(ticket_id, safe='')}.json")

    def _ticket_key(self, queue: str, seq: int) -> str:
        # the key is the seq SLOT alone (ticket identity lives in the
        # body): If-None-Match on this key is then a real slot
        # arbitration — with the ticket_id embedded, two different
        # tickets racing one slot would write different keys and both
        # "win", yielding duplicate seqs
        return self._ticket_prefix(queue) + f"{seq:08d}.json"

    def _list_ticket_objs(self, queue: str
                          ) -> list[tuple[str, dict, str]]:
        out = []
        for obj in self.client.list(self._ticket_prefix(queue)):
            cached = self._terminal_tickets.get(obj.key)
            if cached is not None:
                # terminal never reverts: skip the GET ("" etag — a
                # terminal ticket is never CAS-written again)
                out.append((obj.key, dict(cached), ""))
                continue
            got = self.client.get(obj.key)
            if got is None:
                continue
            body, etag = got
            try:
                d = json.loads(body)
            except json.JSONDecodeError:
                continue
            if d.get("state") in ("done", "failed"):
                self._terminal_tickets[obj.key] = dict(d)
            out.append((obj.key, d, etag))
        out.sort(key=lambda kde: kde[0])  # seq-prefixed keys
        return out

    def _find_ticket(self, queue: str, ticket_id: str
                     ) -> Optional[tuple[str, dict, str]]:
        # memoized fast path: one GET when this instance has seen the
        # ticket's key before (every heartbeat renew lands here)
        memo = self._ticket_keys.get((queue, ticket_id))
        if memo is not None:
            got = self.client.get(memo)
            if got is not None:
                body, etag = got
                try:
                    d = json.loads(body)
                except json.JSONDecodeError:
                    d = None
                if d is not None and d.get("ticket_id") == ticket_id:
                    return memo, d, etag
            self._ticket_keys.pop((queue, ticket_id), None)  # stale
        for key, d, etag in self._list_ticket_objs(queue):
            tid = d.get("ticket_id")
            if tid:
                self._ticket_keys[(queue, tid)] = key
            if tid == ticket_id:
                return key, d, etag
        return None

    def _max_seq(self, queue: str) -> int:
        """Highest occupied seq slot, from key NAMES alone — seq keys
        are `{seq:08d}.json`, so no ticket bodies need downloading."""
        max_seq = -1
        for obj in self.client.list(self._ticket_prefix(queue)):
            base = obj.key.rsplit("/", 1)[-1]
            if not base.endswith(".json"):
                continue
            try:
                max_seq = max(max_seq, int(base[:-5]))
            except ValueError:
                continue
        return max_seq

    def enqueue_ticket(self, queue: str,
                       ticket: FleetTicket) -> FleetTicket:
        # Two conditional creates, two distinct races: the per-TICKET-ID
        # guard object is the idempotency fence (two replicas enqueueing
        # the same ticket_id would otherwise compute DIFFERENT seq keys
        # and both win their per-key If-None-Match — a double
        # admission); the seq-keyed ticket object's If-None-Match then
        # arbitrates the seq slot among different tickets.  One GET
        # (guard) answers idempotency and the seq comes from key names,
        # so the common case costs O(1) GETs, not a body download of
        # the whole queue.
        guard = self._ticket_id_guard(queue, ticket.ticket_id)
        won_guard = False
        for _ in range(32):
            if not won_guard and self._conditional:
                got = self.client.get(guard)
                if got is None:
                    try:
                        self._put_json(guard,
                                       {"ticket_id": ticket.ticket_id,
                                        "ts": time.time()},
                                       if_none_match=True)
                        won_guard = True
                    except PreconditionFailed:
                        continue  # raced the create: re-read the guard
                else:
                    # another replica owns this ticket_id: return its
                    # ticket once visible.  Takeover is by guard AGE,
                    # not a fixed poll count — a merely SLOW owner
                    # (S3 tail latency) re-opening the race would be
                    # exactly the double admission the guard prevents;
                    # only a guard older than the stale threshold
                    # (owner died before writing its ticket) is taken
                    # over, via CAS on the guard itself so one taker
                    # wins.
                    found = self._find_ticket(queue, ticket.ticket_id)
                    if found is not None:
                        return FleetTicket.from_json(found[1])
                    body, etag = got
                    try:
                        ts = float(json.loads(body).get("ts", 0.0))
                    except (json.JSONDecodeError, TypeError,
                            ValueError):
                        ts = 0.0
                    if time.time() - ts > ENQUEUE_GUARD_STALE_SECONDS:
                        try:
                            self._put_json(
                                guard,
                                {"ticket_id": ticket.ticket_id,
                                 "ts": time.time()},
                                if_match=etag)
                            won_guard = True
                        except PreconditionFailed:
                            time.sleep(0.05)
                            continue  # another taker won: re-read
                    else:
                        time.sleep(0.05)
                        continue
            elif not self._conditional:
                # LWW degrade: idempotency falls back to the body scan
                found = self._find_ticket(queue, ticket.ticket_id)
                if found is not None:
                    return FleetTicket.from_json(found[1])
            d = ticket.to_json()
            d["seq"] = self._max_seq(queue) + 1
            d["state"] = "queued"
            d["enqueued_at"] = time.time()
            key = self._ticket_key(queue, d["seq"])
            try:
                self._put_json(key, d, if_none_match=True)
                if not self._conditional:
                    # same visibility rule as the claim path: the
                    # degrade must be loud — an unconditional seq-slot
                    # put can overwrite (lose) a racing replica's
                    # admitted ticket
                    logger.warning(
                        "ticket enqueue %s is last-writer-wins (no "
                        "conditional writes): a racing enqueue may "
                        "overwrite this seq slot and lose a ticket",
                        key)
                self._ticket_keys[(queue, ticket.ticket_id)] = key
                return FleetTicket.from_json(d)
            except PreconditionFailed:
                time.sleep(0.05)  # a DIFFERENT ticket raced this seq
                #                   slot; re-list and take the next one
        raise TimeoutError(
            f"enqueue_ticket race on queue {queue!r} did not converge")

    def list_tickets(self, queue: str) -> list[FleetTicket]:
        return [FleetTicket.from_json(d)
                for _k, d, _e in self._list_ticket_objs(queue)]

    def claim_ticket(self, queue: str, ticket_id: str,
                     worker_id: str) -> Optional[FleetTicket]:
        found = self._find_ticket(queue, ticket_id)
        if found is None:
            return None
        key, d, etag = found
        now = time.time()
        if not ticket_claimable(d, now):
            return None
        claim_in_place(d, worker_id, self.lease_seconds, now)
        try:
            # conditional on the read ETag: exactly one claimer wins
            self._put_json(key, d, if_match=etag)
        except PreconditionFailed:
            return None  # another worker claimed/stole it first
        if not self._conditional:
            logger.warning(
                "ticket claim %s by %s is last-writer-wins (no "
                "conditional writes): a racing worker may run this "
                "ticket twice", key, worker_id)
        return FleetTicket.from_json(d)

    def renew_ticket_leases(self, queue: str, worker_id: str,
                            ticket_id: Optional[str] = None,
                            claim_epoch: Optional[int] = None) -> int:
        if self.lease_seconds <= 0:
            return 0
        now = time.time()
        if ticket_id is not None:
            # the heartbeat path: one memoized GET + one PUT, not a
            # full queue scan every interval
            found = self._find_ticket(queue, ticket_id)
            candidates = [found] if found is not None else []
        else:
            candidates = self._list_ticket_objs(queue)
        renewed = 0
        for key, d, etag in candidates:
            if claim_epoch is not None \
                    and d.get("claim_epoch", 0) != claim_epoch:
                continue
            if d.get("state") != "claimed" \
                    or d.get("claimed_by") != worker_id:
                continue
            d["lease_expires_at"] = now + self.lease_seconds
            try:
                self._put_json(key, d, if_match=etag)
                renewed += 1
            except PreconditionFailed:
                continue  # updated under us (revoke?): next beat sees it
        return renewed

    def _fenced_ticket_write(self, queue: str, ticket: FleetTicket,
                             mutate,
                             accept_terminal_retry: bool = False
                             ) -> bool:
        found = self._find_ticket(queue, ticket.ticket_id)
        if found is None:
            return False
        key, d, etag = found
        for _ in range(16):
            if accept_terminal_retry and \
                    complete_is_duplicate(d, ticket):
                return True  # idempotent retry of a lost response
            if not fence_matches(d, ticket):
                return False  # zombie: reclaimed/revoked since
            mutate(d)
            try:
                self._put_json(key, d, if_match=etag)
                return True
            except PreconditionFailed:
                time.sleep(0.05)
                got = self.client.get(key)
                if got is None:
                    return False
                body, etag = got
                try:
                    d = json.loads(body)
                except json.JSONDecodeError:
                    return False
        raise TimeoutError(
            f"ticket CAS on {key} did not converge")

    def complete_ticket(self, queue: str, ticket: FleetTicket,
                        error: str = "") -> bool:
        return self._fenced_ticket_write(
            queue, ticket, lambda d: complete_in_place(d, error),
            accept_terminal_retry=True)

    def release_ticket(self, queue: str, ticket: FleetTicket,
                       failed: bool = False) -> bool:
        return self._fenced_ticket_write(
            queue, ticket,
            lambda d: release_in_place(d, failed=failed))

    def revoke_ticket(self, queue: str,
                      ticket_id: str) -> Optional[FleetTicket]:
        for _ in range(16):
            found = self._find_ticket(queue, ticket_id)
            if found is None:
                return None
            key, d, etag = found
            if d.get("state") != "claimed":
                return None  # nothing to preempt
            revoke_in_place(d)
            try:
                self._put_json(key, d, if_match=etag)
                return FleetTicket.from_json(d)
            except PreconditionFailed:
                time.sleep(0.05)  # claim/renew raced: re-read and retry
        raise TimeoutError(
            f"revoke_ticket CAS for {ticket_id!r} did not converge")

    def gc_tickets(self, queue: str,
                   retention_seconds: Optional[float] = None) -> int:
        retention = ticket_retention_seconds() \
            if retention_seconds is None else retention_seconds
        now = time.time()
        pruned = 0
        # terminal bodies come from the cache (no GETs); deleting both
        # the seq object and the id guard keeps enqueue idempotency
        # honest for the retained window only — a pruned id could in
        # principle re-enqueue, which is why retention defaults to a
        # day, far past any admission retry
        for key, d, _etag in self._list_ticket_objs(queue):
            if not ticket_expired(d, retention, now):
                continue
            self.client.delete(key)
            tid = d.get("ticket_id", "")
            if tid:
                self.client.delete(self._ticket_id_guard(queue, tid))
                self._ticket_keys.pop((queue, tid), None)
            self._terminal_tickets.pop(key, None)
            pruned += 1
        return pruned

    # -- durable observability segments --------------------------------------
    # Per-segment objects (`<prefix>obs/<scope>/<worker>-<seq>.json`):
    # the (worker, seq) key is unique per export, so the put needs no
    # conditional write — a RE-put of the same seq (export retry after
    # a lost response) replaces its own object, which is the idempotent
    # contract.  Torn bodies (a writer that died mid-PUT never makes
    # the object visible on real S3; fakes/filesystems may) are skipped
    # at read time.

    def _obs_prefix(self, scope: str) -> str:
        return self._key("obs", urllib.parse.quote(scope, safe=""), "")

    def _obs_key(self, scope: str, worker: str, seq: int) -> str:
        return self._obs_prefix(scope) + \
            f"{urllib.parse.quote(worker, safe='')}-{seq:08d}.json"

    def put_obs_segment(self, scope: str, segment: dict) -> None:
        worker = str(segment.get("worker", ""))
        seq = int(segment.get("seq", 0))
        self._put_json(self._obs_key(scope, worker, seq), segment)

    def list_obs_segments(self, scope: str) -> list[dict]:
        out = []
        for obj in self.client.list(self._obs_prefix(scope)):
            d, _ = self._get_json(obj.key, None)
            if isinstance(d, dict):
                out.append(d)
        return out

    def gc_obs_segments(self, scope: str,
                        retention_seconds: Optional[float] = None
                        ) -> int:
        retention = obs_retention_seconds() \
            if retention_seconds is None else retention_seconds
        bound = obs_segments_per_worker()
        now = time.time()
        pruned = 0
        per_worker: dict[str, list[str]] = {}
        for obj in self.client.list(self._obs_prefix(scope)):
            base = obj.key.rsplit("/", 1)[-1]
            if not base.endswith(".json"):
                continue
            worker = base[:-5].rsplit("-", 1)[0]
            d, _ = self._get_json(obj.key, None)
            ts = d.get("ts") if isinstance(d, dict) else None
            if not isinstance(ts, (int, float)):
                # torn/unparsable body (crashed writer on a fake or
                # filesystem backend — real S3 never surfaces partial
                # PUTs): it will never parse, the merge only ever
                # skips it, and its writer is gone, so no per-worker
                # trim can reach it — delete instead of re-GETting it
                # on every pass forever
                self.client.delete(obj.key)
                pruned += 1
                continue
            if now - ts > retention:
                self.client.delete(obj.key)
                pruned += 1
                continue
            per_worker.setdefault(worker, []).append(obj.key)
        for keys in per_worker.values():
            for key in sorted(keys)[:-bound]:
                self.client.delete(key)
                pruned += 1
        return pruned

    # -- MVCC staging-store control plane -------------------------------------
    # One control doc per scope (`<prefix>mvcc/<scope>.json`), mutated
    # through the same If-Match CAS loop as every other shared doc: the
    # abstract/mvccfence helpers run inside the update closure, so the
    # decision returned is the one that actually LANDED.  Under LWW
    # degrade the fence weakens to reference semantics exactly like
    # staged commits — race-sensitive conformance tests skip s3-lww.

    def _mvcc_key(self, scope: str) -> str:
        return self._key("mvcc", f"{urllib.parse.quote(scope, safe='')}.json")

    @staticmethod
    def _mvcc_doc(cur: dict) -> dict:
        if not isinstance(cur, dict) or "layers" not in cur:
            return mvccfence.new_mvcc_doc()
        return cur

    def mvcc_admit_layer(self, scope: str, layer: dict) -> dict:
        res: dict = {}

        def upd(cur: dict) -> dict:
            nonlocal res
            doc = self._mvcc_doc(cur)
            res = mvccfence.admit_layer_in_place(doc, layer)
            return doc

        self._merge_json(self._mvcc_key(scope), upd)
        return res

    def mvcc_cutover(self, scope: str, watermark: int,
                     epoch: int, offsets=None) -> dict:
        res: dict = {}

        def upd(cur: dict) -> dict:
            nonlocal res
            doc = self._mvcc_doc(cur)
            res = mvccfence.cutover_in_place(doc, watermark, epoch,
                                             offsets=offsets)
            return doc

        self._merge_json(self._mvcc_key(scope), upd)
        return res

    def mvcc_record_base(self, scope: str, base: dict) -> dict:
        res: dict = {}

        def upd(cur: dict) -> dict:
            nonlocal res
            doc = self._mvcc_doc(cur)
            res = mvccfence.record_base_in_place(doc, base)
            return doc

        self._merge_json(self._mvcc_key(scope), upd)
        return res

    def mvcc_state(self, scope: str) -> dict:
        cur, _ = self._get_json(self._mvcc_key(scope), {})
        return mvccfence.state_view(self._mvcc_doc(cur))

    def mvcc_prune_layers(self, scope: str, keys: list) -> int:
        pruned = 0

        def upd(cur: dict) -> dict:
            nonlocal pruned
            doc = self._mvcc_doc(cur)
            pruned = mvccfence.prune_layers_in_place(doc, keys)
            return doc

        self._merge_json(self._mvcc_key(scope), upd)
        return pruned

    # -- MVCC spill blobs ----------------------------------------------------
    # Plain objects under <prefix>mvccblob/<scope>/<name> — no CAS:
    # each (scope, name) has exactly one writer and a retried put is
    # a byte-identical replace (S3 PUT is atomic per object).
    def _mvcc_blob_key(self, scope: str, name: str) -> str:
        return self._key("mvccblob", urllib.parse.quote(scope, safe=""),
                         urllib.parse.quote(name, safe=""))

    def put_mvcc_blob(self, scope: str, name: str,
                      data: bytes) -> str:
        key = self._mvcc_blob_key(scope, name)
        self.client.put(key, bytes(data))
        return f"s3://{key}"

    def get_mvcc_blob(self, scope: str, locator: str):
        if not locator.startswith("s3://"):
            return None
        got = self.client.get(locator[len("s3://"):])
        return got[0] if got is not None else None

    def delete_mvcc_blobs(self, scope: str, locators: list) -> int:
        deleted = 0
        for loc in locators:
            if not str(loc).startswith("s3://"):
                continue
            key = str(loc)[len("s3://"):]
            if self.client.get(key) is not None:
                self.client.delete(key)
                deleted += 1
        return deleted

    # -- health -------------------------------------------------------------
    def operation_health(self, operation_id: str, worker_index: int,
                         payload: Optional[dict] = None) -> None:
        self._put_json(
            self._key("health", f"op_{operation_id}",
                      f"{worker_index}.json"),
            {"worker": worker_index, "ts": time.time(),
             "payload": payload})

    def get_operation_health(self, operation_id: str) -> dict[int, dict]:
        # already latest-per-worker: one object per worker index
        prefix = self._key("health", f"op_{operation_id}", "")
        out: dict[int, dict] = {}
        for obj in self.client.list(prefix):
            d, _ = self._get_json(obj.key, None)
            if d is None:
                continue
            try:
                widx = int(d.get("worker", obj.key.rsplit("/", 1)[-1]
                           .removesuffix(".json")))
            except (TypeError, ValueError):
                continue
            out[widx] = {"ts": d.get("ts"), "payload": d.get("payload")}
        return out

    def transfer_health(self, transfer_id: str, worker_index: int = 0,
                        healthy: bool = True) -> None:
        self._put_json(
            self._key("health", f"tr_{transfer_id}",
                      f"{worker_index}.json"),
            {"worker": worker_index, "ts": time.time(),
             "healthy": healthy})
