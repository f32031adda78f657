"""Minimal Kafka broker client: Metadata, Produce, Fetch, ListOffsets
(the port's copy of the plaintext half of
``transferia_tpu/providers/kafka/client.py``).

Request framing: int32 size + apiKey(2) apiVersion(2) correlationId(4)
clientId(STRING) + body.  API versions are old-but-universally-supported
non-flexible ones (Metadata v1, Produce v3, Fetch v4, ListOffsets v1).

Partition leadership: Metadata responses populate a node table and a
(topic, partition) -> leader map; produce/fetch/list_offsets route to the
partition leader and refresh metadata and retry once on NOT_LEADER or
connection failures.

Transactions: the KIP-98 subset the staged-commit Kafka sink speaks
(`init_producer`, InitProducerId v3 proposing the part's epoch, and
`txn_produce`, one Produce v3 carrying the transactional id); a fenced
producer surfaces as a KafkaError that `is_producer_fenced` names.  TLS
and SASL wait (ROADMAP.md A7) and raise NotImplementedError.  Every
request is one `kafka_roundtrip` span behind the
`client.kafka.roundtrip` failpoint, as in the reference.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.providers.kafka.protocol import (
    Reader,
    Record,
    decode_record_batches,
    enc_bytes,
    enc_str,
    encode_record_batch,
)
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.utils.net import recv_exact

logger = logging.getLogger(__name__)

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_INIT_PRODUCER_ID = 22

ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC = 3
ERR_LEADER_NOT_AVAILABLE = 5
ERR_NOT_LEADER = 6
ERR_INVALID_PRODUCER_EPOCH = 47
ERR_PRODUCER_FENCED = 90

_RETRIABLE = {ERR_LEADER_NOT_AVAILABLE, ERR_NOT_LEADER}
_FENCED = {ERR_INVALID_PRODUCER_EPOCH, ERR_PRODUCER_FENCED}

NOT_PORTED = "not ported yet (ROADMAP.md A7: TLS and SASL for Kafka)"


class KafkaError(CategorizedError):
    def __init__(self, message: str, code: int = -1):
        super().__init__(CategorizedError.SOURCE, message)
        self.code = code


def is_producer_fenced(err: KafkaError) -> bool:
    """True when the broker rejected a transactional operation because
    a newer producer epoch owns the transactional id (KIP-98 zombie
    fencing): the staged-commit publish maps this onto
    StaleEpochPublishError."""
    return err.code in _FENCED


CLIENT_ID = "transferia-tpu"
TIMEOUT_SECONDS = 30.0


class KafkaClient:
    def __init__(self, brokers: list[str], tls: bool = False,
                 sasl_mechanism: str = ""):
        if tls:
            raise NotImplementedError(f"kafka tls: {NOT_PORTED}")
        if sasl_mechanism:
            raise NotImplementedError(f"kafka sasl: {NOT_PORTED}")
        self.bootstrap = brokers
        self._conns: dict[object, socket.socket] = {}  # node_id | "boot"
        self._nodes: dict[int, tuple[str, int]] = {}
        self._leaders: dict[tuple[str, int], int] = {}
        self._corr = 0
        self._fetch_rotation = 0
        self._lock = threading.Lock()

    # -- connections --------------------------------------------------------
    def _dial(self, host: str, port: int) -> socket.socket:
        s = socket.create_connection((host, port), timeout=TIMEOUT_SECONDS)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _conn_for(self, node) -> socket.socket:
        sock = self._conns.get(node)
        if sock is not None:
            return sock
        if node == "boot":
            last: Optional[Exception] = None
            for b in self.bootstrap:
                host, _, port = b.partition(":")
                try:
                    sock = self._dial(host, int(port or 9092))
                    break
                except OSError as e:
                    last = e
                    sock = None
            if sock is None:
                raise KafkaError(f"no kafka broker reachable: {last}")
        else:
            addr = self._nodes.get(node)
            if addr is None:
                raise KafkaError(f"unknown broker node {node}")
            try:
                sock = self._dial(*addr)
            except OSError as e:
                raise KafkaError(
                    f"broker node {node} {addr} unreachable: {e}"
                ) from e
        self._conns[node] = sock
        return sock

    def _drop_conn(self, node) -> None:
        sock = self._conns.pop(node, None)
        if sock is not None:
            sock.close()

    def close(self) -> None:
        with self._lock:
            for node in list(self._conns):
                self._drop_conn(node)

    def _roundtrip(self, api_key: int, api_version: int, body: bytes,
                   node="boot") -> Reader:
        failpoint("client.kafka.roundtrip")  # before the lock: may sleep
        with trace.span("kafka_roundtrip", api=api_key), self._lock:
            sock = self._conn_for(node)
            self._corr += 1
            corr = self._corr
            header = struct.pack("!hhi", api_key, api_version, corr) \
                + enc_str(CLIENT_ID)
            msg = header + body
            # I/O under the lock is the design: the lock serializes
            # request/response framing on the one socket of a node
            try:
                sock.sendall(  # trtpu: ignore[LCK001]
                    struct.pack("!i", len(msg)) + msg)
                size = struct.unpack(
                    "!i", recv_exact(sock, 4))[0]  # trtpu: ignore[LCK001]
                payload = recv_exact(sock, size)  # trtpu: ignore[LCK001]
            except (OSError, ConnectionError) as e:
                self._drop_conn(node)
                raise KafkaError(f"kafka io error (node {node}): {e}") from e
        r = Reader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            with self._lock:
                self._drop_conn(node)
            raise KafkaError(
                f"correlation mismatch: {got_corr} != {corr}"
            )
        return r

    # -- metadata -----------------------------------------------------------
    def metadata(self, topics: Optional[list[str]] = None) -> dict:
        """topic -> [partition ids]; refreshes the node and leader maps."""
        if topics is None:
            body = struct.pack("!i", -1)
        else:
            body = struct.pack("!i", len(topics))
            for t in topics:
                body += enc_str(t)
        r = self._roundtrip(API_METADATA, 1, body)
        with self._lock:
            for _ in range(r.i32()):
                node_id = r.i32()
                host = r.string()
                port = r.i32()
                r.string()       # rack
                self._nodes[node_id] = (host or "", port)
            r.i32()              # controller id
            n_topics = r.i32()
            out: dict[str, list[int]] = {}
            for _ in range(n_topics):
                err = r.i16()
                name = r.string()
                r.i8()           # is_internal
                parts = []
                for _ in range(r.i32()):
                    r.i16()      # partition error
                    pid = r.i32()
                    leader = r.i32()
                    for _ in range(r.i32()):
                        r.i32()  # replicas
                    for _ in range(r.i32()):
                        r.i32()  # isr
                    parts.append(pid)
                    if name is not None:
                        self._leaders[(name, pid)] = leader
                if err == ERR_NONE and name is not None:
                    out[name] = sorted(parts)
        return out

    def _leader_node(self, topic: str, partition: int):
        leader = self._leaders.get((topic, partition))
        if leader is None or leader not in self._nodes:
            self.metadata([topic])
            leader = self._leaders.get((topic, partition))
        # fall back to bootstrap when metadata gave nothing
        return leader if leader is not None and leader in self._nodes \
            else "boot"

    def _routed(self, topic: str, partition: int, api: int, version: int,
                body: bytes) -> Reader:
        """Round-trip to the partition leader; one metadata-refresh retry
        on routing errors."""
        node = self._leader_node(topic, partition)
        try:
            return self._roundtrip(api, version, body, node)
        except KafkaError:
            self.metadata([topic])
            node = self._leader_node(topic, partition)
            return self._roundtrip(api, version, body, node)

    # -- produce ------------------------------------------------------------
    def produce(self, topic: str, partition: int,
                records: list[Record], acks: int = -1,
                timeout_ms: int = 30_000, compression: str = "") -> int:
        """Append records; returns the base offset assigned (Produce v3)."""
        batch = encode_record_batch(records, compression=compression)
        body = enc_str(None)                      # transactional id
        body += struct.pack("!hi", acks, timeout_ms)
        body += struct.pack("!i", 1) + enc_str(topic)
        body += struct.pack("!i", 1) + struct.pack("!i", partition)
        body += enc_bytes(batch)

        def attempt() -> int:
            r = self._routed(topic, partition, API_PRODUCE, 3, body)
            base_offset = -1
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()              # partition
                    err = r.i16()
                    base_offset = r.i64()
                    r.i64()              # log append time
                    if err != ERR_NONE:
                        raise KafkaError(f"produce failed: error {err}",
                                         code=err)
            r.i32()  # throttle
            return base_offset

        try:
            return attempt()
        except KafkaError as e:
            if e.code not in _RETRIABLE:
                raise
            self.metadata([topic])
            return attempt()

    # -- transactions (KIP-98 subset) ----------------------------------------
    def init_producer(self, transactional_id: str,
                      producer_epoch: int) -> tuple[int, int]:
        """InitProducerId for an epoch-keyed transactional id.

        KIP-360 shape: the client proposes its producer epoch (the part's
        assignment epoch, monotone per part key) and the broker fences a
        proposal older than the id's current epoch with PRODUCER_FENCED,
        the zombie-publish fence.  Returns (producer_id,
        accepted_epoch)."""
        body = enc_str(transactional_id)
        body += struct.pack("!i", 60_000)           # txn timeout
        body += struct.pack("!qh", -1, producer_epoch)
        r = self._roundtrip(API_INIT_PRODUCER_ID, 3, body)
        r.i32()  # throttle
        err = r.i16()
        pid = r.i64()
        epoch = r.i16()
        if err != ERR_NONE:
            e = KafkaError(
                f"init_producer({transactional_id!r}) failed: "
                f"error {err}", code=err)
            # a fencing response carries the id's current epoch when the
            # broker discloses it (the in-repo fake does; real brokers
            # return -1): the staged-commit publish maps it onto
            # StaleEpochPublishError's published_epoch
            e.fence_epoch = int(epoch) if epoch >= 0 else None
            raise e
        return pid, epoch

    def txn_produce(self, transactional_id: str, producer_id: int,
                    producer_epoch: int,
                    messages: dict[tuple[str, int], list[Record]],
                    acks: int = -1, timeout_ms: int = 30_000) -> int:
        """One transactional produce: every (topic, partition) record
        list lands in a single Produce request carrying the transactional
        id and batches stamped with the producer's id and epoch; the
        broker applies it atomically and fences a stale epoch.  Returns
        the records produced."""
        by_topic: dict[str, list[tuple[int, list[Record]]]] = {}
        for (topic, partition), records in sorted(messages.items()):
            by_topic.setdefault(topic, []).append((partition, records))
        body = enc_str(transactional_id)
        body += struct.pack("!hi", acks, timeout_ms)
        body += struct.pack("!i", len(by_topic))
        total = 0
        for topic, parts in sorted(by_topic.items()):
            body += enc_str(topic)
            body += struct.pack("!i", len(parts))
            for partition, records in parts:
                batch = encode_record_batch(
                    records, producer_id=producer_id,
                    producer_epoch=producer_epoch)
                body += struct.pack("!i", partition)
                body += enc_bytes(batch)
                total += len(records)
        r = self._roundtrip(API_PRODUCE, 3, body)
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()              # partition
                err = r.i16()
                r.i64()              # base offset
                r.i64()              # log append time
                if err != ERR_NONE:
                    raise KafkaError(
                        f"transactional produce failed: error {err}",
                        code=err)
        r.i32()  # throttle
        return total

    # -- offsets ------------------------------------------------------------
    def list_offsets(self, topic: str, partition: int,
                     timestamp: int = -2) -> int:
        """-2 = earliest, -1 = latest (ListOffsets v1)."""
        body = struct.pack("!i", -1)              # replica id
        body += struct.pack("!i", 1) + enc_str(topic)
        body += struct.pack("!i", 1)
        body += struct.pack("!iq", partition, timestamp)
        r = self._routed(topic, partition, API_LIST_OFFSETS, 1, body)
        offset = 0
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                r.i64()              # timestamp
                offset = r.i64()
                if err != ERR_NONE:
                    raise KafkaError(f"list_offsets failed: {err}",
                                     code=err)
        return offset

    # -- fetch --------------------------------------------------------------
    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 8 << 20,
              max_wait_ms: int = 250) -> tuple[list[Record], int]:
        """(records, high_watermark) from the given offset (Fetch v4)."""
        body = struct.pack("!iiii", -1, max_wait_ms, 1, max_bytes)
        body += b"\x00"                           # isolation level
        body += struct.pack("!i", 1) + enc_str(topic)
        body += struct.pack("!i", 1)
        body += struct.pack("!iqi", partition, offset, max_bytes)

        def attempt():
            r = self._routed(topic, partition, API_FETCH, 4, body)
            r.i32()  # throttle
            records: list[Record] = []
            high = 0
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()              # partition
                    err = r.i16()
                    high = r.i64()
                    r.i64()              # last stable offset
                    for _ in range(r.i32()):
                        r.i64()          # aborted txn producer id
                        r.i64()          # first offset
                    blob = r.bytes_() or b""
                    if err == ERR_OFFSET_OUT_OF_RANGE:
                        raise KafkaError("offset out of range", code=err)
                    if err != ERR_NONE:
                        raise KafkaError(f"fetch failed: error {err}",
                                         code=err)
                    records.extend(decode_record_batches(blob))
            return records, high

        try:
            records, high = attempt()
        except KafkaError as e:
            if e.code not in _RETRIABLE:
                raise
            self.metadata([topic])
            records, high = attempt()
        # the broker may return records below the requested offset (batch
        # alignment); trim client-side
        return [rec for rec in records if rec.offset >= offset], high

    def fetch_multi(self, topic: str, offsets: dict[int, int],
                    max_bytes: int = 8 << 20, max_wait_ms: int = 250,
                    ) -> dict[int, tuple[list[Record], int]]:
        """Fetch many partitions in few round trips: partitions group by
        leader and each leader gets one Fetch request carrying all of its
        partitions.  Returns {partition: (records, high_watermark)};
        per-partition retriable errors retry once through `fetch`."""
        by_node: dict[object, list[int]] = {}
        for p in offsets:
            by_node.setdefault(self._leader_node(topic, p), []).append(p)
        out: dict[int, tuple[list[Record], int]] = {}
        retry: list[int] = []
        self._fetch_rotation += 1
        for node, parts in by_node.items():
            # rotate the partition order per request: brokers fill
            # partitions in request order until max_bytes runs out, so a
            # fixed order lets one backlogged partition starve the rest
            parts = sorted(parts)
            rot = self._fetch_rotation % len(parts)
            parts = parts[rot:] + parts[:rot]
            body = struct.pack("!iiii", -1, max_wait_ms, 1, max_bytes)
            body += b"\x00"                       # isolation level
            body += struct.pack("!i", 1) + enc_str(topic)
            body += struct.pack("!i", len(parts))
            for p in parts:
                body += struct.pack("!iqi", p, offsets[p], max_bytes)
            try:
                r = self._roundtrip(API_FETCH, 4, body, node)
            except KafkaError:
                retry.extend(parts)
                continue
            r.i32()  # throttle
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    p = r.i32()
                    err = r.i16()
                    high = r.i64()
                    r.i64()              # last stable offset
                    for _ in range(r.i32()):
                        r.i64()          # aborted txn producer id
                        r.i64()          # first offset
                    blob = r.bytes_() or b""
                    if err == ERR_OFFSET_OUT_OF_RANGE:
                        raise KafkaError("offset out of range", code=err)
                    if err != ERR_NONE:
                        retry.append(p)
                        continue
                    off = offsets.get(p, 0)
                    recs = [rec for rec in decode_record_batches(blob)
                            if rec.offset >= off]
                    out[p] = (recs, high)
        for p in retry:
            if p in offsets:
                out[p] = self.fetch(topic, p, offsets[p],
                                    max_bytes=max_bytes,
                                    max_wait_ms=max_wait_ms)
        return out
