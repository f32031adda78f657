"""In-process fake Kafka broker (wire-protocol subset): the port's copy of
``tests/recipes/fake_kafka.py`` on the port's ``protocol.py``.

Server side of what the port's client speaks: Metadata v1, Produce v3
(stores the raw record batch and serves it again on fetch, as a real
broker does), Fetch v4, ListOffsets v1, and the KIP-98 subset of the
staged-commit Kafka sink: InitProducerId (fences an older proposed
epoch, error 90, disclosing the id's current one) and the transactional
Produce (error 47 for an unknown producer or a stale epoch read from the
frame; a republish under the same transactional id supersedes the id's
earlier publish in place).  The JAX fake's SASL and TLS serve clients
the port does not have yet (its client refuses both) and are left out.
"""

from __future__ import annotations

import socketserver
import struct
import threading
from typing import Optional

from transferia_tpu_torch.providers.kafka.protocol import (
    Reader,
    crc32c,
    decode_record_batches,
    enc_str,
    encode_record_batch,
)


def _index_frames(blob: bytes) -> Optional[list]:
    """[(frame_pos, record_count)] straight from the batch header(s),
    no decode: recordCount sits at fixed offset 57 of each v2 frame."""
    frames = []
    pos = 0
    n = len(blob)
    while pos + 61 <= n:
        batch_len = struct.unpack_from("!i", blob, pos + 8)[0]
        magic = blob[pos + 16]
        # a non-positive length would loop forever; corrupt frames must
        # land on the eager-decode path, which raises on produce
        if magic != 2 or batch_len <= 0 or pos + 12 + batch_len > n:
            return None
        # brokers validate the CRC at append time, so does this fake: a
        # corrupt batch errors the producer, not a later consumer
        expect = struct.unpack_from("!I", blob, pos + 17)[0]
        if crc32c(blob[pos + 21:pos + 12 + batch_len]) != expect:
            return None
        frames.append((pos, struct.unpack_from("!i", blob, pos + 57)[0]))
        pos += 12 + batch_len
    if pos != n:
        return None
    return frames


class _PartitionLog:
    """Partition storage as a real broker keeps it: raw produced batch
    blobs, served verbatim, and records appended one by one when a blob
    does not index (they re-encode on fetch)."""

    def __init__(self):
        # [base, count, blob|None, records|None]
        self._segments: list[list] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append_blob(self, blob: bytes) -> bool:
        frames = _index_frames(blob)
        if frames is None:
            return False
        total = sum(c for _, c in frames)
        if not total:
            return True
        # assign offsets the broker way: rewrite each frame's baseOffset
        # in place, so the stored bytes serve verbatim on fetch
        ba = bytearray(blob)
        base = self._n
        for pos, count in frames:
            struct.pack_into("!q", ba, pos, base)
            base += count
        self._segments.append([self._n, total, bytes(ba), None])
        self._n += total
        return True

    def raw_from(self, offset: int, max_records: int = 1000) -> bytes:
        """Stored frames covering [offset, ...), served verbatim (the
        client trims records below the requested offset, as with a real
        broker's batch-aligned responses)."""
        out = []
        taken = 0
        for seg in self._segments:
            if seg[0] + seg[1] <= offset:
                continue
            if taken >= max_records:
                break
            if seg[2] is not None:
                out.append(seg[2])
            else:
                out.append(encode_record_batch(seg[3],
                                               base_offset=seg[0]))
            taken += seg[1]
        return b"".join(out)

    def append(self, rec) -> None:
        rec.offset = self._n
        if self._segments and self._segments[-1][2] is None:
            seg = self._segments[-1]
            seg[3].append(rec)
            seg[1] += 1
        else:
            self._segments.append([self._n, 1, None, [rec]])
        self._n += 1

    def _records_of(self, seg: list) -> list:
        if seg[3] is None:
            recs = decode_record_batches(seg[2])
            for i, r in enumerate(recs):
                r.offset = seg[0] + i
            seg[3] = recs
        return seg[3]

    def __iter__(self):
        for seg in self._segments:
            yield from self._records_of(seg)


class FakeKafka:
    def __init__(self, n_partitions: int = 2):
        self.n_partitions = n_partitions
        # topic -> partition -> _PartitionLog (absolute offsets = index)
        self.topics: dict[str, list[_PartitionLog]] = {}
        self.lock = threading.RLock()
        self.port = 0
        self._srv = None
        # transactional state (the KIP-98 subset of the staged-commit
        # sink): transactional id -> {"pid", "epoch", "published":
        # [(topic, partition, segment)] of the last committed
        # transaction}, so a republish supersedes instead of appending
        # and a stale producer epoch is fenced
        self.txns: dict[str, dict] = {}
        self._next_pid = 1000

    def create_topic(self, name: str,
                     n_partitions: Optional[int] = None) -> None:
        with self.lock:
            if name not in self.topics:
                self.topics[name] = [
                    _PartitionLog()
                    for _ in range(n_partitions or self.n_partitions)
                ]

    def records(self, topic: str, partition: int = 0) -> list:
        with self.lock:
            return list(self.topics.get(topic, [[]])[partition])

    def live_size(self, topic: str) -> int:
        """Record count excluding superseded transactional segments
        (offsets still cover them, like aborted-transaction gaps on a
        real broker)."""
        with self.lock:
            n = 0
            for p in self.topics.get(topic, []):
                for seg in p._segments:
                    if seg[2] is None and seg[3] == []:
                        continue
                    n += seg[1]
            return n

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FakeKafka":
        fake = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        raw = self._recv_exact(4)
                        size = struct.unpack("!i", raw)[0]
                        payload = self._recv_exact(size)
                        resp = fake.handle_request(payload)
                        self.request.sendall(
                            struct.pack("!i", len(resp)) + resp
                        )
                except (ConnectionError, OSError):
                    return

            def _recv_exact(self, n):
                parts = []
                got = 0
                while got < n:
                    chunk = self.request.recv(n - got)
                    if not chunk:
                        raise ConnectionError()
                    parts.append(chunk)
                    got += len(chunk)
                return b"".join(parts)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()

    # -- dispatch -----------------------------------------------------------
    def handle_request(self, payload: bytes) -> bytes:
        r = Reader(payload)
        api_key = r.i16()
        r.i16()  # api version
        corr = r.i32()
        r.string()  # client id
        body = {
            3: self._metadata,
            0: self._produce,
            1: self._fetch,
            2: self._list_offsets,
            22: self._init_producer_id,
        }.get(api_key, lambda _r: b"")(r)
        return struct.pack("!i", corr) + body

    def _metadata(self, r: Reader) -> bytes:
        n = r.i32()
        wanted = None
        if n >= 0:
            wanted = [r.string() for _ in range(n)]
        with self.lock:
            for t in wanted or ():
                self.create_topic(t)
            names = wanted if wanted is not None else list(self.topics)
            out = struct.pack("!i", 1)  # one broker
            out += struct.pack("!i", 0) + enc_str("127.0.0.1") \
                + struct.pack("!i", self.port) + enc_str(None)
            out += struct.pack("!i", 0)  # controller
            out += struct.pack("!i", len(names))
            for name in names:
                parts = self.topics.get(name)
                err = 0 if parts is not None else 3
                out += struct.pack("!h", err) + enc_str(name) + b"\x00"
                out += struct.pack("!i", len(parts or []))
                for pid in range(len(parts or [])):
                    out += struct.pack("!hiii", 0, pid, 0, 1)
                    out += struct.pack("!i", 0)       # replicas
                    out += struct.pack("!i", 0)       # isr
        return out

    @staticmethod
    def _frame_producer_epoch(blob: bytes) -> int:
        """producerEpoch of the first v2 frame (offset 51 of the frame:
        the 12-byte outer header and 39 bytes to the epoch field)."""
        if len(blob) < 61:
            return -1
        return struct.unpack_from("!h", blob, 51)[0]

    def _init_producer_id(self, r: Reader) -> bytes:
        """InitProducerId (KIP-360 shape): the client proposes its epoch;
        a proposal older than the id's current epoch is fenced (error
        90), else the id adopts it."""
        txn_id = r.string()
        r.i32()              # transaction timeout
        r.i64()              # producer id proposal (-1)
        epoch = r.i16()
        with self.lock:
            state = self.txns.get(txn_id)
            if state is None:
                state = {"pid": self._next_pid, "epoch": epoch,
                         "published": []}
                self._next_pid += 1
                self.txns[txn_id] = state
            elif epoch < state["epoch"]:
                # fenced: disclose the id's current epoch so the client's
                # StaleEpochPublishError names the real winner
                return struct.pack("!ihqh", 0, 90, -1, state["epoch"])
            else:
                state["epoch"] = epoch
            return struct.pack("!ihqh", 0, 0, state["pid"],
                               state["epoch"])

    def _produce(self, r: Reader) -> bytes:
        txn_id = r.string()  # transactional id (None = plain produce)
        r.i16()              # acks
        r.i32()              # timeout
        incoming = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                partition = r.i32()
                blob = r.bytes_() or b""
                incoming.append((topic, partition, blob))
        err = 0
        bases = {}
        with self.lock:
            state = self.txns.get(txn_id) if txn_id else None
            if txn_id is not None:
                if state is None:
                    err = 47  # unknown producer for the txn id
                else:
                    for _t, _p, blob in incoming:
                        if self._frame_producer_epoch(blob) \
                                < state["epoch"]:
                            err = 47  # stale producer epoch: fenced
                            break
            if not err:
                if state is not None:
                    # one transactional produce = one committed
                    # transaction: supersede the id's previous publish in
                    # place (offsets keep their slots, like aborted-txn
                    # gaps)
                    for _t, _p, seg in state["published"]:
                        seg[2] = None
                        seg[3] = []
                    state["published"] = []
                for topic, partition, blob in incoming:
                    self.create_topic(topic)
                    plist = self.topics[topic][partition]
                    bases[(topic, partition)] = len(plist)
                    segs_before = len(plist._segments)
                    # store the raw blob (a real broker never decodes);
                    # unparseable frames fall back to eager decode so
                    # protocol errors still surface on produce
                    if not plist.append_blob(blob):
                        for rec in decode_record_batches(blob):
                            plist.append(rec)
                    if state is not None:
                        for seg in plist._segments[segs_before:]:
                            state["published"].append(
                                (topic, partition, seg))
        out = struct.pack("!i", len(incoming))
        for topic, partition, _blob in incoming:
            base = bases.get((topic, partition), -1)
            out += enc_str(topic) + struct.pack("!i", 1)
            out += struct.pack("!ihqq", partition, err, base, -1)
        out += struct.pack("!i", 0)  # throttle
        return out

    def _list_offsets(self, r: Reader) -> bytes:
        r.i32()  # replica id
        out = b""
        n_topics = r.i32()
        out += struct.pack("!i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            out += enc_str(topic) + struct.pack("!i", n_parts)
            for _ in range(n_parts):
                partition = r.i32()
                ts = r.i64()
                with self.lock:
                    plist = self.topics.get(topic, [[]] * (partition + 1))
                    n = len(plist[partition]) if partition < len(plist) \
                        else 0
                offset = 0 if ts == -2 else n
                out += struct.pack("!ihqq", partition, 0, -1, offset)
        return out

    def _fetch(self, r: Reader) -> bytes:
        r.i32()  # replica
        r.i32()  # max wait
        r.i32()  # min bytes
        r.i32()  # max bytes
        r.i8()   # isolation
        n_topics = r.i32()
        out = struct.pack("!i", 0)  # throttle
        out += struct.pack("!i", n_topics)
        for _ in range(n_topics):
            topic = r.string()
            n_parts = r.i32()
            out += enc_str(topic) + struct.pack("!i", n_parts)
            for _ in range(n_parts):
                partition = r.i32()
                offset = r.i64()
                r.i32()  # partition max bytes
                with self.lock:
                    plist = self.topics.get(topic)
                    if plist is not None:
                        log = plist[partition]
                        high = len(log)
                        # stored frames serve verbatim (batch-aligned,
                        # like a real broker; clients trim the head)
                        blob = log.raw_from(offset)
                    else:
                        blob = b""
                        high = 0
                out += struct.pack("!ihqq", partition, 0, high, high)
                out += struct.pack("!i", 0)   # aborted txns
                out += struct.pack("!i", len(blob)) + blob
        return out
