"""Kafka wire protocol primitives: framing and record batches v2 (the
port's copy of ``transferia_tpu/providers/kafka/protocol.py``).

Binary conventions: big-endian fixed ints; STRING = int16 len + utf8
(-1 = null); BYTES = int32 len + data (-1 = null); record-batch internals
use zigzag varints.  CRC32C (Castagnoli) covers the batch from the
attributes field onward.  As in the JAX package, the CRC and the
record-section encode and scan run in the host library
(`transferia_tpu_torch.native`: `crc32c_buf`, `kafka_encode_records`,
`kafka_scan_records`).  The pure-Python routes (`crc32c_py`,
`encode_records_py`, `decode_record_batches_py`) give the same bytes;
tests hold the native ones against them.  Records with headers and
gzip-compressed batches are outside the native encoder's and scanner's
envelope and take the Python walk, as in the JAX package.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from transferia_tpu_torch import native


def _make_table() -> list[int]:
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    """CRC32C of a buffer (the host library's SSE4.2 or table loop)."""
    return int(native.lib().crc32c_buf(np.frombuffer(data, np.uint8),
                                       len(data), 0))


def crc32c_batch(keys: list[bytes]) -> np.ndarray:
    """CRC32C of each buffer in one host-library call (uint32)."""
    offs = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offs[1:])
    data = np.frombuffer(b"".join(keys), dtype=np.uint8)
    out = np.empty(len(keys), dtype=np.uint32)
    native.lib().crc32c_batch(
        data if data.size else np.zeros(1, dtype=np.uint8), offs,
        len(keys), out)
    return out


def crc32c_py(data: bytes) -> int:
    """CRC32C in pure Python (the spec the host library is held to)."""
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- primitive codecs --------------------------------------------------------

def enc_str(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack("!h", -1)
    b = s.encode()
    return struct.pack("!h", len(b)) + b


def enc_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack("!i", -1)
    return struct.pack("!i", len(b)) + b


def enc_varint(n: int) -> bytes:
    """Zigzag varint."""
    z = (n << 1) ^ (n >> 63)
    out = b""
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def i8(self) -> int:
        v = struct.unpack_from("!b", self.buf, self.pos)[0]
        self.pos += 1
        return v

    def i16(self) -> int:
        v = struct.unpack_from("!h", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from("!i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from("!q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        s = self.buf[self.pos:self.pos + n].decode()
        self.pos += n
        return s

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return bytes(b)

    def varint(self) -> int:
        z = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (z >> 1) ^ -(z & 1)


# -- record batches v2 -------------------------------------------------------

@dataclass
class Record:
    key: Optional[bytes]
    value: Optional[bytes]
    offset: int = 0
    timestamp_ms: int = 0
    headers: list = field(default_factory=list)


_CODEC_GZIP = 1
# attributes bit 4: this batch is part of a transaction
_ATTR_TRANSACTIONAL = 0x10


def _encode_records_native(records: list[Record], now: int,
                           base_ts: int) -> bytes:
    """The record section through the host library's encoder (records
    without headers)."""
    n = len(records)
    key_parts = [r.key or b"" for r in records]
    val_parts = [r.value or b"" for r in records]
    key_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(k) for k in key_parts], out=key_off[1:])
    val_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(v) for v in val_parts], out=val_off[1:])
    key_null = np.fromiter((r.key is None for r in records),
                           dtype=np.uint8, count=n)
    val_null = np.fromiter((r.value is None for r in records),
                           dtype=np.uint8, count=n)
    ts = [(r.timestamp_ms or now) - base_ts for r in records]
    ts_arr = np.asarray(ts, dtype=np.int64) if any(ts) else None
    key_data = np.frombuffer(b"".join(key_parts), dtype=np.uint8) \
        if key_off[-1] else np.zeros(0, dtype=np.uint8)
    val_data = np.frombuffer(b"".join(val_parts), dtype=np.uint8) \
        if val_off[-1] else np.zeros(0, dtype=np.uint8)
    # a record takes at most 64 bytes besides its key and value
    cap = int(key_off[-1] + val_off[-1]) + 64 * n + 64
    out = np.empty(cap, dtype=np.uint8)
    rc = native.lib().kafka_encode_records(
        key_data, key_off, key_null.ctypes.data, val_data, val_off,
        val_null.ctypes.data,
        ts_arr.ctypes.data if ts_arr is not None else None,
        n, out, cap)
    if rc < 0:
        raise RuntimeError(f"kafka_encode_records: {rc} (output cap {cap})")
    return out[:rc].tobytes()


def encode_records_py(records: list[Record], now: int,
                      base_ts: int) -> bytes:
    """The record section in pure Python (headers included)."""
    # accumulate in a list: += on bytes is O(total^2)
    parts: list[bytes] = []
    for i, r in enumerate(records):
        body = [b"\x00"]  # attributes
        body.append(enc_varint((r.timestamp_ms or now) - base_ts))
        body.append(enc_varint(i))  # offset delta
        if r.key is None:
            body.append(enc_varint(-1))
        else:
            body.append(enc_varint(len(r.key)))
            body.append(r.key)
        if r.value is None:
            body.append(enc_varint(-1))
        else:
            body.append(enc_varint(len(r.value)))
            body.append(r.value)
        body.append(enc_varint(len(r.headers)))
        for hk, hv in r.headers:
            body.append(enc_varint(len(hk)))
            body.append(hk)
            body.append(enc_varint(len(hv)))
            body.append(hv)
        blob = b"".join(body)
        parts.append(enc_varint(len(blob)))
        parts.append(blob)
    return b"".join(parts)


def encode_record_batch(records: list[Record],
                        base_offset: int = 0,
                        compression: str = "",
                        producer_id: int = -1,
                        producer_epoch: int = -1) -> bytes:
    """Records -> one RecordBatch v2 blob (optionally gzip-compressed).
    `producer_id`/`producer_epoch` stamp the header for transactional
    produce."""
    now = int(time.time() * 1000)
    base_ts = records[0].timestamp_ms or now if records else now
    if records and not any(r.headers for r in records):
        recs = _encode_records_native(records, now, base_ts)
    else:
        recs = encode_records_py(records, now, base_ts)
    attrs = 0
    if compression == "gzip":
        import gzip as _gzip

        recs = _gzip.compress(recs)
        attrs = _CODEC_GZIP
    elif compression:
        raise ValueError(f"unsupported compression {compression!r} "
                         f"(only gzip ships dependency-free)")
    if producer_id >= 0:
        attrs |= _ATTR_TRANSACTIONAL
    # batch body after the crc field
    after_crc = (
        struct.pack("!h", attrs)                   # attributes
        + struct.pack("!i", max(0, len(records) - 1))  # lastOffsetDelta
        + struct.pack("!q", base_ts)
        + struct.pack("!q", (records[-1].timestamp_ms or now)
                      if records else now)
        + struct.pack("!q", producer_id)           # producerId
        + struct.pack("!h", producer_epoch)        # producerEpoch
        + struct.pack("!i", -1)                    # baseSequence
        + struct.pack("!i", len(records))
        + recs
    )
    header = (
        struct.pack("!i", 0)       # partitionLeaderEpoch
        + b"\x02"                  # magic
        + struct.pack("!I", crc32c(after_crc))
    )
    batch_len = len(header) + len(after_crc)
    return struct.pack("!q", base_offset) + struct.pack("!i", batch_len) \
        + header + after_crc


def _scan_records_native(data: bytes) -> Optional[list[Record]]:
    """The host library's scan of uncompressed, header-less frames; None
    when a frame is outside that envelope (the Python walk decides)."""
    # upper bound on records: the sum of the frames' recordCount headers
    max_n = 0
    pos = 0
    n = len(data)
    while pos + 61 <= n:
        batch_len = struct.unpack_from("!i", data, pos + 8)[0]
        count = struct.unpack_from("!i", data, pos + 57)[0]
        if batch_len <= 0 or count < 0 or data[pos + 16] != 2:
            return None  # corrupt or foreign framing
        max_n += count
        pos += 12 + batch_len
    if max_n == 0:
        return [] if pos else None
    arr = np.empty(max_n * 6, dtype=np.int64)
    blob = np.frombuffer(data, dtype=np.uint8)
    rc = native.lib().kafka_scan_records(blob, len(data), arr, max_n)
    if rc < 0:
        if rc == -1:
            raise ValueError("record batch CRC mismatch or corrupt frame")
        return None  # -2: compression or headers
    out = []
    for ks, ke, vs, ve, off, ts in arr[:rc * 6].reshape(-1, 6).tolist():
        out.append(Record(
            key=data[ks:ke] if ks >= 0 else None,
            value=data[vs:ve] if vs >= 0 else None,
            offset=off, timestamp_ms=ts))
    return out


def decode_record_batches(data: bytes) -> list[Record]:
    """RecordBatch v2 blob(s) -> Records with absolute offsets."""
    scanned = _scan_records_native(data)
    if scanned is not None:
        return scanned
    return decode_record_batches_py(data)


def decode_record_batches_py(data: bytes) -> list[Record]:
    """RecordBatch v2 blob(s) -> Records, in pure Python (gzip batches
    and headers included)."""
    out: list[Record] = []
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        base_offset, batch_len = struct.unpack_from("!qi", data, pos)
        end = pos + 12 + batch_len
        if end > n:
            break  # partial batch at the end of a fetch response
        r = Reader(data, pos + 12)
        r.i32()            # partitionLeaderEpoch
        magic = r.i8()
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        expect_crc = struct.unpack_from("!I", data, r.pos)[0]
        r.pos += 4
        if crc32c(data[r.pos:end]) != expect_crc:
            raise ValueError("record batch CRC mismatch")
        attributes = r.i16()
        codec = attributes & 0x07
        if codec not in (0, _CODEC_GZIP):
            raise ValueError(
                f"compressed record batch codec {codec} not supported "
                f"(gzip=1 is; snappy/lz4/zstd need codecs this "
                f"environment does not ship) — configure the producers "
                f"accordingly"
            )
        if attributes & 0x20:
            # control batch: txn markers are broker metadata, never data
            pos = end
            continue
        r.i32()            # lastOffsetDelta
        base_ts = r.i64()
        r.i64()            # maxTimestamp
        r.i64()            # producerId
        r.i16()            # producerEpoch
        r.i32()            # baseSequence
        count = r.i32()
        if codec == _CODEC_GZIP:
            import gzip as _gzip

            r = Reader(_gzip.decompress(bytes(r.buf[r.pos:end])))
        for _ in range(count):
            r.varint()                 # record length
            r.i8()                     # attributes
            ts_delta = r.varint()
            off_delta = r.varint()
            klen = r.varint()
            key = None
            if klen >= 0:
                key = bytes(r.buf[r.pos:r.pos + klen])
                r.pos += klen
            vlen = r.varint()
            value = None
            if vlen >= 0:
                value = bytes(r.buf[r.pos:r.pos + vlen])
                r.pos += vlen
            hcount = r.varint()
            headers = []
            for _ in range(hcount):
                hklen = r.varint()
                hk = bytes(r.buf[r.pos:r.pos + hklen])
                r.pos += hklen
                hvlen = r.varint()
                hv = b""
                if hvlen >= 0:
                    hv = bytes(r.buf[r.pos:r.pos + hvlen])
                    r.pos += hvlen
                headers.append((hk, hv))
            out.append(Record(
                key=key, value=value,
                offset=base_offset + off_delta,
                timestamp_ms=base_ts + ts_delta,
                headers=headers,
            ))
        pos = end
    return out
