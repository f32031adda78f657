"""Minimal BSON codec (the subset MongoDB's commands and documents use;
the port's copy of ``transferia_tpu/providers/mongo/bson.py``).

Types: double, string, document, array, binary, ObjectId, bool, UTC
datetime, null, int32, timestamp, int64, decimal128 (passed through as
bytes).  Unknown element types raise — silent truncation would corrupt
document streams.
"""

from __future__ import annotations

import struct
from typing import Any


class ObjectId:
    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 12:
            raise ValueError("ObjectId must be 12 bytes")
        self.raw = raw

    def __repr__(self) -> str:
        return f"ObjectId({self.raw.hex()})"

    def __str__(self) -> str:
        return self.raw.hex()

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectId) and other.raw == self.raw

    def __hash__(self) -> int:
        return hash(self.raw)


class Binary:
    __slots__ = ("subtype", "raw")

    def __init__(self, raw: bytes, subtype: int = 0):
        self.raw = raw
        self.subtype = subtype


class Timestamp:
    """BSON timestamp (oplog ordinal), distinct from UTC datetime."""

    __slots__ = ("t", "i")

    def __init__(self, t: int, i: int):
        self.t = t
        self.i = i

    def __repr__(self) -> str:
        return f"Timestamp({self.t}, {self.i})"


class UTCDateTime:
    """Milliseconds since epoch (kept numeric; no tz library games)."""

    __slots__ = ("ms",)

    def __init__(self, ms: int):
        self.ms = ms


def encode(doc: dict) -> bytes:
    out = bytearray()
    for key, value in doc.items():
        out += _encode_element(key, value)
    return struct.pack("<i", len(out) + 5) + bytes(out) + b"\x00"


def _encode_element(key: str, v: Any) -> bytes:
    name = key.encode() + b"\x00"
    if isinstance(v, bool):  # before int!
        return b"\x08" + name + (b"\x01" if v else b"\x00")
    if isinstance(v, float):
        return b"\x01" + name + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"\x02" + name + struct.pack("<i", len(b) + 1) + b + b"\x00"
    if isinstance(v, dict):
        return b"\x03" + name + encode(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + name + encode(
            {str(i): item for i, item in enumerate(v)}
        )
    if isinstance(v, Binary):
        return b"\x05" + name + struct.pack("<iB", len(v.raw), v.subtype) \
            + v.raw
    if isinstance(v, bytes):
        return b"\x05" + name + struct.pack("<iB", len(v), 0) + v
    if isinstance(v, ObjectId):
        return b"\x07" + name + v.raw
    if isinstance(v, UTCDateTime):
        return b"\x09" + name + struct.pack("<q", v.ms)
    if v is None:
        return b"\x0a" + name
    if isinstance(v, Timestamp):
        return b"\x11" + name + struct.pack("<II", v.i, v.t)
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + name + struct.pack("<i", v)
        return b"\x12" + name + struct.pack("<q", v)
    raise TypeError(f"bson: cannot encode {type(v).__name__}")


_INDEX_KEYS = [str(i) for i in range(64)]
_INT32 = struct.Struct("<i").unpack_from
_INT64 = struct.Struct("<q").unpack_from
_DOUBLE = struct.Struct("<d").unpack_from


def decode(data: bytes, offset: int = 0) -> tuple[dict, int]:
    """Decode one document at offset; returns (doc, end_offset).  The
    element types of a typical document (string, int32, double, int64,
    bool, null, sub-document) decode inline, the rest in _decode_value."""
    end = offset + _INT32(data, offset)[0]
    pos = offset + 4
    doc: dict = {}
    find = data.index
    while pos < end - 1:
        etype = data[pos]
        nul = find(b"\x00", pos + 1)
        key = data[pos + 1:nul].decode()
        pos = nul + 1
        if etype == 0x02:
            ln = _INT32(data, pos)[0]
            doc[key] = data[pos + 4:pos + 3 + ln].decode("utf-8", "replace")
            pos += 4 + ln
        elif etype == 0x10:
            doc[key] = _INT32(data, pos)[0]
            pos += 4
        elif etype == 0x01:
            doc[key] = _DOUBLE(data, pos)[0]
            pos += 8
        elif etype == 0x03:
            doc[key], pos = decode(data, pos)
        elif etype == 0x12:
            doc[key] = _INT64(data, pos)[0]
            pos += 8
        elif etype == 0x08:
            doc[key] = data[pos] == 1
            pos += 1
        elif etype == 0x0A:
            doc[key] = None
        else:
            doc[key], pos = _decode_value(etype, data, pos)
    return doc, end


def _decode_value(etype: int, data: bytes, pos: int) -> tuple[Any, int]:
    if etype == 0x01:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if etype == 0x02:
        ln = struct.unpack_from("<i", data, pos)[0]
        s = data[pos + 4:pos + 4 + ln - 1].decode("utf-8", "replace")
        return s, pos + 4 + ln
    if etype == 0x03:
        return decode(data, pos)
    if etype == 0x04:
        arr_doc, end = decode(data, pos)
        vals = list(arr_doc.values())
        if len(vals) <= len(_INDEX_KEYS) and \
                list(arr_doc) == _INDEX_KEYS[:len(vals)]:
            return vals, end   # keys "0", "1", ... in order, as written
        return [arr_doc[k] for k in sorted(arr_doc, key=int)], end
    if etype == 0x05:
        ln, subtype = struct.unpack_from("<iB", data, pos)
        raw = bytes(data[pos + 5:pos + 5 + ln])
        return (raw if subtype == 0 else Binary(raw, subtype)), pos + 5 + ln
    if etype == 0x06:  # undefined (deprecated)
        return None, pos
    if etype == 0x07:
        return ObjectId(bytes(data[pos:pos + 12])), pos + 12
    if etype == 0x08:
        return data[pos] == 1, pos + 1
    if etype == 0x09:
        return UTCDateTime(struct.unpack_from("<q", data, pos)[0]), pos + 8
    if etype == 0x0A:
        return None, pos
    if etype == 0x0B:  # regex: two cstrings
        n1 = data.index(b"\x00", pos)
        n2 = data.index(b"\x00", n1 + 1)
        return {"$regex": data[pos:n1].decode(),
                "$options": data[n1 + 1:n2].decode()}, n2 + 1
    if etype == 0x10:
        return struct.unpack_from("<i", data, pos)[0], pos + 4
    if etype == 0x11:
        i, t = struct.unpack_from("<II", data, pos)
        return Timestamp(t, i), pos + 8
    if etype == 0x12:
        return struct.unpack_from("<q", data, pos)[0], pos + 8
    if etype == 0x13:  # decimal128: surface raw bytes
        return Binary(bytes(data[pos:pos + 16]), 0x13), pos + 16
    raise ValueError(f"bson: unsupported element type 0x{etype:02x}")


# values to_jsonish returns as they are, by exact type (a subclass takes
# the isinstance route below, to the same result)
_AS_IS = frozenset({str, int, float, bool, type(None)})


def to_jsonish(v: Any) -> Any:
    """BSON value -> JSON-serializable canonical form (for ANY columns)."""
    t = type(v)
    if t is dict:
        return {k: x if type(x) in _AS_IS else to_jsonish(x)
                for k, x in v.items()}
    if t in _AS_IS:
        return v
    if isinstance(v, dict):
        return {k: to_jsonish(x) for k, x in v.items()}
    if isinstance(v, list):
        return [x if type(x) in _AS_IS else to_jsonish(x) for x in v]
    if isinstance(v, ObjectId):
        return {"$oid": str(v)}
    if isinstance(v, UTCDateTime):
        return {"$date": v.ms}
    if isinstance(v, Timestamp):
        return {"$timestamp": {"t": v.t, "i": v.i}}
    if isinstance(v, Binary):
        import base64

        return {"$binary": base64.b64encode(v.raw).decode(),
                "$type": v.subtype}
    if isinstance(v, bytes):
        import base64

        return {"$binary": base64.b64encode(v).decode(), "$type": 0}
    return v
