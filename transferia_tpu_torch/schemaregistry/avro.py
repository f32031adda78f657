"""Minimal Avro binary decoder (schema-driven, dependency-free).

Covers what Confluent-wire Debezium/connector payloads use: records,
primitives, unions (the nullable-field idiom), enums, fixed, arrays, maps
and logical-type passthrough (decimal bytes stay bytes; timestamps stay
ints — the canonical typesystem maps them downstream).  The encoding is
the public Avro spec: zigzag-varint ints/longs, little-endian IEEE
float/double, length-prefixed bytes/strings, block-encoded arrays/maps.

The port's copy of ``transferia_tpu/schemaregistry/avro.py``.
"""

from __future__ import annotations

import json
import struct
from typing import Any


class AvroError(ValueError):
    pass


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def varint(self) -> int:
        result = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise AvroError("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 70:
                raise AvroError("varint overflow")
        return (result >> 1) ^ -(result & 1)  # zigzag

    def take(self, n: int) -> bytes:
        if n < 0:
            raise AvroError("negative length")
        if self.pos + n > len(self.buf):
            raise AvroError("truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


class AvroSchema:
    """Parsed schema with named-type resolution (records/enums/fixed)."""

    def __init__(self, schema_json: str):
        self.named: dict[str, Any] = {}
        self.root = self._norm(json.loads(schema_json), "")

    def _norm(self, s, namespace: str):
        if isinstance(s, list):
            return ["union", [self._norm(x, namespace) for x in s]]
        if isinstance(s, str):
            return s  # primitive or named-type reference
        t = s.get("type")
        if t in ("record", "error"):
            ns = s.get("namespace", namespace)
            name = s["name"] if "." in s["name"] \
                else (f"{ns}.{s['name']}" if ns else s["name"])
            fields = []
            node = ["record", name, fields]
            self.named[name] = node
            self.named[s["name"]] = node  # short-name refs too
            for f in s.get("fields", []):
                fields.append((f["name"], self._norm(f["type"], ns)))
            return node
        if t in ("enum", "fixed"):
            node = (["enum", s.get("symbols", [])] if t == "enum"
                    else ["fixed", int(s.get("size", 0))])
            ns = s.get("namespace", namespace)
            self.named[s["name"]] = node
            if ns and "." not in s["name"]:
                # standard writers reference enums/fixed by fullname too
                self.named[f"{ns}.{s['name']}"] = node
            return node
        if t == "array":
            return ["array", self._norm(s.get("items", "null"), namespace)]
        if t == "map":
            return ["map", self._norm(s.get("values", "null"), namespace)]
        if isinstance(t, (dict, list)):
            return self._norm(t, namespace)
        return t  # {"type": "long", "logicalType": ...} etc.

    def decode(self, payload: bytes) -> Any:
        r = Reader(payload)
        out = self._read(self.root, r)
        return out

    def _read(self, node, r: Reader) -> Any:
        if isinstance(node, str):
            if node in ("null",):
                return None
            if node == "boolean":
                return r.take(1) != b"\x00"
            if node in ("int", "long"):
                return r.varint()
            if node == "float":
                return struct.unpack("<f", r.take(4))[0]
            if node == "double":
                return struct.unpack("<d", r.take(8))[0]
            if node == "bytes":
                return bytes(r.take(r.varint()))
            if node == "string":
                return r.take(r.varint()).decode("utf-8")
            resolved = self.named.get(node)
            if resolved is None:
                raise AvroError(f"unknown avro type {node!r}")
            return self._read(resolved, r)
        kind = node[0]
        if kind == "union":
            idx = r.varint()
            branches = node[1]
            if not 0 <= idx < len(branches):
                raise AvroError(f"union index {idx} out of range")
            return self._read(branches[idx], r)
        if kind == "record":
            return {name: self._read(t, r) for name, t in node[2]}
        if kind == "enum":
            idx = r.varint()
            symbols = node[1]
            if not 0 <= idx < len(symbols):
                raise AvroError(f"enum index {idx} out of range")
            return symbols[idx]
        if kind == "fixed":
            return bytes(r.take(node[1]))
        if kind == "array":
            out = []
            while True:
                n = r.varint()
                if n == 0:
                    return out
                if n < 0:
                    r.varint()  # block byte size (skippable)
                    n = -n
                for _ in range(n):
                    out.append(self._read(node[1], r))
        if kind == "map":
            out = {}
            while True:
                n = r.varint()
                if n == 0:
                    return out
                if n < 0:
                    r.varint()
                    n = -n
                for _ in range(n):
                    k = r.take(r.varint()).decode("utf-8")
                    out[k] = self._read(node[1], r)
        raise AvroError(f"unsupported avro node {node!r}")
