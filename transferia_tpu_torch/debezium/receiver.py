"""Debezium envelope receiver (the port's copy of
``transferia_tpu/debezium/receiver.py``).

Parses Debezium value JSON (with or without the schema block) back into
ChangeItems; schema blocks restore canonical types via Connect semantic
names, schemaless payloads fall back to JSON-shape inference.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableSchema,
)
from transferia_tpu_torch.debezium.types import (
    FROM_CONNECT,
    FROM_SEMANTIC,
    decode_value,
)

def _decode_connect_decimal(v, scale: int):
    """base64 big-endian two's-complement unscaled int -> decimal string
    (org.apache.kafka.connect.data.Decimal)."""
    import base64

    try:
        raw = base64.b64decode(v)
        unscaled = int.from_bytes(raw, "big", signed=True)
        s = scale
    except Exception:
        return v
    if s <= 0:
        # scale-0 decimals are integers (e.g. mysql bigint unsigned in
        # precise mode): return the int, not its string form
        return unscaled * 10 ** (-s)
    sign = "-" if unscaled < 0 else ""
    digits = str(abs(unscaled)).rjust(s + 1, "0")
    return f"{sign}{digits[:-s]}.{digits[-s:]}"


_OPS = {"c": Kind.INSERT, "r": Kind.INSERT, "u": Kind.UPDATE,
        "d": Kind.DELETE}


class DebeziumReceiver:
    def __init__(self, unpacker=None):
        """unpacker: debezium.packer.Unpacker for Confluent wire-format
        messages (magic 0x00 + schema id frame); plain JSON otherwise."""
        self._schema_cache: dict[str, TableSchema] = {}
        self.unpacker = unpacker

    # -- schema -------------------------------------------------------------
    def _connect_to_colschema(self, f: dict, keys: set[str]) -> ColSchema:
        semantic = f.get("name", "")
        if semantic in FROM_SEMANTIC:
            ctype = FROM_SEMANTIC[semantic]
        else:
            ctype = FROM_CONNECT.get(f.get("type", "string"),
                                     CanonicalType.ANY)
        props: list = []
        if semantic:
            props.append(("semantic", semantic))
        if f.get("type") == "array":
            items = f.get("items") or {}
            props.append(("array_item_type", items.get("type", "string")))
            if items.get("name"):
                props.append(("array_item_semantic", items["name"]))
        if semantic == "org.apache.kafka.connect.data.Decimal":
            # Connect Decimal: base64 big-endian unscaled bytes + a scale
            # schema parameter
            scale = (f.get("parameters") or {}).get("scale", "0")
            props.append(("scale", str(scale)))
        return ColSchema(
            name=f["field"],
            data_type=ctype,
            primary_key=f["field"] in keys,
            required=not f.get("optional", True),
            properties=tuple(props),
        )

    def _schema_from_block(self, value_schema: dict,
                           key_schema: Optional[dict]) -> Optional[TableSchema]:
        after = next(
            (f for f in value_schema.get("fields", [])
             if f.get("field") == "after"),
            None,
        )
        if after is None:
            return None
        keys = set()
        if key_schema:
            keys = {f["field"] for f in key_schema.get("fields", [])}
        # cache key covers the full field list + key set, not just the table
        # name — upstream ALTERs change the schema block under the same
        # <prefix>.<table>.Value name and must invalidate the cache.  Tuple
        # key, not json.dumps: this runs per received message.
        cache_key = (
            after.get("name", ""),
            tuple(
                (f.get("field"), f.get("type"), f.get("name"),
                 f.get("optional", True),
                 tuple(sorted((f.get("parameters") or {}).items())),
                 (f.get("items") or {}).get("type"),
                 (f.get("items") or {}).get("name"))
                for f in after.get("fields", [])
            ),
            frozenset(keys),
        )
        cached = self._schema_cache.get(cache_key)
        if cached is not None:
            return cached
        schema = TableSchema([
            self._connect_to_colschema(f, keys)
            for f in after.get("fields", [])
        ])
        self._schema_cache[cache_key] = schema
        return schema

    @staticmethod
    def _infer_schema(payload_row: dict, keys: set[str]) -> TableSchema:
        cols = []
        for k, v in payload_row.items():
            if isinstance(v, bool):
                t = CanonicalType.BOOLEAN
            elif isinstance(v, int):
                t = CanonicalType.INT64
            elif isinstance(v, float):
                t = CanonicalType.DOUBLE
            elif isinstance(v, str):
                t = CanonicalType.UTF8
            else:
                t = CanonicalType.ANY
            cols.append(ColSchema(k, t, primary_key=k in keys))
        return TableSchema(cols)

    # -- decode -------------------------------------------------------------
    def receive(self, value: bytes,
                key: Optional[bytes] = None) -> Optional[ChangeItem]:
        """One Debezium value (+key) -> ChangeItem (None for tombstones)."""
        if not value:
            return None
        if value[:1] == b"\x00" and self.unpacker is not None:
            vblock, payload_obj = self.unpacker.unpack(value)
            obj = ({"schema": vblock, "payload": payload_obj}
                   if vblock is not None else payload_obj)
            key_obj = None
            if key and key[:1] == b"\x00":
                kblock, kpayload = self.unpacker.unpack(key)
                key_obj = ({"schema": kblock, "payload": kpayload}
                           if kblock is not None else kpayload)
            elif key:
                key_obj = json.loads(key)
        else:
            obj = json.loads(value)
            key_obj = json.loads(key) if key else None

        if isinstance(obj, dict) and "payload" in obj and "schema" in obj:
            payload = obj["payload"]
            schema = self._schema_from_block(
                obj.get("schema") or {},
                (key_obj or {}).get("schema") if isinstance(key_obj, dict)
                else None,
            )
        else:
            payload = obj
            schema = None

        if not isinstance(payload, dict) or "op" not in payload:
            raise ValueError("not a debezium envelope: missing op")
        kind = _OPS.get(payload["op"])
        if kind is None:
            return None  # txn markers etc.

        source = payload.get("source") or {}
        after = payload.get("after")
        before = payload.get("before")

        key_payload = {}
        if isinstance(key_obj, dict):
            key_payload = key_obj.get("payload", key_obj)
            if not isinstance(key_payload, dict):
                key_payload = {}

        if schema is None:
            row = after or before or key_payload or {}
            schema = self._infer_schema(row, set(key_payload))

        # resolve per-column decode plans once per message, not per cell
        decimal_scales = {}
        semantics = {}
        array_items = {}
        for c in schema:
            props = dict(c.properties) if c.properties else {}
            if c.data_type == CanonicalType.DECIMAL and props:
                decimal_scales[c.name] = int(props.get("scale", 0))
            if props.get("semantic"):
                semantics[c.name] = props["semantic"]
            if "array_item_type" in props:
                array_items[c.name] = (
                    FROM_SEMANTIC.get(
                        props.get("array_item_semantic", ""),
                        FROM_CONNECT.get(props["array_item_type"],
                                         CanonicalType.ANY)),
                    props.get("array_item_semantic", ""),
                )

        def decode_row(row: Optional[dict]) -> dict:
            if not row:
                return {}
            out = {}
            for k, v in row.items():
                cs = schema.find(k)
                if cs is None:
                    out[k] = v
                elif k in decimal_scales and v is not None:
                    out[k] = _decode_connect_decimal(
                        v, decimal_scales[k])
                elif k in array_items and isinstance(v, list):
                    ictype, isem = array_items[k]
                    out[k] = [decode_value(ictype, x, isem) for x in v]
                else:
                    out[k] = decode_value(cs.data_type, v,
                                          semantics.get(k, ""))
            return out

        values = decode_row(after if kind != Kind.DELETE else None)
        before_vals = decode_row(before)
        if kind == Kind.DELETE and not before_vals:
            before_vals = decode_row(key_payload)

        names = tuple(schema.names())
        old_keys = OldKeys()
        if before_vals:
            key_cols = [c.name for c in schema.key_columns()] or \
                list(before_vals)
            old_keys = OldKeys(
                tuple(key_cols),
                tuple(before_vals.get(k) for k in key_cols),
            )
        return ChangeItem(
            kind=kind,
            schema=source.get("schema") or source.get("db", ""),
            table=source.get("table", ""),
            column_names=names if kind != Kind.DELETE else (),
            column_values=tuple(values.get(n) for n in names)
            if kind != Kind.DELETE else (),
            table_schema=schema,
            old_keys=old_keys,
            lsn=source.get("lsn") or 0,
            txn_id=str(source.get("txId") or ""),
            commit_time_ns=(source.get("ts_ms") or 0) * 1_000_000,
        )
