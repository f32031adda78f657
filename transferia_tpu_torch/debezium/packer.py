"""Debezium packers (the port's copy of
``transferia_tpu/debezium/packer.py``), over the port's schema-registry
client.

Three functional packers decide how an envelope leaves the emitter:

  include_schema   — kafka-connect schema embedded in each message
                     (default Debezium behaviour; lives in emitter.py)
  skip_schema      — payload only ('schema.enable: false')
  schema_registry  — Confluent wire format: the kafka-connect schema is
                     converted to a Confluent JSON schema, registered
                     with the Schema Registry, and the payload is framed
                     as [0x00][schema_id BE32][json payload] (the JSON
                     converter, not Avro).

Resolved schema ids are cached per (subject, final schema).  The
Unpacker inverts the wire frame and re-derives a kafka-connect schema
from the registered Confluent JSON schema so the receiver decodes with
exact types.
"""

from __future__ import annotations

import json
import logging
import struct
from typing import Optional

logger = logging.getLogger(__name__)

# kafka-connect primitive type -> (json-schema type, connect.type kept)
_CONNECT_TO_JSON = {
    "int8": "integer",
    "int16": "integer",
    "int32": "integer",
    "int64": "integer",
    "float": "number",
    "double": "number",
    "boolean": "boolean",
    "string": "string",
    "bytes": "string",
}


def kafka_schema_to_confluent_json(block: dict,
                                   closed: bool = False) -> dict:
    """kafka-connect schema block -> Confluent JSON schema."""
    t = block.get("type", "string")
    if t == "struct":
        props = {}
        required = []
        for i, f in enumerate(block.get("fields", [])):
            name = f.get("field", f"f{i}")
            props[name] = kafka_schema_to_confluent_json(f, closed)
            props[name]["connect.index"] = i
            if not f.get("optional", True):
                required.append(name)
        out: dict = {"type": "object", "properties": props}
        if block.get("name"):
            out["title"] = block["name"]
        if required:
            out["required"] = required
        if closed:
            out["additionalProperties"] = False
        return out
    if t == "array":
        return {"type": "array",
                "items": kafka_schema_to_confluent_json(
                    block.get("items", {}), closed)}
    out = {"type": _CONNECT_TO_JSON.get(t, "string")}
    out["connect.type"] = t
    if block.get("name"):
        out["title"] = block["name"]
    return out


_JSON_TO_CONNECT = {
    "integer": "int64",
    "number": "double",
    "boolean": "boolean",
    "string": "string",
}


def confluent_json_to_kafka_schema(cj: dict,
                                   field: Optional[str] = None) -> dict:
    """Inverse mapping: Confluent JSON schema -> kafka-connect block."""
    out: dict = {}
    if field is not None:
        out["field"] = field
    t = cj.get("type")
    if t == "object":
        props = sorted(
            cj.get("properties", {}).items(),
            key=lambda kv: kv[1].get("connect.index", 0),
        )
        required = set(cj.get("required", []))
        out.update({
            "type": "struct",
            "fields": [
                {**confluent_json_to_kafka_schema(p, name),
                 "optional": name not in required}
                for name, p in props
            ],
            "optional": False,
        })
        if cj.get("title"):
            out["name"] = cj["title"]
        return out
    if t == "array":
        out.update({"type": "array",
                    "items": confluent_json_to_kafka_schema(
                        cj.get("items", {}))})
        return out
    out["type"] = cj.get("connect.type") or _JSON_TO_CONNECT.get(
        t or "string", "string")
    if cj.get("title"):
        out["name"] = cj["title"]
    return out


def make_subject(topic: str, is_key: bool,
                 strategy: str = "topic") -> str:
    """TopicNameStrategy (the only strategy the CLI exposes):
    <topic>-key / <topic>-value."""
    if strategy != "topic":
        raise ValueError(f"unsupported subject name strategy {strategy!r}")
    return f"{topic}-{'key' if is_key else 'value'}"


class SchemaRegistryPacker:
    """Confluent wire-format packer with schema-id caching."""

    MAGIC = b"\x00"

    def __init__(self, client, is_key: bool = False,
                 subject_name_strategy: str = "topic",
                 closed_content_model: bool = False):
        self.client = client
        self.is_key = is_key
        self.strategy = subject_name_strategy
        self.closed = closed_content_model
        # (subject, schema fingerprint) -> schema id
        self._ids: dict[tuple[str, str], int] = {}

    def pack(self, topic: str, schema_block: dict,
             payload: dict) -> bytes:
        confluent = kafka_schema_to_confluent_json(schema_block,
                                                   self.closed)
        raw_schema = json.dumps(confluent, sort_keys=True,
                                separators=(",", ":"))
        subject = make_subject(topic, self.is_key, self.strategy)
        key = (subject, raw_schema)
        schema_id = self._ids.get(key)
        if schema_id is None:
            schema_id = self.client.register_schema(subject, raw_schema,
                                                    "JSON")
            self._ids[key] = schema_id
        body = json.dumps(payload, separators=(",", ":"),
                          default=str).encode()
        return self.MAGIC + struct.pack("!I", schema_id) + body


class Unpacker:
    """Confluent wire frame -> (kafka-connect schema | None, payload)."""

    def __init__(self, client=None):
        self.client = client
        self._schemas: dict[int, Optional[dict]] = {}

    def unpack(self, data: bytes) -> tuple[Optional[dict], dict]:
        if not data[:1] == b"\x00" or len(data) < 5:
            raise ValueError("not a Confluent wire-format message")
        schema_id = struct.unpack_from("!I", data, 1)[0]
        payload = json.loads(data[5:])
        block = None
        if self.client is not None:
            if schema_id not in self._schemas:
                try:
                    reg = self.client.schema_by_id(schema_id)
                    cj = json.loads(reg.get("schema", "{}"))
                    self._schemas[schema_id] = \
                        confluent_json_to_kafka_schema(cj)
                except Exception as e:
                    # do NOT negative-cache: a transient registry outage
                    # must not degrade this id to schema-less decoding
                    # for the process lifetime — retry on the next message
                    logger.warning("schema id %d unresolvable (will "
                                   "retry): %s", schema_id, e)
            block = self._schemas.get(schema_id)
        return block, payload
