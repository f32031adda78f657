"""Parser plugins beyond the generic JSON/TSKV pair (the port's copy of
the blank, Debezium and Confluent schema-registry parsers of
``transferia_tpu/parsers/plugins.py``; the CloudEvents, native,
audit-trail, cloud-logging and protobuf parsers wait: ROADMAP.md A7)."""

from __future__ import annotations

import logging
import struct
from typing import Optional, Sequence

import numpy as np

from transferia_tpu_torch import native

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.parsers.base import (
    Message,
    ParseResult,
    Parser,
    unparsed_batch,
)
from transferia_tpu_torch.parsers.generic import GenericJsonParser
from transferia_tpu_torch.parsers.registry import register_parser
from transferia_tpu_torch.schemaregistry import (
    SchemaRegistryClient,
    sr_resolver,
)
from transferia_tpu_torch.schemaregistry.avro import AvroSchema

logger = logging.getLogger(__name__)

# Raw queue-mirror schema: topic/partition/offset/write time + the raw
# key and data as the row.
RAW_SCHEMA = TableSchema([
    ColSchema("topic", CanonicalType.UTF8, primary_key=True),
    ColSchema("partition", CanonicalType.UINT32, primary_key=True),
    ColSchema("offset", CanonicalType.UINT64, primary_key=True),
    ColSchema("timestamp", CanonicalType.TIMESTAMP),
    ColSchema("key", CanonicalType.STRING),
    ColSchema("data", CanonicalType.STRING),
])


@register_parser("blank")
@register_parser("raw_to_table")
class BlankParser(Parser):
    """Messages pass through as raw rows (the queue source's default)."""

    def __init__(self, table: str = "", namespace: str = ""):
        self.table = table
        self.namespace = namespace

    def do_batch(self, messages: Sequence[Message]) -> ParseResult:
        if not messages:
            return ParseResult()
        table = TableID(self.namespace,
                        self.table or messages[0].topic or "data")
        batch = ColumnBatch.from_pydict(table, RAW_SCHEMA, {
            "topic": [m.topic for m in messages],
            "partition": [m.partition for m in messages],
            "offset": [m.offset for m in messages],
            "timestamp": [m.write_time_ns // 1000 for m in messages],
            "key": [m.key for m in messages],
            "data": [m.value for m in messages],
        })
        return ParseResult(batches=[batch])


@register_parser("debezium")
class DebeziumParser(Parser):
    """Debezium envelopes -> ChangeItems -> columnar blocks; with a
    registry URL, Confluent-framed messages (0x00 + schema id) unpack
    through it."""

    def __init__(self, schema_registry_url: str = "",
                 schema_registry_user: str = "",
                 schema_registry_password: str = "", **kw):
        from transferia_tpu_torch.debezium import DebeziumReceiver

        unpacker = None
        if schema_registry_url:
            from transferia_tpu_torch.debezium.packer import Unpacker

            unpacker = Unpacker(SchemaRegistryClient(
                schema_registry_url, user=schema_registry_user,
                password=schema_registry_password))
        self.receiver = DebeziumReceiver(unpacker=unpacker)

    def do_batch(self, messages: Sequence[Message]) -> ParseResult:
        items: list[ChangeItem] = []
        bad: list[Message] = []
        reasons: list[str] = []
        for m in messages:
            try:
                it = self.receiver.receive(m.value, m.key or None)
                if it is not None:
                    items.append(it)
            except (ValueError, KeyError, TypeError) as e:
                bad.append(m)
                reasons.append(f"debezium: {e}")
        result = ParseResult()
        # group consecutive same-(table, schema) runs into columnar blocks
        run: list[ChangeItem] = []

        def flush():
            if run:
                result.batches.append(ColumnBatch.from_rows(run))
                run.clear()

        for it in items:
            if run and (it.table_id != run[0].table_id
                        or it.table_schema != run[0].table_schema):
                flush()
            run.append(it)
        flush()
        if bad:
            result.unparsed = unparsed_batch(bad, reasons)
        return result


@register_parser("confluent_schema_registry")
class ConfluentSRParser(Parser):
    """Confluent wire format (magic byte 0 + 4-byte schema id + payload).

    Resolves schemas through a pluggable resolver.  JSON-schema payloads
    decode via the generic parser; AVRO payloads decode by the registered
    writer schema: a flat record of primitives through the host library's
    columnar `avro_decode_flat`, anything else (and a run holding a
    malformed message) row by row through schemaregistry/avro.py.
    """

    def __init__(self, table: str = "data", namespace: str = "",
                 resolver: Optional[object] = None,
                 registry_url: str = "", registry_user: str = "",
                 registry_password: str = ""):
        self.table = table
        self.namespace = namespace
        # resolver: callable(schema_id) -> field-spec list (the generic
        # parser's `schema` config) or None; a registry_url builds one over
        # the Confluent REST API; absent falls back to schema inference
        if resolver is None and registry_url:
            resolver = sr_resolver(registry_url, user=registry_user,
                                   password=registry_password)
        self.resolver = resolver
        self.registry_url = registry_url
        self.registry_user = registry_user
        self.registry_password = registry_password
        self._parsers: dict[int, GenericJsonParser] = {}
        self._avro: dict[int, object] = {}
        self._client = None

    def _sr_client(self):
        if self._client is None:
            # reuse the resolver's client when it exposes one (sr_resolver
            # does) — one connection/config/cache, not two
            self._client = getattr(self.resolver, "client", None)
        if self._client is None and self.registry_url:
            self._client = SchemaRegistryClient(
                self.registry_url, user=self.registry_user,
                password=self.registry_password)
        return self._client

    def _avro_for(self, schema_id: int):
        """AvroSchema for a registered AVRO entry; None when the registry
        says the id is NOT Avro (cached).  Transient registry failures
        RAISE: dead-lettering valid data on an outage would consume the
        offsets forever — the parse failure propagates so the runtime
        retries the batch without committing (at-least-once)."""
        if schema_id in self._avro:
            return self._avro[schema_id]
        client = self._sr_client()
        avro = None
        if client is not None:
            try:
                entry = client.schema_by_id(schema_id)
            except Exception as e:
                if "404" in str(e):
                    # PERMANENTLY absent id (deleted / foreign registry):
                    # cache the miss so the message dead-letters instead
                    # of poisoning the partition with endless retries
                    logger.warning("schema id %d not registered (404)",
                                   schema_id)
                    self._avro[schema_id] = None
                    return None
                raise  # transient outage: abort the batch for retry
            if entry.get("schemaType", "AVRO") == "AVRO":
                try:
                    avro = AvroSchema(entry["schema"])
                except Exception as e:
                    logger.warning("schema id %d: bad avro schema (%s)",
                                   schema_id, e)
                    avro = None  # permanently undecodable: cacheable
        self._avro[schema_id] = avro
        return avro

    @staticmethod
    def _avro_col_type(node) -> CanonicalType:
        prim = {
            "int": CanonicalType.INT32, "long": CanonicalType.INT64,
            "float": CanonicalType.FLOAT, "double": CanonicalType.DOUBLE,
            "boolean": CanonicalType.BOOLEAN,
            "string": CanonicalType.UTF8, "bytes": CanonicalType.STRING,
        }
        if isinstance(node, str):
            return prim.get(node, CanonicalType.ANY)
        if node[0] == "union":
            # only the nullable-field idiom has a single concrete type;
            # multi-branch unions can carry any branch's value
            concrete = [b for b in node[1] if b != "null"]
            if len(concrete) == 1:
                return ConfluentSRParser._avro_col_type(concrete[0])
            return CanonicalType.ANY
        if node[0] == "enum":
            return CanonicalType.UTF8
        if node[0] == "fixed":
            return CanonicalType.STRING
        return CanonicalType.ANY

    # avro primitive -> (C type code, canonical type) for the flat-record
    # native fast path (hostops.cpp avro_decode_flat)
    _AVRO_C_TYPES = {
        "boolean": (1, CanonicalType.BOOLEAN),
        "int": (2, CanonicalType.INT32),
        "long": (2, CanonicalType.INT64),
        "float": (3, CanonicalType.FLOAT),
        "double": (4, CanonicalType.DOUBLE),
        "string": (5, CanonicalType.UTF8),
        "bytes": (5, CanonicalType.STRING),
    }

    def _flat_spec(self, avro):
        """(name, c_code, ctype, nullable, null_branch) per field when the
        schema is a flat record of primitives (None = out of envelope);
        cached per AvroSchema instance."""
        # cached ON the schema object: an id()-keyed dict would serve a
        # stale spec if a freed AvroSchema's address got reused
        spec = getattr(avro, "_flat_spec_cache", False)
        if spec is not False:
            return spec
        spec = None
        root = avro.root
        if isinstance(root, list) and root[0] == "record":
            out = []
            for name, t in root[2]:
                nullable, null_branch = False, 0
                node = t
                if isinstance(node, list) and node[0] == "union" \
                        and len(node[1]) == 2 and "null" in node[1]:
                    nullable = True
                    null_branch = node[1].index("null")
                    node = node[1][1 - null_branch]
                if not isinstance(node, str) \
                        or node not in self._AVRO_C_TYPES:
                    out = None
                    break
                code, ctype = self._AVRO_C_TYPES[node]
                out.append((name, code, ctype, nullable, null_branch))
            spec = out or None
        try:
            avro._flat_spec_cache = spec
        except AttributeError:  # slotted schema object: just recompute
            pass
        return spec

    def _avro_batch_native(self, avro, msgs: list[Message]):
        """Columnar decode of a flat-record run via the host library's
        `avro_decode_flat`; None defers to the exact per-row path (out of
        envelope, or any malformed message in the run).  A failed build
        or call of the library raises."""
        spec = self._flat_spec(avro)
        if spec is None:
            return None
        cdll = native.lib()
        n = len(msgs)
        payloads = [m.value for m in msgs]
        data = np.frombuffer(b"".join(payloads), dtype=np.uint8)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(p) for p in payloads], out=offs[1:])
        if int(offs[-1]) > 0x7FFF0000:
            # var-width offsets are int32 in the C decoder
            return None
        ftypes = np.array([c for _, c, _, _, _ in spec], dtype=np.uint8)
        fnull = np.array([1 if nl else 0 for *_, nl, _ in spec],
                         dtype=np.uint8)
        fbr = np.array([br for *_, br in spec], dtype=np.uint8)
        tasks = np.zeros((len(spec), 6), dtype=np.int64)
        holds = []
        for i, (name, code, ctype, nullable, _br) in enumerate(spec):
            validity = np.empty(n, dtype=np.uint8) if nullable else None
            if code == 5:
                cap = int(offs[-1])
                vdata = np.empty(max(cap, 1), dtype=np.uint8)
                voffs = np.empty(n + 1, dtype=np.int32)
                tasks[i, 1] = vdata.ctypes.data
                tasks[i, 2] = voffs.ctypes.data
                tasks[i, 3] = cap
                holds.append((vdata, voffs, validity))
            else:
                dt = {1: np.uint8, 2: np.int64, 3: np.float32,
                      4: np.float64}[code]
                out = np.empty(n, dtype=dt)
                tasks[i, 0] = out.ctypes.data
                holds.append((out, validity))
            if validity is not None:
                tasks[i, 4] = validity.ctypes.data
        rc = cdll.avro_decode_flat(
            data if data.size else np.zeros(1, dtype=np.uint8),
            offs, n, ftypes, fnull, fbr, len(spec), tasks.reshape(-1))
        if rc != n:
            return None
        cols = {}
        for i, (name, code, ctype, nullable, _br) in enumerate(spec):
            h = holds[i]
            validity = h[-1]
            v = None
            if validity is not None and not validity.all():
                v = validity.astype(np.bool_)
            if code == 5:
                vdata, voffs = h[0], h[1]
                flat = vdata[:int(voffs[n])]
                if ctype == CanonicalType.UTF8:
                    # the exact path DECODES strings (and dead-letters
                    # rows with invalid utf-8); one bulk validation over
                    # the flat buffer keeps the classification identical
                    try:
                        flat.tobytes().decode("utf-8")
                    except UnicodeDecodeError:
                        return None
                cols[name] = Column(name, ctype, flat, voffs, v)
            else:
                vals = h[0]
                if ctype == CanonicalType.INT32:
                    vals = vals.astype(np.int32)
                elif ctype == CanonicalType.BOOLEAN:
                    vals = vals.view(np.bool_)
                cols[name] = Column(name, ctype, vals, None, v)
        schema = TableSchema([
            ColSchema(name, ctype) for name, _, ctype, _, _ in spec])
        result = ParseResult()
        result.batches.append(ColumnBatch(
            TableID(self.namespace, self.table), schema, cols))
        return result

    def _avro_batch(self, avro, msgs: list[Message]) -> ParseResult:
        fast = self._avro_batch_native(avro, msgs)
        if fast is not None:
            return fast
        result = ParseResult()
        rows, bad, reasons = [], [], []
        for m in msgs:
            try:
                rows.append(avro.decode(m.value))
            except Exception as e:
                bad.append(m)
                reasons.append(f"avro: {e}")
        if rows:
            root = avro.root
            if isinstance(root, list) and root[0] == "record":
                cols = [(name, self._avro_col_type(t))
                        for name, t in root[2]]
            else:  # non-record root: single value column
                cols = [("value", self._avro_col_type(root))]
                rows = [{"value": r} for r in rows]
            schema = TableSchema([ColSchema(n, t) for n, t in cols])
            result.batches.append(ColumnBatch.from_pydict(
                TableID(self.namespace, self.table), schema,
                {n: [r.get(n) for r in rows] for n, _ in cols},
            ))
        if bad:
            result.unparsed = unparsed_batch(bad, reasons)
        return result

    def _parser_for(self, schema_id: int) -> GenericJsonParser:
        p = self._parsers.get(schema_id)
        if p is None:
            fields = None
            resolver_ok = True
            if self.resolver is not None:
                try:
                    fields = self.resolver(schema_id)
                except Exception as e:
                    # transient registry outage: fall back to inference for
                    # this batch but do NOT cache, so the id retries later
                    logger.warning(
                        "schema registry lookup for id %d failed (%s); "
                        "falling back to inference", schema_id, e,
                    )
                    resolver_ok = False
            p = GenericJsonParser(schema=fields, table=self.table,
                                  namespace=self.namespace)
            if resolver_ok:
                self._parsers[schema_id] = p
        return p

    def do_batch(self, messages: Sequence[Message]) -> ParseResult:
        # contiguous runs per schema id: offset order within the batch must
        # survive schema evolution (CDC consumers replay in emit order)
        runs: list[tuple[int, list[Message]]] = []
        bad, reasons = [], []
        for m in messages:
            v = m.value
            if len(v) >= 5 and v[0] == 0:
                schema_id = struct.unpack(">I", v[1:5])[0]
                payload = v[5:]
                stripped = Message(
                    value=payload, key=m.key, topic=m.topic,
                    partition=m.partition, offset=m.offset,
                    write_time_ns=m.write_time_ns,
                )
                # the registry's schemaType is authoritative: an Avro
                # payload may begin with 0x7b ('{') by coincidence (e.g.
                # a long field encoding -62), so byte-sniffing only
                # decides when the id has no registered Avro schema
                if self._avro_for(schema_id) is not None:
                    kind = "avro"
                elif payload[:1] in (b"{", b"["):
                    kind = "json"
                else:
                    bad.append(m)
                    reasons.append(
                        "confluent-sr: binary payload and no AVRO schema "
                        "registered for this id"
                    )
                    continue
                if runs and runs[-1][0] == (schema_id, kind):
                    runs[-1][1].append(stripped)
                else:
                    runs.append(((schema_id, kind), [stripped]))
            else:
                bad.append(m)
                reasons.append("confluent-sr: missing magic byte")
        result = ParseResult()
        for (schema_id, kind), msgs in runs:
            if kind == "avro":
                sub = self._avro_batch(self._avro_for(schema_id), msgs)
            else:
                sub = self._parser_for(schema_id).do_batch(msgs)
            result.batches.extend(sub.batches)
            if sub.unparsed is not None:
                result.unparsed = sub.unparsed \
                    if result.unparsed is None else \
                    ColumnBatch.concat([result.unparsed, sub.unparsed])
        if bad:
            ub = unparsed_batch(bad, reasons)
            result.unparsed = ub if result.unparsed is None else \
                ColumnBatch.concat([result.unparsed, ub])
        return result
