"""Debezium envelope emitter (the port's copy of
``transferia_tpu/debezium/emitter.py``).

Produces (key_bytes, value_bytes) JSON pairs per row.  Deletes also emit
the tombstone (key, None) message when configured, matching Debezium's
default topic compaction contract.

Insert-only columnar batches take a vectorized path: the schema block
and every static byte of the envelope render once per (table, schema)
into %s-templates, values render per column (numpy string casts for
ints, C-speed maps for the rest), and rows assemble by template
substitution.  Output bytes are identical to the per-row path (tests
pin it, and pin both routes to the JAX package's bytes); anything
outside the envelope (CDC kinds, packers, exotic source types) falls
back to the per-row emitter below.
"""

from __future__ import annotations

import base64
import json
import re
import time
from typing import Iterable, Optional

import numpy as np

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import CanonicalType, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.debezium.types import (
    _split_original,
    encode_value,
    to_connect,
)


def _field_schema(cs) -> dict:
    ctype, semantic, params = to_connect(cs)
    if isinstance(ctype, dict):  # Connect array: {"type","items"}
        out = dict(ctype)
        out.update({"optional": not cs.required, "field": cs.name})
    else:
        out = {"type": ctype, "optional": not cs.required,
               "field": cs.name}
    if semantic:
        out["name"] = semantic
        out["version"] = 1
    if params:
        out["parameters"] = dict(params)
    return out


class DebeziumEmitter:
    """config: topic_prefix, connector name, include_schema (schema block
    on/off), emit_tombstones."""

    VERSION = "2.5.0.transferia-tpu"

    def __init__(self, topic_prefix: str = "transfer",
                 connector: str = "transferia-tpu",
                 include_schema: bool = True,
                 emit_tombstones: bool = False,
                 source_db_type: str = "postgresql",
                 packer: str = "",
                 topic: str = "",
                 schema_registry_url: str = "",
                 schema_registry_user: str = "",
                 schema_registry_password: str = ""):
        """packer: '' -> include_schema flag decides (include_schema /
        skip_schema); 'schema_registry' -> Confluent wire format
        (`packer.py`).  topic: the sink's FIXED topic when
        it writes into one topic — SR subjects derive from the topic the
        messages actually land on (TopicNameStrategy); default is the
        kafka sink's per-table naming '<namespace>.<table>'."""
        self.sink_topic = topic
        self.topic_prefix = topic_prefix
        self.connector = connector
        self.include_schema = include_schema
        self.emit_tombstones = emit_tombstones
        self.source_db_type = source_db_type
        self.key_packer = self.value_packer = None
        # keyed on schema.fingerprint(), never id(schema): a freed
        # TableSchema's address can be reused by a new schema for the
        # same table (same column count after a rename/type change),
        # which would silently serve a stale envelope (the fingerprint is
        # computed once and cached on the schema)
        self._value_schema_cache: dict = {}
        self._key_schema_cache: dict = {}
        # rendered %s-templates for the vectorized columnar path
        self._fast_tmpl_cache: dict = {}
        if packer == "schema_registry":
            from transferia_tpu_torch.debezium.packer import (
                SchemaRegistryPacker,
            )
            from transferia_tpu_torch.schemaregistry import (
                SchemaRegistryClient,
            )

            client = SchemaRegistryClient(
                schema_registry_url, user=schema_registry_user,
                password=schema_registry_password)
            self.key_packer = SchemaRegistryPacker(client, is_key=True)
            self.value_packer = SchemaRegistryPacker(client, is_key=False)
        elif packer not in ("", "include_schema", "skip_schema"):
            raise ValueError(f"unknown debezium packer {packer!r}")
        elif packer:
            self.include_schema = packer == "include_schema"

    def topic_for(self, item: ChangeItem) -> str:
        """The topic this item's message lands on: the sink's fixed topic
        when configured, else the kafka sink's per-table '<ns>.<table>'.
        SR subject names must match this (TopicNameStrategy), or
        consumers looking up '<actual-topic>-value' find nothing."""
        if self.sink_topic:
            return self.sink_topic
        return f"{item.schema}.{item.table}" if item.schema \
            else item.table

    # -- schema blocks (cached per table schema fingerprint) ---------------
    def _value_schema(self, item: ChangeItem, schema: TableSchema) -> dict:
        fqtn = f"{self.topic_prefix}.{item.schema}.{item.table}"
        cached = self._value_schema_cache.get((fqtn, schema.fingerprint()))
        if cached is not None:
            return cached
        row_fields = [_field_schema(c) for c in schema]
        row_struct = lambda name: {  # noqa: E731
            "type": "struct", "optional": True, "field": name,
            "fields": row_fields,
            "name": f"{fqtn}.Value",
        }
        out = {
            "type": "struct",
            "name": f"{fqtn}.Envelope",
            "optional": False,
            "fields": [
                row_struct("before"),
                row_struct("after"),
                {
                    "type": "struct", "optional": False, "field": "source",
                    "name": "io.debezium.connector.common.Source",
                    "fields": [
                        {"type": "string", "optional": False,
                         "field": "version"},
                        {"type": "string", "optional": False,
                         "field": "connector"},
                        {"type": "string", "optional": False, "field": "name"},
                        {"type": "int64", "optional": False, "field": "ts_ms"},
                        {"type": "string", "optional": True,
                         "field": "snapshot"},
                        {"type": "string", "optional": False, "field": "db"},
                        {"type": "string", "optional": True, "field": "schema"},
                        {"type": "string", "optional": False, "field": "table"},
                        {"type": "int64", "optional": True, "field": "lsn"},
                        {"type": "string", "optional": True, "field": "txId"},
                    ],
                },
                {"type": "string", "optional": False, "field": "op"},
                {"type": "int64", "optional": True, "field": "ts_ms"},
            ],
        }
        self._value_schema_cache[(fqtn, schema.fingerprint())] = out
        return out

    def _key_schema(self, item: ChangeItem, schema: TableSchema) -> dict:
        fqtn = f"{self.topic_prefix}.{item.schema}.{item.table}"
        cached = self._key_schema_cache.get((fqtn, schema.fingerprint()))
        if cached is not None:
            return cached
        out = {
            "type": "struct", "optional": False, "name": f"{fqtn}.Key",
            "fields": [_field_schema(c) for c in schema.key_columns()],
        }
        self._key_schema_cache[(fqtn, schema.fingerprint())] = out
        return out

    # -- payload ------------------------------------------------------------
    def _row_payload(self, names, values, schema: TableSchema) -> dict:
        out = {}
        for n, v in zip(names, values):
            cs = schema.find(n)
            out[n] = encode_value(cs.data_type, v,
                                  cs.original_type) if cs else v
        return out

    def _source(self, item: ChangeItem, snapshot: bool) -> dict:
        return {
            "version": self.VERSION,
            "connector": self.connector,
            "name": self.topic_prefix,
            "ts_ms": item.commit_time_ns // 1_000_000 or
            int(time.time() * 1000),
            "snapshot": "true" if snapshot else "false",
            "db": self.source_db_type,
            "schema": item.schema,
            "table": item.table,
            "lsn": item.lsn or None,
            "txId": item.txn_id or None,
        }

    def emit_item(self, item: ChangeItem,
                  snapshot: bool = False) -> list[tuple[bytes, Optional[bytes]]]:
        """One row -> [(key, value)] (+ tombstone for deletes)."""
        schema = item.table_schema
        if schema is None:
            raise ValueError("debezium emitter requires table_schema")
        op = {Kind.INSERT: "r" if snapshot else "c",
              Kind.UPDATE: "u", Kind.DELETE: "d"}.get(item.kind)
        if op is None:
            return []  # control events don't serialize to debezium

        key_vals = {}
        for c in schema.key_columns():
            if item.kind == Kind.DELETE and item.old_keys.key_names:
                key_vals[c.name] = encode_value(
                    c.data_type, item.old_keys.as_dict().get(c.name),
                    c.original_type,
                )
            else:
                key_vals[c.name] = encode_value(
                    c.data_type, item.value(c.name), c.original_type,
                )

        after = None
        before = None
        if item.kind != Kind.DELETE:
            after = self._row_payload(item.column_names, item.column_values,
                                      schema)
        if item.kind in (Kind.UPDATE, Kind.DELETE) and \
                item.old_keys.key_names:
            before = self._row_payload(
                item.old_keys.key_names, item.old_keys.key_values, schema
            )

        value_payload = {
            "before": before,
            "after": after,
            "source": self._source(item, snapshot),
            "op": op,
            "ts_ms": int(time.time() * 1000),
        }
        if self.value_packer is not None:
            # Confluent wire format: schemas live in the registry
            topic = self.topic_for(item)
            key_b = self.key_packer.pack(
                topic, self._key_schema(item, schema), key_vals)
            value_b = self.value_packer.pack(
                topic, self._value_schema(item, schema), value_payload)
            out = [(key_b, value_b)]
            if item.kind == Kind.DELETE and self.emit_tombstones:
                out.append((key_b, None))
            return out
        if self.include_schema:
            key_obj = {"schema": self._key_schema(item, schema),
                       "payload": key_vals}
            value_obj = {"schema": self._value_schema(item, schema),
                         "payload": value_payload}
        else:
            key_obj, value_obj = key_vals, value_payload
        key_b = json.dumps(key_obj, separators=(",", ":"),
                           default=str).encode()
        value_b = json.dumps(value_obj, separators=(",", ":"),
                             default=str).encode()
        out: list[tuple[bytes, Optional[bytes]]] = [(key_b, value_b)]
        if item.kind == Kind.DELETE and self.emit_tombstones:
            out.append((key_b, None))
        return out

    def emit_batch(self, batch, snapshot: bool = False
                   ) -> list[tuple[bytes, Optional[bytes]]]:
        """ColumnBatch or row list -> envelope pairs, order-preserving."""
        items: Iterable[ChangeItem]
        if isinstance(batch, ColumnBatch):
            fast = self._emit_columnar_fast(batch, snapshot)
            if fast is not None:
                return fast
            items = batch.to_rows()
        else:
            items = batch
        out = []
        for it in items:
            if it.is_row_event():
                out.extend(self.emit_item(it, snapshot))
        return out

    # -- vectorized insert-only columnar path --------------------------------

    # original_type (provider, base) combinations encode_value special-
    # cases; columns carrying them take the per-value path
    _SLOW_MYSQL = ("bigint unsigned", "time", "year", "enum", "set", "bit")
    # chars safe to embed in a JSON string unescaped under ensure_ascii:
    # printable ASCII minus '"' and '\'
    _JSON_SAFE = re.compile(r'[^ !#-\[\]-~]')

    def _col_fragments(self, col, cs) -> Optional[list]:
        """Per-row JSON value fragments for one column, byte-identical to
        json.dumps(encode_value(...)); None = out of the fast envelope."""
        orig = cs.original_type or ""
        slow_orig = False
        if orig:
            provider, base, _args = _split_original(orig)
            if provider == "pg":
                slow_orig = True  # arrays/money/ranges/bits: keep exact
            elif provider == "mysql" and base in self._SLOW_MYSQL:
                slow_orig = True
        ct = cs.data_type
        frags: Optional[list] = None
        if not slow_orig:
            if ct in (CanonicalType.INT8, CanonicalType.INT16,
                      CanonicalType.INT32, CanonicalType.INT64,
                      CanonicalType.UINT8, CanonicalType.UINT16,
                      CanonicalType.UINT32, CanonicalType.UINT64,
                      CanonicalType.DATE):
                data = col.data
                if data is None:
                    return None
                if ct == CanonicalType.DATE and \
                        data.dtype.kind == "M":
                    data = data.astype("datetime64[D]").astype(np.int64)
                frags = data.astype("U").tolist()
            elif ct == CanonicalType.DATETIME:
                data = col.data
                if data is None:
                    return None
                if data.dtype.kind == "M":
                    data = data.astype("datetime64[s]").astype(np.int64)
                # seconds -> ms (io.debezium.time.Timestamp)
                frags = (data.astype(np.int64) * 1000).astype("U").tolist()
            elif ct == CanonicalType.TIMESTAMP:
                data = col.data
                if data is None:
                    return None
                if data.dtype.kind == "M":
                    data = data.astype("datetime64[us]").astype(np.int64)
                frags = data.astype("U").tolist()
            elif ct in (CanonicalType.FLOAT, CanonicalType.DOUBLE):
                data = col.data
                # NaN/inf spell differently in json ('NaN'/'Infinity');
                # rare — keep the exact per-row path for those batches
                if data is None or not np.isfinite(data).all():
                    return None
                frags = list(map(repr, data.astype(np.float64).tolist()))
            elif ct == CanonicalType.BOOLEAN:
                data = col.data
                if data is None:
                    return None
                frags = [("true" if v else "false")
                         for v in data.tolist()]
            elif ct in (CanonicalType.UTF8, CanonicalType.DECIMAL):
                safe = self._JSON_SAFE
                dumps = json.dumps
                frags = [
                    "null" if s is None
                    else ('"' + s + '"') if not safe.search(s)
                    else dumps(s)
                    for s in col.to_pylist()
                ]
            elif ct == CanonicalType.STRING:
                b64 = base64.b64encode
                frags = [
                    "null" if v is None
                    else '"' + b64(v).decode() + '"'
                    for v in col.to_pylist()
                ]
        if frags is None:
            # exact fallback: per-value encode + dumps (still columnar —
            # no ChangeItem materialization)
            dumps = json.dumps
            frags = [
                dumps(encode_value(ct, v, orig), separators=(",", ":"),
                      default=str)
                for v in col.to_pylist()
            ]
            return frags
        if col.validity is not None:
            frags = [f if ok else "null"
                     for f, ok in zip(frags, col.validity.tolist())]
        return frags

    def _emit_columnar_fast(self, batch: ColumnBatch, snapshot: bool
                            ) -> Optional[list]:
        """Insert-only JSON-mode batches render by template; None defers
        to the per-row path."""
        if self.value_packer is not None:
            return None
        schema = batch.schema
        if schema is None or batch.n_rows == 0:
            return None
        if batch.kinds is not None:
            from transferia_tpu_torch.abstract.kinds import KIND_CODES

            if not (batch.kinds == KIND_CODES[Kind.INSERT]).all():
                return None
        key_cols = schema.key_columns()
        if not key_cols:
            return None
        names = [cs.name for cs in schema]
        if set(n for n in names) - set(batch.columns.keys()):
            return None

        frag_by_name = {}
        for cs in schema:
            frags = self._col_fragments(batch.columns[cs.name], cs)
            if frags is None:
                return None
            frag_by_name[cs.name] = frags
        return self._render_fast(batch, schema, names, key_cols,
                                 frag_by_name, snapshot)

    def _build_templates(self, schema, names, key_cols, item_schema,
                         item_table, snapshot) -> tuple:
        """All static envelope bytes as %s-templates (cached upstream)."""
        def esc(s: str) -> str:
            # static json text going into a %-template
            return json.dumps(s, separators=(",", ":"),
                              default=str).replace("%", "%%")

        after_fmt = "{" + ",".join(esc(n) + ":%s" for n in names) + "}"
        key_payload_fmt = "{" + ",".join(
            esc(c.name) + ":%s" for c in key_cols) + "}"
        op = "r" if snapshot else "c"
        src_fmt = (
            '{"version":' + esc(self.VERSION)
            + ',"connector":' + esc(self.connector)
            + ',"name":' + esc(self.topic_prefix)
            + ',"ts_ms":%s,"snapshot":'
            + ('"true"' if snapshot else '"false"')
            + ',"db":' + esc(self.source_db_type)
            + ',"schema":' + esc(item_schema)
            + ',"table":' + esc(item_table)
            + ',"lsn":%s,"txId":%s}'
        )
        env_core = ('{"before":null,"after":%s,"source":%s,"op":"' + op
                    + '","ts_ms":\x00TS\x00}')
        if self.include_schema:
            # only schema-block naming reads .schema/.table off the item
            class _Shim:
                schema = item_schema
                table = item_table

            shim = _Shim()
            vschema = json.dumps(self._value_schema(shim, schema),
                                 separators=(",", ":"), default=str)
            kschema = json.dumps(self._key_schema(shim, schema),
                                 separators=(",", ":"), default=str)
            value_fmt = ('{"schema":' + vschema.replace("%", "%%")
                         + ',"payload":' + env_core + "}")
            key_fmt = ('{"schema":' + kschema.replace("%", "%%")
                       + ',"payload":' + key_payload_fmt + "}")
        else:
            value_fmt = env_core
            key_fmt = key_payload_fmt
        return after_fmt, key_fmt, value_fmt, src_fmt

    def _render_fast(self, batch: ColumnBatch, schema, names, key_cols,
                     frag_by_name: dict, snapshot: bool) -> list:

        tid = batch.table_id
        item_schema, item_table = tid.namespace, tid.name
        now_ms = int(time.time() * 1000)

        # -- templates: ALL static bytes (incl. the full schema blocks)
        # render once per (table, schema, mode) and cache — re-dumping a
        # multi-KB schema json per small CDC batch would dwarf the row
        # rendering this path accelerates.  \x00TS\x00 marks the
        # envelope timestamp slot (a NUL can never appear in json text)
        cache_key = (item_schema, item_table, schema.fingerprint(),
                     snapshot)
        tmpl = self._fast_tmpl_cache.get(cache_key)
        if tmpl is None:
            tmpl = self._build_templates(schema, names, key_cols,
                                         item_schema, item_table,
                                         snapshot)
            self._fast_tmpl_cache[cache_key] = tmpl
        after_fmt, key_fmt_t, value_fmt_t, src_fmt = tmpl
        key_fmt = key_fmt_t
        value_fmt = value_fmt_t.replace("\x00TS\x00", str(now_ms))
        n = batch.n_rows
        if batch.commit_times is not None:
            ts_list = [str(t // 1_000_000) if t else str(now_ms)
                       for t in batch.commit_times.tolist()]
        else:
            ts_list = None  # constant
        if batch.lsns is not None:
            lsn_list = [str(int(v)) if v else "null"
                        for v in batch.lsns.tolist()]
        else:
            lsn_list = None
        txns = getattr(batch, "txn_ids", None)
        if txns is not None:
            # substituted values are literal — plain json escaping only
            txn_list = [json.dumps(t) if t else "null" for t in txns]
        else:
            txn_list = None
        if ts_list is None and lsn_list is None and txn_list is None:
            src_strs = [src_fmt % (now_ms, "null", "null")] * n
        else:
            ts_it = ts_list or [str(now_ms)] * n
            lsn_it = lsn_list or ["null"] * n
            txn_it = txn_list or ["null"] * n
            src_strs = list(map(src_fmt.__mod__,
                                zip(ts_it, lsn_it, txn_it)))

        col_frags = [frag_by_name[nm] for nm in names]
        after_strs = list(map(after_fmt.__mod__, zip(*col_frags)))
        key_frags = [frag_by_name[c.name] for c in key_cols]
        key_strs = list(map(key_fmt.__mod__, zip(*key_frags)))
        value_strs = list(map(value_fmt.__mod__,
                              zip(after_strs, src_strs)))
        return [(k.encode(), v.encode())
                for k, v in zip(key_strs, value_strs)]
