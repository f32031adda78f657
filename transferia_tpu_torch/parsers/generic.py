"""Generic schema-driven JSON/TSKV parser (the port's copy of
``transferia_tpu/parsers/generic.py``).

The whole message batch decodes in one `json.loads` of the joined lines;
a block that fails splits in halves until the bad rows are isolated
(O(log n) parses when errors are rare).  Failed rows go to `_unparsed`.
The JAX package takes pyarrow's JSON block reader first when pyarrow
imports; the port has no pyarrow, so it keeps the stdlib route only,
which is the JAX package's route without pyarrow (the same rows, columns
and unparsed table).

System columns (_timestamp/_partition/_offset/_idx) become the primary
key when the declared schema has none.
"""

from __future__ import annotations

import json
import re
from typing import Any, Optional, Sequence

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.parsers.base import (
    Message,
    ParseResult,
    Parser,
    unparsed_batch,
)
from transferia_tpu_torch.parsers.registry import register_parser

_SYSTEM_COLS = [
    ColSchema("_timestamp", CanonicalType.TIMESTAMP, primary_key=True),
    ColSchema("_partition", CanonicalType.UTF8, primary_key=True),
    ColSchema("_offset", CanonicalType.UINT64, primary_key=True),
    ColSchema("_idx", CanonicalType.UINT32, primary_key=True),
]


def _field_to_colschema(f: dict) -> ColSchema:
    return ColSchema(
        name=f["name"],
        data_type=CanonicalType(f.get("type", "any")),
        primary_key=bool(f.get("key", False)),
        required=bool(f.get("required", False)),
        path=f.get("path", ""),
    )


class _Lines:
    """Flattened (message, line) view of a batch."""

    __slots__ = ("values", "msg_index", "line_index")

    def __init__(self, messages: Sequence[Message]):
        self.values: list[bytes] = []
        self.msg_index: list[int] = []
        self.line_index: list[int] = []
        for mi, m in enumerate(messages):
            for li, line in enumerate(m.value.split(b"\n")):
                if line.strip():
                    self.values.append(line)
                    self.msg_index.append(mi)
                    self.line_index.append(li)


@register_parser("json")
@register_parser("generic")
class GenericJsonParser(Parser):
    """config: schema: [{name,type,key?,path?,required?}] (None = infer),
    table, namespace, add_system_cols, null_keys_allowed."""

    def __init__(self, schema: Optional[list[dict]] = None,
                 table: str = "data", namespace: str = "",
                 add_system_cols: bool = True,
                 null_keys_allowed: bool = False):
        self.fields = [_field_to_colschema(f) for f in (schema or [])]
        self.table = TableID(namespace, table)
        self.add_system_cols = add_system_cols
        self.null_keys_allowed = null_keys_allowed
        self._schema: Optional[TableSchema] = None
        if self.fields:
            self._schema = self._build_schema(self.fields)

    def _build_schema(self, fields: list[ColSchema]) -> TableSchema:
        cols = list(fields)
        if self.add_system_cols:
            has_user_key = any(c.primary_key for c in cols)
            sys_cols = [
                ColSchema(c.name, c.data_type,
                          primary_key=not has_user_key,
                          required=c.required)
                for c in _SYSTEM_COLS
            ]
            cols = sys_cols + cols
        return TableSchema(cols)

    # -- decoding -----------------------------------------------------------
    def _decode_rows(self, values: list[bytes]) -> list[Optional[dict]]:
        """One dict per line (None = unparseable): the whole block in one
        json.loads, bisecting only blocks that hold a bad row."""
        out: list[Optional[dict]] = [None] * len(values)

        def block_decode(lo: int, hi: int) -> Optional[list[dict]]:
            blob = b"[" + b",".join(values[lo:hi]) + b"]"
            try:
                rows = json.loads(blob)
            except ValueError:
                return None
            if len(rows) != hi - lo or \
                    not all(isinstance(r, dict) for r in rows):
                return None
            return rows

        def attempt(lo: int, hi: int) -> None:
            rows = block_decode(lo, hi)
            if rows is not None:
                out[lo:hi] = rows
                return
            if hi - lo == 1:
                return  # an isolated bad row stays None
            mid = (lo + hi) // 2
            attempt(lo, mid)
            attempt(mid, hi)

        if values:
            attempt(0, len(values))
        return out

    def _extract(self, rows: list[dict], cs: ColSchema) -> list[Any]:
        if cs.path:
            parts = cs.path.split(".")

            def get(r):
                cur: Any = r
                for p in parts:
                    if not isinstance(cur, dict) or p not in cur:
                        return None
                    cur = cur[p]
                return cur

            return [get(r) for r in rows]
        return [r.get(cs.name) for r in rows]

    def do_batch(self, messages: Sequence[Message]) -> ParseResult:
        lines = _Lines(messages)
        decoded = self._decode_rows(lines.values)

        # line index -> failure reason; grows as validation rejects rows
        bad: dict[int, str] = {
            i: "invalid " + ("JSON" if type(self) is GenericJsonParser
                             else self.TYPE)
            for i, d in enumerate(decoded) if d is None
        }
        good_idx = [i for i in range(len(decoded)) if i not in bad]

        fields = self.fields
        if not fields and good_idx:
            # schema inference from the first good rows
            seen: dict[str, CanonicalType] = {}
            for i in good_idx[:100]:
                for k, v in decoded[i].items():
                    seen.setdefault(k, _infer_type(v))
            fields = [ColSchema(k, t) for k, t in seen.items()]

        schema = self._schema or self._build_schema(fields)
        rows = [decoded[i] for i in good_idx]
        data: dict[str, list] = {}
        for cs in fields:
            data[cs.name] = self._extract(rows, cs)
        # null-key validation: offenders move to _unparsed
        if not self.null_keys_allowed:
            for kn in (c.name for c in fields if c.primary_key):
                for j, v in enumerate(data[kn]):
                    if v is None and good_idx[j] not in bad:
                        bad[good_idx[j]] = f"null value in key column {kn}"
        if len(bad) and rows:
            keep = [j for j, i in enumerate(good_idx) if i not in bad]
            data = {k: [v[j] for j in keep] for k, v in data.items()}
            good_idx = [good_idx[j] for j in keep]

        if self.add_system_cols:
            metas = [messages[lines.msg_index[i]] for i in good_idx]
            data["_timestamp"] = [m.write_time_ns // 1000 for m in metas]
            data["_partition"] = [
                f"{m.topic}:{m.partition}" for m in metas
            ]
            data["_offset"] = [m.offset for m in metas]
            data["_idx"] = [lines.line_index[i] for i in good_idx]

        result = ParseResult()
        if good_idx:
            coerced = _coerce(data, schema)
            result.batches.append(
                ColumnBatch.from_pydict(self.table, schema, coerced)
            )
        if bad:
            order = sorted(bad)
            bad_msgs = [
                Message(
                    value=lines.values[i],
                    topic=messages[lines.msg_index[i]].topic,
                    partition=messages[lines.msg_index[i]].partition,
                    offset=messages[lines.msg_index[i]].offset,
                    write_time_ns=messages[lines.msg_index[i]].write_time_ns,
                )
                for i in order
            ]
            result.unparsed = unparsed_batch(
                bad_msgs, [bad[i] for i in order]
            )
        return result


def _infer_type(v: Any) -> CanonicalType:
    if isinstance(v, bool):
        return CanonicalType.BOOLEAN
    if isinstance(v, int):
        return CanonicalType.INT64
    if isinstance(v, float):
        return CanonicalType.DOUBLE
    if isinstance(v, str):
        return CanonicalType.UTF8
    return CanonicalType.ANY


def _coerce(data: dict[str, list], schema: TableSchema) -> dict[str, list]:
    """Best-effort scalar coercion to the declared types."""
    out = {}
    for name, values in data.items():
        cs = schema.find(name)
        if cs is None:
            continue
        t = cs.data_type
        if t.is_numeric or t in (CanonicalType.DATETIME,
                                 CanonicalType.TIMESTAMP,
                                 CanonicalType.DATE):
            def conv(v):
                if v is None or isinstance(v, (int, float)):
                    return v
                try:
                    return float(v) if t.is_float else int(v)
                except (TypeError, ValueError):
                    return None
            out[name] = [conv(v) for v in values]
        elif t == CanonicalType.BOOLEAN:
            out[name] = [
                None if v is None else
                (v if isinstance(v, bool) else str(v).lower() == "true")
                for v in values
            ]
        else:
            out[name] = values
    return out


_TSKV_UNESCAPE = {"t": "\t", "n": "\n", "r": "\r", "0": "\0",
                  "\\": "\\", "=": "="}
_TSKV_ESCAPE = re.compile(r"\\(.)")


@register_parser("tskv")
class TskvParser(GenericJsonParser):
    """TSKV (tab-separated key=value) lines -> the same output contract."""

    def _decode_rows(self, values: list[bytes]) -> list[Optional[dict]]:
        out: list[Optional[dict]] = []
        for line in values:
            try:
                text = line.decode("utf-8")
                if text.startswith("tskv\t"):
                    text = text[5:]
                row: dict[str, Any] = {}
                for pair in text.split("\t"):
                    if not pair:
                        continue
                    if "=" not in pair:
                        raise ValueError(f"no '=' in {pair!r}")
                    k, v = pair.split("=", 1)
                    # single-pass unescape: sequential .replace corrupts
                    # escaped backslashes followed by t/n
                    row[k] = _TSKV_ESCAPE.sub(
                        lambda m: _TSKV_UNESCAPE.get(m.group(1), m.group(1)),
                        v,
                    )
                out.append(row if row else None)
            except (ValueError, UnicodeDecodeError):
                out.append(None)
        return out
