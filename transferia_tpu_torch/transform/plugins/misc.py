"""The remaining host transformer plugins (the port's copy of
``transferia_tpu/transform/plugins/misc.py``): batch_splitter, custom,
jsonparser, problem_item_detector, raw_doc_grouper (and
raw_cdc_doc_grouper), mongo_pk_extender, regex_replace and yt_dict.
"""

from __future__ import annotations

import json
import re
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.transform.base import (
    TransformResult,
    Transformer,
    error_batch,
)
from transferia_tpu_torch.transform.registry import register_transformer


def _tables_opt(tables):
    return [TableID.parse(t) for t in tables] if tables else None


def _match(patterns, table: TableID) -> bool:
    if patterns is None:
        return True
    return any(table.include_matches(p) for p in patterns)


@register_transformer("batch_splitter")
class BatchSplitter(Transformer):
    """Caps batch size (registry/batch_splitter): oversized blocks split
    into <= max_rows chunks (delivered via the chain's multi-output path)."""

    def __init__(self, max_rows: int = 10_000,
                 tables: Optional[list[str]] = None):
        self.max_rows = max_rows
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        if batch.n_rows <= self.max_rows:
            return TransformResult(batch)
        from transferia_tpu_torch.transform.chain import MultiBatch

        parts = [
            batch.slice(i, i + self.max_rows)
            for i in range(0, batch.n_rows, self.max_rows)
        ]
        return TransformResult(MultiBatch(parts))


@register_transformer("regex_replace")
class RegexReplace(Transformer):
    """Regex substitution on string columns (registry/regex_replace)."""

    def __init__(self, columns: list[str], pattern: str, replacement: str,
                 tables: Optional[list[str]] = None):
        self.columns = columns
        self.rx = re.compile(pattern)
        self.replacement = replacement
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and any(
            (c := schema.find(name)) is not None
            and c.data_type.is_variable_width
            for name in self.columns
        )

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = dict(batch.columns)
        for name in self.columns:
            col = cols.get(name)
            if col is None or col.offsets is None:
                continue
            vals = col.to_pylist()
            out = [
                None if v is None else self.rx.sub(
                    self.replacement,
                    v if isinstance(v, str)
                    else v.decode("utf-8", "replace"),
                )
                for v in vals
            ]
            cols[name] = Column.from_pylist(name, col.ctype, out)
        return TransformResult(batch.with_columns(cols))


@register_transformer("jsonparser")
class JsonParserTransformer(Transformer):
    """Expands a JSON string column into schema fields
    (registry/jsonparser)."""

    def __init__(self, column: str, fields: list[dict],
                 keep_source: bool = False,
                 tables: Optional[list[str]] = None):
        self.column = column
        self.fields = [
            ColSchema(f["name"], CanonicalType(f.get("type", "any")),
                      primary_key=bool(f.get("key", False)),
                      path=f.get("path", ""))
            for f in fields
        ]
        self.keep_source = keep_source
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and \
            schema.find(self.column) is not None

    def result_schema(self, schema: TableSchema) -> TableSchema:
        base = schema if self.keep_source else schema.drop([self.column])
        return base.append(*self.fields)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        col = batch.column(self.column)
        parsed: list[Optional[dict]] = []
        bad = np.zeros(batch.n_rows, dtype=np.bool_)
        for i in range(batch.n_rows):
            v = col.value(i)
            if isinstance(v, dict):
                parsed.append(v)
                continue
            try:
                obj = json.loads(v) if v is not None else None
                if obj is not None and not isinstance(obj, dict):
                    raise ValueError("not an object")
                parsed.append(obj)
            except (ValueError, TypeError):
                parsed.append(None)
                bad[i] = True
        good = batch.filter(~bad) if bad.any() else batch
        good_rows = [p for p, b in zip(parsed, bad) if not b]
        cols = dict(good.columns)
        if not self.keep_source:
            cols.pop(self.column, None)
        for f in self.fields:
            path = f.path.split(".") if f.path else [f.name]

            def get(r):
                cur = r
                for p in path:
                    if not isinstance(cur, dict) or p not in cur:
                        return None
                    cur = cur[p]
                return cur

            cols[f.name] = Column.from_pylist(
                f.name, f.data_type,
                [None if r is None else get(r) for r in good_rows],
            )
        out = good.with_columns(cols, self.result_schema(batch.schema))
        errors = error_batch(batch, bad, "jsonparser: invalid JSON") \
            if bad.any() else None
        return TransformResult(out, errors)


@register_transformer("problem_item_detector")
class ProblemItemDetector(Transformer):
    """Flags rows violating declared schema constraints
    (registry/problem_item_detector): required columns that are NULL."""

    def __init__(self, drop: bool = False,
                 tables: Optional[list[str]] = None):
        self.drop = drop
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and any(
            c.required or c.primary_key for c in schema
        )

    def apply(self, batch: ColumnBatch) -> TransformResult:
        bad = np.zeros(batch.n_rows, dtype=np.bool_)
        for c in batch.schema:
            if not (c.required or c.primary_key):
                continue
            col = batch.columns.get(c.name)
            if col is not None and col.validity is not None:
                bad |= ~col.validity
        if not bad.any():
            return TransformResult(batch)
        good = batch.filter(~bad)
        errors = None if self.drop else error_batch(
            batch, bad, "problem_item_detector: null in required column"
        )
        return TransformResult(good, errors)


@register_transformer("raw_doc_grouper")
class RawDocGrouper(Transformer):
    """Collapses rows into (keys..., doc) documents
    (registry/raw_doc_grouper): non-key columns fold into one JSON doc
    column; raw_cdc_doc_grouper additionally keeps CDC metadata."""

    def __init__(self, keys: list[str], doc_column: str = "doc",
                 include_cdc_meta: bool = False,
                 tables: Optional[list[str]] = None):
        self.keys = keys
        self.doc_column = doc_column
        self.include_cdc_meta = include_cdc_meta
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and all(
            schema.find(k) is not None for k in self.keys
        )

    def result_schema(self, schema: TableSchema) -> TableSchema:
        from dataclasses import replace

        keyed = [replace(schema.find(k), primary_key=True)
                 for k in self.keys]
        extra = [ColSchema(self.doc_column, CanonicalType.ANY)]
        if self.include_cdc_meta:
            extra.append(ColSchema("__lsn", CanonicalType.INT64))
            extra.append(ColSchema("__kind", CanonicalType.UTF8))
        return TableSchema(keyed + extra)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        data = batch.to_pydict()
        n = batch.n_rows
        docs = []
        for i in range(n):
            doc = {
                k: v[i] for k, v in data.items() if k not in self.keys
            }
            docs.append({
                k: (v.decode("utf-8", "replace")
                    if isinstance(v, bytes) else v)
                for k, v in doc.items()
            })
        cols = {
            k: batch.columns[k] for k in self.keys
        }
        cols[self.doc_column] = Column.from_pylist(
            self.doc_column, CanonicalType.ANY, docs
        )
        if self.include_cdc_meta:
            lsns = batch.lsns if batch.lsns is not None \
                else np.zeros(n, dtype=np.int64)
            cols["__lsn"] = Column("__lsn", CanonicalType.INT64,
                                   np.asarray(lsns, dtype=np.int64))
            kinds = [batch.kind_at(i).value for i in range(n)]
            cols["__kind"] = Column.from_pylist(
                "__kind", CanonicalType.UTF8, kinds
            )
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )


@register_transformer("raw_cdc_doc_grouper")
def _raw_cdc_doc_grouper(cfg: dict) -> Transformer:
    cfg = dict(cfg or {})
    cfg["include_cdc_meta"] = True
    return RawDocGrouper(**cfg)


@register_transformer("mongo_pk_extender")
class MongoPkExtender(Transformer):
    """Promotes fields of an _id document into top-level key columns
    (registry/mongo_pk_extender)."""

    def __init__(self, id_column: str = "_id",
                 fields: Optional[list[str]] = None,
                 tables: Optional[list[str]] = None):
        self.id_column = id_column
        self.fields = fields or []
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and \
            schema.find(self.id_column) is not None and bool(self.fields)

    def result_schema(self, schema: TableSchema) -> TableSchema:
        return schema.append(*[
            ColSchema(f, CanonicalType.UTF8, primary_key=True)
            for f in self.fields
        ])

    def apply(self, batch: ColumnBatch) -> TransformResult:
        col = batch.column(self.id_column)
        cols = dict(batch.columns)
        ids = [col.value(i) for i in range(batch.n_rows)]
        for f in self.fields:
            cols[f] = Column.from_pylist(
                f, CanonicalType.UTF8,
                [
                    str(v.get(f)) if isinstance(v, dict) and f in v
                    else None
                    for v in ids
                ],
            )
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )


@register_transformer("custom")
def _custom(cfg: dict) -> Transformer:
    """Alias of the lambda transformer (registry/custom): user code by
    dotted path."""
    from transferia_tpu_torch.transform.plugins.lambda_tf import (
        LambdaTransformer,
    )

    return LambdaTransformer(**cfg)


@register_transformer("yt_dict")
class YtDictTransformer(Transformer):
    """YT dict/any normalization (registry/yt_dict): stringifies ANY
    columns into canonical YSON-ish JSON for YT static tables."""

    def __init__(self, tables: Optional[list[str]] = None):
        self.tables = _tables_opt(tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return _match(self.tables, table) and any(
            c.data_type == CanonicalType.ANY for c in schema
        )

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = dict(batch.columns)
        for c in batch.schema:
            if c.data_type != CanonicalType.ANY:
                continue
            col = cols.get(c.name)
            if col is None:
                continue
            vals = col.to_pylist()
            cols[c.name] = Column.from_pylist(
                c.name, CanonicalType.UTF8,
                [
                    None if v is None else
                    (v if isinstance(v, str)
                     else json.dumps(v, sort_keys=True, default=str))
                    for v in vals
                ],
            )
        schema = batch.schema.with_types({
            c.name: CanonicalType.UTF8 for c in batch.schema
            if c.data_type == CanonicalType.ANY
        })
        return TransformResult(batch.with_columns(cols, schema))
