"""Type conversion transformers (the port's copy of
``transferia_tpu/transform/plugins/convert.py``): to_string,
number_to_float, to_datetime."""

from __future__ import annotations

from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    _offsets_from_lengths,
)
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


def _stringify_column(col: Column) -> Column:
    """Vectorized fixed-width -> utf8 conversion."""
    if col.offsets is not None:
        if col.ctype == CanonicalType.UTF8:
            return col
        return Column(col.name, CanonicalType.UTF8, col.data, col.offsets,
                      col.validity)
    if col.ctype == CanonicalType.BOOLEAN:
        strs = np.where(col.data, "true", "false").astype("U5")
    elif col.ctype.is_float:
        strs = col.data.astype("U32")
    else:
        strs = col.data.astype("U24")
    if col.validity is not None:
        strs = np.where(col.validity, strs, "")
    encoded = np.char.encode(strs, "utf-8")
    lens = np.char.str_len(strs) if encoded.dtype.itemsize == 0 else np.array(
        [len(s) for s in encoded], dtype=np.int64
    )
    offsets = _offsets_from_lengths(lens)
    data = np.frombuffer(b"".join(encoded.tolist()), dtype=np.uint8).copy() \
        if len(encoded) else np.zeros(0, dtype=np.uint8)
    return Column(col.name, CanonicalType.UTF8, data, offsets, col.validity)


@register_transformer("to_string")
class ToString(Transformer):
    """Convert columns to utf8 strings (registry/to_string)."""

    def __init__(self, columns: Optional[list[str]] = None,
                 tables: Optional[list[str]] = None):
        self.columns = columns  # None = all convertible
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def _match(self, table: TableID) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    def _targets(self, schema: TableSchema) -> list[str]:
        if self.columns is not None:
            return [c for c in self.columns if schema.find(c) is not None]
        return [c.name for c in schema
                if c.data_type != CanonicalType.UTF8]

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return self._match(table) and bool(self._targets(schema))

    def result_schema(self, schema: TableSchema) -> TableSchema:
        return schema.with_types({
            c: CanonicalType.UTF8 for c in self._targets(schema)
        })

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = dict(batch.columns)
        for name in self._targets(batch.schema):
            if name in cols:
                cols[name] = _stringify_column(cols[name])
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )


@register_transformer("number_to_float")
class NumberToFloat(Transformer):
    """Integer columns -> double (registry/number_to_float; CH compat)."""

    def __init__(self, tables: Optional[list[str]] = None):
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def _match(self, table: TableID) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return self._match(table) and any(
            c.data_type.is_integer for c in schema
        )

    def result_schema(self, schema: TableSchema) -> TableSchema:
        return schema.with_types({
            c.name: CanonicalType.DOUBLE
            for c in schema if c.data_type.is_integer
        })

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = dict(batch.columns)
        for name, col in batch.columns.items():
            if col.ctype.is_integer:
                cols[name] = Column(
                    name, CanonicalType.DOUBLE,
                    col.data.astype(np.float64), None, col.validity,
                )
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )


@register_transformer("to_datetime")
class ToDatetime(Transformer):
    """Numeric epoch columns -> datetime/timestamp (registry/to_datetime).

    config: columns: [...], unit: s|ms|us|ns (input unit, default s)
    """

    _DIV = {"s": (CanonicalType.DATETIME, 1),
            "ms": (CanonicalType.TIMESTAMP, 1_000),
            "us": (CanonicalType.TIMESTAMP, 1),
            "ns": (CanonicalType.TIMESTAMP, 1_000)}

    def __init__(self, columns: list[str], unit: str = "s",
                 tables: Optional[list[str]] = None):
        if unit not in self._DIV:
            raise ValueError(f"to_datetime: bad unit {unit!r}")
        self.columns = columns
        self.unit = unit
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def _match(self, table: TableID) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return self._match(table) and any(
            (c := schema.find(name)) is not None and c.data_type.is_numeric
            for name in self.columns
        )

    def result_schema(self, schema: TableSchema) -> TableSchema:
        ctype, _ = self._DIV[self.unit]
        return schema.with_types({
            name: ctype for name in self.columns
            if (c := schema.find(name)) is not None and c.data_type.is_numeric
        })

    def apply(self, batch: ColumnBatch) -> TransformResult:
        ctype, scale = self._DIV[self.unit]
        cols = dict(batch.columns)
        for name in self.columns:
            col = cols.get(name)
            if col is None or not col.ctype.is_numeric:
                continue
            vals = col.data.astype(np.int64)
            if self.unit == "ms":
                vals = vals * 1_000
            elif self.unit == "ns":
                vals = vals // 1_000
            cols[name] = Column(name, ctype, vals, None, col.validity)
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )
