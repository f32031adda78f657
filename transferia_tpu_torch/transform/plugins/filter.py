"""Row filter transformer (registry/filter_rows)."""

from __future__ import annotations

from typing import Optional

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.predicate import compile_mask, parse
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


@register_transformer("filter_rows")
class FilterRows(Transformer):
    """WHERE-predicate row filter (registry/filter_rows/filter_rows.go:22-40).

    config: filter: "price > 100 AND category IN ('a','b')";
            tables: optional include list.
    Evaluates one vectorized mask per batch.
    """

    def __init__(self, filter: str, tables: Optional[list[str]] = None):
        self.text = filter
        self.node = parse(filter)
        self.mask_fn = compile_mask(self.node)
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        if self.tables is not None and not any(
                table.include_matches(p) for p in self.tables):
            return False
        return self.node.columns() <= set(schema.names())

    def apply(self, batch: ColumnBatch) -> TransformResult:
        mask = self.mask_fn(batch)
        if mask.all():
            return TransformResult(batch)
        return TransformResult(batch.filter(mask))

    def describe(self) -> str:
        return f"filter_rows({self.text})"
