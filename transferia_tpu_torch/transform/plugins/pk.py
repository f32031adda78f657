"""Primary-key manipulation (the port's copy of
``transferia_tpu/transform/plugins/pk.py``): replace_primary_key."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


@register_transformer("replace_primary_key")
class ReplacePrimaryKey(Transformer):
    """Re-declare the primary key columns (registry/replace_primary_key).

    config: keys: [...], tables: optional include list.
    """

    def __init__(self, keys: list[str], tables: Optional[list[str]] = None):
        self.keys = keys
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def _match(self, table: TableID) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return self._match(table) and all(
            schema.find(k) is not None for k in self.keys
        )

    def result_schema(self, schema: TableSchema) -> TableSchema:
        keyset = set(self.keys)
        # key columns first, preserving declared key order (reference parity)
        keyed = [replace(schema.find(k), primary_key=True, required=True)
                 for k in self.keys]
        rest = [replace(c, primary_key=False)
                for c in schema if c.name not in keyset]
        return TableSchema(keyed + rest)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        schema = self.result_schema(batch.schema)
        cols = {c.name: batch.columns[c.name] for c in schema
                if c.name in batch.columns}
        return TransformResult(batch.with_columns(cols, schema))
