"""Table/column rename transformers (registry/rename, registry/filter).

The port's copy of transferia_tpu/transform/plugins/rename.py.  Both
run on the host: they rebind names and move no column bytes.  A rename
is opaque to plan-time fusion (transform/fused.py), so a mask_field that
follows it still fuses into its own device step, as in the reference.
"""

from __future__ import annotations

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer


@register_transformer("rename_tables")
class RenameTables(Transformer):
    """Renames tables (pkg/transformer/registry/rename).

    config: tables: [{from: "ns.name", to: "ns2.name2"}, ...]
    """

    def __init__(self, tables: list[dict]):
        self.mapping: dict[TableID, TableID] = {
            TableID.parse(t["from"]): TableID.parse(t["to"])
            for t in tables
        }

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return table in self.mapping

    def result_table(self, table: TableID) -> TableID:
        return self.mapping.get(table, table)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        return TransformResult(
            batch.rename_table(self.mapping[batch.table_id])
        )


@register_transformer("rename_columns")
class RenameColumns(Transformer):
    """Renames columns within matching tables.

    config: columns: {old: new, ...}; tables: optional include list
    """

    def __init__(self, columns: dict[str, str],
                 tables: list[str] | None = None):
        self.columns = columns
        self.tables = [TableID.parse(t) for t in tables] if tables else None

    def _table_match(self, table: TableID) -> bool:
        if self.tables is None:
            return True
        return any(table.include_matches(p) for p in self.tables)

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return self._table_match(table) and any(
            schema.find(old) for old in self.columns
        )

    def result_schema(self, schema: TableSchema) -> TableSchema:
        return schema.rename(self.columns)

    def apply(self, batch: ColumnBatch) -> TransformResult:
        cols = {}
        for name, col in batch.columns.items():
            new = self.columns.get(name, name)
            cols[new] = col.renamed(new) if new != name else col
        return TransformResult(
            batch.with_columns(cols, self.result_schema(batch.schema))
        )
