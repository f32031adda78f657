"""Debug logging transformer (the port's copy of
``transferia_tpu/transform/plugins/logger_tf.py``): logger."""

from __future__ import annotations

import logging

from transferia_tpu_torch.abstract.schema import TableID, TableSchema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.registry import register_transformer

logger = logging.getLogger("transferia_tpu_torch.transform.logger")


@register_transformer("logger")
class LoggerTransformer(Transformer):
    """Logs batch summaries (and optionally sample rows) as they flow.

    config: sample_rows: int = 0; level: "info"|"debug"
    """

    def __init__(self, sample_rows: int = 0, level: str = "info"):
        self.sample_rows = sample_rows
        self.level = logging.DEBUG if level == "debug" else logging.INFO

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        return True

    def apply(self, batch: ColumnBatch) -> TransformResult:
        logger.log(self.level, "batch %s: %d rows, %d cols, %d bytes",
                   batch.table_id, batch.n_rows, len(batch.columns),
                   batch.nbytes())
        if self.sample_rows:
            for row in batch.slice(0, self.sample_rows).to_rows():
                logger.log(self.level, "  row: %s", row.as_dict())
        return TransformResult(batch)
