"""Table splitter (the port's copy of
``transferia_tpu/tasks/table_splitter.py``).

Splits tables into parallel parts when the source storage implements
ShardingStorage and the destination accepts sharded writes; sorts parts
big-first so stragglers start early.
"""

from __future__ import annotations

import logging

from transferia_tpu_torch.abstract.interfaces import ShardingStorage, Storage
from transferia_tpu_torch.abstract.table import (
    OperationTablePart,
    TableDescription,
)
from transferia_tpu_torch.models.endpoint import capability

logger = logging.getLogger(__name__)


def split_tables(storage: Storage, tables: list[TableDescription],
                 transfer, operation_id: str) -> list[OperationTablePart]:
    """Build the operation part queue for a snapshot."""
    shardeable_dst = capability(transfer.dst, "is_shardeable", True)
    parts: list[OperationTablePart] = []
    for td in tables:
        descriptions = [td]
        if shardeable_dst and isinstance(storage, ShardingStorage):
            try:
                descriptions = storage.shard_table(td) or [td]
            except Exception as e:  # non-fatal: load the table whole
                logger.warning("shard_table(%s) failed, loading whole: %s",
                               td.id, e)
                descriptions = [td]
        n = len(descriptions)
        for i, d in enumerate(descriptions):
            parts.append(OperationTablePart(
                operation_id=operation_id,
                table_id=d.id,
                filter=d.filter,
                offset=d.offset,
                part_index=i,
                parts_count=n,
                eta_rows=d.eta_rows,
            ))
    parts.sort(key=lambda p: -p.eta_rows)  # big first
    return parts
