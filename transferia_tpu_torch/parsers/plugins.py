"""Parser plugins beyond the generic JSON/TSKV pair (the port's copy of
the blank parser of ``transferia_tpu/parsers/plugins.py``; the Debezium,
CloudEvents, native, audit-trail, cloud-logging, protobuf and
schema-registry parsers wait: ROADMAP.md A5)."""

from __future__ import annotations

from typing import Sequence

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.parsers.base import Message, ParseResult, Parser
from transferia_tpu_torch.parsers.registry import register_parser

import transferia_tpu_torch.parsers.generic  # noqa: F401  (registers json/tskv)

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
