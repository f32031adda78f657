"""Parser contracts (the port's copy of ``transferia_tpu/parsers/base.py``)."""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch

# System table receiving unparseable rows.
UNPARSED_TABLE = TableID("", "_unparsed")

UNPARSED_SCHEMA = TableSchema([
    ColSchema("_timestamp", CanonicalType.TIMESTAMP),
    ColSchema("_partition", CanonicalType.UTF8, primary_key=True),
    ColSchema("_offset", CanonicalType.UINT64, primary_key=True),
    ColSchema("_idx", CanonicalType.UINT32, primary_key=True),
    ColSchema("unparsed_row", CanonicalType.STRING),
    ColSchema("reason", CanonicalType.UTF8),
])


@dataclass(frozen=True)
class Message:
    """One queue message."""

    value: bytes
    key: bytes = b""
    topic: str = ""
    partition: int = 0
    offset: int = 0
    write_time_ns: int = 0
    headers: tuple = ()


@dataclass
class ParseResult:
    """do_batch output: parsed columnar blocks + unparsed leftovers."""

    batches: list[ColumnBatch] = field(default_factory=list)
    unparsed: Optional[ColumnBatch] = None

    def row_count(self) -> int:
        return sum(b.n_rows for b in self.batches)


class Parser(abc.ABC):
    """Payload decoder: one decode per message batch."""

    TYPE = ""

    @abc.abstractmethod
    def do_batch(self, messages: Sequence[Message]) -> ParseResult:
        ...

def unparsed_batch(messages: Sequence[Message],
                   reasons: Sequence[str]) -> ColumnBatch:
    """Build the `_unparsed` block for failed messages."""
    n = len(messages)
    now = time.time_ns() // 1000
    return ColumnBatch.from_pydict(
        UNPARSED_TABLE, UNPARSED_SCHEMA, {
            "_timestamp": [
                (m.write_time_ns // 1000) if m.write_time_ns else now
                for m in messages
            ],
            "_partition": [
                f"{m.topic}:{m.partition}" for m in messages
            ],
            "_offset": [m.offset for m in messages],
            "_idx": list(range(n)),
            "unparsed_row": [m.value for m in messages],
            "reason": list(reasons),
        }
    )
