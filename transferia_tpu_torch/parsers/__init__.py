"""Parsers: queue payloads -> columnar batches (the port's copy of
``transferia_tpu/parsers/``).

`do_batch` is the primary API and returns ColumnBatches: a whole message
batch decodes at once.  Rows that fail to parse are routed to the
`_unparsed` system table, never dropped.  The port ships the generic
JSON/TSKV parser, the blank (raw) parser, the Debezium parser and the
Confluent schema-registry parser (JSON schema and Avro); CloudEvents,
protobuf and native parsers wait (ROADMAP.md A10).
"""

from transferia_tpu_torch.parsers.base import (
    UNPARSED_TABLE,
    Message,
    ParseResult,
    Parser,
    unparsed_batch,
)
from transferia_tpu_torch.parsers.registry import make_parser, register_parser

import transferia_tpu_torch.parsers.plugins  # noqa: F401,E402  (self-registration)

__all__ = [
    "Message",
    "ParseResult",
    "Parser",
    "UNPARSED_TABLE",
    "unparsed_batch",
    "make_parser",
    "register_parser",
]
