"""DBLog-style incremental snapshot: chunked reads interleaved with live
CDC (the port's copy of ``transferia_tpu/dblog/``).  Used when a huge
table must snapshot while its replication stream keeps flowing, without
a long-held consistent read transaction.

Algorithm (per chunk):
  1. write LOW watermark to the signal table (appears in the WAL stream)
  2. SELECT the next chunk by PK order (past the last cursor)
  3. write HIGH watermark
  4. rows whose PKs were touched by WAL events observed between LOW and
     HIGH are dropped from the chunk (the live event is newer); the rest
     push as snapshot inserts
"""

from transferia_tpu_torch.dblog.core import (
    ChunkIterator,
    DBLogSnapshot,
    SignalTable,
    Watermark,
    WatermarkKind,
)

__all__ = [
    "ChunkIterator",
    "DBLogSnapshot",
    "SignalTable",
    "Watermark",
    "WatermarkKind",
]
