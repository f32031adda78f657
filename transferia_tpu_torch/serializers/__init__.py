"""Serializers: batches -> bytes (the port's copy of
``transferia_tpu/serializers/``).

Two shapes: `BatchSerializer.serialize(batch) -> bytes` for object and
file sinks (json/csv/raw; parquet raises NotImplementedError, it needs
pyarrow), and `QueueSerializer.serialize_messages(batch) -> [(key,
value)]` for message-broker sinks (json/native/debezium/mirror/
raw_column).
"""

from transferia_tpu_torch.serializers.batch import (
    BufferPool,
    ConcurrentBatchSerializer,
    ConcurrentQueueSerializer,
    RawColumnQueueSerializer,
)
from transferia_tpu_torch.serializers.formats import (
    BatchSerializer,
    CsvSerializer,
    JsonSerializer,
    ParquetSerializer,
    QueueSerializer,
    RawSerializer,
    make_queue_serializer,
    make_serializer,
)

__all__ = [
    "BatchSerializer",
    "BufferPool",
    "ConcurrentBatchSerializer",
    "ConcurrentQueueSerializer",
    "CsvSerializer",
    "JsonSerializer",
    "ParquetSerializer",
    "QueueSerializer",
    "RawColumnQueueSerializer",
    "RawSerializer",
    "make_serializer",
    "make_queue_serializer",
]
