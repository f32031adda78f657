"""Serializer implementations (the port's copy of
``transferia_tpu/serializers/formats.py``): the json, csv and raw batch
serializers and the json, native, debezium and mirror queue serializers.

The parquet serializer writes through pyarrow in the reference; the port
may not import pyarrow, so it raises NotImplementedError (ROADMAP.md A7,
the blocked list).
"""

from __future__ import annotations

import abc
import csv
import io
import json
from typing import Any, Optional

from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.interfaces import Batch, is_columnar


def _rows_of(batch: Batch) -> list[ChangeItem]:
    if is_columnar(batch):
        return batch.to_rows()
    return [it for it in batch if it.is_row_event()]


class BatchSerializer(abc.ABC):
    """Whole-batch byte encoder."""

    @abc.abstractmethod
    def serialize(self, batch: Batch) -> bytes:
        ...


class JsonSerializer(BatchSerializer):
    """JSON lines of row value maps."""

    def __init__(self, add_meta: bool = False):
        self.add_meta = add_meta

    def serialize(self, batch: Batch) -> bytes:
        buf = io.BytesIO()
        for it in _rows_of(batch):
            row: dict[str, Any] = it.as_dict()
            if self.add_meta:
                row = {"__kind": it.kind.value,
                       "__table": str(it.table_id), **row}
            buf.write(json.dumps(row, separators=(",", ":"),
                                 default=_json_default).encode())
            buf.write(b"\n")
        return buf.getvalue()


def _json_default(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", errors="replace")
    return str(v)


class CsvSerializer(BatchSerializer):
    """RFC-4180 CSV."""

    def __init__(self, header: bool = False, delimiter: str = ","):
        self.header = header
        self.delimiter = delimiter

    def serialize(self, batch: Batch) -> bytes:
        out = io.StringIO()
        w = csv.writer(out, delimiter=self.delimiter, lineterminator="\n")
        rows = _rows_of(batch)
        if not rows:
            return b""
        if self.header:
            w.writerow(rows[0].column_names)
        for it in rows:
            w.writerow([
                v.decode("utf-8", "replace") if isinstance(v, bytes)
                else ("" if v is None else v)
                for v in it.column_values
            ])
        return out.getvalue().encode()


class ParquetSerializer(BatchSerializer):
    """Parquet files: the reference encodes through pyarrow, which the
    port may not import, so constructing one raises."""

    def __init__(self, compression: str = "snappy"):
        raise NotImplementedError(
            "the parquet serializer writes through pyarrow, which "
            "transferia_tpu_torch may not import (ROADMAP.md A7, blocked)")

    def serialize(self, batch: Batch) -> bytes:
        raise NotImplementedError


class RawSerializer(BatchSerializer):
    """First column's raw bytes, newline-joined."""

    def __init__(self, column: str = "data"):
        self.column = column

    def serialize(self, batch: Batch) -> bytes:
        out = io.BytesIO()
        for it in _rows_of(batch):
            v = it.value(self.column)
            if v is None and it.column_values:
                v = it.column_values[0]
            if isinstance(v, str):
                v = v.encode()
            out.write(v or b"")
            out.write(b"\n")
        return out.getvalue()


class QueueSerializer(abc.ABC):
    """Per-row (key, value) pairs for message brokers."""

    @abc.abstractmethod
    def serialize_messages(self, batch: Batch
                           ) -> list[tuple[bytes, Optional[bytes]]]:
        ...


class JsonQueueSerializer(QueueSerializer):
    def serialize_messages(self, batch):
        out = []
        for it in _rows_of(batch):
            key = json.dumps(
                {c.name: it.value(c.name)
                 for c in (it.table_schema.key_columns()
                           if it.table_schema else [])},
                separators=(",", ":"), default=_json_default,
            ).encode()
            value = json.dumps(it.as_dict(), separators=(",", ":"),
                               default=_json_default).encode()
            out.append((key, value))
        return out


class NativeQueueSerializer(QueueSerializer):
    def serialize_messages(self, batch):
        return [
            (str(it.table_id).encode(),
             json.dumps(it.to_json(), separators=(",", ":"),
                        default=_json_default).encode())
            for it in _rows_of(batch)
        ]


class DebeziumQueueSerializer(QueueSerializer):
    """config: emitter params + snapshot: bool (emits op 'r' instead of
    'c' for initial-load rows, Debezium's snapshot-read marker)."""

    def __init__(self, snapshot: bool = False, **cfg):
        from transferia_tpu_torch.debezium import DebeziumEmitter

        self.emitter = DebeziumEmitter(**cfg)
        self.snapshot = snapshot

    def serialize_messages(self, batch):
        return self.emitter.emit_batch(batch, snapshot=self.snapshot)


class MirrorQueueSerializer(QueueSerializer):
    """Raw pass-through for queue mirroring (the key/data columns of the
    blank parser's RAW_SCHEMA)."""

    def serialize_messages(self, batch):
        out = []
        for it in _rows_of(batch):
            key = it.value("key") or b""
            data = it.value("data") or b""
            if isinstance(key, str):
                key = key.encode()
            if isinstance(data, str):
                data = data.encode()
            out.append((key, data))
        return out


_SERIALIZERS = {
    "json": JsonSerializer,
    "csv": CsvSerializer,
    "parquet": ParquetSerializer,
    "raw": RawSerializer,
}


def _raw_column_queue_serializer(**cfg):
    from transferia_tpu_torch.serializers.batch import (
        RawColumnQueueSerializer,
    )

    return RawColumnQueueSerializer(**cfg)


_QUEUE_SERIALIZERS = {
    "json": JsonQueueSerializer,
    "native": NativeQueueSerializer,
    "debezium": DebeziumQueueSerializer,
    "mirror": MirrorQueueSerializer,
    "raw_column": _raw_column_queue_serializer,
}


def make_serializer(fmt: str, concurrency: int = 1,
                    threshold: int = 0, **cfg) -> BatchSerializer:
    """Build a serializer; concurrency > 1 wraps row-shaped formats in the
    threshold-gated parallel chunker.  Parquet is a whole-file format
    and is never wrapped."""
    if fmt not in _SERIALIZERS:
        raise KeyError(
            f"unknown serializer {fmt!r}; known: {sorted(_SERIALIZERS)}"
        )
    inner = _SERIALIZERS[fmt](**cfg)
    # whole-file formats and headered csv must not be chunk-concatenated
    # (every chunk would re-emit the header mid-file)
    unwrappable = fmt == "parquet" or (fmt == "csv" and cfg.get("header"))
    if concurrency > 1 and not unwrappable:
        from transferia_tpu_torch.serializers.batch import (
            DEFAULT_THRESHOLD,
            ConcurrentBatchSerializer,
        )

        return ConcurrentBatchSerializer(
            inner, concurrency=concurrency,
            threshold=threshold or DEFAULT_THRESHOLD)
    return inner


def make_queue_serializer(fmt: str, threads: int = 1,
                          threshold: int = 0, **cfg) -> QueueSerializer:
    """Build a queue serializer; threads > 1 returns the ordered parallel
    wrapper with one inner serializer per worker."""
    if fmt not in _QUEUE_SERIALIZERS:
        raise KeyError(
            f"unknown queue serializer {fmt!r}; known: "
            f"{sorted(_QUEUE_SERIALIZERS)}"
        )
    if threads > 1:
        from transferia_tpu_torch.serializers.batch import (
            DEFAULT_THRESHOLD,
            ConcurrentQueueSerializer,
        )

        return ConcurrentQueueSerializer(
            lambda: _QUEUE_SERIALIZERS[fmt](**cfg),
            concurrency=threads,
            threshold=threshold or DEFAULT_THRESHOLD)
    return _QUEUE_SERIALIZERS[fmt](**cfg)
