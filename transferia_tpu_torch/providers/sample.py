"""Synthetic sample provider — the built-in load generator (the port's
copy of ``transferia_tpu/providers/sample.py``).

Generates deterministic columnar batches directly, born device-ready.
Presets `iot` and `users`; `dict_encode` emits the low-cardinality utf8
columns (iot status/device_id, users country) as dictionary columns over
one pool per (preset, column) and process, byte-identical to the flat
emission when materialized.  `SampleReplicationSource` is the
Kafka-free INCREMENT_ONLY source: an endless insert stream.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from transferia_tpu_torch.abstract.interfaces import (
    AsyncSink,
    Pusher,
    ShardingStorage,
    Source,
    Storage,
    TableInfo,
)
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
    new_table_schema,
)
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    DictEnc,
    DictPool,
    _offsets_from_lengths,
)
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.runtime import lockwatch
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.typesystem.rules import register_source_rules


@register_endpoint
@dataclass
class SampleSourceParams(EndpointParams):
    PROVIDER = "sample"
    IS_SOURCE = True

    preset: str = "iot"          # iot | users
    table: str = "events"
    rows: int = 100_000          # snapshot rows
    batch_rows: int = 16_384
    rate: float = 0.0            # replication rows/sec, 0 = unthrottled
    replication_batch: int = 1024
    seed: int = 7
    shard_parts: int = 0         # >0: advertise ShardingStorage parts
    dict_encode: bool = False


_IOT_SCHEMA = new_table_schema([
    ("event_id", "int64", True),
    ("device_id", "utf8"),
    ("ts", "timestamp"),
    ("temperature", "double"),
    ("humidity", "double"),
    ("status", "utf8"),
])

_USERS_SCHEMA = new_table_schema([
    ("user_id", "int64", True),
    ("name", "utf8"),
    ("email", "utf8"),
    ("age", "int32"),
    ("score", "double"),
    ("country", "utf8"),
])

_STATUSES = np.array(["ok", "warn", "error", "offline"])
_COUNTRIES = np.array(["de", "us", "fr", "jp", "br", "in"])

register_source_rules("sample", {
    "int64": CanonicalType.INT64, "utf8": CanonicalType.UTF8,
    "timestamp": CanonicalType.TIMESTAMP, "double": CanonicalType.DOUBLE,
    "int32": CanonicalType.INT32,
})


def _utf8_column(name: str, values: np.ndarray) -> Column:
    """A var-width column from a numpy unicode array."""
    bufs = [v.encode() for v in values.tolist()]
    offsets = _offsets_from_lengths([len(b) for b in bufs])
    data = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy()
    return Column(name, CanonicalType.UTF8, data, offsets)


# one pool per (preset, column) and process, so every batch of a load
# references the same DictPool and its memos (the hexed HMAC pool, the
# fingerprint's per-entry accumulators) amortize across the transfer
_DICT_POOLS: dict[str, DictPool] = {}
_DICT_POOL_LOCK = lockwatch.named_lock("pool.sample_dict")


def _shared_pool(key: str, values: list[str]) -> DictPool:
    with _DICT_POOL_LOCK:
        pool = _DICT_POOLS.get(key)
        if pool is None:
            bufs = [v.encode() for v in values]
            data = np.frombuffer(b"".join(bufs), dtype=np.uint8).copy()
            # one extra empty-bytes sentinel entry for null rows (none in
            # the presets, but the pool contract carries it)
            off = _offsets_from_lengths([len(b) for b in bufs] + [0])
            pool = _DICT_POOLS[key] = DictPool(data, off,
                                               null_code=len(bufs))
        return pool


def _dict_column(name: str, key: str, values: list[str],
                 codes: np.ndarray) -> Column:
    return Column(name, CanonicalType.UTF8,
                  dict_enc=DictEnc(codes.astype(np.int32),
                                   pool=_shared_pool(key, values)))


def make_batch(preset: str, table: TableID, start: int, n: int,
               seed: int, dict_encode: bool = False) -> ColumnBatch:
    """Deterministic batch of n rows with ids [start, start+n), the same
    as the JAX package's `make_batch`."""
    rng = np.random.default_rng(seed + start)
    ids = np.arange(start, start + n, dtype=np.int64)
    if preset == "iot":
        dev = rng.integers(0, 1000, n)
        dev_values = ["dev-" + str(i) for i in range(1000)]
        cols = {
            "event_id": Column("event_id", CanonicalType.INT64, ids),
            "device_id": _dict_column(
                "device_id", "iot.device_id", dev_values, dev)
            if dict_encode else _utf8_column(
                "device_id",
                np.char.add("dev-", dev.astype("U6")),
            ),
            "ts": Column("ts", CanonicalType.TIMESTAMP,
                         np.int64(1_700_000_000_000_000) + ids * 1000),
            "temperature": Column(
                "temperature", CanonicalType.DOUBLE,
                np.round(rng.normal(21.0, 5.0, n), 3),
            ),
            "humidity": Column(
                "humidity", CanonicalType.DOUBLE,
                np.round(rng.uniform(0, 100, n), 3),
            ),
            "status": _dict_column(
                "status", "iot.status", _STATUSES.tolist(),
                rng.integers(0, 4, n))
            if dict_encode else _utf8_column(
                "status", _STATUSES[rng.integers(0, 4, n)].astype("U8")
            ),
        }
        return ColumnBatch(table, _IOT_SCHEMA, cols)
    if preset == "users":
        cols = {
            "user_id": Column("user_id", CanonicalType.INT64, ids),
            "name": _utf8_column(
                "name", np.char.add("user_", ids.astype("U12"))
            ),
            "email": _utf8_column(
                "email",
                np.char.add(np.char.add("u", ids.astype("U12")),
                            "@example.com"),
            ),
            "age": Column("age", CanonicalType.INT32,
                          rng.integers(18, 90, n).astype(np.int32)),
            "score": Column("score", CanonicalType.DOUBLE,
                            np.round(rng.uniform(0, 1000, n), 2)),
            "country": _dict_column(
                "country", "users.country", _COUNTRIES.tolist(),
                rng.integers(0, 6, n))
            if dict_encode else _utf8_column(
                "country", _COUNTRIES[rng.integers(0, 6, n)].astype("U4")
            ),
        }
        return ColumnBatch(table, _USERS_SCHEMA, cols)
    raise ValueError(f"sample: unknown preset {preset!r}")


def preset_schema(preset: str) -> TableSchema:
    return _IOT_SCHEMA if preset == "iot" else _USERS_SCHEMA


class SampleStorage(Storage, ShardingStorage):
    """Snapshot storage over the generator."""

    def __init__(self, params: SampleSourceParams):
        self.params = params
        self.table = TableID("sample", params.table)

    def table_list(self, include=None):
        info = TableInfo(eta_rows=self.params.rows,
                         schema=preset_schema(self.params.preset))
        tables = {self.table: info}
        if include:
            tables = {
                t: i for t, i in tables.items()
                if any(t.include_matches(p) for p in include)
            }
        return tables

    def table_schema(self, table: TableID) -> TableSchema:
        return preset_schema(self.params.preset)

    def estimate_table_rows_count(self, table: TableID) -> int:
        return self.params.rows

    def exact_table_rows_count(self, table: TableID) -> int:
        return self.params.rows

    def shard_table(self, table: TableDescription) -> list[TableDescription]:
        parts = self.params.shard_parts
        if parts <= 1:
            return [table]
        total = self.params.rows
        per = (total + parts - 1) // parts
        out = []
        for i in range(parts):
            lo = i * per
            hi = min(total, lo + per)
            if lo >= hi:
                break
            out.append(TableDescription(
                id=table.id, filter=f"rows:{lo}:{hi}", offset=lo,
                eta_rows=hi - lo,
            ))
        return out

    def load_table(self, table: TableDescription, pusher: Pusher) -> None:
        failpoint("storage.part.open")
        if table.filter.startswith("rows:"):
            _, lo_s, hi_s = table.filter.split(":")
            lo, hi = int(lo_s), int(hi_s)
        else:
            lo, hi = 0, self.params.rows
        bs = self.params.batch_rows
        for start in range(lo, hi, bs):
            n = min(bs, hi - start)
            failpoint("storage.part.read")
            sp = trace.span("source_decode")
            if sp:
                sp.add(rows=n)
            with sp:
                batch = make_batch(self.params.preset, table.id, start, n,
                                   self.params.seed,
                                   dict_encode=self.params.dict_encode)
            # synthetic data's event time is its generation instant,
            # stamped on the read path (make_batch stays deterministic)
            batch.commit_times = np.full(n, time.time_ns(),
                                         dtype=np.int64)
            pusher(batch)


class SampleReplicationSource(Source):
    """Endless insert stream (the replication mode's load generator)."""

    def __init__(self, params: SampleSourceParams):
        self.params = params
        self.table = TableID("sample", params.table)
        self._stop = threading.Event()

    def run(self, sink: AsyncSink) -> None:
        lsn = 0
        start = self.params.rows  # continue after the snapshot range
        bs = self.params.replication_batch
        futures = []
        while not self._stop.is_set():
            batch = make_batch(self.params.preset, self.table, start, bs,
                               self.params.seed)
            lsn += 1
            batch.lsns = np.full(bs, lsn, dtype=np.int64)
            batch.commit_times = np.full(bs, time.time_ns(),
                                         dtype=np.int64)
            futures.append(sink.async_push(batch))
            if len(futures) > 16:
                futures.pop(0).result()
            start += bs
            if self.params.rate > 0:
                self._stop.wait(bs / self.params.rate)
        for f in futures:
            f.result()

    def stop(self) -> None:
        self._stop.set()


@register_provider
class SampleProvider(Provider):
    NAME = "sample"

    def storage(self):
        return SampleStorage(self.transfer.src)

    def source(self):
        return SampleReplicationSource(self.transfer.src)
