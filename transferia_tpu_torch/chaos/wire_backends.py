"""Exactly-once chaos backends: one harness per staged-commit sink (the
port's copy of ``transferia_tpu/chaos/wire_backends.py``).

`run_exactly_once_trial` (chaos/runner.py) drives the same gauntlet —
torn staging writes, mid-part and mid-publish kills, zombie replay
after a real lease steal — against every staged-commit capable sink.
Each backend differs only in plumbing: how its (fake) target comes up,
what the transfer's dst params look like, how the delivered rows read
back, and how a direct sink-layer stale-epoch publish is attempted.
This module packages those four differences behind `EoBackend` so the
trial body is backend-agnostic.

The wire backends (postgres, clickhouse, kafka, s3 objects) run
against the port's own protocol fakes, `transferia_tpu_torch/recipes/
fake_{postgres,clickhouse,kafka,s3}.py`: real sockets, the port's real
provider clients, only the server side fake.  Two of the reference's
seven backends report unavailable, and the chaos matrix skips them with
a warning naming their roadmap item: `arrow_ipc` (its sink needs
pyarrow, which the port never imports) and `ydb` (the port has no YDB
provider or fake yet); both wait under ROADMAP.md A7.

A harness takes the device its sinks key staged batches on (K10 in
keys mode on a card; the plain version with `device="cpu"`).

Delivered rows are read STRAIGHT from each fake's storage (not through
a destination-storage scan) and canonicalized by `rows_to_batch`: the
reference run and the trial run read through the same function, so the
delivery audit compares like with like.
"""

from __future__ import annotations

import json
import logging

from transferia_tpu_torch.runtime.device import DeviceLike

logger = logging.getLogger(__name__)

# the reason an unavailable backend gives (run_trials logs it as the
# skip's warning and the report names it)
ARROW_IPC_BLOCKED = ("ROADMAP.md A7: the arrow_ipc sink needs pyarrow, "
                     "which the port does not import (blocked)")
YDB_WAITING = ("ROADMAP.md A7: the port has no YDB provider or fake "
               "YDB yet")

_SINK_TABLE = ("sample", "events")


def rows_to_batch(rows: list[dict], table=_SINK_TABLE):
    """Canonicalize delivered row dicts into one all-UTF8 ColumnBatch
    (sorted column order, values stringified, staging-plane meta
    columns dropped) — row identity for the delivery audit."""
    from transferia_tpu_torch.abstract.schema import (
        CanonicalType,
        ColSchema,
        TableID,
        TableSchema,
    )
    from transferia_tpu_torch.columnar.batch import ColumnBatch
    from transferia_tpu_torch.providers.staging import is_meta_name

    names = sorted({k for r in rows for k in r if not is_meta_name(k)})
    schema = TableSchema([
        ColSchema(name=n, data_type=CanonicalType.UTF8) for n in names
    ])
    data = {}
    for n in names:
        col = []
        for r in rows:
            v = r.get(n)
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            col.append(None if v is None else str(v))
        data[n] = col
    return ColumnBatch.from_pydict(TableID(*table), schema, data)


class EoBackend:
    """One exactly-once chaos backend: target lifecycle + the four
    backend-specific hooks the trial needs."""

    name = ""

    @classmethod
    def available(cls) -> tuple[bool, str]:
        """(usable, reason-when-not) — checked before trials start."""
        return True, ""

    def dst(self):
        """Target params for the trial's transfer."""
        raise NotImplementedError

    def observed(self) -> list:
        """Delivered batches for the delivery audit."""
        raise NotImplementedError

    def zombie_publish(self, key: str, epoch: int) -> None:
        """Attempt a direct sink-layer publish of `key` at a stale
        `epoch`; the sink's own persisted fence must raise
        StaleEpochPublishError."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def _zombie_via_sinker(make_sinker, key: str, epoch: int) -> None:
    """Shared zombie shape: open a stage at the stale epoch and try to
    publish it — the persisted target-side fence must reject."""
    sinker = make_sinker()
    sinker.begin_part(key, epoch)
    try:
        sinker.publish_part(key, epoch)
    finally:
        try:
            sinker.abort_part(key)
        finally:
            sinker.close()


class MemoryBackend(EoBackend):
    name = "memory"

    def __init__(self, sink_id: str, device: DeviceLike = None):
        from transferia_tpu_torch.providers.memory import get_store

        self.sink_id = sink_id
        self.store = get_store(sink_id)
        self.store.clear()

    def dst(self):
        from transferia_tpu_torch.providers.memory import MemoryTargetParams

        return MemoryTargetParams(sink_id=self.sink_id)

    def observed(self) -> list:
        return self.store.batches

    def zombie_publish(self, key: str, epoch: int) -> None:
        self.store.begin_stage(key, epoch)
        try:
            self.store.publish_stage(key, epoch)
        finally:
            self.store.abort_stage(key, epoch)

    def close(self) -> None:
        self.store.clear()


class ArrowIpcBackend(EoBackend):
    """The arrow_ipc staging-directory sink: blocked on pyarrow."""

    name = "arrow_ipc"

    @classmethod
    def available(cls) -> tuple[bool, str]:
        return False, ARROW_IPC_BLOCKED

    def __init__(self, sink_id: str, device: DeviceLike = None):
        raise NotImplementedError(ARROW_IPC_BLOCKED)


class PostgresBackend(EoBackend):
    name = "postgres"

    def __init__(self, sink_id: str, device: DeviceLike = None):
        from transferia_tpu_torch.recipes.fake_postgres import FakePG

        self.device = device
        self.fake = FakePG().start()

    def dst(self):
        from transferia_tpu_torch.providers.postgres.provider import (
            PGTargetParams,
        )

        return PGTargetParams(host="127.0.0.1", port=self.fake.port)

    def observed(self) -> list:
        with self.fake.lock:
            rows = list(self.fake.tables.get(_SINK_TABLE,
                                             _EMPTY).rows)
        return [rows_to_batch(rows)] if rows else []

    def zombie_publish(self, key: str, epoch: int) -> None:
        from transferia_tpu_torch.providers.postgres.provider import PGSinker

        _zombie_via_sinker(lambda: PGSinker(self.dst(), self.device),
                           key, epoch)

    def close(self) -> None:
        self.fake.stop()


class _Empty:
    rows: list = []


_EMPTY = _Empty()


class ClickHouseBackend(EoBackend):
    name = "clickhouse"

    def __init__(self, sink_id: str, device: DeviceLike = None):
        from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH

        self.device = device
        self.fake = FakeCH().start()

    def dst(self):
        from transferia_tpu_torch.providers.clickhouse.provider import (
            CHTargetParams,
        )

        # no bufferer: its timer-based flush would make batch
        # boundaries (and so the failpoint hit sequence) wall-clock
        # dependent, breaking byte-identical seed replay
        return CHTargetParams(host="127.0.0.1", port=self.fake.port,
                              bufferer=None)

    def observed(self) -> list:
        rows = self.fake.rows("__".join(_SINK_TABLE))
        return [rows_to_batch(rows)] if rows else []

    def zombie_publish(self, key: str, epoch: int) -> None:
        from transferia_tpu_torch.providers.clickhouse.provider import CHSinker

        _zombie_via_sinker(lambda: CHSinker(self.dst(), self.device),
                           key, epoch)

    def close(self) -> None:
        self.fake.stop()


class YdbBackend(EoBackend):
    """The YDB target: the port has no YDB provider or fake yet."""

    name = "ydb"

    @classmethod
    def available(cls) -> tuple[bool, str]:
        return False, YDB_WAITING

    def __init__(self, sink_id: str, device: DeviceLike = None):
        raise NotImplementedError(YDB_WAITING)


class KafkaBackend(EoBackend):
    name = "kafka"

    def __init__(self, sink_id: str, device: DeviceLike = None):
        from transferia_tpu_torch.recipes.fake_kafka import FakeKafka

        self.device = device
        self.fake = FakeKafka(n_partitions=2).start()
        self.topic = ".".join(_SINK_TABLE)

    def dst(self):
        from transferia_tpu_torch.providers.kafka.provider import (
            KafkaTargetParams,
        )

        return KafkaTargetParams(
            brokers=[f"127.0.0.1:{self.fake.port}"],
            topic=self.topic, serializer="json")

    def observed(self) -> list:
        rows = []
        with self.fake.lock:
            logs = list(self.fake.topics.get(self.topic, []))
        for log in logs:
            for rec in log:
                if rec.value:
                    rows.append(json.loads(rec.value))
        return [rows_to_batch(rows)] if rows else []

    def zombie_publish(self, key: str, epoch: int) -> None:
        from transferia_tpu_torch.providers.kafka.provider import KafkaSinker

        _zombie_via_sinker(lambda: KafkaSinker(self.dst(), self.device),
                           key, epoch)

    def close(self) -> None:
        self.fake.stop()


class S3Backend(EoBackend):
    name = "s3"

    def __init__(self, sink_id: str, device: DeviceLike = None):
        from transferia_tpu_torch.recipes.fake_s3 import FakeS3

        self.device = device
        self.fake = FakeS3(conditional_writes=True, page_size=64).start()

    def dst(self):
        from transferia_tpu_torch.providers.s3 import S3TargetParams

        return S3TargetParams(
            url="s3://chaos-eo/out", format="jsonl",
            endpoint_url=self.fake.endpoint,
            access_key="test-ak", secret_key="test-sk")

    def observed(self) -> list:
        rows = []
        with self.fake.lock:
            objects = {
                k: body for k, (body, _etag) in self.fake.objects.items()
                if k.startswith("out/") and "/.staging/" not in k
            }
        for _k, body in sorted(objects.items()):
            for line in body.splitlines():
                if line.strip():
                    rows.append(json.loads(line))
        return [rows_to_batch(rows)] if rows else []

    def zombie_publish(self, key: str, epoch: int) -> None:
        from transferia_tpu_torch.providers.s3 import S3Sinker

        _zombie_via_sinker(lambda: S3Sinker(self.dst(), self.device),
                           key, epoch)

    def close(self) -> None:
        self.fake.stop()


_BACKENDS = {
    cls.name: cls
    for cls in (MemoryBackend, ArrowIpcBackend, PostgresBackend,
                ClickHouseBackend, YdbBackend, KafkaBackend, S3Backend)
}


def backend_names() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def backend_available(name: str) -> tuple[bool, str]:
    return _BACKENDS[name].available()


def make_backend(name: str, sink_id: str,
                 device: DeviceLike = None) -> EoBackend:
    return _BACKENDS[name](sink_id, device)
