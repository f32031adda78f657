"""In-memory message broker provider (the port's copy of
``transferia_tpu/providers/mq.py``).

The local stand-in for Kafka-shaped sources/sinks (reference test recipes
spin up real brokers via testcontainers, tests/tcrecipes/ — this image has
no docker, so the broker lives in-process).  It exercises the exact queue
replication machinery (QueueSource: sequencer + parsequeue + post-push
offset commits; queue sink: serializer + key-hash partitioning) that the
kafka provider shares.  The sink's staged pushes key each batch for the
dedup window on the provider's device (K10 in keys mode on a card).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import Batch, Sinker
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.parsers import Message
from transferia_tpu_torch.providers.queue_common import (
    FetchedBatch,
    QueueSource,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.serializers import make_queue_serializer
from transferia_tpu_torch.transform.plugins.sharder import (
    hash_column_to_shards,
)


# tombstone for a superseded staged-commit publish: entries are
# REPLACED in place (never deleted) so partition offsets — list
# indices consumers commit — stay stable across a part republish
_SUPERSEDED = object()


class MemoryBroker:
    """topic -> partition -> list of (key, value, timestamp_ns)."""

    def __init__(self, n_partitions: int = 1):
        self.lock = threading.RLock()
        self.n_partitions = n_partitions
        self.topics: dict[str, list[list[tuple]]] = {}
        self.committed: dict[tuple[str, str, int], int] = {}  # (group,t,p)
        # staged-commit publish registry (the broker-side half of the
        # mq offset-commit exactly-once path): part key -> (epoch,
        # [(topic, partition, message tuple)]) of the LAST accepted
        # publish, so a republish replaces instead of appending and a
        # stale-epoch publish is rejected
        self.published_parts: dict[str, tuple[int, list]] = {}

    def _topic(self, name: str) -> list[list[tuple]]:
        with self.lock:
            if name not in self.topics:
                self.topics[name] = [[] for _ in range(self.n_partitions)]
            return self.topics[name]

    def produce(self, topic: str, key: bytes, value: Optional[bytes],
                partition: Optional[int] = None) -> None:
        parts = self._topic(topic)
        if partition is None:
            partition = (hash(bytes(key or b"")) & 0x7FFFFFFF) % len(parts)
        with self.lock:
            parts[partition % len(parts)].append(
                (key, value, time.time_ns())
            )

    def fetch_from(self, topic: str, partition: int, offset: int,
                   max_messages: int) -> list[Message]:
        parts = self._topic(topic)
        picked: list[tuple] = []
        with self.lock:
            plist = parts[partition]
            # scan past superseded-publish tombstones: they hold their
            # index (committed offsets stay valid) but carry no message
            i = offset
            while i < len(plist) and len(picked) < max_messages:
                entry = plist[i]
                if entry is not _SUPERSEDED:
                    picked.append((i, entry))
                i += 1
        return [
            Message(value=v if v is not None else b"", key=k or b"",
                    topic=topic, partition=partition, offset=idx,
                    write_time_ns=ts)
            for idx, (k, v, ts) in picked
        ]

    def commit(self, group: str, topic: str, partition: int,
               offset: int) -> None:
        with self.lock:
            self.committed[(group, topic, partition)] = offset

    def committed_offset(self, group: str, topic: str,
                         partition: int) -> int:
        with self.lock:
            return self.committed.get((group, topic, partition), -1)

    def size(self, topic: str) -> int:
        parts = self._topic(topic)
        with self.lock:
            return sum(1 for p in parts for e in p
                       if e is not _SUPERSEDED)

    def publish_part(self, part_key: str, epoch: int,
                     messages: list[tuple]) -> int:
        """Transactional part publish: land `messages` — entries of
        (topic, partition, key, value) — atomically, REPLACING whatever
        an earlier publish of the same part key landed (the in-memory
        twin of a kafka transaction + replace-on-republish), behind the
        epoch fence.  Partition None routes by key hash, like
        produce()."""
        with self.lock:
            prev = self.published_parts.get(part_key)
            if prev is not None and epoch < prev[0]:
                raise StaleEpochPublishError(part_key, epoch, prev[0])
            if prev is not None:
                # tombstone in place — NEVER delete: offsets are list
                # indices and consumer groups have committed them
                for topic, p, entry in prev[1]:
                    plist = self._topic(topic)[p]
                    for i, cur in enumerate(plist):
                        if cur is entry:
                            plist[i] = _SUPERSEDED
                            break
            landed = []
            for topic, partition, key, value in messages:
                parts = self._topic(topic)
                if partition is None:
                    partition = (hash(bytes(key or b"")) & 0x7FFFFFFF) \
                        % len(parts)
                entry = (key, value, time.time_ns())
                parts[partition % len(parts)].append(entry)
                landed.append((topic, partition % len(parts), entry))
            self.published_parts[part_key] = (epoch, landed)
            return len(landed)


_BROKERS: dict[str, MemoryBroker] = {}


def get_broker(broker_id: str, n_partitions: int = 1) -> MemoryBroker:
    if broker_id not in _BROKERS:
        _BROKERS[broker_id] = MemoryBroker(n_partitions)
    return _BROKERS[broker_id]


@register_endpoint
@dataclass
class MQSourceParams(EndpointParams):
    PROVIDER = "mq"
    IS_SOURCE = True
    # queue sources cannot be re-read from scratch: reupload
    # is forbidden (model/endpoint.go AppendOnlySource)
    is_append_only = True

    broker_id: str = "default"
    topic: str = "topic"
    group: str = "transfer"
    parser: Optional[dict] = None          # one-of parser config
    parallelism: int = 4
    n_partitions: int = 1

    def parser_config(self):
        return self.parser


@register_endpoint
@dataclass
class MQTargetParams(EndpointParams):
    PROVIDER = "mq"
    IS_TARGET = True

    broker_id: str = "default"
    topic: str = ""                # empty -> per-table "<ns>.<name>"
    serializer: str = "json"       # json | native | debezium | mirror
    serializer_config: dict = field(default_factory=dict)
    n_partitions: int = 1
    partition_by: str = ""         # column for shard hashing; "" = key hash


class _MQClient:
    """QueueSource client over a MemoryBroker consumer group."""

    def __init__(self, params: MQSourceParams):
        self.broker = get_broker(params.broker_id, params.n_partitions)
        self.topic = params.topic
        self.group = params.group
        self.positions = {
            p: self.broker.committed_offset(self.group, self.topic, p) + 1
            for p in range(params.n_partitions)
        }

    def fetch(self, max_messages: int = 1024) -> list[FetchedBatch]:
        out = []
        for p, pos in self.positions.items():
            msgs = self.broker.fetch_from(self.topic, p, pos, max_messages)
            if msgs:
                self.positions[p] = msgs[-1].offset + 1
                out.append(FetchedBatch(self.topic, p, msgs))
        return out

    def commit(self, topic: str, partition: int, offset: int) -> None:
        self.broker.commit(self.group, topic, partition, offset)

    def seek(self, topic: str, partition: int, offset: int) -> None:
        """Reposition the fetch cursor (kafka consumer seek): the MVCC
        pump resumes partitions from the offsets its admitted layers
        already cover, not from the group's committed offset — those
        only commit inside the cutover fence (mvcc/pump.py)."""
        if topic == self.topic and partition in self.positions:
            self.positions[partition] = int(offset)

    def close(self) -> None:
        pass


class MQSinker(Sinker, StagedSinker):
    """Queue sink: serialize rows, partition by key/column hash
    (reference kafka/sink.go + writer/).

    Staged-commit capable (abstract/commit.py): with an open part stage
    the serialized messages buffer sink-side and land in the broker
    through one epoch-fenced `MemoryBroker.publish_part` transaction —
    the in-memory twin of a kafka transactional produce tied to the
    offset-commit path.  `device` is where the dedup window keys each
    staged batch."""

    def __init__(self, params: MQTargetParams, device: DeviceLike = None):
        self.params = params
        self.device = device
        self.broker = get_broker(params.broker_id, params.n_partitions)
        self.serializer = make_queue_serializer(
            params.serializer, **(params.serializer_config or {})
        )
        self._stage = None  # staging.PartStage when open
        self._staged_messages: list[tuple] = []

    def _messages_for(self, batch: Batch) -> list[tuple]:
        """Serialize one batch to (topic, partition, key, value)
        message tuples (partition None = key hash at produce time)."""
        from transferia_tpu_torch.abstract.interfaces import is_columnar

        pairs = self.serializer.serialize_messages(batch)
        partitions: Optional[list[int]] = None
        if is_columnar(batch):
            topic = self.params.topic or str(batch.table_id)
            # column-hash partitioning is only sound when pairs align 1:1
            # with rows; serializers may expand rows (e.g. debezium
            # tombstones), in which case fall back to key-hash so a
            # tombstone always lands in its delete's partition
            if self.params.partition_by and \
                    self.params.partition_by in batch.columns and \
                    len(pairs) == batch.n_rows:
                partitions = hash_column_to_shards(
                    batch.column(self.params.partition_by),
                    self.params.n_partitions,
                ).tolist()
        else:
            rows = [it for it in batch if it.is_row_event()]
            topic = self.params.topic or (
                str(rows[0].table_id) if rows else "controls"
            )
        return [
            (topic, partitions[i] if partitions is not None else None,
             key, value)
            for i, (key, value) in enumerate(pairs)
        ]

    def push(self, batch: Batch) -> None:
        if self._stage is not None:
            batch = self._stage.stage(batch)
            try:
                self._staged_messages.extend(self._messages_for(batch))
            except BaseException:
                # serialization died after the dedup window recorded
                # the batch: only a full part restage is safe
                self._stage.mark_failed()
                raise
            return
        for topic, partition, key, value in self._messages_for(batch):
            self.broker.produce(topic, key, value, partition=partition)

    # -- StagedSinker -------------------------------------------------------
    def begin_part(self, key: str, epoch: int) -> None:
        from transferia_tpu_torch.providers.staging import PartStage

        # hold=False: the serialized message list is the buffer; the
        # PartStage only runs the dedup window over the pushed batches
        self._stage = PartStage(key, epoch, hold=False, device=self.device)
        self._staged_messages = []

    def publish_part(self, key: str, epoch: int) -> int:
        from transferia_tpu_torch.providers.staging import publish_guard

        if self._stage is None:
            raise RuntimeError(f"mq sink: no open stage for {key!r}")
        with publish_guard(key, epoch):
            n = self.broker.publish_part(key, epoch,
                                         self._staged_messages)
        self.last_dedup_dropped = self._stage.dedup_dropped
        self._stage = None
        self._staged_messages = []
        return n

    def abort_part(self, key: str) -> None:
        self._stage = None
        self._staged_messages = []

    def note_push_retry(self) -> None:
        if self._stage is not None:
            self._stage.note_push_retry()


@register_provider
class MQProvider(Provider):
    NAME = "mq"

    def source(self):
        p = self.transfer.src
        client = _MQClient(p)
        return QueueSource(client, p.parser, parallelism=p.parallelism,
                           metrics=self.metrics,
                           transfer_id=self.transfer.id)

    def sinker(self):
        return MQSinker(self.transfer.dst, self.device)
