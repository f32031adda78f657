"""Kafka source and sink over the wire client (the port's copy of
``transferia_tpu/providers/kafka/provider.py``).

The source composes the shared QueueSource machinery (sequencer +
parsequeue + post-push commits); offsets checkpoint through the transfer
coordinator after the push (at-least-once).  The sink serializes batches
(`serializers/`) and produces per partition: the key's CRC32C in one
host-library call (`crc32c_batch`), or the column hash under
`partition_by`; with a staged part open it buffers the part's records
and publishes them in one transactional produce.  The partitioned (Kafka
-> object storage) strategy is `runtime/local.py::PartitionedWorker`, a
source of this module a partition.  A publish records
the reference's `kafka_publish_txn` instant behind the
`sink.kafka.publish` failpoint.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from transferia_tpu_torch.abstract.commit import StagedSinker
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.interfaces import (
    Batch,
    Sinker,
    is_columnar,
)
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.parsers import Message
from transferia_tpu_torch.providers.kafka.client import (
    KafkaClient,
    KafkaError,
    is_producer_fenced,
)
from transferia_tpu_torch.providers.kafka.protocol import (
    Record,
    crc32c_batch,
)
from transferia_tpu_torch.providers.queue_common import (
    FetchedBatch,
    QueueSource,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
)
from transferia_tpu_torch.providers.staging import (
    PartStage,
    part_slug,
    publish_guard,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.serializers import make_queue_serializer
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.transform.plugins.sharder import (
    hash_column_to_shards,
)

logger = logging.getLogger(__name__)


@register_endpoint
@dataclass
class KafkaSourceParams(EndpointParams):
    PROVIDER = "kafka"
    IS_SOURCE = True
    # queue sources cannot be re-read from scratch: reupload is forbidden
    is_append_only = True

    brokers: list[str] = field(default_factory=lambda: ["localhost:9092"])
    topic: str = ""
    parser: Optional[dict] = None
    parallelism: int = 4
    max_bytes_per_fetch: int = 8 << 20
    start_from: str = "earliest"   # earliest | latest
    # security: the port's client refuses TLS and SASL
    # (NotImplementedError, ROADMAP.md A7)
    tls: bool = False
    tls_ca: str = ""              # CA bundle path (custom/self-signed)
    tls_verify: bool = True
    sasl_mechanism: str = ""      # PLAIN | SCRAM-SHA-256 | SCRAM-SHA-512
    sasl_username: str = ""
    sasl_password: str = ""

    def __post_init__(self):
        if self.start_from not in ("earliest", "latest"):
            # a typo silently meaning "latest" would skip all existing data
            raise ValueError(
                f"kafka start_from must be 'earliest' or 'latest', "
                f"got {self.start_from!r}"
            )


@register_endpoint
@dataclass
class KafkaTargetParams(EndpointParams):
    PROVIDER = "kafka"
    IS_TARGET = True

    brokers: list[str] = field(default_factory=lambda: ["localhost:9092"])
    topic: str = ""               # "" -> per-table "<ns>.<name>"
    serializer: str = "json"
    serializer_config: dict = field(default_factory=dict)
    partition_by: str = ""
    compression: str = ""         # "" | gzip
    # security: the port's client refuses TLS and SASL
    # (NotImplementedError, ROADMAP.md A7)
    tls: bool = False
    tls_ca: str = ""              # CA bundle path (custom/self-signed)
    tls_verify: bool = True
    sasl_mechanism: str = ""      # PLAIN | SCRAM-SHA-256 | SCRAM-SHA-512
    sasl_username: str = ""
    sasl_password: str = ""


def _make_client(params) -> KafkaClient:
    return KafkaClient(params.brokers, tls=params.tls,
                       sasl_mechanism=params.sasl_mechanism)


class _KafkaQueueClient:
    """QueueSource client contract over KafkaClient with coordinator-backed
    offset checkpoints (state key kafka_offsets)."""

    STATE_KEY = "kafka_offsets"

    # one lock for all clients of a process: the partitioned strategy
    # runs one client a partition against the same transfer-state blob,
    # and a lock an instance would let concurrent read-modify-writes lose
    # another partition's committed offset
    _commit_lock = threading.Lock()

    def __init__(self, params: KafkaSourceParams, transfer_id: str,
                 coordinator: Optional[Coordinator],
                 partitions: Optional[list[int]] = None):
        """partitions: restrict to a subset (the partitioned replication
        strategy runs one client a partition)."""
        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.client = _make_client(params)
        meta = self.client.metadata([params.topic])
        all_partitions = meta.get(params.topic)
        if not all_partitions:
            raise KafkaError(f"topic {params.topic!r} not found")
        if partitions is not None:
            all_partitions = [p for p in all_partitions
                              if p in set(partitions)]
        partitions = all_partitions
        saved = {}
        if self.cp is not None:
            saved = self.cp.get_transfer_state(transfer_id).get(
                self.STATE_KEY, {}
            )
        self.positions: dict[int, int] = {}
        for p in partitions:
            key = f"{params.topic}:{p}"
            if key in saved:
                self.positions[p] = int(saved[key]) + 1
            else:
                ts = -2 if params.start_from == "earliest" else -1
                self.positions[p] = self.client.list_offsets(
                    params.topic, p, ts
                )

    def fetch(self, max_messages: int = 1024) -> list[FetchedBatch]:
        # one multi-partition Fetch per leader, not one round trip per
        # partition
        fetched = self.client.fetch_multi(
            self.params.topic, dict(self.positions),
            max_bytes=self.params.max_bytes_per_fetch,
        )
        out = []
        for p in sorted(fetched):
            records, high = fetched[p]
            if not records:
                continue
            records = records[:max_messages]
            self.positions[p] = records[-1].offset + 1
            out.append(FetchedBatch(
                self.params.topic, p,
                [
                    Message(
                        value=r.value or b"", key=r.key or b"",
                        topic=self.params.topic, partition=p,
                        offset=r.offset,
                        write_time_ns=r.timestamp_ms * 1_000_000,
                        headers=tuple(r.headers),
                    )
                    for r in records
                ],
            ))
        return out

    def commit(self, topic: str, partition: int, offset: int) -> None:
        if self.cp is None:
            return
        with _KafkaQueueClient._commit_lock:
            state = self.cp.get_transfer_state(self.transfer_id).get(
                self.STATE_KEY, {}
            )
            state[f"{topic}:{partition}"] = offset
            self.cp.set_transfer_state(
                self.transfer_id, {self.STATE_KEY: state}
            )

    def close(self) -> None:
        self.client.close()


def topic_partitions(params: KafkaSourceParams) -> list[int]:
    """Partition ids of the source topic."""
    client = _make_client(params)
    try:
        meta = client.metadata([params.topic])
        return sorted(meta.get(params.topic) or [])
    finally:
        client.close()


class KafkaSinker(Sinker, StagedSinker):
    """Produce sink; staged-commit capable (abstract/commit.py): with an
    open part stage the serialized messages buffer sink-side and land in
    the broker through one transactional produce tied to the part's
    transactional id (`trtpu.<part slug>`).  Kafka's own KIP-98 producer
    fencing rejects a zombie (its InitProducerId or produce with the
    stale epoch fails PRODUCER_FENCED, raised as
    StaleEpochPublishError), and a republish under the same
    transactional id supersedes the previous publish instead of
    appending duplicates.

    Protocol bound: this speaks the KIP-98 subset the in-repo fake
    broker implements: one transactional Produce request = one
    committed transaction, with broker-side supersede-in-place of the
    id's previous publish.  A full Apache Kafka deployment additionally
    needs AddPartitionsToTxn/EndTxn, commit markers and read_committed
    consumers; until then the exactly-once claim holds for the
    fake-backed wire, and real brokers should keep the at-least-once
    path.

    `device` is where the staged pushes' dedup window keys each batch
    (K10 in keys mode on a card)."""

    def __init__(self, params: KafkaTargetParams, device: DeviceLike = None):
        self.params = params
        self.device = device
        self.client = _make_client(params)
        cfg = dict(params.serializer_config or {})
        if params.serializer == "debezium" and params.topic:
            # single-topic sinks: SR subjects must derive from the real
            # topic (TopicNameStrategy)
            cfg.setdefault("topic", params.topic)
        self.serializer = make_queue_serializer(params.serializer, **cfg)
        self._partitions: dict[str, list[int]] = {}
        self._stage: Optional[PartStage] = None
        self._stage_key = ""
        self._staged: dict[tuple[str, int], list[Record]] = {}

    def _topic_partitions(self, topic: str) -> list[int]:
        if topic not in self._partitions:
            meta = self.client.metadata([topic])
            self._partitions[topic] = meta.get(topic) or [0]
        return self._partitions[topic]

    @staticmethod
    def _key_partitions(pairs, n_parts: int) -> np.ndarray:
        """crc32c(key) % n_parts per pair, in one host-library call (the
        library builds or raises: there is no per-key loop)."""
        return crc32c_batch([bytes(k or b"") for k, _ in pairs]) % n_parts

    def _partitioned_records(self, batch: Batch
                             ) -> dict[tuple[str, int], list[Record]]:
        """Serialize one batch into per-(topic, partition) records."""
        pairs = self.serializer.serialize_messages(batch)
        if not pairs:
            return {}
        if is_columnar(batch):
            topic = self.params.topic or str(batch.table_id)
        else:
            rows = [it for it in batch if it.is_row_event()]
            topic = self.params.topic or (
                str(rows[0].table_id) if rows else "controls"
            )
        partitions = self._topic_partitions(topic)
        n_parts = len(partitions)
        col_parts = None
        if is_columnar(batch) and self.params.partition_by and \
                self.params.partition_by in batch.columns and \
                len(pairs) == batch.n_rows:
            col_parts = hash_column_to_shards(
                batch.column(self.params.partition_by), n_parts
            )
        if col_parts is not None:
            part_idx = col_parts
        else:
            # deterministic key hash (crc32c): built-in hash() is
            # randomized per process and would break per-key partition
            # affinity across restarts
            part_idx = self._key_partitions(pairs, n_parts)
        out: dict[tuple[str, int], list[Record]] = {}
        for i, (key, value) in enumerate(pairs):
            p = partitions[int(part_idx[i])]
            out.setdefault((topic, p), []).append(
                Record(key=key, value=value)
            )
        return out

    def push(self, batch: Batch) -> None:
        if self._stage is not None:
            batch = self._stage.stage(batch)
            try:
                for tp, records in self._partitioned_records(
                        batch).items():
                    self._staged.setdefault(tp, []).extend(records)
            except BaseException:
                # serialization died after the dedup window recorded the
                # batch: only a full part restage is safe
                self._stage.mark_failed()
                raise
            return
        for (topic, p), records in self._partitioned_records(
                batch).items():
            self.client.produce(topic, p, records,
                                compression=self.params.compression)

    # -- StagedSinker (publish = one kafka transaction) ---------------------
    def begin_part(self, key: str, epoch: int) -> None:
        # hold=False: the serialized record buffer is the stage; the
        # PartStage only runs the dedup window over the pushed batches
        self._stage = PartStage(key, epoch, hold=False, device=self.device)
        self._stage_key = key
        self._staged = {}

    def publish_part(self, key: str, epoch: int) -> int:
        stage = self._stage
        if stage is None or self._stage_key != key:
            raise RuntimeError(f"kafka sink: no open stage for {key!r}")
        with publish_guard(key, epoch):
            txn_id = f"trtpu.{part_slug(key)}"
            trace.instant("kafka_publish_txn", part=key, epoch=epoch,
                          rows=stage.rows)
            failpoint("sink.kafka.publish")
            try:
                pid, accepted = self.client.init_producer(txn_id, epoch)
                self.client.txn_produce(txn_id, pid, accepted,
                                        self._staged)
            except KafkaError as e:
                if is_producer_fenced(e):
                    # KIP-98 zombie fencing is the sink-side epoch fence:
                    # a newer owner holds the transactional id.  Brokers
                    # that do not disclose the winning epoch (real ones
                    # return -1) get the epoch+1 lower bound
                    won = getattr(e, "fence_epoch", None)
                    raise StaleEpochPublishError(
                        key, epoch,
                        won if won is not None else epoch + 1) from e
                raise
            self.last_dedup_dropped = stage.dedup_dropped
            rows = stage.rows
        self._stage = None
        self._stage_key = ""
        self._staged = {}
        return rows

    def abort_part(self, key: str) -> None:
        self._stage = None
        self._stage_key = ""
        self._staged = {}

    def note_push_retry(self) -> None:
        if self._stage is not None:
            self._stage.note_push_retry()

    def close(self) -> None:
        self.client.close()


@register_provider
class KafkaProvider(Provider):
    NAME = "kafka"

    def source(self):
        if isinstance(self.transfer.src, KafkaSourceParams):
            p = self.transfer.src
            client = _KafkaQueueClient(p, self.transfer.id,
                                       self.coordinator)
            return QueueSource(client, p.parser,
                               parallelism=p.parallelism,
                               metrics=self.metrics,
                               transfer_id=self.transfer.id)
        return None

    def sinker(self):
        if isinstance(self.transfer.dst, KafkaTargetParams):
            return KafkaSinker(self.transfer.dst, self.device)
        return None
