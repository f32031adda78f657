"""Kafka replication source over the wire client (the port's copy of the
source half of ``transferia_tpu/providers/kafka/provider.py``).

The source composes the shared QueueSource machinery (sequencer +
parsequeue + post-push commits); offsets checkpoint through the transfer
coordinator after the push (at-least-once).  The Kafka sink, its
serializers and the partitioned (Kafka -> object storage) strategy wait
(ROADMAP.md A7, A9).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from transferia_tpu_torch.coordinator.interface import Coordinator
from transferia_tpu_torch.models.endpoint import (
    EndpointParams,
    register_endpoint,
)
from transferia_tpu_torch.parsers import Message
from transferia_tpu_torch.providers.kafka.client import (
    KafkaClient,
    KafkaError,
)
from transferia_tpu_torch.providers.queue_common import (
    FetchedBatch,
    QueueSource,
)
from transferia_tpu_torch.providers.registry import (
    Provider,
    register_provider,
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
    # security: the port's client refuses either (NotImplementedError)
    tls: bool = False
    sasl_mechanism: str = ""      # PLAIN | SCRAM-SHA-256 | SCRAM-SHA-512

    def __post_init__(self):
        if self.start_from not in ("earliest", "latest"):
            # a typo silently meaning "latest" would skip all existing data
            raise ValueError(
                f"kafka start_from must be 'earliest' or 'latest', "
                f"got {self.start_from!r}"
            )


def _make_client(params) -> KafkaClient:
    return KafkaClient(params.brokers, tls=params.tls,
                       sasl_mechanism=params.sasl_mechanism)


class _KafkaQueueClient:
    """QueueSource client contract over KafkaClient with coordinator-backed
    offset checkpoints (state key kafka_offsets)."""

    STATE_KEY = "kafka_offsets"

    # one lock for all clients of a process: clients that share a
    # transfer's state blob must not lose each other's offsets in
    # concurrent read-modify-writes
    _commit_lock = threading.Lock()

    def __init__(self, params: KafkaSourceParams, transfer_id: str,
                 coordinator: Optional[Coordinator]):
        self.params = params
        self.transfer_id = transfer_id
        self.cp = coordinator
        self.client = _make_client(params)
        meta = self.client.metadata([params.topic])
        partitions = meta.get(params.topic)
        if not partitions:
            raise KafkaError(f"topic {params.topic!r} not found")
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
                               metrics=self.metrics)
        return None
