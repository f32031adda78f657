"""Kafka provider of the port: the replication source over the wire
client.  The Kafka sink and its serializers wait (ROADMAP.md A7)."""

from transferia_tpu_torch.providers.kafka.provider import (
    KafkaProvider,
    KafkaSourceParams,
)

__all__ = ["KafkaProvider", "KafkaSourceParams"]
