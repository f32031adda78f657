"""Kafka provider of the port: the replication source and the sink (with
its transactional staged publish) over the wire client."""

from transferia_tpu_torch.providers.kafka.provider import (
    KafkaProvider,
    KafkaSourceParams,
    KafkaTargetParams,
)

__all__ = ["KafkaProvider", "KafkaSourceParams", "KafkaTargetParams"]
