"""Debezium protocol codec (the port's copy of ``transferia_tpu/debezium/``).

Bidirectional: the emitter turns ChangeItems/ColumnBatches into Debezium
envelope (key, value) JSON pairs for queue sinks (BASELINE config #4,
mysql2kafka); the receiver turns Debezium envelopes back into
ChangeItems for the `debezium` parser.  Type fidelity follows Kafka
Connect schema names (io.debezium.time.*,
org.apache.kafka.connect.data.Decimal).
"""

from transferia_tpu_torch.debezium.emitter import DebeziumEmitter
from transferia_tpu_torch.debezium.receiver import DebeziumReceiver

__all__ = ["DebeziumEmitter", "DebeziumReceiver"]
