"""Kafka topic runtime: a from-scratch wire-protocol client (and a
Kafka-protocol facade for the in-process broker) implementing the Topic
SPI, so applications written against this framework run unchanged on an
existing Kafka cluster (``streamingCluster.type: kafka``).

Reference: ``langstream-kafka-runtime/src/main/java/ai/langstream/kafka/
runner/KafkaTopicConnectionsRuntime.java:53`` (SPI wiring) and
``KafkaConsumerWrapper.java:52-230`` (out-of-order ack bookkeeping with a
contiguous commit watermark — reimplemented here client-side, the same
semantics the in-memory broker enforces server-side).

No kafka client library exists in this image, so the protocol layer is
implemented directly (framing, record batches v2 with CRC32C, consumer
groups); see ``protocol.py``.

The port's own copy of ``langstream_tpu/topics/kafka/``.
"""

from langstream_tpu_torch.topics.kafka.runtime import KafkaTopicConnectionsRuntime

__all__ = ["KafkaTopicConnectionsRuntime"]
