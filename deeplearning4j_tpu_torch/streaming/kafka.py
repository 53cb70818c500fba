"""Kafka client for array streams, gated on kafka-python availability.

Parity with `dl4j-streaming/.../streaming/kafka/NDArrayKafkaClient.java` (and
its NDArrayPublisher/NDArrayConsumer): publish/consume arrays on a Kafka
topic. The environment has no Kafka broker or client library baked in, so
construction degrades to the in-process :class:`EmbeddedBroker` unless
``kafka-python`` is importable — the same frames flow either way.

The port's copy of the JAX package's ``streaming/kafka.py``; without
``kafka-python`` it behaves as the reference does.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.streaming.broker import EmbeddedBroker
from deeplearning4j_tpu_torch.streaming.codec import deserialize_array, serialize_array


def _kafka_available() -> bool:
    try:
        import kafka  # noqa: F401
        return True
    except ImportError:
        return False


class NDArrayKafkaClient:
    """Publish/consume numpy arrays on a topic."""

    def __init__(self, bootstrap_servers: Optional[str] = None,
                 topic: str = "ndarrays",
                 embedded: Optional[EmbeddedBroker] = None):
        self.topic = topic
        self._producer = self._consumer = None
        if bootstrap_servers is not None and _kafka_available():
            from kafka import KafkaConsumer, KafkaProducer
            self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)
            self._consumer = KafkaConsumer(topic,
                                           bootstrap_servers=bootstrap_servers)
            self._broker = None
        elif bootstrap_servers is not None:
            raise ImportError(
                "kafka-python is not installed; pass embedded=EmbeddedBroker() "
                "for the in-process transport or install kafka-python")
        else:
            self._broker = embedded or EmbeddedBroker()

    def publish(self, array) -> None:
        frame = serialize_array(array)
        if self._producer is not None:
            self._producer.send(self.topic, frame)
            self._producer.flush()
        else:
            self._broker.publish(self.topic, frame)

    def poll(self, timeout: float = 5.0):
        if self._consumer is not None:
            records = self._consumer.poll(timeout_ms=int(timeout * 1000))
            for batch in records.values():
                for rec in batch:
                    return deserialize_array(rec.value)
            return None
        frame = self._broker.poll(self.topic, timeout=timeout)
        return None if frame is None else deserialize_array(frame)
