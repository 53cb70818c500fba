"""Streaming of the PyTorch/CUDA port.

Counterpart of the JAX package's ``streaming/``: ``codec`` (the
self-describing binary frame of arrays and DataSets that the model
server's binary predict path and the broker speak), ``broker`` (the
in-process topic broker, the TCP publisher and consumer and the streaming
DataSet iterator), ``kafka`` (the kafka-python client, or the embedded
broker without it) and ``route`` (source → transforms → sink).
"""

from deeplearning4j_tpu_torch.streaming.codec import (  # noqa: F401
    BFloat16Array,
    deserialize_array,
    deserialize_dataset,
    serialize_array,
    serialize_dataset,
)
from deeplearning4j_tpu_torch.streaming.broker import (  # noqa: F401
    EmbeddedBroker,
    SocketConsumer,
    SocketPublisher,
    StreamingDataSetIterator,
)
from deeplearning4j_tpu_torch.streaming.kafka import NDArrayKafkaClient  # noqa: F401
from deeplearning4j_tpu_torch.streaming.route import Route, RouteError  # noqa: F401
