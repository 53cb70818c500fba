"""Streaming of the PyTorch/CUDA port.

Counterpart of the JAX package's ``streaming/``. Ported so far: ``codec``,
the self-describing binary frame of arrays and DataSets that the model
server's binary predict path speaks. The broker, the routes and the Kafka
client come with ROADMAP item 7.
"""

from deeplearning4j_tpu_torch.streaming.codec import (  # noqa: F401
    BFloat16Array,
    deserialize_array,
    deserialize_dataset,
    serialize_array,
    serialize_dataset,
)
