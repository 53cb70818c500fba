"""Graph embeddings — DeepWalk on random walks with hierarchical softmax.

TPU-native re-design of the reference's ``deeplearning4j-graph`` module
(`deeplearning4j-graph/src/main/java/org/deeplearning4j/graph/`): the graph
structure is CSR-backed so walk generation is vectorised over all start
vertices, and DeepWalk training runs as batched, jitted hierarchical-softmax
updates (scatter-add on device) instead of the reference's per-pair hogwild
loop (`models/deepwalk/DeepWalk.java`, `models/embeddings/InMemoryGraphLookupTable.java`).

The port's counterpart of the JAX package's ``graph/``: the graph, walks,
tree and loaders are the reference's numpy code; DeepWalk's tables and
steps are torch on the card unless ``device="cpu"``.
"""

from deeplearning4j_tpu_torch.graph.api import (  # noqa: F401
    Edge,
    NoEdgeHandling,
    NoEdgesException,
    ParseException,
    Vertex,
)
from deeplearning4j_tpu_torch.graph.graph import Graph, VertexSequence  # noqa: F401
from deeplearning4j_tpu_torch.graph.huffman import GraphHuffman  # noqa: F401
from deeplearning4j_tpu_torch.graph.iterator import (  # noqa: F401
    RandomWalkGraphIteratorProvider,
    RandomWalkIterator,
    WeightedRandomWalkGraphIteratorProvider,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import (  # noqa: F401
    DeepWalk,
    GraphVectors,
    InMemoryGraphLookupTable,
)
from deeplearning4j_tpu_torch.graph.loader import GraphLoader  # noqa: F401
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec  # noqa: F401
from deeplearning4j_tpu_torch.graph.serializer import GraphVectorSerializer  # noqa: F401
