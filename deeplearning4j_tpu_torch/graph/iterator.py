"""Walk iterators over a graph.

Parity with ``graph/iterator/RandomWalkIterator.java``,
``WeightedRandomWalkIterator.java`` and the parallel iterator providers in
``graph/iterator/parallel/``. Walks for a whole epoch are generated in one
vectorised call (:meth:`Graph.random_walks`); the iterator then yields
:class:`VertexSequence` views for API parity. The "provider" splits the vertex
range into partitions — in the reference this feeds one iterator per JVM
thread; here partitions become device-batch shards.

The port's copy of the JAX package's jax-free ``graph/iterator.py``: the
same walk iterators and providers.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import NoEdgeHandling
from deeplearning4j_tpu_torch.graph.graph import Graph, VertexSequence


class _BaseWalkIterator:
    weighted = False

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 mode: NoEdgeHandling = NoEdgeHandling.EXCEPTION_ON_DISCONNECTED,
                 first_vertex: int = 0, last_vertex: Optional[int] = None):
        self.graph = graph
        self._walk_length = walk_length
        self.seed = seed
        self.mode = mode
        self.first_vertex = first_vertex
        self.last_vertex = graph.num_vertices() if last_vertex is None else last_vertex
        self._rng = np.random.default_rng(seed)
        self.reset()

    def walk_length(self) -> int:
        return self._walk_length

    def reset(self):
        """Regenerate walks: one per start vertex, start order shuffled
        (``RandomWalkIterator.reset``)."""
        starts = np.arange(self.first_vertex, self.last_vertex)
        self._rng.shuffle(starts)
        self._walks = self.graph.random_walks(
            starts, self._walk_length, self._rng, weighted=self.weighted,
            self_loop_disconnected=(self.mode is NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED))
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._walks)

    def next(self) -> VertexSequence:
        if not self.has_next():
            raise StopIteration
        seq = VertexSequence(self.graph, self._walks[self._pos])
        self._pos += 1
        return seq

    def __iter__(self) -> Iterator[VertexSequence]:
        while self.has_next():
            yield self.next()

    def walks_array(self) -> np.ndarray:
        """All remaining walks as one (n, walk_length+1) array — the batched
        path the DeepWalk trainer consumes directly."""
        return self._walks[self._pos:]


class RandomWalkIterator(_BaseWalkIterator):
    """Uniform random walks, one starting at every vertex exactly once per
    epoch (``iterator/RandomWalkIterator.java``)."""

    weighted = False


class WeightedRandomWalkIterator(_BaseWalkIterator):
    """Random walks with transition probability proportional to edge weight
    (``iterator/WeightedRandomWalkIterator.java``)."""

    weighted = True


class RandomWalkGraphIteratorProvider:
    """Splits start vertices into ``n`` contiguous ranges, one iterator each
    (``iterator/parallel/RandomWalkGraphIteratorProvider.java``)."""

    iterator_cls = RandomWalkIterator

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 mode: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.mode = mode

    def get_graph_walk_iterators(self, num_iterators: int) -> List[_BaseWalkIterator]:
        n = self.graph.num_vertices()
        num_iterators = min(num_iterators, n)
        bounds = np.linspace(0, n, num_iterators + 1, dtype=int)
        out = []
        for i in range(num_iterators):
            if bounds[i + 1] > bounds[i]:
                out.append(self.iterator_cls(
                    self.graph, self.walk_length, self.seed + i, self.mode,
                    int(bounds[i]), int(bounds[i + 1])))
        return out


class WeightedRandomWalkGraphIteratorProvider(RandomWalkGraphIteratorProvider):
    """Weighted variant (``parallel/WeightedRandomWalkGraphIteratorProvider.java``)."""

    iterator_cls = WeightedRandomWalkIterator
