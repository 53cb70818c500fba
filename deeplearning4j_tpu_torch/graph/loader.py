"""Graph loading from delimited files.

Parity with ``graph/data/GraphLoader.java`` and the line processors in
``graph/data/impl/`` (``DelimitedEdgeLineProcessor``,
``WeightedEdgeLineProcessor``, ``DelimitedVertexLoader``).

The port's copy of the JAX package's jax-free ``graph/loader.py``: the same
loaders and line processors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.graph.api import Edge, ParseException
from deeplearning4j_tpu_torch.graph.graph import Graph


class DelimitedEdgeLineProcessor:
    """Parses "from<delim>to" lines into unweighted edges
    (``data/impl/DelimitedEdgeLineProcessor.java``)."""

    def __init__(self, delim: str = ",", directed: bool = False,
                 skip_prefixes: Sequence[str] = ("//", "#")):
        self.delim = delim
        self.directed = directed
        self.skip_prefixes = tuple(skip_prefixes)

    def process_line(self, line: str) -> Optional[Edge]:
        line = line.strip()
        if not line or any(line.startswith(p) for p in self.skip_prefixes):
            return None
        parts = line.split(self.delim)
        if len(parts) != 2:
            raise ParseException(f"Invalid line: expected 2 fields, got {len(parts)}: {line!r}")
        return Edge(int(parts[0]), int(parts[1]), None, self.directed)


class WeightedEdgeLineProcessor:
    """Parses "from<delim>to<delim>weight" lines
    (``data/impl/WeightedEdgeLineProcessor.java``)."""

    def __init__(self, delim: str = ",", directed: bool = False,
                 skip_prefixes: Sequence[str] = ("//", "#")):
        self.delim = delim
        self.directed = directed
        self.skip_prefixes = tuple(skip_prefixes)

    def process_line(self, line: str) -> Optional[Edge]:
        line = line.strip()
        if not line or any(line.startswith(p) for p in self.skip_prefixes):
            return None
        parts = line.split(self.delim)
        if len(parts) != 3:
            raise ParseException(f"Invalid line: expected 3 fields, got {len(parts)}: {line!r}")
        return Edge(int(parts[0]), int(parts[1]), float(parts[2]), self.directed)


class DelimitedVertexLoader:
    """Parses "index<delim>value" vertex lines
    (``data/impl/DelimitedVertexLoader.java``)."""

    def __init__(self, delim: str = ":", skip_prefixes: Sequence[str] = ("//", "#")):
        self.delim = delim
        self.skip_prefixes = tuple(skip_prefixes)

    def load_vertices(self, path: str) -> List[str]:
        out = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or any(line.startswith(p) for p in self.skip_prefixes):
                    continue
                idx, _, value = line.partition(self.delim)
                out[int(idx)] = value
        return [out.get(i) for i in range(max(out) + 1)] if out else []


class GraphLoader:
    """Static loaders (``data/GraphLoader.java``)."""

    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, num_vertices: int,
                                             delim: str = ",") -> Graph:
        """Each line "0<delim>1" is one undirected edge
        (`GraphLoader.java:34-51`)."""
        proc = DelimitedEdgeLineProcessor(delim, directed=False)
        return GraphLoader.load_graph(path, proc, num_vertices)

    @staticmethod
    def load_weighted_edge_list_file(path: str, num_vertices: int,
                                     delim: str = ",", directed: bool = False) -> Graph:
        """Each line "from<delim>to<delim>weight" (`GraphLoader.java:81-126`)."""
        proc = WeightedEdgeLineProcessor(delim, directed=directed)
        return GraphLoader.load_graph(path, proc, num_vertices)

    @staticmethod
    def load_graph(path, line_processor, num_vertices: int,
                   vertices: Optional[Sequence] = None,
                   allow_multiple_edges: bool = True) -> Graph:
        g = Graph(num_vertices, allow_multiple_edges, vertices=vertices)
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                edge = line_processor.process_line(line)
                if edge is not None:
                    g.add_edge(edge)
        return g

    @staticmethod
    def load_graph_from_vertex_and_edge_files(vertex_path: str, edge_path: str,
                                              vertex_loader=None, edge_processor=None,
                                              allow_multiple_edges: bool = True) -> Graph:
        """Two-file form (`GraphLoader.java:155`)."""
        vertex_loader = vertex_loader or DelimitedVertexLoader()
        values = vertex_loader.load_vertices(vertex_path)
        edge_processor = edge_processor or DelimitedEdgeLineProcessor()
        return GraphLoader.load_graph(edge_path, edge_processor, len(values),
                                      vertices=values,
                                      allow_multiple_edges=allow_multiple_edges)
