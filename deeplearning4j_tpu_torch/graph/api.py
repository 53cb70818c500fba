"""Core graph API types.

Parity with the reference's ``graph/api/`` package: ``Vertex.java``,
``Edge.java``, ``NoEdgeHandling.java``, ``exception/NoEdgesException.java``,
``exception/ParseException.java``.

The port's copy of the JAX package's jax-free ``graph/api.py``: the same
vertex, edge and exception types.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Optional


class NoEdgeHandling(enum.Enum):
    """What to do when a random walk reaches a vertex with no (outgoing) edges.

    Mirrors ``graph/api/NoEdgeHandling.java``.
    """

    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class NoEdgesException(Exception):
    """Raised when a walk hits a vertex with no outgoing edges in
    EXCEPTION_ON_DISCONNECTED mode (``graph/exception/NoEdgesException.java``)."""


class ParseException(Exception):
    """Raised on malformed graph-file lines (``graph/exception/ParseException.java``)."""


@dataclass(frozen=True)
class Vertex:
    """A vertex in a graph: integer index plus an arbitrary value
    (``graph/api/Vertex.java``)."""

    idx: int
    value: Any = None

    def vertex_id(self) -> int:
        return self.idx

    def get_value(self) -> Any:
        return self.value


@dataclass(frozen=True)
class Edge:
    """An edge, directed or undirected, with an optional value/weight
    (``graph/api/Edge.java``)."""

    from_idx: int
    to_idx: int
    value: Any = None
    directed: bool = False

    def get_from(self) -> int:
        return self.from_idx

    def get_to(self) -> int:
        return self.to_idx

    def get_value(self) -> Any:
        return self.value

    def is_directed(self) -> bool:
        return self.directed

    def weight(self) -> float:
        """Numeric weight of the edge (1.0 when the value is not numeric)."""
        if isinstance(self.value, (int, float)):
            return float(self.value)
        return 1.0
