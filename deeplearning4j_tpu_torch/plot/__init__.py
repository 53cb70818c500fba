"""Dimensionality-reduction / visualization (parity:
``deeplearning4j-core/.../plot/`` — ``BarnesHutTsne.java:65``).

The port's counterpart of the JAX package's ``plot/``."""

from .tsne import BarnesHutTsne, Tsne

__all__ = ["BarnesHutTsne", "Tsne"]
