"""Brute-force nearest neighbours on the card.

Counterpart of the JAX package's ``clustering/bruteforce.py`` (the
reference reaches k-NN through ``VPTree.java:48``): a corpus of N points
on the device and a batch of Q queries become one ``(Q, D) @ (D, N)``
product and a sort, with no pointer chasing.

Two things the reference's jitted path gives for free are kept by hand:

- The products run in full f32: ``|q|² − 2q·c + |c|²`` cancels near 0,
  which is why the reference asks for ``Precision.HIGHEST``. torch's f32
  ``matmul`` is full f32 unless the caller has turned TF32 on
  (``torch.backends.cuda.matmul.allow_tf32``, off by default); nothing
  here turns it on. The formula is the reference's, so that the distances
  are its distances (``torch.cdist`` would choose its own method).
- Ties keep the reference's order: ``jax.lax.top_k`` puts equal values
  lowest index first, and ``torch.topk`` on the card promises no order
  among ties, so :func:`knn` takes the first k of a stable sort.

:func:`pairwise_distance` and :func:`knn` follow their tensors' device
(numpy arrays are host tensors); :class:`BruteForceNearestNeighbors` puts
its corpus on the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

#: distance names accepted everywhere in this package (VPTree.java supports
#: "euclidean" by default plus similarity functions via ND4J reduce ops)
DISTANCES = ("euclidean", "sqeuclidean", "manhattan", "chebyshev", "cosine",
             "dot", "hamming", "jaccard")


def as_tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a float tensor: a tensor keeps its device (unless
    ``device`` is given), a numpy array or a list lands on ``device`` or
    the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device or x.device, dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device or "cpu")


def pairwise_distance(queries, corpus, distance: str = "euclidean") -> torch.Tensor:
    """``(Q, D) x (N, D) -> (Q, N)`` distance matrix on the inputs' device.

    Euclidean, cosine and dot take one product; the elementwise metrics
    broadcast, as the reference's do.
    """
    queries = queries if isinstance(queries, torch.Tensor) else as_tensor(queries)
    corpus = corpus if isinstance(corpus, torch.Tensor) else as_tensor(corpus)
    if distance in ("euclidean", "sqeuclidean"):
        # |q - c|^2 = |q|^2 - 2 q.c + |c|^2 ; the q.c term is the product.
        qq = torch.sum(queries * queries, dim=-1, keepdim=True)
        cc = torch.sum(corpus * corpus, dim=-1)
        d2 = qq - 2.0 * torch.matmul(queries, corpus.T) + cc[None, :]
        d2 = torch.clamp(d2, min=0.0)
        return d2 if distance == "sqeuclidean" else torch.sqrt(d2)
    if distance == "cosine":
        qn = queries / (torch.linalg.norm(queries, dim=-1, keepdim=True) + 1e-12)
        cn = corpus / (torch.linalg.norm(corpus, dim=-1, keepdim=True) + 1e-12)
        return 1.0 - torch.matmul(qn, cn.T)
    if distance == "dot":
        return -torch.matmul(queries, corpus.T)
    if distance == "manhattan":
        return torch.sum(torch.abs(queries[:, None, :] - corpus[None, :, :]), dim=-1)
    if distance == "chebyshev":
        return torch.amax(torch.abs(queries[:, None, :] - corpus[None, :, :]), dim=-1)
    if distance == "hamming":
        return torch.mean((queries[:, None, :] != corpus[None, :, :]).to(queries.dtype),
                          dim=-1)
    if distance == "jaccard":
        mn = torch.minimum(queries[:, None, :], corpus[None, :, :]).sum(-1)
        mx = torch.maximum(queries[:, None, :], corpus[None, :, :]).sum(-1)
        return 1.0 - mn / (mx + 1e-12)
    raise ValueError(f"unknown distance {distance!r}; expected one of {DISTANCES}")


def smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d`` and their indices,
    ascending, equal values lowest index first (``jax.lax.top_k``'s order
    on the negated row)."""
    values, idx = torch.sort(d, dim=-1, stable=True)
    return values[..., :k], idx[..., :k]


def knn(queries, corpus, k: int,
        distance: str = "euclidean") -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest: returns ``(distances, indices)`` each ``(Q, k)``."""
    return smallest(pairwise_distance(queries, corpus, distance), k)


class BruteForceNearestNeighbors:
    """Device-resident k-NN index (role of ``VPTree`` for batch queries).

    Holds the corpus on the device once; every query batch is one product
    and a sort. ``query_chunk`` bounds the (Q, N) scratch.
    """

    def __init__(self, points, distance: str = "euclidean",
                 query_chunk: int = 4096, device=None):
        self.device = resolve_device(device)
        self.points = as_tensor(points, self.device)
        self.distance = distance
        self.query_chunk = int(query_chunk)

    def __len__(self) -> int:
        return int(self.points.shape[0])

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.atleast_2d(as_tensor(queries, self.points.device))
        k = min(int(k), len(self))
        outs_d, outs_i = [], []
        for s in range(0, q.shape[0], self.query_chunk):
            d, i = knn(q[s:s + self.query_chunk], self.points, k, self.distance)
            outs_d.append(d)
            outs_i.append(i)
        return (torch.cat(outs_d).cpu().numpy(), torch.cat(outs_i).cpu().numpy())

    def search_excluding_self(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN of every corpus point against the corpus, self excluded
        (what Barnes-Hut t-SNE and VPTreeFillSearch need): the query's own
        row is dropped by index from its k + 1 nearest, else the last."""
        d, i = self.search(self.points, k + 1)
        dropped = i == np.arange(len(i))[:, None]
        # the kept entries first, in their order (a row without its own
        # index keeps its first k)
        order = np.argsort(dropped, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(d, order, axis=1),
                np.take_along_axis(i, order, axis=1))
