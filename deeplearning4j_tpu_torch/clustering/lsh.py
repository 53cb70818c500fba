"""Locality-sensitive hashing (parity: ``clustering/lsh/LSH.java`` +
``RandomProjectionLSH.java``).

Counterpart of the JAX package's ``clustering/lsh.py``: sign-of-random-
projection hashing whose products run on the card (one ``(N, D) @ (D,
hash_length)`` product a table), the buckets on the host as in the
reference, then exact re-ranking of the candidates on the card. The
projections come from the reference's numpy generator, so the hashes are
the reference's wherever no projection lies within rounding of 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

from .bruteforce import as_tensor, knn, pairwise_distance


class RandomProjectionLSH:
    """``RandomProjectionLSH(hashLength, numTables, intDimensions, radius)``.

    Multi-table sign-LSH: each table hashes with its own random projection;
    search unions the query's buckets across tables and re-ranks exactly.
    """

    def __init__(self, hash_length: int = 16, num_tables: int = 4,
                 in_dimensions: int = None, radius: float = 1.0, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.hash_length = int(hash_length)
        self.num_tables = int(num_tables)
        self.in_dimensions = in_dimensions
        self.radius = float(radius)
        self.seed = seed
        self.data: Optional[np.ndarray] = None
        self._data: Optional[torch.Tensor] = None    # the corpus on the device
        self._proj: Optional[torch.Tensor] = None    # (T, D, H) on the device
        self._tables: List[Dict[int, List[int]]] = []

    def hash_signs(self, x) -> np.ndarray:
        """(N, D) -> (T, N, H) bool: the sign bits, one product a table."""
        x = as_tensor(x, self.device)
        return np.stack([(x @ self._proj[t] > 0).cpu().numpy()
                         for t in range(self.num_tables)])

    def _hash_bits(self, x) -> np.ndarray:
        """(N, D) -> (T, N) packed integer hashes."""
        weights = (1 << np.arange(self.hash_length)).astype(np.int64)
        return self.hash_signs(x).astype(np.int64) @ weights

    def make_index(self, data) -> None:
        """Hash + bucket the corpus (``LSH.makeIndex``)."""
        self.data = np.asarray(data, np.float32)
        n, d = self.data.shape
        self.in_dimensions = d
        self._data = as_tensor(self.data, self.device)
        rng = np.random.default_rng(self.seed)
        self._proj = as_tensor(rng.standard_normal(
            (self.num_tables, d, self.hash_length)).astype(np.float32), self.device)
        codes = self._hash_bits(self._data)           # (T, N)
        self._tables = []
        for t in range(self.num_tables):
            buckets: Dict[int, List[int]] = {}
            for i, c in enumerate(codes[t]):
                buckets.setdefault(int(c), []).append(i)
            self._tables.append(buckets)

    def bucket(self, query) -> np.ndarray:
        """Candidate indices sharing a bucket with the query in any table
        (``LSH.bucket``)."""
        q = np.asarray(query, np.float32).reshape(1, -1)
        codes = self._hash_bits(q)[:, 0]
        cand: List[int] = []
        for t in range(self.num_tables):
            cand.extend(self._tables[t].get(int(codes[t]), []))
        return np.unique(np.array(cand, np.int64))

    def _query(self, query) -> torch.Tensor:
        return as_tensor(np.asarray(query, np.float32).reshape(1, -1), self.device)

    def search(self, query, max_range: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact-ranked candidates within ``max_range`` (``LSH.search``).
        Returns (distances, indices) sorted ascending."""
        max_range = self.radius if max_range is None else float(max_range)
        cand = self.bucket(query)
        if cand.size == 0:
            return np.empty(0, np.float32), np.empty(0, np.int64)
        d = pairwise_distance(self._query(query),
                              self._data[torch.from_numpy(cand).to(self.device)]
                              )[0].cpu().numpy()
        keep = d <= max_range
        order = np.argsort(d[keep])
        return d[keep][order].astype(np.float32), cand[keep][order]

    def get_all_nearest_neighbors(self, query, k: int
                                  ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN among bucket candidates, exact-fallback when the buckets
        under-fill (mirrors VPTreeFillSearch's guarantee)."""
        cand = self.bucket(query)
        q = self._query(query)
        if cand.size < k:
            d, i = knn(q, self._data, min(k, len(self.data)))
            return d[0].cpu().numpy(), i[0].cpu().numpy()
        d, i = knn(q, self._data[torch.from_numpy(cand).to(self.device)],
                   min(k, cand.size))
        return d[0].cpu().numpy(), cand[i[0].cpu().numpy()]
