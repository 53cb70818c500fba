"""t-SNE (parity: ``deeplearning4j-core/.../plot/BarnesHutTsne.java:65``).

Two execution paths, selected like the reference selects exact-vs-BH via
``theta``:

- ``theta == 0`` → **exact t-SNE fully on device**: the (N, N) affinity and
  gradient are product and broadcast work, the iteration loop an eager
  torch loop with no host read inside it.
- ``theta > 0`` → **Barnes-Hut on host**: sparse input affinities from
  device k-NN (:class:`~..clustering.bruteforce.BruteForceNearestNeighbors`),
  per-iteration :class:`~..clustering.sptree.SpTree` forces on CPU, matching
  the reference algorithm for N too large for the quadratic path.

The port's counterpart of the JAX package's ``plot/tsne.py``: the exact
path runs on the card (``device=None``) or the host (``device="cpu"``);
the perplexity search and the Barnes-Hut loop are the reference's host
numpy, its k-NN the port's brute-force index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device

from ..clustering.bruteforce import (
    BruteForceNearestNeighbors,
    as_tensor,
    pairwise_distance,
)


# -- shared: perplexity calibration (BarnesHutTsne.computeGaussianPerplexity) --

def _binary_search_betas(d2: np.ndarray, perplexity: float,
                         tol: float = 1e-5, iters: int = 50) -> np.ndarray:
    """Per-row precision (beta) so row entropy == log(perplexity).

    d2: (N, K) squared distances to the considered neighbors (self excluded).
    Vectorized over rows (the reference does a per-row scalar loop).
    """
    n = d2.shape[0]
    beta = np.ones(n)
    beta_min = np.full(n, -np.inf)
    beta_max = np.full(n, np.inf)
    log_u = np.log(perplexity)
    p = np.zeros_like(d2)
    for _ in range(iters):
        p = np.exp(-d2 * beta[:, None])
        sum_p = np.maximum(p.sum(1), 1e-12)
        h = np.log(sum_p) + beta * (d2 * p).sum(1) / sum_p
        diff = h - log_u
        done = np.abs(diff) < tol
        if done.all():
            break
        hi = diff > 0
        beta_min = np.where(hi & ~done, beta, beta_min)
        beta_max = np.where(~hi & ~done, beta, beta_max)
        beta = np.where(
            hi & ~done,
            np.where(np.isinf(beta_max), beta * 2, (beta + beta_max) / 2),
            np.where(~hi & ~done,
                     np.where(np.isinf(beta_min), beta / 2, (beta + beta_min) / 2),
                     beta))
    return p / np.maximum(p.sum(1, keepdims=True), 1e-12)


# -- exact path (device) ------------------------------------------------------

def _exact_tsne_run(p: torch.Tensor, y0: torch.Tensor, n_iter: int,
                    stop_lying_iter: int, momentum_switch: int,
                    learning_rate: float) -> torch.Tensor:
    """Full exact t-SNE optimization, an eager loop on ``p``'s device (the
    reference's one compiled ``fori_loop``) that never reads the device
    from the host."""

    def grad_kl(y, pmat):
        d2 = pairwise_distance(y, y, "sqeuclidean")
        num = 1.0 / (1.0 + d2)
        num.fill_diagonal_(0.0)
        q = num / torch.clamp(num.sum(), min=1e-12)
        pq = (pmat - q) * num
        # 4 (diag(rowsum pq) - pq) @ y, without the N x N diagonal matrix
        return 4.0 * (pq.sum(1)[:, None] * y - pq @ y)

    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    for i in range(n_iter):
        pmat = p * 4.0 if i < stop_lying_iter else p  # early exaggeration
        g = grad_kl(y, pmat)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
        mom = 0.5 if i < momentum_switch else 0.8
        vel = mom * vel - learning_rate * gains * g
        y = y + vel
        y = y - y.mean(0)
    return y


class Tsne:
    """Exact t-SNE, device-resident (role of the non-BH path in
    ``BarnesHutTsne.java`` when ``theta == 0``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate="auto", n_iter: int = 1000,
                 stop_lying_iteration: int = 100, momentum_switch: int = 100,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.stop_lying_iteration = stop_lying_iteration
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.y: Optional[np.ndarray] = None

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        xt = as_tensor(x, self.device)
        d2 = pairwise_distance(xt, xt, "sqeuclidean").cpu().numpy()
        np.fill_diagonal(d2, np.inf)
        p_cond = _binary_search_betas(
            np.where(np.isinf(d2), 1e12, d2),
            min(self.perplexity, (n - 1) / 3.0))
        p = (p_cond + p_cond.T) / (2.0 * n)
        p = np.maximum(p, 1e-12)
        rng = np.random.default_rng(self.seed)
        y0 = (rng.standard_normal((n, self.n_components)) * 1e-4).astype(np.float32)
        lr = (max(n / 16.0, 50.0) if self.learning_rate == "auto"
              else float(self.learning_rate))
        y = _exact_tsne_run(as_tensor(p, self.device), as_tensor(y0, self.device),
                            self.n_iter, self.stop_lying_iteration,
                            self.momentum_switch, lr)
        self.y = y.cpu().numpy()
        return self.y


class BarnesHutTsne:
    """Barnes-Hut t-SNE (``BarnesHutTsne.java:65``; builder defaults
    ``theta=0.5``, ``perplexity=30``, 3*perplexity neighbors).

    ``theta=0`` falls back to the exact device path.
    """

    def __init__(self, n_components: int = 2, theta: float = 0.5,
                 perplexity: float = 30.0, learning_rate="auto",
                 n_iter: int = 1000, stop_lying_iteration: int = 100,
                 momentum_switch: int = 100, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.n_components = n_components
        self.theta = float(theta)
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.stop_lying_iteration = stop_lying_iteration
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.y: Optional[np.ndarray] = None

    def fit_transform(self, x) -> np.ndarray:
        if self.theta == 0.0:
            inner = Tsne(self.n_components, self.perplexity,
                         self.learning_rate, self.n_iter,
                         self.stop_lying_iteration, self.momentum_switch,
                         self.seed, device=self.device)
            self.y = inner.fit_transform(x)
            return self.y

        from ..clustering.sptree import SpTree

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        k = min(int(3 * self.perplexity), n - 1)
        # sparse symmetric P from device k-NN
        index = BruteForceNearestNeighbors(x, "euclidean", device=self.device)
        nd, ni = index.search_excluding_self(k)
        p_cond = _binary_search_betas((nd ** 2).astype(np.float64),
                                      min(self.perplexity, k / 3.0))
        p = {}
        for i in range(n):
            for j_pos in range(k):
                j = int(ni[i, j_pos])
                v = p_cond[i, j_pos]
                p[(i, j)] = p.get((i, j), 0.0) + v
                p[(j, i)] = p.get((j, i), 0.0) + v
        total = sum(p.values())
        # CSR triplets
        rows = np.zeros(n + 1, np.int64)
        for (i, _), _v in p.items():
            rows[i + 1] += 1
        rows = np.cumsum(rows)
        cols = np.zeros(len(p), np.int64)
        vals = np.zeros(len(p), np.float64)
        fill = rows[:-1].copy()
        for (i, j), v in p.items():
            cols[fill[i]] = j
            vals[fill[i]] = max(v / total, 1e-12)
            fill[i] += 1

        lr = (max(n / 48.0, 50.0) if self.learning_rate == "auto"
              else float(self.learning_rate))
        rng = np.random.default_rng(self.seed)
        y = (rng.standard_normal((n, self.n_components)) * 1e-4)
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.n_iter):
            exagg = 12.0 if it < self.stop_lying_iteration else 1.0
            tree = SpTree(y)
            pos_f = np.zeros_like(y)
            neg_f = np.zeros_like(y)
            tree.compute_edge_forces(rows, cols, vals * exagg, pos_f)
            sum_q = 0.0
            for i in range(n):
                row_neg = np.zeros(self.n_components)
                sum_q += tree.compute_non_edge_forces(i, self.theta, row_neg)
                neg_f[i] = row_neg
            g = pos_f - neg_f / max(sum_q, 1e-12)
            same = np.sign(g) == np.sign(vel)
            gains = np.clip(np.where(same, gains * 0.8, gains + 0.2), 0.01, None)
            mom = 0.5 if it < self.momentum_switch else 0.8
            vel = mom * vel - lr * gains * g
            y = y + vel
            y = y - y.mean(0)
        self.y = y.astype(np.float32)
        return self.y

    # reference-style aliases (BarnesHutTsne.fit / getData)
    fit = fit_transform

    def get_data(self) -> Optional[np.ndarray]:
        return self.y
