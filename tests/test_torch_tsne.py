"""The port's t-SNE against the JAX package's on the CPU.

The perplexity search is the reference's numpy, equal bit for bit. The
exact path's loop is chaotic: two f32 runs of 60 points part by 1e-1 at
iteration 20 in either package, as do f32 and f64 runs of one package
(lr 50, early exaggeration 4). So from the same affinities and start the
port's loop lies within 1e-4 × the largest coordinate of the reference's
for 10 iterations, and ``fit_transform`` (whose affinities come from each
package's own distances) for 5; at 50 iterations the port's f32 run lies
no farther from the f64 run than 4 × the reference's f32 run does.
Barnes-Hut runs 20 iterations on small-integer points, whose k-NN
distances both packages compute exactly, and lies within 1e-5 of the
reference's (its loop is the reference's host numpy).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.plot import tsne as R
from deeplearning4j_tpu_torch.plot import tsne as P
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4   # × the reference's largest coordinate
F64_FACTOR = 4.0


def _points(integer=False, n=60, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-2, 3, size=(n, d)) if integer
         else rng.standard_normal((n, d))).astype(np.float32)
    x[: n // 2] += 4
    return x


@functools.lru_cache(maxsize=None)
def _affinities():
    """The reference's P and start for the 60 points (perplexity 10)."""
    x = _points()
    n = len(x)
    d2 = np.array(R.pairwise_distance(jnp.asarray(x), jnp.asarray(x), "sqeuclidean"))
    np.fill_diagonal(d2, np.inf)
    p_cond = R._binary_search_betas(np.where(np.isinf(d2), 1e12, d2), 10.0)
    p = np.maximum((p_cond + p_cond.T) / (2.0 * n), 1e-12)
    y0 = (np.random.default_rng(0).standard_normal((n, 2)) * 1e-4).astype(np.float32)
    return p, y0


def _run_reference(n_iter):
    p, y0 = _affinities()
    return np.asarray(R._exact_tsne_run(jnp.asarray(p, jnp.float32), jnp.asarray(y0),
                                        n_iter, 100, 100, 50.0))


def _run_port(n_iter, dtype=torch.float32):
    p, y0 = _affinities()
    return P._exact_tsne_run(torch.tensor(p, dtype=dtype), torch.tensor(y0, dtype=dtype),
                             n_iter, 100, 100, 50.0).numpy()


@pytest.mark.parametrize("case", ["blobs", "narrow", "converged", "wide"])
def test_binary_search_betas_equals_the_reference_s(case):
    rng = np.random.default_rng(2)
    d2 = {"blobs": lambda: np.where(np.eye(40) > 0, 1e12, rng.random((40, 40)) * 9),
          "narrow": lambda: rng.random((30, 12)) * 1e-3,
          "converged": lambda: np.tile(np.log(np.arange(1, 9.0)), (5, 1)),
          "wide": lambda: rng.random((20, 19)) * 1e3}[case]()
    for perplexity in (2.0, 5.0):
        np.testing.assert_array_equal(P._binary_search_betas(d2, perplexity),
                                      R._binary_search_betas(d2, perplexity))


def test_exact_loop_from_the_same_start_matches_the_reference():
    want = _run_reference(10)
    got = _run_port(10)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_exact_loop_at_50_iterations_in_the_ratio_form():
    f64 = _run_port(50, torch.float64)
    port, ref = _run_port(50), _run_reference(50)
    assert np.isfinite(port).all()
    assert np.abs(port - f64).max() <= F64_FACTOR * np.abs(ref - f64).max()


def test_fit_transform_matches_the_reference():
    x = _points()
    want = R.Tsne(perplexity=10.0, n_iter=5, seed=0).fit_transform(x)
    model = P.Tsne(perplexity=10.0, n_iter=5, seed=0, device="cpu")
    got = model.fit_transform(x)
    assert got.dtype == np.float32 and got.shape == (60, 2)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    np.testing.assert_array_equal(model.y, got)
    # theta 0 is the exact path
    bh0 = P.BarnesHutTsne(theta=0.0, perplexity=10.0, n_iter=5, seed=0, device="cpu")
    np.testing.assert_array_equal(bh0.fit_transform(x), got)


def test_barnes_hut_matches_the_reference():
    x = _points(integer=True)
    want = R.BarnesHutTsne(perplexity=5.0, n_iter=20, seed=0).fit_transform(x)
    model = P.BarnesHutTsne(perplexity=5.0, n_iter=20, seed=0, device="cpu")
    got = model.fit(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(model.get_data(), got)
