"""Put-in masks for the regularizer parity tests.

JAX's threefry and torch's generators never draw the same numbers, so the
tests hand both packages the same draws. :class:`PutIn` replaces
``jax.random.bernoulli``, ``jax.random.normal`` and ``jax.random.uniform``
with functions that hand out numpy arrays from a seeded source in call
order (the JAX package's train and pretrain steps are jitted, so they
draw once, at trace time, and bake the draws into the compiled step),
and the port's ``nn/dropout.py`` ``bernoulli``, ``normal`` and
``uniform`` with functions that replay the same sequence, step after
step. A Bernoulli probability may be an array (a VAE's Bernoulli
samples), compared entry by entry. One step per compiled shape is what
such a comparison can hold.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import dropout as port_dropout


class PutIn:
    def __init__(self, monkeypatch, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.drawn = []  # (kind, array) in the JAX package's call order
        self.port_calls = 0
        monkeypatch.setattr(jax.random, "bernoulli", self._jax_bernoulli)
        monkeypatch.setattr(jax.random, "normal", self._jax_normal)
        monkeypatch.setattr(jax.random, "uniform", self._jax_uniform)
        monkeypatch.setattr(port_dropout, "bernoulli", self._port_bernoulli)
        monkeypatch.setattr(port_dropout, "normal", self._port_normal)
        monkeypatch.setattr(port_dropout, "uniform", self._port_uniform)

    # -- the JAX package's draws: fresh arrays, recorded -----------------
    def _jax_bernoulli(self, key, p=0.5, shape=None):
        mask = self.rng.random(tuple(shape)) < np.asarray(p, np.float64)
        self.drawn.append(("bernoulli", mask))
        return mask

    def _jax_normal(self, key, shape=(), dtype=np.float32):
        z = self.rng.standard_normal(tuple(shape)).astype(np.dtype(dtype))
        self.drawn.append(("normal", z))
        return z

    def _jax_uniform(self, key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0):
        u = self.rng.uniform(float(minval), float(maxval),
                             tuple(shape)).astype(np.dtype(dtype))
        self.drawn.append(("uniform", u))
        return u

    # -- the port's draws: the recorded arrays, replayed cyclically -------
    def _next(self, kind, shape):
        assert self.drawn, "the JAX package has drawn nothing yet"
        k, a = self.drawn[self.port_calls % len(self.drawn)]
        assert k == kind and a.shape == tuple(shape), (
            f"draw {self.port_calls}: the port asks {kind}{tuple(shape)}, the "
            f"JAX package drew {k}{a.shape}")
        self.port_calls += 1
        return a

    def _port_bernoulli(self, p, shape, gen, device, dtype=torch.float32):
        port_dropout._check_generator(gen, device)
        return torch.from_numpy(self._next("bernoulli", shape)).to(device)

    def _port_normal(self, shape, gen, device, dtype=torch.float32):
        port_dropout._check_generator(gen, device)
        z = self._next("normal", shape)
        if z.dtype.name == "bfloat16":  # torch cannot read numpy's (ml_dtypes) bf16
            z = z.astype(np.float32)  # exact: every bf16 is an f32
        return torch.from_numpy(z).to(device, dtype)

    def _port_uniform(self, shape, gen, device, dtype=torch.float32, low=0.0,
                      high=1.0):
        port_dropout._check_generator(gen, device)
        return torch.from_numpy(self._next("uniform", shape)).to(device, dtype)
