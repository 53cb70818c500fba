"""The pieces of an eager train step that both networks share.

``ComputationGraph`` (``nn/graph.py``) and ``MultiLayerNetwork``
(``nn/multilayer.py``) keep their parameters as ``{key: {param: tensor}}``
(the key is a vertex name or a layer index), registered on the module as
``<key>/<param>``, with one updater and one updater state per tensor. The
parameters never require grad: :func:`gradients` differentiates detached
aliases of them (they share storage) with ``torch.autograd.grad``, and
:func:`apply_updates` then writes the new values IN PLACE under
``torch.no_grad()`` (a helper such as ``FusedUpdaterHelper`` writes into
their storage), so an inference pass never meets an autograd graph.

Layer state (BatchNorm's running statistics; ``Layer.init_state``) lives
beside the parameters as ``{key: {name: tensor}}``, registered on the
module as buffers ``<key>/<name>``. It takes no gradient and no updater:
a train forward returns each stateful layer's new state, and
:func:`commit_states` copies it over the old one, in place, once per
update.

Mixed precision (the configuration's ``compute_dtype``): a network casts
its f32 master parameters and its floating inputs to the compute dtype
inside the forward (:func:`compute_cast_tree`), so the gradients that
``torch.autograd.grad`` returns for the masters are f32 and everything
after it (the updater seam, gradient normalization, constraints) sees f32
parameters and f32 gradients, as without it.

Per layer, :func:`apply_updates` normalizes the gradients (the layer's
``gradient_normalization``) before the updater seam, so a fused updater
kernel sees the normalized gradient, and runs the layer's constraints
after its update, writing them into the same tensors. The train-time
noise (dropout, weight noise, attention dropout) draws from a network's
own generator, :func:`dropout_generator`, on the network's device.

On a network placed on a device mesh (``parallel/sharding.py``) the
trees hold DTensors: :func:`gradients` returns a replicated parameter's
gradient as a ``Partial`` sum over the batch's shards, and
:func:`apply_updates` reduces it onto the parameter's placements first.

Gradient checkpointing (the configuration's ``gradient_checkpointing``):
:func:`checkpointed_forward` runs a layer's train forward under
``torch.utils.checkpoint`` (non-reentrant, so that parameters get their
gradients where no input requires grad), and its backward recomputes
the forward instead of keeping the activations. The recompute draws from
the network's generator set to the state the forward started from, so it
draws the same masks; the generator then takes back the state the
recompute found it in, so the draws after the step are those without
checkpointing. The layer's new state comes from the first forward only.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from deeplearning4j_tpu_torch.nn import helpers as _helpers
from deeplearning4j_tpu_torch.nn.activations import signed_abs
from deeplearning4j_tpu_torch.nn.constraints import apply_constraints
from deeplearning4j_tpu_torch.nn.dtensor import full, match_placements
from deeplearning4j_tpu_torch.nn.updaters import Sgd, normalize_gradients

Tree = Dict[object, Dict[str, torch.Tensor]]


def as_tensor(x, dtype: torch.dtype, device, cast_float: bool = True) -> torch.Tensor:
    """A numpy array or tensor on ``device``; floating data in ``dtype``
    when ``cast_float`` (token ids arrive as floats, as in the reference)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if cast_float and t.is_floating_point() and t.dtype != dtype:
        t = t.to(dtype)
    if isinstance(t, DTensor):  # placed on a mesh: its device is the mesh's
        return t
    return t.to(device)


def compute_cast(t, dtype: Optional[torch.dtype]):
    """The reference's mixed-precision ``cast``: a floating tensor in the
    compute ``dtype``, anything else (integer ids, None, a Python int)
    untouched; no-op when ``dtype`` is None. Through autograd the cast of
    an f32 master parameter gives it an f32 gradient, as ``jax.grad``
    through ``astype`` does."""
    if (dtype is not None and isinstance(t, torch.Tensor)
            and t.is_floating_point() and t.dtype != dtype):
        return t.to(dtype)
    return t


def compute_cast_tree(params: Tree, dtype: Optional[torch.dtype]) -> Tree:
    """:func:`compute_cast` over ``{key: {param: tensor}}``."""
    if dtype is None:
        return params
    return {k: {n: compute_cast(t, dtype) for n, t in named.items()}
            for k, named in params.items()}


def to_host(a) -> np.ndarray:
    """A numpy array of ``a`` (a numpy array or a tensor on any device;
    bf16 as f32)."""
    if isinstance(a, torch.Tensor):
        a = full(a).detach().cpu()
        # numpy has no bf16: a mixed-precision answer comes back as f32
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def init_parameters(module: nn.Module, layers: Iterable[Tuple[object, object]],
                    global_conf, gen: torch.Generator, dtype, device):
    """Random parameters for each ``(key, layer)``, registered on
    ``module`` as ``<key>/<param>`` (never requiring grad). Each tensor
    gets its updater (the layer's, else the network's, else ``Sgd(0.1)``;
    ``b`` takes the bias updater when one is set) and that updater's zero
    state. Returns ``(params, updaters, updater_states)``."""
    default_updater = global_conf.updater or Sgd(0.1)
    params, updaters, states = {}, {}, {}
    for key, layer in layers:
        layer_upd = layer.updater or default_updater
        bias_upd = layer.bias_updater or global_conf.bias_updater or layer_upd
        params[key], updaters[key], states[key] = {}, {}, {}
        for n, t in layer.init_params(gen, dtype, device).items():
            param = nn.Parameter(t, requires_grad=False)
            module.register_parameter(f"{key}/{n}", param)
            u = bias_upd if n == "b" else layer_upd
            params[key][n] = param
            updaters[key][n] = u
            states[key][n] = u.init_state(param.detach())
    return params, updaters, states


def init_states(module: nn.Module, layers: Iterable[Tuple[object, object]],
                device) -> Tree:
    """Each ``(key, layer)``'s initial state (empty for a stateless
    layer), registered on ``module`` as buffers ``<key>/<name>``."""
    states = {}
    for key, layer in layers:
        states[key] = layer.init_state(device)
        for n, t in states[key].items():
            module.register_buffer(f"{key}/{n}", t)
    return states


def commit_states(states: Tree, new_states: Tree) -> None:
    """Copy each new state (detached) over the old, in place, so that the
    buffers keep their identity. A state the layer did not start with, or
    one whose shape changed (a mixture of experts' collected gates, one row
    a token of the last batch), replaces the old entry."""
    with torch.no_grad():
        for key, named in new_states.items():
            for n, t in named.items():
                old = states[key].get(n)
                if old is None or old.shape != t.shape:
                    states[key][n] = t.detach().clone()
                elif t is not old:
                    old.copy_(t)


def checkpointed_forward(forward: Callable, gen: Optional[torch.Generator], *args):
    """``forward(*args) -> (y, new_state)`` with ``y``'s activations
    recomputed in the backward pass; returns ``(y, new_state)``, the state
    of the first forward. ``gen``, the generator ``forward`` draws from,
    replays in the recompute."""
    from torch.utils.checkpoint import checkpoint

    start = None if gen is None else gen.get_state()
    first = []  # the new state of the first forward

    def run(*a):
        if first:  # the recompute, in the backward pass
            if gen is None:
                return forward(*a)[0]
            now = gen.get_state()
            gen.set_state(start)
            try:  # the recompute may stop early, by raising
                return forward(*a)[0]
            finally:
                gen.set_state(now)
        y, st = forward(*a)
        first.append(st)
        return y

    # every draw comes from ``gen``, saved and restored above, so the
    # global generators need no saving
    y = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    return y, first[0]


def regularization(layers: Iterable[Tuple[object, object]], params: Tree):
    """The l1/l2 penalty of every ``(key, layer)``'s parameters: ``b``
    takes ``l1_bias``/``l2_bias``, every other tensor ``l1``/``l2``;
    ``l1·Σ|v| + ½·l2·Σv²``. 0.0 when nothing is regularized."""
    reg = 0.0
    for key, layer in layers:
        for n, v in params[key].items():
            is_bias = n == "b"
            l1 = (layer.l1_bias if is_bias else layer.l1) or 0.0
            l2 = (layer.l2_bias if is_bias else layer.l2) or 0.0
            if l1:
                # the subgradient at 0 is +1, as jax.grad of jnp.abs gives,
                # so biases that start at 0 move alike
                reg = reg + l1 * torch.sum(signed_abs(v))
            if l2:
                reg = reg + 0.5 * l2 * torch.sum(v * v)
    return reg


def gradients(loss_fn: Callable, params: Tree):
    """``(loss, grads, aux)`` of ``loss_fn(live) -> (loss, aux)``, where
    ``live`` holds detached aliases of ``params`` that require grad; the
    loss comes back detached and ``grads`` shaped as ``params``."""
    live = {k: {n: t.detach().requires_grad_(True) for n, t in named.items()}
            for k, named in params.items()}
    leaves = [t for named in live.values() for t in named.values()]
    with torch.enable_grad():
        loss, aux = loss_fn(live)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)
    it = iter(flat)
    grads = {k: {n: next(it) for n in named} for k, named in live.items()}
    return loss.detach(), grads, aux


#: the dropout generator's seed is the network's seed plus this, so its
#: stream stays apart from the one that initialized the parameters
DROPOUT_SEED_OFFSET = 0x9E3779B9


def dropout_generator(seed: int, device) -> torch.Generator:
    """The generator every train-time draw of a network comes from, on the
    network's device, seeded from the network's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + DROPOUT_SEED_OFFSET) % 2 ** 63)
    return gen


def apply_updates(params: Tree, grads: Tree, updaters, states,
                  iteration: int, epoch: int, layers=None) -> None:
    """One updater step per parameter tensor, in place, at the 1-based step
    ``iteration + 1``. A registered "updater" helper takes every tensor its
    ``supports`` admits (the reference's seam); the others take their
    updater's stock math. ``layers`` (``{key: layer}``) brings each
    layer's gradient normalization, before its update, and its
    constraints, after it."""
    uhelper = _helpers.get_helper("updater")
    it, ep = np.float32(iteration), np.float32(epoch)
    t = float(iteration) + 1.0
    layers = layers or {}
    with torch.no_grad():
        for key, named in grads.items():
            layer = layers.get(key)
            if layer is not None and layer.gradient_normalization:
                # on DTensors the norms are the whole tensors'
                named = {n: match_placements(g, params[key][n])
                         for n, g in named.items()}
                named = normalize_gradients(
                    named, layer.gradient_normalization,
                    layer.gradient_normalization_threshold)
            for n, g in named.items():
                u = updaters[key][n]
                p = params[key][n]
                # on a mesh, a Partial gradient (summed over the batch's
                # shards) is reduced onto the parameter's own placements
                g = match_placements(g, p)
                lr = u.lr_at(it, ep)
                if uhelper is not None and uhelper.supports(u, p, g):
                    p_new, states[key][n] = uhelper.apply(u, p, g, states[key][n],
                                                          lr, t)
                    if p_new is not p:
                        p.copy_(p_new)
                    continue
                upd, states[key][n] = u.update(g, states[key][n], lr, t)
                p.sub_(upd.to(p.dtype))
            if layer is not None:
                # written into the same tensors: the updater state and a
                # fused kernel keep pointing at them
                for n, v in apply_constraints(layer, params[key]).items():
                    if v is not params[key][n]:
                        params[key][n].copy_(v)


def pretrain_batches(data):
    """The batches a ``pretrain_layer`` call walks: a DataSet (or
    MultiDataSet) as one batch, an array or tensor as the features of one,
    anything else as an iterator of them."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    if hasattr(data, "features"):
        return [data]
    if hasattr(data, "shape"):
        return [DataSet(data, data)]
    return data


def pretrain_step(layer, key, params: Tree, updaters, states, h: torch.Tensor,
                  gen: Optional[torch.Generator], step: int) -> torch.Tensor:
    """One layerwise-pretraining update of ``params[key]`` (the reference's
    jitted pretrain step): the gradient of ``layer.pretrain_loss`` alone (no
    l1/l2, no gradient normalization, no constraints), then the updater
    seam at the learning rate of ``(step, epoch 0)`` and the 1-based step
    ``step + 1``, where ``step`` counts from 0 in each ``pretrain_layer``
    call. The updater state is the one ``fit`` uses. Returns the loss."""
    loss, grads, _ = gradients(
        lambda live: (layer.pretrain_loss(live[key], h, gen), None),
        {key: params[key]})
    apply_updates({key: params[key]}, grads, {key: updaters[key]},
                  {key: states[key]}, step, 0)
    return loss

