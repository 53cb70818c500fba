"""Where the network code meets DTensors.

A network placed on a device mesh (``parallel/sharding.py``) holds its
parameters, updater state and layer state as DTensors, and its batches
arrive as DTensors sharded over the mesh's ``data`` axis. The layers run
on them through DTensor's own dispatch, which keeps the global batch's
semantics: a mean over the batch is the whole batch's. These are the few
places where that dispatch needs a word from the network code.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate


def spread(t, dim=None) -> bool:
    """True for a DTensor that is sharded (or partial) over a mesh
    dimension of more than one rank — on tensor dimension ``dim`` when
    given. On a mesh of one rank a DTensor is its full value, and the
    network code then takes exactly the path of a plain tensor."""
    if not isinstance(t, DTensor):
        return False
    mesh = t.device_mesh
    for i, p in enumerate(t.placements):
        if mesh.size(i) <= 1 or p.is_replicate():
            continue
        if dim is None or (p.is_shard() and p.dim % t.ndim == dim % t.ndim):
            return True
    return False


def reduce_partial(t):
    """A DTensor whose placements hold a ``Partial`` (a reduction over a
    sharded dimension, such as a mean over the batch) with each ``Partial``
    reduced to ``Replicate``, so that what combines it with a sharded
    tensor next keeps the sharded tensor's placements; anything else
    unchanged. Batch statistics (BatchNorm's mean and variance) pass
    through it."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in t.placements])
    return t


def full(t):
    """A plain tensor of ``t``'s global value (``full_tensor()`` of a
    DTensor, which gathers its shards); a plain tensor unchanged."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@contextlib.contextmanager
def mesh_scope(net):
    """Inside it, a network placed on a mesh (``net._mesh``) may combine
    its DTensors with plain tensors (a causal mask, a dropout draw, a
    recurrent layer's initial carry), each taken as replicated: the same
    full value on every rank, which every plain tensor of the network's
    code is. Re-entrant; nothing happens for a network on no mesh."""
    if getattr(net, "_mesh", None) is None:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def place_input(net, t):
    """A batch tensor of a network placed on a mesh: a DTensor passes
    through, a plain tensor (the full batch, the same on every rank) is
    placed sharded over the mesh's ``data`` axis when its leading dimension
    divides the axis, else replicated. A network on no mesh gets ``t``
    back."""
    mesh = getattr(net, "_mesh", None)
    if mesh is None or t is None or isinstance(t, DTensor):
        return t
    from deeplearning4j_tpu_torch.parallel.sharding import place_batch

    return place_batch(t, mesh)


def match_placements(g, p):
    """``g`` (a gradient) on the placements of ``p`` (its parameter) when
    ``p`` is a DTensor: a ``Partial`` gradient is reduced (an all-reduce,
    or a reduce-scatter onto a sharded parameter), a plain one taken as
    replicated and cut; anything else unchanged."""
    if not isinstance(p, DTensor):
        return g
    if not isinstance(g, DTensor):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(g, p.device_mesh, p.placements, src_data_rank=None)
    if tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def inference(net):
    """The context of an inference forward: ``torch.inference_mode()``, or
    ``torch.no_grad()`` on a network placed on a mesh (DTensor's views
    cannot be made of inference tensors)."""
    if getattr(net, "_mesh", None) is None:
        return torch.inference_mode()
    return torch.no_grad()


def _class_sharded(x) -> bool:
    """True for a DTensor sharded on its last (class) dimension."""
    return spread(x, -1)


def log_softmax(x):
    """``torch.log_softmax(x, dim=-1)``; on a DTensor whose last dimension
    is sharded (column-parallel logits) the log-sum-exp is taken sharded:
    the row maximum and the sum of exponentials are each one all-reduce
    of a row statistic, and the classes are never gathered."""
    if not _class_sharded(x):
        return torch.log_softmax(x, dim=-1)
    z = x - reduce_partial(x.detach().amax(dim=-1, keepdim=True))
    return z - torch.log(reduce_partial(torch.exp(z).sum(dim=-1, keepdim=True)))


def softmax(x):
    """``torch.softmax(x, dim=-1)``; sharded over the classes as
    :func:`log_softmax` is."""
    if not _class_sharded(x):
        return torch.softmax(x, dim=-1)
    return torch.exp(log_softmax(x))


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward reduces a ``Partial`` gradient to
    ``Replicate`` (Megatron's "f" operator before a column-parallel
    product)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def column_input(x, w):
    """``x`` as the input of ``x @ w``: when ``w`` is a DTensor sharded on
    its last dimension (column-parallel), ``x``'s gradient, a ``Partial``
    sum over the columns' shards, is all-reduced right there, instead of
    flowing back partial until an operator gathers a weight for it."""
    if (spread(w, -1) and isinstance(x, DTensor) and torch.is_grad_enabled()
            and x.requires_grad):
        return _ReduceGrad.apply(x)
    return x


def mean(x, dims=None):
    """``x.mean(dim=dims)`` (every dimension when None); on a DTensor
    sharded over more than one rank, the sum divided by the count and
    reduced to ``Replicate`` (:func:`reduce_partial`): a sum over a sharded
    dimension is a ``Partial`` sum, whose gradient flows back through the
    reduction as a sum again, where DTensor's own mean would gather the
    shards or leave a ``Partial`` average that its backward refuses. Batch
    statistics (BatchNorm's mean and variance) and a loss's mean pass
    through it."""
    if not spread(x):
        return torch.mean(x) if dims is None else x.mean(dim=dims)
    if dims is None:
        return reduce_partial(torch.sum(x)) / x.numel()
    count = 1
    for d in dims:
        count *= x.shape[d]
    return reduce_partial(x.sum(dim=dims) / count)


def batch_local(fn, x, *weights):
    """``fn(x, *weights)``, on a DTensor ``x`` run on each rank's block
    through ``local_map``: ``x`` sharded on its batch (dim 0) or
    replicated on each mesh dimension, the weights replicated (a plain
    weight is taken as replicated); the output is placed as ``x``, and a
    weight's gradient comes back as a ``Partial`` sum over the batch's
    shards. For the operations whose work is per example (a convolution,
    a pooling window): DTensor's own rules for them differ between torch
    versions, and some take only the tensor-parallel split of the width.
    Any other placement raises. A plain ``x`` gets ``fn(x, *weights)``."""
    if not isinstance(x, DTensor):
        return fn(x, *weights)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    batch = set()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == 0:
            batch.add(i)
        elif not isinstance(p, Replicate):
            raise ValueError(f"a per-example operation takes a batch-sharded or "
                             f"replicated input; got {tuple(x.placements)}")
    rep = [Replicate()] * mesh.ndim
    placed = []
    for w in weights:
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, mesh, rep, run_check=False)
        elif any(not isinstance(p, Replicate) for p in w.placements):
            raise ValueError(f"a per-example operation takes replicated weights; "
                             f"got {tuple(w.placements)}")
        placed.append(w)
    pl_x = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    grad_w = [Partial() if i in batch else Replicate() for i in range(mesh.ndim)]
    return local_map(fn, out_placements=pl_x,
                     in_placements=(pl_x, *([rep] * len(placed))),
                     in_grad_placements=(pl_x, *([grad_w] * len(placed))),
                     device_mesh=mesh)(x, *placed)
