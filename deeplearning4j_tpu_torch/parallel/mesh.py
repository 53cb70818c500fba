"""Device mesh construction helpers.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. The reference's
mesh is one controller's ``jax.sharding.Mesh`` over its devices; the
port's is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
a ``torch.distributed`` world, one device a rank (``cuda:<local rank>``
under NCCL, the CPU under gloo). Every rank runs the same program and
passes the same global batch, so the single-controller contract of the
reference holds: a full host array is the same on every rank, and
:func:`make_global` cuts each rank's block of it without communicating.

Axes keep the reference's names (data / model / pipe / seq / expert), and
``mesh_axes(mesh)`` gives the ``{axis: size}`` that ``mesh.shape`` is in
the reference. With no process group initialised, :func:`make_mesh` opens
a world of one rank (on ``cuda``, or on ``cpu`` when asked), so
``make_mesh()`` works with no setup, as the reference's does.

:func:`shard_map` is the reference's ``shard_map`` on
``torch.distributed.tensor.experimental.local_map``: the function sees
each rank's local block of every input and its outputs are taken as the
local blocks of DTensors of the given specs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

# Canonical axis names used across the framework.
DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPELINE_AXIS = "pipe"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"

#: the backend a world of one rank opens on each device type
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per tensor
    dimension, each None (not sharded), a mesh axis name, or a tuple of
    names; trailing dimensions may be left out. Compares as the tuple of
    its entries, so ``P(None, "model") == P(None, "model")`` and ``P() ==
    P()`` as in jax."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


def parse_mesh_axes(spec: str) -> Dict[str, int]:
    """Parse the CLI/env mesh-shape grammar ``"data=4,model=2"`` into the
    ``{axis: size}`` dict :func:`make_mesh` takes. ``-1`` (at most one
    axis) means inferred. The string form is what crosses process
    boundaries — the ``train``/``serve`` flags and the elastic
    supervisor→worker environment both carry it."""
    axes: Dict[str, int] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh axis {part!r} in {spec!r} (want name=size, "
                f"e.g. data=4,model=2)")
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or name in axes:
            raise ValueError(f"bad or duplicate mesh axis name in {spec!r}")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(
                f"mesh axis {name!r} has non-integer size {size!r}") from None
        if n == 0 or n < -1:
            raise ValueError(
                f"mesh axis {name!r} size must be positive or -1 "
                f"(inferred), got {n}")
        axes[name] = n
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    if sum(1 for s in axes.values() if s == -1) > 1:
        raise ValueError(f"at most one mesh axis may be -1: {spec!r}")
    return axes


def format_mesh_axes(axes: Dict[str, int]) -> str:
    """Inverse of :func:`parse_mesh_axes` (axis order preserved)."""
    return ",".join(f"{k}={int(v)}" for k, v in axes.items())


def ensure_world(device_type: Optional[str] = None) -> str:
    """The device type of the ``torch.distributed`` world, opening a world
    of one rank when none is initialised: NCCL on ``cuda`` (the default;
    it raises when there is no card), gloo on ``cpu``. A world that exists
    keeps its backend; asking it for another device type raises."""
    if dist.is_initialized():
        have = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if device_type is not None and device_type != have:
            raise ValueError(f"the process group runs on {have!r} "
                             f"({dist.get_backend()}); asked for {device_type!r}")
        return have
    device_type = device_type or "cuda"
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' "
                           "to run the mesh on the CPU")
    dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)
    return device_type


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None, *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """Build a DeviceMesh from ``{axis_name: size}`` over the world's ranks
    (``devices``: the ranks to lay out, all of them by default; one device
    a rank).

    At most one axis size may be -1 (inferred, like a reshape). Default is a
    pure data-parallel mesh over all ranks. Every rank of the world calls
    it with the same arguments; a layout asked for again in the same world
    gives the same mesh object."""
    device_type = ensure_world(device_type)
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    n = len(ranks)
    if axes is None:
        axes = {DATA_AXIS: n}
    names = list(axes.keys())
    sizes = list(axes.values())
    n_infer = sum(1 for s in sizes if s == -1)
    if n_infer > 1:
        raise ValueError("at most one mesh axis may be -1")
    if n_infer == 1:
        known = int(np.prod([s for s in sizes if s != -1])) if len(sizes) > 1 else 1
        if n % known:
            raise ValueError(f"cannot infer axis: {n} devices not divisible by {known}")
        sizes = [n // known if s == -1 else s for s in sizes]
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh wants {total} devices, only {n} available")
    layout = torch.tensor(ranks[:total], dtype=torch.int64).reshape(sizes)
    # one mesh object per layout and world: DTensor takes two meshes of one
    # layout for equal and caches sharding decisions per thread, so a
    # second mesh object would let threads (and so ranks) disagree on
    # whose process groups a collective runs on
    pg = dist.distributed_c10d._get_default_group()
    key = (device_type, tuple(names), tuple(sizes), tuple(ranks[:total]))
    have = _MESHES.get(key)
    if have is not None and have[0] is pg:
        return have[1]
    mesh = DeviceMesh(device_type, layout, mesh_dim_names=tuple(names))
    _MESHES[key] = (pg, mesh)
    return mesh


#: the meshes made in this process, by layout, with the world they were made in
_MESHES: Dict[tuple, tuple] = {}


def mesh_axes(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` on ``mesh``; 1 for an axis it has not (or no
    mesh)."""
    if mesh is None:
        return 1
    return mesh_axes(mesh).get(axis, 1)


def local_mesh(n: Optional[int] = None, axis: str = DATA_AXIS, *,
               device_type: Optional[str] = None) -> DeviceMesh:
    """1-D data-parallel mesh over the first ``n`` ranks of this host (all
    of them by default)."""
    device_type = ensure_world(device_type)
    local = int(torch.cuda.device_count()) if device_type == "cuda" else 0
    ranks = list(range(min(dist.get_world_size(), local or dist.get_world_size())))
    if n is not None:
        ranks = ranks[:n]
    return make_mesh({axis: len(ranks)}, ranks, device_type=device_type)


def is_multiprocess(mesh: DeviceMesh) -> bool:
    """True when the mesh spans ranks other than this one (each rank is a
    process, so a mesh of more than one device)."""
    me = dist.get_rank()
    return any(int(r) != me for r in mesh.mesh.flatten().tolist())


def placements(mesh: DeviceMesh, spec) -> tuple:
    """The DTensor placements of a spec on ``mesh``: ``Shard(d)`` on each
    mesh axis that tensor dimension ``d`` names, ``Replicate()`` on the
    others. A dimension may name one axis or a tuple of them; an axis
    named twice, or one the mesh has not, raises."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(tuple(spec or ())):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, which the mesh "
                                 f"{mesh.mesh_dim_names} has not")
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def spec_of(t) -> PartitionSpec:
    """The spec of a DTensor's placements (the reference's
    ``x.sharding.spec``); ``P()`` for a plain tensor or a replicated one."""
    if not isinstance(t, DTensor):
        return P()
    dims: Dict[int, list] = {}
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim % t.ndim, []).append(name)
    if not dims:
        return P()
    return P(*[None if d not in dims else
               (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
               for d in range(max(dims) + 1)])


def make_global(tree, mesh: DeviceMesh, spec) -> object:
    """Host-local full copies → DTensors over the mesh.

    Every rank passes the SAME full-value tree (the single-controller
    contract: identical host data everywhere, e.g. replicated params or a
    full batch about to be split over the data axis); each rank keeps only
    its own block, cut locally, with no communication. Leaves are numpy
    arrays or tensors (a tensor stays on its device, an array goes to the
    mesh's); dicts, lists and tuples are walked."""
    pl = placements(mesh, spec)
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(conv(v) for v in a)
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t.to(device), mesh, pl, src_data_rank=None)

    return conv(tree)


def shard_map(fn, *, mesh: DeviceMesh, in_specs, out_specs):
    """``fn`` run on each rank's local blocks (the reference's
    ``shard_map``, on ``local_map``). ``in_specs`` gives one spec an
    argument (None for an argument that is not a tensor), ``out_specs`` one
    an output (a single spec for a single output). A plain tensor argument
    is the full value on every rank (:func:`make_global` cuts it); a
    DTensor is redistributed to its spec. ``fn``'s outputs are the local
    blocks of the returned DTensors, so a replicated output must be equal
    on every rank (after a collective, as ``pmean`` makes it)."""
    single = not isinstance(out_specs, (list, tuple)) or isinstance(out_specs, PartitionSpec)
    outs = (out_specs,) if single else tuple(out_specs)
    out_pl = tuple(None if s is None else placements(mesh, s) for s in outs)
    in_pl = tuple(None if s is None else placements(mesh, s) for s in in_specs)
    mapped = local_map(
        fn, out_placements=list(out_pl[0]) if single else out_pl,
        in_placements=in_pl, device_mesh=mesh, redistribute_inputs=True)

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        placed = [a if s is None or not isinstance(a, torch.Tensor) or isinstance(a, DTensor)
                  else make_global(a, mesh, s) for a, s in zip(args, in_specs)]
        return mapped(*placed)

    return call


def pmean_(tensors, mesh: DeviceMesh, axis: str = DATA_AXIS) -> None:
    """Average plain tensors over the ranks of ``axis``, in place (the
    reference's ``lax.pmean`` inside ``shard_map``): one ``all_reduce`` a
    tensor over the axis's process group, then a division by its size."""
    size = axis_size(mesh, axis)
    if size <= 1:
        return
    group = mesh.get_group(axis)
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(size)

