"""Sharding rules: how a network's tensors map onto a device mesh.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. The rules work
on names and specs and are the reference's, with the port's
:class:`~deeplearning4j_tpu_torch.parallel.mesh.PartitionSpec` (``P``) in
place of jax's. Placing a network turns its parameters, updater state and
layer state into DTensors on the mesh (``Shard`` on each mesh axis a
spec names, ``Replicate`` on the others), in place, and records the mesh
on the network (``net._mesh``): its own ``fit``, ``output`` and
``evaluate`` then place each incoming batch on the ``data`` axis, and the
layers run on DTensors, whose dispatch inserts the collectives a tensor-
parallel split needs (the all-reduce after a row-parallel product).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    P,
    PartitionSpec,
    axis_size,
    make_global,
    mesh_axes,
    placements,
)

__all__ = ["P", "PartitionSpec", "NamedSharding", "replicated", "batch_sharding",
           "place_batch", "tp_param_specs", "DEFAULT_2D_RULES", "normalize_rules",
           "load_sharding_rules", "match_partition_rules", "lint_partition_rules",
           "shard_model_with_rules", "shard_model", "unshard_model"]


class NamedSharding:
    """A spec on a mesh (jax's ``NamedSharding``); ``placements`` are its
    DTensor placements."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({mesh_axes(self.mesh)}, {self.spec!r})"


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: DeviceMesh, ndim: int, axis: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def place_batch(x, mesh: Optional[DeviceMesh], axis: str = DATA_AXIS):
    """One batch array (numpy or tensor, the same full value on every rank)
    as a DTensor with its leading dim sharded over the mesh's data axis —
    the input half of a DP×MP step (params carry the model axis; the
    batch carries data). ``None`` leaves and a ``None`` mesh pass through.
    A batch on a mesh without the axis, a scalar, or a ragged batch that
    does not divide the axis is placed replicated: every rank computes
    all of it, the same contract as ParallelWrapper's tail batch."""
    if x is None or mesh is None:
        return x
    d = axis_size(mesh, axis)
    ndim = getattr(x, "ndim", 0)
    if d <= 1 or ndim == 0 or x.shape[0] % d:
        return make_global(x, mesh, P())
    return make_global(x, mesh, batch_sharding(mesh, ndim, axis).spec)


_COLUMN = "column"
_ROW = "row"


def _dense_like(layer) -> bool:
    """Layers holding one [n_in, n_out] matmul W (+ bias b): the building
    blocks of Megatron column/row pairs. OutputLayer subclasses DenseLayer."""
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    return isinstance(layer, DenseLayer)


def _is_output_layer(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    return isinstance(layer, OutputLayer)


def _is_attention(layer) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
    return isinstance(layer, SelfAttentionLayer)


def _is_graph(net) -> bool:
    return hasattr(net.conf, "vertices")


def _require_inferred_preprocessors(net) -> None:
    """Pair-breaking reads the conf's preprocessor maps, and the INFERRED
    half (automatic reshape boundaries) only exists after
    ``conf.finalize()`` runs shape inference. Both network constructors
    finalize, so this only trips for hand-built configuration objects."""
    if getattr(net.conf, "_finalized", True) is False:
        raise RuntimeError(
            "tp_param_specs/shard_model need the conf's inferred input "
            "preprocessors, which are computed by shape inference: call "
            "net.init() (or conf.finalize()) before requesting "
            "tensor-parallel specs — otherwise column/row pairs could "
            "form across a reshape boundary and the all-gather-free "
            "activation path is silently lost")


def _layer_topology(net):
    """(key, layer, consumers) in forward order for both network kinds.

    MultiLayerNetwork: keys are layer indices, consumer of i is [i+1].
    ComputationGraph: keys are vertex names, consumers from the
    vertex-input edges (layer vertices only — elementwise vertices break
    pairs: a residual add merges two activation shardings)."""
    if _is_graph(net):
        vertices = net.conf.vertices
        consumers = {k: [] for k in vertices}
        n_inputs = {}
        for name, vd in vertices.items():
            n_inputs[name] = len(vd.inputs)
            for src in vd.inputs:
                if src in consumers:
                    consumers[src].append(name)
        # a per-vertex input preprocessor reshapes the activation between
        # the pair and would gather the column sharding
        graph_pre = set(getattr(net.conf, "preprocessors", {}) or {})

        def pairable_consumers(name):
            # ANY non-layer or multi-input consumer (residual tap, merge)
            # disqualifies pairing
            out = []
            for c in consumers[name]:
                if not (vertices[c].is_layer and n_inputs[c] == 1
                        and c not in graph_pre):
                    return []
                out.append(c)
            return out

        return [(name, vd.obj, pairable_consumers(name))
                for name, vd in vertices.items() if vd.is_layer]
    layers = list(net.layers)
    # an input preprocessor (explicit spec or inferred reshape) between two
    # layers breaks the pair, as a non-layer vertex does in a graph
    pre = set(getattr(net.conf, "preprocessors", {}) or {})
    pre |= set(getattr(net.conf, "input_pre_processors", {}) or {})
    return [(i, layer,
             [i + 1] if i + 1 < len(layers) and (i + 1) not in pre else [])
            for i, layer in enumerate(layers)]


def tp_param_specs(net, axis: str = MODEL_AXIS, mesh: Optional[DeviceMesh] = None):
    """Megatron-pattern tensor-parallel specs, ``{key: {param: P}}`` shaped
    as the network's parameters.

    - **Dense→Dense chains**: the first layer is column-parallel
      (``W: P(None, axis)``, ``b: P(axis)``), its unique dense consumer
      row-parallel (``W: P(axis, None)``, ``b: P()``). Pairs form greedily
      along the forward order; an OutputLayer may END a pair but never
      starts one.
    - **Self-attention**: ``Wqkv: P(None, axis)``, ``bqkv: P(axis)``,
      ``Wo: P(axis, None)``, ``bo: P()`` — head-major columns, so the
      split is by heads and the block needs one all-reduce.
    - Everything else stays replicated.

    When ``mesh`` is given, a pair whose shared hidden dimension does not
    divide the model-axis size degrades JOINTLY to replicated, and so does
    attention whose head count does not."""
    _require_inferred_preprocessors(net)
    topo = _layer_topology(net)
    by_key = {k: layer for k, layer, _ in topo}
    roles: Dict[object, str] = {}

    def tp_size():
        return axis_size(mesh, axis) if mesh is not None else None

    for key, layer, consumers in topo:
        if key in roles or not _dense_like(layer) or _is_output_layer(layer):
            continue
        if len(consumers) != 1:
            continue
        nxt = consumers[0]
        nxt_layer = by_key.get(nxt)
        if nxt_layer is None or nxt in roles or not _dense_like(nxt_layer):
            continue
        if tp_size() is not None and layer.n_out % tp_size():
            continue
        roles[key] = _COLUMN
        roles[nxt] = _ROW

    def specs_for(key, layer, p: Dict) -> Dict[str, PartitionSpec]:
        if _is_attention(layer):
            if tp_size() is not None and layer.n_heads % tp_size():
                return {n: P() for n in p}
            d = {"Wqkv": P(None, axis), "bqkv": P(axis)}
            if "Wo" in p:
                d["Wo"] = P(axis, None)
                d["bo"] = P()
            return {n: d.get(n, P()) for n in p}
        role = roles.get(key)
        if role == _COLUMN:
            return {n: (P(None, axis) if n == "W"
                        else P(axis) if n == "b" else P()) for n in p}
        if role == _ROW:
            return {n: (P(axis, None) if n == "W" else P()) for n in p}
        return {n: P() for n in p}

    return {key: specs_for(key, by_key[key], p)
            for key, p in net.params.items() if key in by_key}


# -- rule-based sharding: regex-over-param-path → PartitionSpec --------------
#
# A rule is (regex, spec); rules are tried in order against the '/'-joined
# param path ("vertex/W" for graphs, "0/W" for MultiLayerNetwork layers)
# and the FIRST match wins. Scalar / size-1 leaves are never partitioned;
# a param no rule matches fails loudly.

Rule = Tuple[str, PartitionSpec]

#: Default rule set for the framework's transformer naming convention:
#: the Megatron column→row pairs, plus the vocab path — the embedding
#: table vocab-ROW-sharded (``F.embedding`` over a sharded axis 0 gives
#: masked local lookups and one all-reduce, no gather) and the LM head
#: vocab-COLUMN-sharded, its logits kept sharded through the log-sum-exp
#: cross-entropy (``nn/losses.py`` ``log_softmax``), so the whole path
#: runs with ZERO all-gathers.
DEFAULT_2D_RULES: Tuple[Rule, ...] = (
    (r"(^|/)embed[^/]*/W$", P(MODEL_AXIS, None)),
    (r"(^|/)(out|output|logits|lm_head)[^/]*/W$", P(None, MODEL_AXIS)),
    (r"(^|/)(out|output|logits|lm_head)[^/]*/b$", P(MODEL_AXIS)),
    (r"/Wqkv$", P(None, MODEL_AXIS)),
    (r"/bqkv$", P(MODEL_AXIS)),
    (r"/Wo$", P(MODEL_AXIS, None)),
    (r"/bo$", P()),
    (r"ff1[^/]*/W$", P(None, MODEL_AXIS)),
    (r"ff1[^/]*/b$", P(MODEL_AXIS)),
    (r"ff2[^/]*/W$", P(MODEL_AXIS, None)),
    (r".*", P()),
)


def _leaves(tree, prefix=()):
    """``(path, leaf)`` of a tree of dicts, lists and tuples, in order; the
    path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _map_leaves(fn, tree, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_leaves(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _path_name(path) -> str:
    """'/'-joined name for a key path: dict keys and sequence indices both
    render bare (``0/W``, ``block0-att/Wqkv``)."""
    return "/".join(str(k) for k in path)


def _as_spec(spec) -> PartitionSpec:
    if isinstance(spec, PartitionSpec):
        return spec
    if spec is None:
        return P()
    if isinstance(spec, (list, tuple)):
        return P(*[None if (s is None or s == "null") else str(s)
                   for s in spec])
    raise ValueError(f"bad partition spec {spec!r} (want PartitionSpec, "
                     f"None, or a list of axis names / null)")


def normalize_rules(rules: Sequence) -> List[Rule]:
    """Validate + canonicalize a rule list: each entry becomes
    ``(compiled-ok regex string, PartitionSpec)``."""
    out: List[Rule] = []
    for i, entry in enumerate(rules):
        try:
            pattern, spec = entry
        except (TypeError, ValueError):
            raise ValueError(
                f"rule[{i}] must be a (regex, spec) pair, got {entry!r}"
            ) from None
        if not isinstance(pattern, str):
            raise ValueError(f"rule[{i}] pattern must be a string, "
                             f"got {type(pattern).__name__}")
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(f"rule[{i}] regex {pattern!r} invalid: {e}") \
                from None
        out.append((pattern, _as_spec(spec)))
    if not out:
        raise ValueError("empty sharding rule list")
    return out


def load_sharding_rules(source) -> List[Rule]:
    """Load rules from a JSON file path / file object / parsed dict.

    Schema: ``{"rules": [[regex, [axis-or-null, ...]], ...]}`` — the
    spec array gives one entry per tensor dimension (trailing dims may
    be omitted = unsharded), ``null`` meaning replicated on that dim.
    """
    if isinstance(source, dict):
        doc = source
    elif hasattr(source, "read"):
        doc = json.load(source)
    else:
        with open(source, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict) or "rules" not in doc:
        raise ValueError("sharding rules file must be an object with a "
                         "'rules' array")
    return normalize_rules(doc["rules"])


def _is_scalar_leaf(leaf) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return True
    return len(shape) == 0 or int(np.prod(tuple(shape))) == 1


def match_partition_rules(rules: Sequence, params):
    """Map a param tree to a same-structure spec tree by first-match regex
    over each leaf's '/'-joined path. Scalar and size-1 leaves are never
    partitioned (always ``P()``); a leaf no rule matches raises — add a
    catch-all ``(".*", P())`` rule to opt into replicate-by-default."""
    rules = normalize_rules(rules)

    def match(path, leaf):
        name = _path_name(path)
        if _is_scalar_leaf(leaf):
            return P()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return spec
        raise ValueError(f"Partition rule not found for param: {name}")

    return _map_leaves(match, params)


def lint_partition_rules(rules: Sequence, params) -> List[str]:
    """Dry-run lint against a sample model's param tree: returns
    warnings (empty = clean) for unmatched params (would raise at
    placement time), dead rules (match nothing), and shadowed rules
    (every leaf they match is claimed by an earlier rule)."""
    rules = normalize_rules(rules)
    names = [_path_name(p) for p, leaf in _leaves(params)
             if not _is_scalar_leaf(leaf)]
    problems: List[str] = []
    hits: List[set] = [set() for _ in rules]
    first_hit: Dict[str, int] = {}
    for name in names:
        matched = False
        for i, (pattern, _spec) in enumerate(rules):
            if re.search(pattern, name):
                hits[i].add(name)
                if not matched:
                    first_hit[name] = i
                matched = True
        if not matched:
            problems.append(f"param {name!r} matches no rule (placement "
                            f"would fail loudly)")
    for i, (pattern, _spec) in enumerate(rules):
        if not hits[i]:
            problems.append(f"rule[{i}] {pattern!r} matches no param of "
                            f"the sample model (dead rule?)")
        elif all(first_hit[n] != i for n in hits[i]):
            winners = sorted({first_hit[n] for n in hits[i]})
            problems.append(
                f"rule[{i}] {pattern!r} is fully shadowed by earlier "
                f"rule(s) {winners} — it can never win a match")
    return problems


def _leaf_sharding_ok(shape, spec: PartitionSpec, mesh: DeviceMesh) -> bool:
    axes = mesh_axes(mesh)
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            # an axis the mesh does not have (e.g. 2-D rules on a
            # data-only mesh) degrades to replicated, as a non-dividing
            # dim does
            if a not in axes or dim % axes[a]:
                return False
    return True


def _to_dtensor(t: torch.Tensor, mesh: DeviceMesh, spec: PartitionSpec):
    """``t`` (a tensor, or a DTensor placed elsewhere) as a DTensor of
    ``spec`` on ``mesh``, cut locally from the full value."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return distribute_tensor(t.detach(), mesh, placements(mesh, spec),
                             src_data_rank=None)


def _place(net, mesh: DeviceMesh, specs: Dict) -> None:
    """Put every parameter of ``net`` on ``mesh`` by ``specs`` (``{key:
    {param: P}}``; a leaf whose dims do not divide its axes, or one the
    mesh has not, is replicated), its updater state beside it (a slot of
    the parameter's shape takes its spec, any other is replicated) and its
    layer state replicated, in place on the module; records the mesh."""
    for key, named in net.params.items():
        for n, v in list(named.items()):
            spec = specs.get(key, {}).get(n, P())
            if not _leaf_sharding_ok(tuple(v.shape), spec, mesh):
                spec = P()
            placed = nn.Parameter(_to_dtensor(v, mesh, spec), requires_grad=False)
            net.register_parameter(f"{key}/{n}", placed)
            named[n] = placed
            slots = (net.updater_states or {}).get(key, {}).get(n)
            if slots:
                for s, a in list(slots.items()):
                    if isinstance(a, torch.Tensor):
                        slots[s] = _to_dtensor(a, mesh, spec if tuple(a.shape) == tuple(v.shape)
                                               else P())
    for key, named in (net.states or {}).items():
        for n, t in list(named.items()):
            named[n] = _to_dtensor(t, mesh, P())
            net.register_buffer(f"{key}/{n}", named[n])
    net._mesh = mesh


def shard_model_with_rules(net, mesh: DeviceMesh, rules: Optional[Sequence] = None
                           ) -> None:
    """Place a model on a DP×MP mesh from a rule list, in place: params by
    first-match rule, updater-state slots sharing the param's spec when
    shapes match, layer states replicated. Records the mesh on the net
    (``net._mesh``) so ``fit``/``output``/``evaluate`` shard incoming
    batches over the ``data`` axis end to end.

    ``rules=None`` uses :data:`DEFAULT_2D_RULES`. A matched leaf whose
    dims do not divide the named axes degrades to replicated."""
    if net.params is None:
        net.init()
    specs = match_partition_rules(DEFAULT_2D_RULES if rules is None else rules,
                                  net.params)
    _place(net, mesh, specs)


def shard_model(net, mesh: DeviceMesh, tp_axis: Optional[str] = None) -> None:
    """Place a model's params / states / updater states on the mesh, in
    place, for both network kinds.

    ``tp_axis=None`` → fully replicated (pure data parallel).
    ``tp_axis='model'`` → Megatron paired specs from :func:`tp_param_specs`;
    any leaf whose dims don't divide the axis falls back to replicated."""
    if net.params is None:
        net.init()
    specs = {} if tp_axis is None else tp_param_specs(net, tp_axis, mesh)
    _place(net, mesh, specs)


def unshard_model(net) -> None:
    """Take a placed model off its mesh, in place: every DTensor back to a
    plain tensor of its full value on this rank's device (each rank then
    holds a whole replica), and no mesh recorded."""
    def plain(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    for key, named in (net.params or {}).items():
        for n, v in list(named.items()):
            if isinstance(v, DTensor):
                named[n] = nn.Parameter(plain(v).detach(), requires_grad=False)
                net.register_parameter(f"{key}/{n}", named[n])
            slots = (net.updater_states or {}).get(key, {}).get(n) or {}
            for s, a in list(slots.items()):
                slots[s] = plain(a)
    for key, named in (net.states or {}).items():
        for n, t in list(named.items()):
            if isinstance(t, DTensor):
                named[n] = plain(t)
                net.register_buffer(f"{key}/{n}", named[n])
    net._mesh = None
