"""Carry parameters and optimizer state between the JAX reference and the port.

``load_reference_params(net, params)`` fills a port network from the JAX
network's parameters as numpy arrays (what ``tree_map(np.asarray,
jax_net.params)`` gives); the layouts are the same, so this is a checked
copy. ``export_params(net)`` is the inverse; on a network placed on a device
mesh the exports are the full arrays (each DTensor's ``full_tensor()``).
``load_reference_updater_state`` / ``export_updater_state`` do the same for
the updater state (e.g. Adam's ``m`` and ``v``), so that both sides can
resume from one optimizer state, and ``load_reference_states`` /
``export_states`` for the layer state (BatchNorm's running statistics,
the reference's ``net.states``). ``load_reference_lookup_table`` carries
an embedding model's tables (``nlp/``: syn0, syn1, syn1neg).

A ``ComputationGraph`` is carried as ``{vertex: {name: ...}}`` on both
sides. The reference's ``MultiLayerNetwork`` keeps a list of per-layer
dicts, the port's ``{index: {name: ...}}``: the list is read by position
and exported again as a list.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.dtensor import full


def _mismatches(mine: dict, theirs: dict, path: str, depth: int) -> list:
    """Every key or shape by which the nested dicts ``theirs`` (numpy
    leaves) and ``mine`` (tensor leaves, ``depth`` levels down) differ."""
    problems = []
    for key in sorted(set(mine) | set(theirs)):
        where = f"{path}{key}"
        named = where if path else (f"layer {key}" if isinstance(key, int)
                                    else f"vertex {key!r}")
        if key not in theirs:
            problems.append(f"missing {named}")
        elif key not in mine:
            problems.append(f"unexpected {named}")
        elif depth > 1:
            problems += _mismatches(mine[key], theirs[key], where + "/", depth - 1)
        elif tuple(np.shape(theirs[key])) != tuple(mine[key].shape):
            problems.append(f"{where}: shape {tuple(np.shape(theirs[key]))} "
                            f"!= {tuple(mine[key].shape)}")
    return problems


def _keyed(theirs):
    """The reference's per-layer list as ``{index: layer dict}``."""
    return dict(enumerate(theirs)) if isinstance(theirs, (list, tuple)) else theirs


def _checked_copy(mine: dict, theirs, depth: int, what: str) -> None:
    theirs = _keyed(theirs)
    problems = _mismatches(mine, theirs, "", depth)
    if problems:
        raise ValueError(f"{what} do not match the network: " + "; ".join(problems))

    def copy(m, t, d):
        for key, val in m.items():
            if d > 1:
                copy(val, t[key], d - 1)
            else:
                src = torch.from_numpy(np.array(t[key]))  # own copy
                val.copy_(src.to(dtype=val.dtype))

    with torch.no_grad():
        copy(mine, theirs, depth)


def _export(tree: dict, depth: int) -> dict:
    if depth == 1:
        return {k: full(t).detach().cpu().numpy().copy() for k, t in tree.items()}
    return {k: _export(v, depth - 1) for k, v in tree.items()}


def _export_net(tree: dict, depth: int):
    out = _export(tree, depth)
    if all(isinstance(k, int) for k in out):  # a MultiLayerNetwork's layers
        return [out[i] for i in range(len(out))]
    return out


def load_reference_params(net, params):
    """Copy ``params`` into ``net`` (an initialized ComputationGraph or
    MultiLayerNetwork). Every vertex or layer, name and shape must match;
    on any mismatch it raises and copies nothing. Returns ``net``."""
    if net.params is None:
        raise RuntimeError("net has no parameters yet: call init() first")
    _checked_copy(net.params, params, 2, "parameters")
    return net


def load_reference_states(net, states):
    """Copy the reference's layer states (``tree_map(np.asarray,
    jax_net.states)``: ``{vertex: {name: ndarray}}``, or a list of
    per-layer dicts, empty for a stateless layer) into ``net``'s, in place,
    checked as :func:`load_reference_params` checks. Returns ``net``."""
    if net.states is None:
        raise RuntimeError("net has no layer state yet: call init() first")
    _checked_copy(net.states, states, 2, "layer states")
    return net


def export_states(net):
    """The network's layer states on the host, shaped as
    :func:`export_params` shapes the parameters."""
    return _export_net(net.states, 2)


def export_params(net):
    """The network's parameters on the host: ``{vertex: {name: ndarray}}``
    for a graph, a list of ``{name: ndarray}`` for a MultiLayerNetwork."""
    return _export_net(net.params, 2)


def load_reference_updater_state(net, upd_states):
    """Copy the reference's updater state (``{vertex: {param: {slot:
    ndarray}}}``, or a list of per-layer ``{param: {slot: ndarray}}``,
    what ``tree_map(np.asarray, jax_net.updater_states)`` gives) into
    ``net``'s, in place. Every vertex, parameter, slot and
    shape must match (so must the updater kinds); on any mismatch it raises
    and copies nothing. The step count is the caller's: set
    ``net.iteration`` to the reference's. Returns ``net``."""
    if net.updater_states is None:
        raise RuntimeError("net has no updater state yet: call init() first")
    _checked_copy(net.updater_states, upd_states, 3, "updater states")
    return net


def export_updater_state(net):
    """The network's updater state on the host, shaped as
    :func:`export_params` shapes the parameters."""
    return _export_net(net.updater_states, 3)


def load_reference_lookup_table(model, syn0, syn1=None, syn1neg=None):
    """Copy the reference's embedding tables (numpy ``syn0``, ``syn1`` and
    ``syn1neg``, what ``np.asarray`` of its ``lookup_table``'s gives; None
    for a table it has not) into the port model's (a ``SequenceVectors``
    or its lookup table), in place. The model must have exactly those
    tables, each of that shape; on any mismatch it raises and copies
    nothing. Returns ``model``."""
    table = getattr(model, "lookup_table", model)
    if table is None or table.syn0 is None:
        raise RuntimeError("the model has no lookup table yet: build its "
                           "vocabulary first")
    mine = {n: t for n in ("syn0", "syn1", "syn1neg")
            if (t := getattr(table, n)) is not None}
    theirs = {n: a for n, a in (("syn0", syn0), ("syn1", syn1),
                                ("syn1neg", syn1neg)) if a is not None}
    problems = _mismatches(mine, theirs, "lookup table ", 1)
    if problems:
        raise ValueError("tables do not match the model: " + "; ".join(problems))
    with torch.no_grad():
        for n, t in mine.items():
            t.copy_(torch.from_numpy(np.array(theirs[n])).to(dtype=t.dtype))
    table.touch()
    return model


def load_reference_graph_lookup_table(model, vertex_vectors, out_weights):
    """Copy the reference's DeepWalk tables (numpy ``vertex_vectors`` and
    ``out_weights``, what ``np.asarray`` of its ``lookup_table``'s gives)
    into the port model's (a ``DeepWalk``, a ``Node2Vec`` or its
    ``InMemoryGraphLookupTable``), in place. Both tables must have the
    model's shapes; on any mismatch it raises and copies nothing. Returns
    ``model``."""
    table = getattr(model, "lookup_table", model)
    if table is None:
        raise RuntimeError("the model has no lookup table yet: call "
                           "initialize(graph) first")
    mine = {"vertex_vectors": table.vertex_vectors, "out_weights": table.out_weights}
    problems = _mismatches(mine, {"vertex_vectors": vertex_vectors,
                                  "out_weights": out_weights}, "lookup table ", 1)
    if problems:
        raise ValueError("tables do not match the model: " + "; ".join(problems))
    with torch.no_grad():
        mine["vertex_vectors"].copy_(torch.from_numpy(np.array(vertex_vectors)))
        mine["out_weights"].copy_(torch.from_numpy(np.array(out_weights)))
    return model
