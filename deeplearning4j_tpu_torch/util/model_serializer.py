"""ModelSerializer — the model zip, written and read as the reference does.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py``, the same
zip, so that a model saved by either package restores in the other:

- ``configuration.json``: the configuration (its ``format`` field says
  sequential or graph);
- ``params.npz``: the parameters, keyed ``<layer>/<param>``;
- ``updater.npz``: the updater state, keyed ``<layer>/<param>/<slot>``
  (``m``, ``v``, and ``v_hat`` for AMSGrad);
- ``states.npz``: layer state (BatchNorm's running statistics), keyed
  ``<layer>/<name>``, written when a layer has any;
- ``normalizer.json`` (optional): a fitted normalizer's JSON
  (``datasets/normalizers.py``), written by ``write_model(normalizer=)``
  or ``add_normalizer_to_model`` and read by ``restore_normalizer``;
- ``meta.json``: ``iteration``, ``epoch``, ``framework`` and the
  ``qkv_layout`` stamp (a zip without it holds the older fused-QKV column
  order, repacked on restore).

Both kinds of network are written and read: a ``MultiLayerNetwork``
keys its arrays by layer index, a ``ComputationGraph`` by vertex name.
Arrays are written in the model's dtype from the host. Restore builds the
network on ``device`` (``cuda`` unless the caller passes ``"cpu"``, as
every entry point of the port).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

CONFIG_NAME = "configuration.json"
PARAMS_NAME = "params.npz"
UPDATER_NAME = "updater.npz"
STATES_NAME = "states.npz"
NORMALIZER_NAME = "normalizer.json"
META_NAME = "meta.json"


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def replace_zip_entry(path, entry_name: str, payload: bytes) -> None:
    """Atomically rewrite the zip at ``path`` with every entry except
    ``entry_name`` (matched case-insensitively), then ``payload`` under
    that name. Keeps the file's permissions and removes the temporary
    file on error."""
    path = str(path)
    mode = os.stat(path).st_mode & 0o7777
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".zip")
    os.close(fd)
    try:
        with zipfile.ZipFile(path) as zin, \
                zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zout:
            for entry in zin.namelist():
                if entry.lower() != entry_name.lower():
                    zout.writestr(entry, zin.read(entry))
            zout.writestr(entry_name, payload)
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_model(model, path: Union[str, Path], *,
                save_updater: bool = True, normalizer=None) -> None:
    """``ModelSerializer.writeModel``: ``model``'s zip at ``path``, with
    ``normalizer``'s JSON when one is given."""
    from deeplearning4j_tpu_torch.nn.layers.attention import QKV_LAYOUT

    if model.params is None:
        raise RuntimeError("the model has no parameters: call init() first")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    params = {f"{k}/{n}": _host(v)
              for k, named in model.params.items() for n, v in named.items()}
    states = {f"{k}/{n}": _host(v)
              for k, named in (model.states or {}).items()
              for n, v in named.items()}
    upd = {}
    if save_updater and model.updater_states is not None:
        upd = {f"{k}/{n}/{s}": _host(v)
               for k, named in model.updater_states.items()
               for n, slots in named.items() for s, v in slots.items()}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(CONFIG_NAME, model.conf.to_json())
        z.writestr(PARAMS_NAME, _npz_bytes(params))
        if upd:
            z.writestr(UPDATER_NAME, _npz_bytes(upd))
        if states:
            z.writestr(STATES_NAME, _npz_bytes(states))
        if normalizer is not None:
            z.writestr(NORMALIZER_NAME, normalizer.to_json())
        z.writestr(META_NAME, json.dumps(
            {"iteration": model.iteration, "epoch": model.epoch,
             "framework": "deeplearning4j_tpu_torch",
             "qkv_layout": QKV_LAYOUT}))


def _load_npz(z: zipfile.ZipFile, name: str) -> Optional[dict]:
    if name not in z.namelist():
        return None
    with z.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files}


def validate_model_zip(path: Union[str, Path]) -> list:
    """The problems of a model zip (empty when it is sound): not a zip, a
    required entry missing, an entry that does not decompress or fails
    its CRC."""
    problems = []
    try:
        with zipfile.ZipFile(path, "r") as z:
            for required in (CONFIG_NAME, PARAMS_NAME):
                if required not in z.namelist():
                    problems.append(f"missing required entry {required!r}")
            try:
                bad = z.testzip()
            except (zlib.error, EOFError, OSError) as e:
                # testzip returns the names of CRC mismatches only; a
                # damaged compressed stream raises from the inflater
                bad, problems = None, problems + [f"undecodable entry: {e}"]
            if bad is not None:
                problems.append(f"CRC mismatch in entry {bad!r}")
    except (zipfile.BadZipFile, OSError) as e:
        problems.append(f"unreadable zip: {e}")
    return problems


def _copy_in(path, where: str, target: torch.Tensor, arr: np.ndarray) -> None:
    if tuple(target.shape) != tuple(arr.shape):
        raise ValueError(
            f"checkpoint {path}: array {where} has shape {tuple(arr.shape)} "
            f"but the configuration allocates {tuple(target.shape)} — "
            f"checkpoint and config disagree (wrong file, or corrupt)")
    target.copy_(torch.from_numpy(np.array(arr)).to(target.dtype))


def _entry(container: dict, path, key: str, where: str) -> dict:
    """The per-layer dict of ``container`` that the zip key ``key`` names:
    a layer index of a MultiLayerNetwork, a vertex name of a graph."""
    k = key if key in container or not key.isdigit() else int(key)
    if k not in container:
        raise ValueError(f"checkpoint {path}: array {where} names no layer "
                         f"of the configuration")
    return container[k]


def _restore(path, *, load_updater: bool = True, device=None):
    """The network (either kind) that the zip at ``path`` holds."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        QKV_LAYOUT,
        repack_legacy_fused_qkv,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    try:
        # zipfile checks each entry's CRC as it reads it; the full scan
        # runs only on failure, to name the problem
        with zipfile.ZipFile(path, "r") as z:
            conf_d = json.loads(z.read(CONFIG_NAME))
            params = _load_npz(z, PARAMS_NAME)
            upd = _load_npz(z, UPDATER_NAME) if load_updater else None
            states = _load_npz(z, STATES_NAME)
            meta = (json.loads(z.read(META_NAME))
                    if META_NAME in z.namelist() else {})
    except (zipfile.BadZipFile, zlib.error, EOFError, KeyError, OSError) as e:
        problems = validate_model_zip(path)
        raise ValueError(
            f"checkpoint {path} failed integrity validation: "
            + ("; ".join(problems) if problems else str(e))
            + " — the file is truncated/corrupt or not a model zip") from e
    if "ComputationGraph" in conf_d.get("format", ""):
        model = ComputationGraph(ComputationGraphConfiguration.from_dict(conf_d),
                                 device=device).init()
    else:
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf_d),
                                  device=device).init()
    with torch.no_grad():
        for full, arr in params.items():
            key, pn = full.split("/", 1)
            layer = _entry(model.params, path, key, full)
            if pn not in layer:
                raise ValueError(f"checkpoint {path}: array {full} is not a "
                                 f"parameter of the configuration")
            _copy_in(path, full, layer[pn], arr)
        for full, arr in (states or {}).items():
            key, sn = full.split("/", 1)
            layer = _entry(model.states, path, key, full)
            if sn not in layer:
                raise ValueError(f"checkpoint {path}: array {full} is not a "
                                 f"layer state of the configuration")
            _copy_in(path, full, layer[sn], arr)
        for full, arr in (upd or {}).items():
            key, pn, slot = full.split("/", 2)
            slots = _entry(model.updater_states, path, key, full).get(pn)
            if slots is None or slot not in slots:
                raise ValueError(f"checkpoint {path}: updater state {full} "
                                 f"is not one of the configuration's updaters")
            _copy_in(path, full, slots[slot], arr)
    model.iteration = int(meta.get("iteration", 0))
    model.epoch = int(meta.get("epoch", 0))
    if meta.get("qkv_layout") != QKV_LAYOUT:
        repack_legacy_fused_qkv(model)
    return model


def restore_multi_layer_network(path, *, load_updater: bool = True,
                                device=None):
    """``ModelSerializer.restoreMultiLayerNetwork``: the network the zip
    at ``path`` holds, on ``device`` (``cuda`` unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    model = _restore(path, load_updater=load_updater, device=device)
    if not isinstance(model, MultiLayerNetwork):
        raise ValueError(f"{path} holds a ComputationGraph, not a "
                         f"MultiLayerNetwork")
    return model


def restore_computation_graph(path, *, load_updater: bool = True,
                              device=None):
    """``ModelSerializer.restoreComputationGraph``: the graph the zip at
    ``path`` holds, on ``device`` (``cuda`` unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    model = _restore(path, load_updater=load_updater, device=device)
    if not isinstance(model, ComputationGraph):
        raise ValueError(f"{path} holds a MultiLayerNetwork, not a "
                         f"ComputationGraph")
    return model


def restore_model(path, *, load_updater: bool = True, device=None):
    """Type-agnostic restore: the ``MultiLayerNetwork`` or
    ``ComputationGraph`` the zip holds."""
    return _restore(path, load_updater=load_updater, device=device)


def add_normalizer_to_model(path, normalizer) -> None:
    """``ModelSerializer.addNormalizerToModel``: rewrites the zip at
    ``path`` with ``normalizer``'s JSON."""
    replace_zip_entry(path, NORMALIZER_NAME,
                      normalizer.to_json().encode("utf-8"))


def restore_normalizer(path):
    """The normalizer a model zip holds, or None."""
    from deeplearning4j_tpu_torch.datasets.normalizers import Normalizer

    with zipfile.ZipFile(path, "r") as z:
        if NORMALIZER_NAME not in z.namelist():
            return None
        return Normalizer.from_json(z.read(NORMALIZER_NAME).decode())
