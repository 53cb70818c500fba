"""``KerasModelImport``: the Keras import's entry points.

Counterpart of ``deeplearning4j_tpu/modelimport/keras/importer.py``
(DL4J's ``KerasModelImport.java``: ``importKerasModelAndWeights``, its
two-file JSON + weights overload, the Sequential variants and the
configuration-only ones). Each entry point that builds a network takes
``device=None``: ``cuda`` unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import json
from typing import Optional, Union

from deeplearning4j_tpu_torch.modelimport.keras.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.keras.layers import (
    InvalidKerasConfigurationException,
)
from deeplearning4j_tpu_torch.modelimport.keras.model import (
    KerasModel,
    KerasModelConfig,
    KerasSequentialModel,
)


def _read_configs(archive: Hdf5Archive):
    model_json = archive.read_attribute_as_json("model_config")
    if model_json is None:
        raise InvalidKerasConfigurationException(
            "HDF5 file has no model_config attribute (was it saved with "
            "save_weights only? use the json+weights import variant)")
    training_json = archive.read_attribute_as_json("training_config") or {}
    return model_json, training_json


def _weights_root(archive: Hdf5Archive):
    return ("model_weights",) if "model_weights" in archive.get_groups() else ()


def _is_sequential(model_json: dict) -> bool:
    return model_json.get("class_name") == "Sequential"


class KerasModelImport:
    """Static import API (``KerasModelImport.java``)."""

    @staticmethod
    def import_keras_model_and_weights(h5_path: str,
                                       weights_path: Optional[str] = None,
                                       device=None):
        """Full-model HDF5 (config + weights) → initialized network; or, with
        ``weights_path``, a model-config JSON file + a save_weights HDF5 (the
        two-file overload, ``KerasModelImport.java:50-194`` — exercised by
        the reference's tfscope fixtures). Returns MultiLayerNetwork for
        Sequential, ComputationGraph otherwise."""
        if weights_path is not None:
            with open(h5_path) as f:
                model_json = json.load(f)
            cfg = KerasModelConfig(model_json)
            km = (KerasSequentialModel(cfg) if _is_sequential(model_json)
                  else KerasModel(cfg))
            net = km.init(device)
            with Hdf5Archive(weights_path) as a:
                km.copy_weights(net, a, *_weights_root(a))
            return net
        with Hdf5Archive(h5_path) as a:
            model_json, training_json = _read_configs(a)
            cfg = KerasModelConfig(model_json, training_json)
            if _is_sequential(model_json):
                km = KerasSequentialModel(cfg)
            else:
                km = KerasModel(cfg)
            net = km.init(device)
            km.copy_weights(net, a, *_weights_root(a))
            return net

    @staticmethod
    def import_keras_sequential_model_and_weights(h5_path: str,
                                                  json_path: Optional[str] = None,
                                                  device=None):
        if json_path is not None:
            with open(json_path) as f:
                model_json = json.load(f)
            cfg = KerasModelConfig(model_json)
            km = KerasSequentialModel(cfg)
            net = km.init(device)
            with Hdf5Archive(h5_path) as a:
                km.copy_weights(net, a, *_weights_root(a))
            return net
        return KerasModelImport.import_keras_model_and_weights(h5_path, device=device)

    @staticmethod
    def import_keras_model_configuration(json_path: str):
        """Config-only import: returns the (uninitialized) configuration."""
        with open(json_path) as f:
            model_json = json.load(f)
        cfg = KerasModelConfig(model_json)
        if _is_sequential(model_json):
            return KerasSequentialModel(cfg).conf
        return KerasModel(cfg).conf

    @staticmethod
    def import_keras_sequential_configuration(json_path: str):
        """Sequential config-only import
        (``KerasModelImport.importKerasSequentialConfiguration``); rejects
        functional-model JSON loudly."""
        with open(json_path) as f:
            model_json = json.load(f)
        if not _is_sequential(model_json):
            raise ValueError(
                f"{json_path} is not a Sequential model config; use "
                "import_keras_model_configuration")
        return KerasSequentialModel(KerasModelConfig(model_json)).conf

    @staticmethod
    def import_keras_model_from_json(model_json: Union[str, dict],
                                     training_json: Optional[dict] = None):
        """In-memory JSON -> the built Keras model wrapper: its ``conf``,
        ``init(device=None)`` and ``copy_weights`` (no network yet)."""
        if isinstance(model_json, str):
            model_json = json.loads(model_json)
        cfg = KerasModelConfig(model_json, training_json)
        if _is_sequential(model_json):
            return KerasSequentialModel(cfg)
        return KerasModel(cfg)
