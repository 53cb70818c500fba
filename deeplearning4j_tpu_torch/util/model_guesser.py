"""Load a model, a configuration or a normalizer from a file of unknown kind.

Counterpart of ``deeplearning4j_tpu/util/model_guesser.py`` (DL4J's
``ModelGuesser.java``): each known reader is tried in the reference's order
until one accepts the file.

``load_model_guess``: the port's own MultiLayerNetwork zip, its own
ComputationGraph zip, a DL4J MultiLayerNetwork zip, a DL4J ComputationGraph
zip, a Keras HDF5 (functional, then Sequential). The network lands on
``device``: ``cuda`` unless the caller passes ``"cpu"``.

``load_config_guess``: MultiLayerConfiguration JSON, a Keras configuration
(Sequential and functional share one entry point), ComputationGraph
configuration JSON, then the YAML forms (JSON first, as in the reference:
YAML parses JSON too).
"""

from __future__ import annotations

from typing import Any, List, Tuple


class ModelGuesserException(Exception):
    """No known reader accepted the file."""


def _try_all(path: str, attempts: List[Tuple[str, Any]], kind: str):
    errors = []
    for name, fn in attempts:
        try:
            return fn(path)
        except Exception as e:  # noqa: BLE001 - each reader fails its own way
            errors.append(f"{name}: {type(e).__name__}: {e}")
    raise ModelGuesserException(
        f"Unable to load {kind} from path {path} "
        f"(invalid file or not a known {kind} type). Tried: {'; '.join(errors)}")


def load_model_guess(path: str, device=None):
    """The network the file at ``path`` holds (``loadModelGuess``)."""
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.modelimport.keras.importer import KerasModelImport
    from deeplearning4j_tpu_torch.util import model_serializer as ms

    attempts = [
        ("own MultiLayerNetwork zip",
         lambda p: ms.restore_multi_layer_network(p, device=device)),
        ("own ComputationGraph zip",
         lambda p: ms.restore_computation_graph(p, device=device)),
        ("DL4J MultiLayerNetwork zip",
         lambda p: dl4j.restore_multi_layer_network(p, device=device)),
        ("DL4J ComputationGraph zip",
         lambda p: dl4j.restore_computation_graph(p, device=device)),
        ("Keras model h5",
         lambda p: KerasModelImport.import_keras_model_and_weights(p, device=device)),
        ("Keras sequential h5",
         lambda p: KerasModelImport.import_keras_sequential_model_and_weights(
             p, device=device)),
    ]
    return _try_all(path, attempts, "model")


def load_config_guess(path: str):
    """The network configuration the file at ``path`` holds
    (``loadConfigGuess``)."""
    from deeplearning4j_tpu_torch.modelimport.keras.importer import KerasModelImport
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

    def read(p):
        with open(p, "r", encoding="utf-8") as fh:
            return fh.read()

    attempts = [
        ("MultiLayerConfiguration JSON",
         lambda p: MultiLayerConfiguration.from_json(read(p))),
        ("Keras config", KerasModelImport.import_keras_model_configuration),
        ("ComputationGraphConfiguration JSON",
         lambda p: ComputationGraphConfiguration.from_json(read(p))),
        ("MultiLayerConfiguration YAML",
         lambda p: MultiLayerConfiguration.from_yaml(read(p))),
        ("ComputationGraphConfiguration YAML",
         lambda p: ComputationGraphConfiguration.from_yaml(read(p))),
    ]
    return _try_all(path, attempts, "configuration")


def load_normalizer(path: str):
    """The normalizer a model zip holds (``ModelGuesser.loadNormalizer``):
    the port's own ``normalizer.json`` first, then DL4J's binary
    ``normalizer.bin``; None when the zip holds neither."""
    from deeplearning4j_tpu_torch.modelimport import dl4j
    from deeplearning4j_tpu_torch.util import model_serializer as ms

    own = ms.restore_normalizer(path)
    return own if own is not None else dl4j.restore_normalizer(path)
