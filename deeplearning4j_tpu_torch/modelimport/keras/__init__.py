"""Keras HDF5/JSON model import into the port.

Counterpart of ``deeplearning4j_tpu/modelimport/keras/`` (DL4J's
``KerasModelImport.java``, ``Hdf5Archive.java`` and the per-layer mappers):
h5py reads the files, imported only when one is opened; layouts stay
channels-last (NHWC).
"""

from deeplearning4j_tpu_torch.modelimport.keras.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.keras.importer import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.keras.layers import (
    InvalidKerasConfigurationException,
    UnsupportedKerasConfigurationException,
    clear_lambda_layers,
    register_lambda_layer,
)
from deeplearning4j_tpu_torch.modelimport.keras.model import (
    KerasModel,
    KerasModelConfig,
    KerasSequentialModel,
)

__all__ = [
    "Hdf5Archive", "KerasModelImport", "KerasModel", "KerasModelConfig",
    "KerasSequentialModel", "InvalidKerasConfigurationException",
    "UnsupportedKerasConfigurationException", "register_lambda_layer",
    "clear_lambda_layers",
]
