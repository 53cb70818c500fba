"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package ``deeplearning4j_tpu`` is the reference; this package keeps
its public API, parameter names and data layouts, and runs on an NVIDIA
GPU. Every Pallas kernel of the reference becomes a kernel written by hand
for Hopper (``csrc/``), bound through ``nn/cuda_kernels.py``.

This package imports torch and numpy only: never jax, and nothing of
``deeplearning4j_tpu`` (not even its jax-free modules).

Device rule: the entry points (``ComputationGraph(conf, device=None)``,
``TransformerLM(...).init(device=None)``, ``ParallelInference`` over
such a network, the embedding models of ``nlp/`` and the word-vector
readers) place everything on ``cuda``. They use the CPU only when
the caller passes ``device="cpu"``; with no CUDA device and no explicit
``"cpu"`` they raise. On a CUDA tensor a kernel runs or raises: nothing
falls back to the CPU or to a kernel's plain version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point places its tensors on (see the module
    docstring). ``None`` means ``cuda`` and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: deeplearning4j_tpu_torch runs on the GPU; "
                "pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


# Lazy top-level conveniences, as in the reference: the modules import on
# first attribute access, keeping a bare import light
_LAZY = {
    "SameDiff": "deeplearning4j_tpu_torch.autodiff.samediff",
    "ModelSelector": "deeplearning4j_tpu_torch.zoo.zoo_model",
    "EarlyStoppingTrainer": "deeplearning4j_tpu_torch.optimize",
    "Solver": "deeplearning4j_tpu_torch.optimize",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
