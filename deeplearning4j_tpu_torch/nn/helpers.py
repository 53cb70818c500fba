"""Native acceleration helper seam.

Counterpart of ``deeplearning4j_tpu/nn/helpers.py``, same names: helpers
are registered per kind and layers consult the registry before their plain
math. The validation contract is the reference's: a helper must produce
the same numbers as the built-in path.

In the port the seam holds the hand-written CUDA kernels
(``nn/cuda_kernels.py``). With no attention helper registered and
auto-flash on, float32 or bfloat16 causal attention that
``FlashAttentionHelper.supports`` admits takes the kernel
(``nn/layers/attention.py``); the reference's TPU threshold on T is not
carried over. Likewise, with no lstm helper registered and
auto-fused-LSTM on, a float32 or bfloat16 standard LSTM that
``FusedLSTMHelper.supports`` admits, with a carry of its dtype or none,
takes the fused sequence kernel (``nn/layers/recurrent.py``; a mixed
carry takes the plain loop) at any T and any H: the reference's TPU win
region (``_AUTO_LSTM_MIN_T``, ``_AUTO_LSTM_MAX_H``) is not carried over,
and an H100 threshold waits for a measurement. The "updater" kind takes
``FusedUpdaterHelper`` (the fused Adam/Nadam/AMSGrad kernel) when it is
registered with ``set_helper("updater", FusedUpdaterHelper())``.
"""

from __future__ import annotations

from typing import Dict

_HELPERS: Dict[str, object] = {}
_VERSION = 0  # bumped on every registry change

KINDS = ("lstm", "convolution", "subsampling", "batch_norm", "lrn",
         "attention", "updater")


def version() -> int:
    """Registry generation: bumped on every set/clear and on every change
    of an auto switch."""
    return _VERSION


def set_helper(kind: str, helper) -> None:
    global _VERSION
    if kind not in KINDS:
        raise ValueError(f"unknown helper kind {kind!r} (expected one of {KINDS})")
    _HELPERS[kind] = helper
    _VERSION += 1


def get_helper(kind: str):
    return _HELPERS.get(kind)


def clear_helper(kind: str) -> None:
    global _VERSION
    if _HELPERS.pop(kind, None) is not None:
        _VERSION += 1


def clear_all_helpers() -> None:
    global _VERSION
    if _HELPERS:
        _VERSION += 1
    _HELPERS.clear()


_AUTO_FLASH = True


def set_auto_flash_attention(enabled: bool) -> None:
    """Opt out of (or back into) the automatic causal flash kernel."""
    global _AUTO_FLASH, _VERSION
    if _AUTO_FLASH != bool(enabled):
        _AUTO_FLASH = bool(enabled)
        _VERSION += 1


def auto_flash_attention_enabled() -> bool:
    return _AUTO_FLASH


_AUTO_LSTM = True


def set_auto_fused_lstm(enabled: bool) -> None:
    """Opt out of (or back into) the automatic fused-LSTM kernel."""
    global _AUTO_LSTM, _VERSION
    if _AUTO_LSTM != bool(enabled):
        _AUTO_LSTM = bool(enabled)
        _VERSION += 1


def auto_fused_lstm_enabled() -> bool:
    return _AUTO_LSTM


class LSTMHelper:
    """Interface (``LSTMHelper.java:34``): accelerate the LSTM sequence
    pass. ``forward_seq(layer, params, x, carry)`` returns ``(ys [N,T,H],
    (hN, cN))`` for the configurations ``supports(layer, mask)`` admits."""

    def supports(self, layer, mask) -> bool:  # pragma: no cover - interface
        return False

    def forward_seq(self, layer, params, x, carry):  # pragma: no cover
        raise NotImplementedError


class UpdaterHelper:
    """Interface for fused optimizer-update kernels. ``apply`` performs the
    WHOLE read-modify-write for one parameter tensor (new param AND new
    updater state). ``ComputationGraph._apply_updates`` consults the seam
    per parameter tensor; a helper must only accept (``supports``) updaters
    whose math it reproduces within the stock path's tolerance. In the port
    ``apply`` may write in place into the parameter and state tensors; it
    returns ``(param, state)``."""

    def supports(self, updater, param, grad) -> bool:  # pragma: no cover
        return False

    def apply(self, updater, param, grad, state, lr, t):  # pragma: no cover
        """Returns ``(new_param, new_state)`` for one parameter tensor."""
        raise NotImplementedError


class AttentionHelper:
    """Interface for fused attention kernels.

    ``causal`` describes the REQUESTED semantics: a helper must only accept
    a request whose causality matches what its ``attend`` computes, so
    registering any helper can never change model outputs. ``dtype`` is
    the request's head type (the seam passes ``q.dtype``)."""

    def supports(self, layer, q_shape, mask, dropout_active,
                 causal=False, *, dtype) -> bool:  # pragma: no cover - interface
        return False

    def attend(self, q, k, v):  # pragma: no cover - interface
        raise NotImplementedError
