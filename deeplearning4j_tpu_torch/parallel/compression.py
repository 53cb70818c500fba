"""Threshold gradient compression with a fixed capacity.

Counterpart of ``deeplearning4j_tpu/parallel/compression.py`` (the
reference's ``EncodingHandler.java`` thresholdEncode ``:139`` and its
adaptive threshold ``:28,69-94``; ``EncodedGradientsAccumulator.java``
decode ``:257,292`` and buffer sizing ``getOptimalBufferSize:127-134``).
An update is sent as the indices of the residual's entries whose
magnitude reaches the threshold, each with its sign; the receiver adds
±threshold at each index, and the sender keeps the unsent remainder as
its residual (Strom-style 1-bit compression).

The buffers have a fixed capacity, as in the reference, so the encode
runs on the device with no host synchronisation: each flagged entry's
slot is its rank among the flagged entries (an inclusive cumulative sum
minus one), and an entry whose slot falls past the capacity is dropped
and stays in the residual. The functions follow their tensor's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Encoded(NamedTuple):
    """A sparse threshold-encoded update of fixed capacity."""

    indices: torch.Tensor    # [capacity] int32, -1 = empty slot
    signs: torch.Tensor      # [capacity] int8 (+1 / -1, 0 for empty)
    count: torch.Tensor      # [] int32: the number of valid entries
    threshold: torch.Tensor  # [] float32: the step magnitude


def optimal_capacity(size: int, sparsity: float = 1.0 / 16.0, floor: int = 16) -> int:
    """The buffer size for a worst-case sparsity (the reference sizes for
    ``paramsLength / 16``, hence the 1/16 default)."""
    return max(floor, int(size * sparsity))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def threshold_encode(residual, threshold, capacity: Optional[int] = None
                     ) -> Tuple[Encoded, torch.Tensor]:
    """Encode ``residual`` into ``(message, new residual)``: the entries
    with ``|r| >= threshold`` take slots in flat-index order until the
    capacity is full; each one sent leaves the residual ``±threshold``
    smaller. No host read."""
    residual = _tensor(residual)
    if capacity is None:
        capacity = optimal_capacity(residual.numel())
    capacity = int(capacity)
    r = residual.reshape(-1)
    thr = torch.as_tensor(threshold, dtype=r.dtype, device=r.device)
    flags = r.abs() >= thr
    pos = torch.cumsum(flags, 0) - 1  # the slot of each flagged entry
    fits = flags & (pos < capacity)
    # one slot past the buffer takes every entry that does not fit; it is
    # cut off afterwards (the reference's scatter with mode="drop")
    slot = torch.where(fits, pos, torch.full_like(pos, capacity))
    sign = torch.sign(r)
    idx_buf = torch.full((capacity + 1,), -1, dtype=torch.int32, device=r.device)
    idx_buf.scatter_(0, slot, torch.arange(r.numel(), dtype=torch.int32, device=r.device))
    sign_buf = torch.zeros(capacity + 1, dtype=torch.int8, device=r.device)
    sign_buf.scatter_(0, slot, sign.to(torch.int8))
    count = torch.clamp(flags.sum(), max=capacity).to(torch.int32)
    sent = fits.to(r.dtype) * sign * thr
    new_residual = (r - sent).reshape(residual.shape)
    return (Encoded(idx_buf[:capacity], sign_buf[:capacity], count,
                    thr.to(torch.float32)), new_residual)


def threshold_decode(msg: Encoded, size: int) -> torch.Tensor:
    """A message as a dense float32 update of ``size`` entries (the
    reference applies it to the local parameters)."""
    dev = msg.indices.device
    out = torch.zeros(int(size) + 1, dtype=torch.float32, device=dev)
    vals = msg.signs.to(torch.float32) * msg.threshold.to(torch.float32)
    idx = torch.where(msg.indices >= 0, msg.indices.to(torch.int64),
                      torch.full_like(msg.indices, int(size), dtype=torch.int64))
    out.scatter_add_(0, idx, vals)
    return out[:int(size)]


class EncodingHandler:
    """The residual and the adaptive threshold between calls
    (``EncodingHandler.java``): an encode that sends too few entries
    lowers the threshold (decay), one that fills the buffer raises it."""

    def __init__(self, threshold: float = 1e-3, *, min_threshold: float = 1e-5,
                 decay: float = 0.95, boost: float = 1.2,
                 capacity: Optional[int] = None):
        self.threshold = float(threshold)
        self.min_threshold = float(min_threshold)
        self.decay = float(decay)
        self.boost = float(boost)
        self.capacity = capacity
        self._residual: Optional[torch.Tensor] = None

    def encode(self, update) -> Encoded:
        update = _tensor(update)
        if self._residual is None:
            self._residual = torch.zeros_like(update)
        cap = self.capacity or optimal_capacity(update.numel())
        msg, self._residual = threshold_encode(self._residual + update,
                                               self.threshold, cap)
        n = int(msg.count)  # the host read the threshold's next value needs
        if n >= cap:
            self.threshold *= self.boost
        elif n < max(1, cap // 8):
            self.threshold = max(self.min_threshold, self.threshold * self.decay)
        return msg

    def reset(self) -> None:
        self._residual = None
