"""Input type inference — the DL4J ``InputType`` system: the feed-forward,
recurrent, convolutional (``cnn``, ``cnn_flat``, ``cnn3d``, ``cnn1d``) and
image-sequence (``cnn_seq``) kinds.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``, with the same
fields, so that a configuration's JSON reads back in both packages.
Convolutional activations are NHWC (channels last), recurrent ones
``[batch, time, size]``, volumes ``[batch, D, H, W, C]`` and image
sequences ``[batch, time, H, W, C]`` (ConvLSTM2D's data), as in the
reference. A 1-D convolution's data is the recurrent kind
(``recurrent1d``); the ``cnn1d`` kind has a name and no size, as in the
reference, whose ``flat_size`` and ``batch_shape`` refuse it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

KINDS = ("ff", "rnn", "cnn", "cnn_flat", "cnn3d", "cnn1d", "cnn_seq")


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # one of KINDS
    size: int = 0                    # ff / rnn feature size (cnn_flat: H*W*C)
    timesteps: Optional[int] = None  # rnn, cnn_seq (None = variable)
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0                   # cnn3d

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown InputType kind {self.kind!r}")

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=int(size), timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        """Images that arrive flattened, ``[batch, H*W*C]`` in H, W, C order."""
        return InputType(kind="cnn_flat", height=int(height), width=int(width),
                         channels=int(channels),
                         size=int(height * width * channels))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        return InputType(kind="cnn3d", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

    @staticmethod
    def recurrent1d(size: int, timesteps: Optional[int] = None) -> "InputType":
        """A 1-D convolution's data, ``[batch, time, channels]``: the
        recurrent kind."""
        return InputType.recurrent(size, timesteps)

    @staticmethod
    def recurrent_convolutional(height: int, width: int, channels: int,
                                timesteps: Optional[int] = None) -> "InputType":
        """A sequence of images [batch, time, H, W, C] (ConvLSTM2D data)."""
        return InputType(kind="cnn_seq", height=int(height), width=int(width),
                         channels=int(channels), timesteps=timesteps)

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        if self.kind in ("cnn", "cnn_flat", "cnn_seq"):
            return self.height * self.width * self.channels
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

    def batch_shape(self, batch: int = 1) -> Tuple[int, ...]:
        """Example array shape for one batch of this type (NHWC / NTC /
        NDHWC / NTHWC)."""
        if self.kind in ("ff", "cnn_flat"):
            return (batch, self.flat_size())
        t = self.timesteps if self.timesteps is not None else 1
        if self.kind == "rnn":
            return (batch, t, self.size)
        if self.kind == "cnn_seq":
            return (batch, t, self.height, self.width, self.channels)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "cnn3d":
            return (batch, self.depth, self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def cnn_seq_to_rnn(self):
        """The per-step flatten of an image sequence, ``(fn, type)``:
        [N,T,H,W,C] -> [N,T,H*W*C], for a flat-input layer after a
        ConvLSTM2D stage."""
        assert self.kind == "cnn_seq", self.kind
        return (lambda x: x.reshape(x.shape[0], x.shape[1], -1),
                InputType.recurrent(self.flat_size(), self.timesteps))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
