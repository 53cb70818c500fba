"""Graph vertices — the non-layer nodes of a ComputationGraph DAG.

Counterpart of ``deeplearning4j_tpu/nn/vertices.py``: every vertex of the
reference (Merge, ElementWise, Stack, Unstack, Subset, Reshape, Scale,
Shift, L2Normalize, L2, PoolHelper, PreprocessorVertex and the sequence
vertices LastTimeStep, DuplicateToTimeSeries, ReverseTimeSeries), each a
dataclass with a ``forward(inputs, masks)`` of plain tensor operations
(autograd gives the backward) and the reference's serde: its fields and an
``@vertex`` tag, so a configuration's JSON reads back in both packages.
Activations are NHWC or ``[N, T, C]``, so "the feature axis" is always
the last one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class GraphVertex:
    """Parameterless DAG node: a function of its input activations."""

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def forward(self, inputs: List[torch.Tensor],
                masks: Optional[List[Optional[torch.Tensor]]] = None
                ) -> torch.Tensor:
        raise NotImplementedError

    def output_mask(self, masks):
        """Mask propagation; default: pass through the first input's mask."""
        for m in masks:
            if m is not None:
                return m
        return None

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["@vertex"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertex":
        d = dict(d)
        name = d.pop("@vertex")
        if name not in VERTEX_REGISTRY:
            raise NotImplementedError(f"vertex {name!r} is not ported yet")
        return VERTEX_REGISTRY[name](**{k: tuple(v) if isinstance(v, list) else v
                                        for k, v in d.items()})


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the feature (last) axis (MergeVertex.java)."""

    def output_type(self, input_types):
        t0 = input_types[0]
        if t0.kind == "cnn":
            return InputType.convolutional(
                t0.height, t0.width, sum(t.channels for t in input_types))
        if t0.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       t0.timesteps)
        return InputType.feed_forward(sum(t.size for t in input_types))

    def forward(self, inputs, masks=None):
        return torch.cat(inputs, dim=-1)


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """add | average | subtract | product | max (ElementWiseVertex.java)."""

    op: str = "add"

    def forward(self, inputs, masks=None):
        op = self.op.lower()
        if op in ("add", "sum", "average", "avg"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs) if op in ("average", "avg") else out
        if op in ("subtract", "sub"):
            if len(inputs) != 2:
                raise ValueError("subtract needs exactly 2 inputs")
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"unknown op {self.op!r}")


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Concatenation along the batch (first) axis (StackVertex.java)."""

    def forward(self, inputs, masks=None):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Chunk ``from_index`` of ``stack_size`` equal batch chunks
    (UnstackVertex.java)."""

    from_index: int = 0
    stack_size: int = 1

    def forward(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features [from_index, to_index], both included (SubsetVertex.java)."""

    from_index: int = 0
    to_index: int = 0

    def output_type(self, input_types):
        n = self.to_index - self.from_index + 1
        t0 = input_types[0]
        if t0.kind == "rnn":
            return InputType.recurrent(n, t0.timesteps)
        return InputType.feed_forward(n)

    def forward(self, inputs, masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    """Reshape to ``shape``, the batch axis kept (ReshapeVertex.java)."""

    shape: Tuple[int, ...] = ()

    def output_type(self, input_types):
        s = tuple(self.shape)
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        return input_types[0]

    def forward(self, inputs, masks=None):
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    """Multiplication by a fixed scalar (ScaleVertex.java)."""

    scale_factor: float = 1.0

    def forward(self, inputs, masks=None):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    """Addition of a fixed scalar (ShiftVertex.java)."""

    shift_factor: float = 0.0

    def forward(self, inputs, masks=None):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """x / (||x||₂ + eps) over every axis but the batch's
    (L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def forward(self, inputs, masks=None):
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        norm = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        return x / (norm + self.eps)


@register_vertex
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs, ``[N, 1]`` (L2Vertex.java)."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def forward(self, inputs, masks=None):
        a, b = inputs
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=1, keepdim=True) + self.eps)


@register_vertex
@dataclasses.dataclass
class PoolHelperVertex(GraphVertex):
    """The NHWC map without its first row and column, for imported
    GoogLeNet-style models (PoolHelperVertex.java)."""

    def output_type(self, input_types):
        t = input_types[0]
        return InputType.convolutional(t.height - 1, t.width - 1, t.channels)

    def forward(self, inputs, masks=None):
        return inputs[0][:, 1:, 1:, :]


def _lengths(mask: torch.Tensor) -> torch.Tensor:
    """The unmasked steps of each row of a ``[N, T]`` mask, as int64."""
    return mask.sum(dim=1).to(torch.int32).to(torch.int64)


@register_vertex
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """[N,T,C] → [N,C] at each row's last unmasked step
    (rnn/LastTimeStepVertex.java); ``mask_input`` names the network input
    whose mask applies."""

    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def forward(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        idx = (_lengths(mask) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def output_mask(self, masks):
        return None  # the time axis is gone


@register_vertex
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[N,C] → [N,T,C], T from the second (sequence) input
    (rnn/DuplicateToTimeSeriesVertex.java)."""

    ts_input: Optional[str] = None

    def output_type(self, input_types):
        t = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].size, t)

    def forward(self, inputs, masks=None):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1], x.shape[-1])

    def output_mask(self, masks):
        return masks[1] if len(masks) > 1 else None


@register_vertex
@dataclasses.dataclass
class ReverseTimeSeriesVertex(GraphVertex):
    """Reversal along time; with a mask, of each row's unmasked prefix
    only (rnn/ReverseTimeSeriesVertex.java)."""

    mask_input: Optional[str] = None

    def forward(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return torch.flip(x, dims=(1,))
        lengths = _lengths(mask)[:, None]  # [N, 1]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        src = torch.where(pos < lengths, lengths - 1 - pos, pos)
        return torch.take_along_dim(x, src[:, :, None], dim=1)


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """A named input preprocessor (``nn/conf/preprocessors.py`` spec) as a
    vertex (PreprocessorVertex.java)."""

    preprocessor: str = "identity"

    def output_type(self, input_types):
        return pp.output_type(self.preprocessor, input_types[0])

    def forward(self, inputs, masks=None):
        return pp.apply(self.preprocessor, inputs[0])
