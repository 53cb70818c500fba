"""Graph vertices — the non-layer nodes of a ComputationGraph DAG.

Counterpart of ``GraphVertex`` and ``ElementWiseVertex`` in
``deeplearning4j_tpu/nn/vertices.py``, with the reference's serde (the
fields and an ``@vertex`` tag); the other vertices come with the models
that use them, and reading one raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

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
