"""Mixture-of-experts layer.

Counterpart of ``_route``, ``_moe_apply``, ``MixtureOfExpertsLayer`` and
``load_balancing_loss`` in ``deeplearning4j_tpu/nn/layers/moe.py``: a
gated expert FFN (not in DL4J itself). Every expert runs on every token
(``[..., d_in]`` against ``W`` ``[E, d_in, d_out]``); a router ``Wg``
picks the top ``top_k`` logits of each token, renormalizes them with a
softmax and weights the experts' outputs with those gates.

Routing ties: ``jax.lax.top_k`` puts the lower index first among equal
logits (an all-zero row makes every logit equal); ``torch.topk`` promises
no order, so the top k come from a stable descending sort.

With ``collect_gates`` a train forward returns the last batch's gates as
the layer's state (``"gates"``), for monitoring only. The
expert-parallel ``ep_forward`` of the reference needs a device mesh and is
not ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer


def _route(wg: torch.Tensor, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """Dense ``[..., E]`` gates: the top-k logits softmaxed, 0 elsewhere."""
    logits = matmul(x, wg)
    e = logits.shape[-1]
    k = min(top_k, e)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates_k = torch.softmax(vals[..., :k], dim=-1)
    return torch.sum(F.one_hot(idx[..., :k], e).to(x.dtype) * gates_k[..., None],
                     dim=-2)


def _moe_apply(params, x: torch.Tensor, top_k: int, act):
    """Every expert on every token, weighted by the gates: ``(out,
    gates)``, ``[..., d_out]`` and ``[..., E]``."""
    gates = _route(params["Wg"], x, top_k)
    hidden = act(torch.einsum("...d,edh->...eh", x, params["W"]) + params["b"])
    return torch.einsum("...eh,...e->...h", hidden, gates), gates


@register_layer
@dataclasses.dataclass
class MixtureOfExpertsLayer(Layer):
    """Gated expert FFN: the router picks ``top_k`` of ``n_experts`` per
    token."""

    n_in: int = 0
    n_out: int = 0
    n_experts: int = 4
    top_k: int = 2
    # surface the routing gates as the layer's state (monitoring only)
    collect_gates: bool = False

    def __post_init__(self):
        if self.activation is None:
            self.activation = "relu"

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size
        if not self.n_out:
            self.n_out = self.n_in

    def output_type(self, input_type: InputType) -> InputType:
        # the reference's test: its sequence kind is "rnn", so this branch
        # never takes, and the output type is always feed-forward
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        return {"Wg": (self.n_in, self.n_experts),
                "W": (self.n_experts, self.n_in, self.n_out),
                "b": (self.n_experts, self.n_out)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        wg = self._init_w(gen, (self.n_in, self.n_experts), self.n_in,
                          self.n_experts, dtype, device)
        w = torch.stack([self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                                      self.n_out, dtype, device)
                         for _ in range(self.n_experts)])
        return {"Wg": wg, "W": w,
                "b": torch.zeros((self.n_experts, self.n_out), dtype=dtype,
                                 device=device)}

    def forward_state(self, params, state, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)
        out, gates = _moe_apply(params, x, self.top_k, self.act_fn())
        if self.collect_gates:
            return out, {**state, "gates": gates.detach()}
        return out, state

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.forward_state(params, {}, x, train=train, gen=gen)[0]


def load_balancing_loss(gates: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss, ``E · Σ_e mean_gate_e ·
    dispatch_frac_e`` (each token counted toward its top expert): 1 when
    the routing is uniform over the experts."""
    e = gates.shape[-1]
    flat = gates.reshape(-1, e)
    importance = flat.mean(dim=0)
    dispatch = F.one_hot(torch.argmax(flat, dim=-1), e).to(flat.dtype).mean(dim=0)
    return e * torch.sum(importance * dispatch)
