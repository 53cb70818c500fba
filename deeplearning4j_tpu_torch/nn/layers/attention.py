"""Self-attention layers.

Counterpart of ``deeplearning4j_tpu/nn/layers/attention.py``: one fused,
head-major QKV projection and scaled dot-product attention over
``[N, H, T, Dh]``, through the "attention" helper seam. Both branches are
differentiable: the flash kernels through ``FlashAttentionFunction`` (the
forward kernel saves its LSE, the backward is two kernels), the plain math
through autograd. A train forward with ``attn_dropout > 0`` drops
attention weights after the softmax (``nn/dropout.py``'s
:func:`bernoulli`, kept weights scaled by ``1/(1-rate)``): the flash
kernels have no dropout, so the seam declines such a request, as the
reference's does, and the plain math runs. The causal layer's
``forward_seq`` attends through a fixed-capacity KV cache (stateful
decoding, TBPTT); it never reaches the attention seam.

``LearnedSelfAttentionLayer`` attends from ``n_queries`` learned query
vectors over a fused, head-major key/value projection (``Wkv``);
``CrossAttentionLayer`` takes its queries from one graph input and its
keys and values from others, through the graph's multi-input protocol
(``consumes_multiple_inputs``: ``set_n_in_multi``, ``output_type_multi``,
``forward_multi``). Both reach the seam with queries of another length
than their keys whenever the two differ, and a helper serves only
requests whose q, k and v have one shape, so such requests take the
plain math.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import dropout as _dropout
from deeplearning4j_tpu_torch.nn import helpers as _helpers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.cuda_kernels import FlashAttentionHelper
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer

_AUTO_FLASH = FlashAttentionHelper(causal=True)


def dot_product_attention(q, k, v, mask=None, dropout_rate=0.0, gen=None,
                          train=False, causal=False):
    """q,k,v: [N, H, T, Dh]; mask: [N, T] (1=valid) or [N, 1, Tq, Tk];
    ``causal=True`` additionally lower-triangular-masks the scores;
    ``dropout_rate`` drops attention weights in a train forward that has
    a generator ``gen``.

    The seam in the reference's order: a registered helper takes the
    requests its ``supports`` admits (it is given the request's type);
    with none registered and auto-flash on, a float32 or bfloat16 causal
    request the flash kernel admits takes the kernel of its type (no
    threshold on T: the reference's v5e gate is not carried over, and an
    H100 one waits for a measurement); otherwise the plain math below. A
    dropout-active request is one that no flash kernel admits. The
    kernels take f32 and bf16 (the TPU kernel's types), so a float64 or
    f16 network takes the plain math, as the reference's does off the TPU.
    """
    helper = _helpers.get_helper("attention")
    same = q.shape == k.shape == v.shape
    dropout_active = bool(train and dropout_rate > 0 and gen is not None)
    if (helper is not None and same
            and helper.supports(None, tuple(q.shape), mask, dropout_active,
                                causal=causal, dtype=q.dtype)):
        return helper.attend(q, k, v)
    if (helper is None and causal and same
            and _helpers.auto_flash_attention_enabled()
            and _AUTO_FLASH.supports(None, tuple(q.shape), mask,
                                     dropout_active, causal=True,
                                     dtype=q.dtype)):
        return _AUTO_FLASH.attend(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
    m = None
    if mask is not None:
        m = (mask[:, None, None, :] if mask.ndim == 2 else mask) > 0
    if causal:
        tri = torch.ones((q.shape[-2], k.shape[-2]), dtype=torch.bool,
                         device=q.device).tril()[None, None]
        m = tri if m is None else torch.logical_and(m, tri)
    if m is not None:
        scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
    w = torch.softmax(scores, dim=-1)
    if dropout_active:
        keep = _dropout.bernoulli(1.0 - dropout_rate, w.shape, gen, w.device,
                                  w.dtype)
        w = torch.where(keep, w / (1.0 - dropout_rate), w.new_zeros(()))
    return torch.einsum("nhqk,nhkd->nhqd", w, v)


@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over [N,T,C] with optional output projection."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    attn_dropout: float = 0.0
    causal: bool = False

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size
        if not self.n_out:
            self.n_out = self.n_in

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def _dh(self):
        return self.head_size or self.n_out // self.n_heads

    def param_shapes(self):
        # Wqkv columns are HEAD-MAJOR [H, 3, Dh], as in the reference
        inner = self.n_heads * self._dh()
        shapes = {"Wqkv": (self.n_in, 3 * inner), "bqkv": (3 * inner,)}
        if self.project_input:
            shapes["Wo"] = (inner, self.n_out)
            shapes["bo"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        inner = self.n_heads * self._dh()
        if not self.project_input and inner != self.n_out:
            raise ValueError(
                f"project_input=False requires n_heads*head_size == n_out "
                f"(got {inner} != {self.n_out})")
        kw = dict(dtype=dtype, device=device)
        p = {"Wqkv": self._init_w(gen, (self.n_in, 3 * inner), self.n_in,
                                  3 * inner, dtype, device),
             "bqkv": torch.zeros((3 * inner,), **kw)}
        if self.project_input:
            p["Wo"] = self._init_w(gen, (inner, self.n_out), inner,
                                   self.n_out, dtype, device)
            p["bo"] = torch.zeros((self.n_out,), **kw)
        return p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        n, t, _ = x.shape
        h, dh = self.n_heads, self._dh()
        qkv = matmul(x, params["Wqkv"]) + params["bqkv"]           # [N,T,H*3*Dh]
        qkv = qkv.reshape(n, t, h, 3, dh).permute(3, 0, 2, 1, 4)  # [3,N,H,T,Dh]
        out = dot_product_attention(qkv[0], qkv[1], qkv[2], mask=mask,
                                    causal=self.causal,
                                    dropout_rate=self.attn_dropout, gen=gen,
                                    train=train)
        y = out.transpose(1, 2).reshape(n, t, h * dh)
        if self.project_input:
            # head-sharded Wo: one all-reduce (matmul)
            y = matmul(y, params["Wo"]) + params["bo"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class CausalSelfAttentionLayer(SelfAttentionLayer, BaseRecurrentLayer):
    """Causal (autoregressive) multi-head self-attention: the full-sequence
    forward of :class:`SelfAttentionLayer` with the causal mask, and a
    stateful ``forward_seq`` over a fixed-capacity KV cache.

    The carry is the reference's ``(k_cache [N,H,Tc,Dh], v_cache,
    key_validity [N,Tc], position)``, ``Tc = max_cache``; the position is
    a Python int, so the overflow check and the write's start never wait
    for the device. Each query row (absolute position ``pos+i``) attends
    over all ``Tc`` slots, masked to the slots ``<= pos+i`` that hold valid
    keys; a masked score is ``finfo.min`` (as in the reference), so a row
    that sees no valid slot weighs every slot alike instead of giving
    NaN. New keys and values are written into the caches in place when
    nothing differentiates them (decoding); when they require grad (TBPTT),
    into a copy, so their gradient reaches ``Wqkv``."""

    max_cache: int = 512
    causal: bool = True

    def carry_capacity(self):
        return self.max_cache

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        h, dh, tc = self.n_heads, self._dh(), self.max_cache
        kw = dict(dtype=dtype, device=device)
        return (torch.zeros((batch, h, tc, dh), **kw),   # K cache
                torch.zeros((batch, h, tc, dh), **kw),   # V cache
                torch.zeros((batch, tc), **kw),          # key validity
                0)                                       # write position

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        if carry is None:
            return self.forward(params, x, mask=mask, train=train, gen=gen), None
        n, t, _ = x.shape
        h, dh, tc = self.n_heads, self._dh(), self.max_cache
        kc, vc, valid, pos = carry
        pos = int(pos)
        if pos + t > tc:
            raise ValueError(
                f"KV cache overflow: writing {t} token(s) at position "
                f"{pos} exceeds max_cache={tc}; raise max_cache or "
                f"rnn_clear_previous_state() first")
        qkv = x @ params["Wqkv"] + params["bqkv"]
        qkv = qkv.reshape(n, t, h, 3, dh).permute(3, 0, 2, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if k.requires_grad:
            kc, vc, valid = kc.clone(), vc.clone(), valid.clone()
        kc[:, :, pos:pos + t] = k.to(kc.dtype)
        vc[:, :, pos:pos + t] = v.to(vc.dtype)
        valid[:, pos:pos + t] = (1.0 if mask is None
                                 else (mask[:, :t] > 0).to(valid.dtype))
        # query i (absolute position pos+i) may see the slots <= pos+i
        # that hold valid keys
        slots = torch.arange(tc, device=x.device)
        causal = slots[None, :] <= (pos + torch.arange(t, device=x.device))[:, None]
        m = torch.logical_and(causal[None, None], (valid > 0)[:, None, None, :])
        scale = 1.0 / math.sqrt(dh)
        scores = torch.einsum("nhqd,nhkd->nhqk", q, kc.to(q.dtype)) * scale
        scores = scores.masked_fill(~m, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        if train and self.attn_dropout > 0 and gen is not None:
            # TBPTT through the cache regularizes as the full sequence does
            keep = _dropout.bernoulli(1.0 - self.attn_dropout, w.shape, gen,
                                      w.device, w.dtype)
            w = torch.where(keep, w / (1.0 - self.attn_dropout), w.new_zeros(()))
        out = torch.einsum("nhqk,nhkd->nhqd", w, vc.to(q.dtype))
        y = out.transpose(1, 2).reshape(n, t, h * dh)
        if self.project_input:
            y = y @ params["Wo"] + params["bo"]
        return self.act_fn()(y), (kc, vc, valid, pos + t)


#: the column order of the fused QKV projection that the model zip stamps
#: into ``meta.json``; a zip without the stamp holds the older block-major
#: order ([3, H, Dh] columns, [2, H, Dh] for a fused key/value projection)
QKV_LAYOUT = "head_major"

#: the fused projections and the number of parts each fuses
_FUSED_PARTS = {"Wqkv": 3, "bqkv": 3, "Wkv": 2, "bkv": 2}

#: updater slots that are elementwise per-parameter accumulators, so they
#: share the parameter's column order (every slot of ``nn/updaters.py``)
_COLUMN_INDEXED_SLOTS = frozenset({"v", "m", "u", "h", "v_hat", "eg2", "edx2", "g2"})


def repack_legacy_fused_qkv(model) -> int:
    """Counterpart of the reference's ``repack_legacy_fused_qkv``: move a
    model's fused ``Wqkv``/``bqkv`` and ``Wkv``/``bkv`` (and their
    same-shaped updater slots) from the block-major [parts, H, Dh] column
    order to the head-major [H, parts, Dh] one, in place; a layer that
    lacks one of them is skipped for it. The zip restorer calls it when
    ``meta.json`` has no ``qkv_layout`` stamp. Returns the number of
    tensors repacked."""

    def repack(t, parts, h, dh):
        if t.ndim == 1:
            return t.reshape(parts, h, dh).transpose(0, 1).reshape(-1)
        return (t.reshape(t.shape[0], parts, h, dh).transpose(1, 2)
                .reshape(t.shape[0], -1))

    if hasattr(model.conf, "vertices"):  # a ComputationGraph
        items = [(vd.name, vd.obj) for vd in model.conf.layer_vertices()]
    else:
        items = list(enumerate(model.layers))
    n = 0
    with torch.no_grad():
        for key, layer in items:
            if not isinstance(layer, SelfAttentionLayer) or layer.n_heads <= 1:
                continue
            h, dh = layer.n_heads, layer._dh()
            for pn, parts in _FUSED_PARTS.items():
                if pn not in model.params[key]:
                    continue
                p = model.params[key][pn]
                p.copy_(repack(p, parts, h, dh))
                n += 1
                slots = (model.updater_states or {}).get(key, {}).get(pn, {})
                for slot, arr in slots.items():
                    if slot in _COLUMN_INDEXED_SLOTS and arr.shape == p.shape:
                        arr.copy_(repack(arr, parts, h, dh))
                        n += 1
    return n


@register_layer
@dataclasses.dataclass
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention from ``n_queries`` learned query vectors (DL4J's
    LearnedSelfAttentionLayer) over [N,T,C]: the fused key/value
    projection ``Wkv`` has head-major [H, 2, Dh] columns, the queries
    ``Q`` are [n_queries, H, Dh], and the output, projected by ``Wo``, is
    [N, n_queries, n_out]. A mask [N,T] masks the keys."""

    n_queries: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.n_queries)

    def param_shapes(self):
        dh = self._dh()
        inner = self.n_heads * dh
        return {"Wkv": (self.n_in, 2 * inner), "bkv": (2 * inner,),
                "Q": (self.n_queries, self.n_heads, dh),
                "Wo": (inner, self.n_out), "bo": (self.n_out,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        dh = self._dh()
        inner = self.n_heads * dh
        kw = dict(dtype=dtype, device=device)
        return {
            "Wkv": self._init_w(gen, (self.n_in, 2 * inner), self.n_in,
                                2 * inner, dtype, device),
            "bkv": torch.zeros((2 * inner,), **kw),
            "Q": self._init_w(gen, (self.n_queries, self.n_heads, dh), dh, dh,
                              dtype, device),
            "Wo": self._init_w(gen, (inner, self.n_out), inner, self.n_out,
                               dtype, device),
            "bo": torch.zeros((self.n_out,), **kw),
        }

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        n, t, _ = x.shape
        h, dh, nq = self.n_heads, self._dh(), self.n_queries
        kv = x @ params["Wkv"] + params["bkv"]                  # [N,T,H*2*Dh]
        kv = kv.reshape(n, t, h, 2, dh).permute(3, 0, 2, 1, 4)  # [2,N,H,T,Dh]
        q = params["Q"].transpose(0, 1)[None].expand(n, h, nq, dh)
        out = dot_product_attention(q, kv[0], kv[1], mask=mask,
                                    dropout_rate=self.attn_dropout, gen=gen,
                                    train=train)
        y = out.transpose(1, 2).reshape(n, nq, h * dh)
        return self.act_fn()(y @ params["Wo"] + params["bo"])


@register_layer
@dataclasses.dataclass
class CrossAttentionLayer(Layer):
    """Multi-head cross-attention (Keras ``MultiHeadAttention(query,
    value[, key])``): the queries from the first graph input, the values
    from the second and the keys from the third (the values' source when
    there is none; a single input attends over itself). Separate
    projections ``Wq``/``Wk``/``Wv``/``Wo``, since the sources and the
    value width (``value_size``, default ``head_size``) may differ. The
    keys are masked by the key source's mask, else the value source's,
    else the query's. Consumes several graph inputs through the
    multi-input protocol: no concatenation, no preprocessor."""

    n_in: int = 0          # query feature width
    k_in: int = 0          # key source feature width
    v_in: int = 0          # value source feature width
    n_out: int = 0         # output width (default: the query's)
    n_heads: int = 1
    head_size: Optional[int] = None   # Dh of q and k
    value_size: Optional[int] = None  # Dv (default: head_size)
    attn_dropout: float = 0.0

    consumes_multiple_inputs = True

    def _dh(self) -> int:
        return self.head_size or max(1, self.n_in // self.n_heads)

    def _dv(self) -> int:
        return self.value_size or self._dh()

    def set_n_in_multi(self, input_types) -> None:
        if not self.n_in:
            self.n_in = input_types[0].size
        if len(input_types) > 1 and not self.v_in:
            self.v_in = input_types[1].size
        if not self.k_in:
            self.k_in = (input_types[2].size if len(input_types) > 2
                         else self.v_in or self.n_in)
        if not self.v_in:
            self.v_in = self.n_in
        if not self.n_out:
            self.n_out = self.n_in

    def output_type_multi(self, input_types) -> InputType:
        return InputType.recurrent(self.n_out or input_types[0].size,
                                   input_types[0].timesteps)

    def param_shapes(self):
        h, dh, dv = self.n_heads, self._dh(), self._dv()
        return {"Wq": (self.n_in, h * dh), "bq": (h * dh,),
                "Wk": (self.k_in, h * dh), "bk": (h * dh,),
                "Wv": (self.v_in, h * dv), "bv": (h * dv,),
                "Wo": (h * dv, self.n_out), "bo": (self.n_out,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        shapes, out = self.param_shapes(), {}
        for w in ("Wq", "Wk", "Wv", "Wo"):
            s, b = shapes[w], "b" + w[1:].lower()
            out[w] = self._init_w(gen, s, s[0], s[1], dtype, device)
            out[b] = torch.zeros(shapes[b], dtype=dtype, device=device)
        return out

    def forward_multi(self, params, inputs, *, masks=None, train=False,
                      gen=None):
        xq = inputs[0]
        xv = inputs[1] if len(inputs) > 1 else xq
        xk = inputs[2] if len(inputs) > 2 else xv
        n, tq, _ = xq.shape
        tk = xk.shape[1]
        h, dh, dv = self.n_heads, self._dh(), self._dv()
        q = (xq @ params["Wq"] + params["bq"]).reshape(n, tq, h, dh).transpose(1, 2)
        k = (xk @ params["Wk"] + params["bk"]).reshape(n, tk, h, dh).transpose(1, 2)
        v = (xv @ params["Wv"] + params["bv"]).reshape(n, tk, h, dv).transpose(1, 2)
        kv_mask = None
        if masks:
            # over the keys: the key source's mask, else the value
            # source's, else (one input) the query's
            kv_mask = (masks[2] if len(masks) > 2 and masks[2] is not None
                       else masks[1] if len(masks) > 1 else masks[0])
        out = dot_product_attention(q, k, v, mask=kv_mask,
                                    dropout_rate=self.attn_dropout, gen=gen,
                                    train=train)
        y = out.transpose(1, 2).reshape(n, tq, h * dv)
        return self.act_fn()(y @ params["Wo"] + params["bo"])

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        # one input: self-attention over x, the mask over its keys
        return self.forward_multi(params, [x], train=train, gen=gen,
                                  masks=None if mask is None else [mask])
