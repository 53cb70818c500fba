"""Model zoo: LeNet, ResNet-50, the GPT-style TransformerLM, and text
generation.

Counterpart of ``LeNet``, ``ResNet50``, ``transformer_decoder_block``,
``TransformerLM``,
``lm_labels``, ``generate``, ``generate_on_device`` and ``beam_search`` in
``deeplearning4j_tpu/zoo/models.py``. The same layers, vertex names and
parameter shapes; ``init(device=None)`` builds the network on ``cuda``
(``device="cpu"`` for the CPU). No pretrained weights are fetched: the
zoo's pretrained LeNet and ResNet-50 zips are not in the repository.

Generation runs the network's stateful path: every causal attention layer
carries a fixed-capacity KV cache, so each new token is one single-token
step. Token ids travel as float features ``[N,T,1]`` (exact up to 2**24),
as in the reference. ``generate`` is the reference's host loop over
``rnn_time_step`` (the probabilities read to numpy each token, numpy
sampling). ``generate_on_device`` and ``beam_search`` drive
``ComputationGraph._forward_all`` with carries directly and keep every
token on the device until one read at the end; where the reference
compiles the whole decode into one executable, the port launches each
step's kernels eagerly, with no host synchronisation between the prefill
and that read.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer,
    ActivationLayer,
    BatchNormalizationLayer,
    CausalSelfAttentionLayer,
    ConvolutionLayer,
    DenseLayer,
    EmbeddingSequenceLayer,
    GlobalPoolingLayer,
    LayerNormalizationLayer,
    OutputLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    SubsamplingLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import unchecked_token_ids
from deeplearning4j_tpu_torch.nn.layers.recurrent import map_carry
from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.nn.updaters import AdaDelta, Adam, Nesterovs
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.zoo.helpers import (
    resnet_conv_block,
    resnet_identity_block,
)


class LeNet:
    """LeNet-5-style CNN (``zoo/model/LeNet.java``): two 5x5 "same"
    convolutions of 20 and 50 channels, each followed by a 2x2 max pool,
    a dense 500 and a softmax output, trained with AdaDelta.
    ``input_shape`` is (channels, height, width), as in the reference."""

    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(1, 28, 28)):
        self.num_labels = num_labels
        self.seed = seed
        self.input_shape = tuple(input_shape)

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder().seed(self.seed)
                .activation("identity").weight_init("xavier")
                .updater(AdaDelta()).list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_labels, loss="mcxent",
                                   activation="softmax"))
                .set_input_type(InputType.convolutional(h, w, c)).build())

    def init(self, device=None):
        """The initialized network (seeded with this model's seed)."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(self.conf(), device=device).init(seed=self.seed)


class ResNet50:
    """ResNet-50 (``zoo/model/ResNet50.java``): a 7x7/2 stem (zero padding
    3, convolution, BatchNorm, relu, 3x3/2 max pool), then [3, 4, 6, 3]
    bottleneck blocks of 256, 512, 1024 and 2048 channels, a 3x3 "same"
    average pool, global average pooling and a softmax output; Nesterovs
    (1e-2, 0.9), l1 1e-7, l2 5e-5. Stage 2's projection has stride 1, as
    in the reference (canonical ResNet-50; DL4J's passes 2). The stem
    convolution carries ``space_to_depth_stem`` and runs the plain
    convolution. ``input_shape`` is (channels, height, width)."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        self.num_labels = num_labels
        self.seed = seed
        self.input_shape = tuple(input_shape)

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("identity").weight_init("xavier")
             .updater(Nesterovs(1e-2, 0.9)).l1(1e-7).l2(5e-5).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("stem-zero", ZeroPaddingLayer(padding=(3, 3)), "input")
        g.add_layer("stem-cnn1",
                    ConvolutionLayer(n_out=64, kernel_size=(7, 7), stride=(2, 2),
                                     activation="identity", has_bias=False,
                                     space_to_depth_stem=True), "stem-zero")
        g.add_layer("stem-batch1", BatchNormalizationLayer(activation="identity"),
                    "stem-cnn1")
        g.add_layer("stem-act1", ActivationLayer(activation="relu"), "stem-batch1")
        g.add_layer("stem-maxpool1",
                    SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                     stride=(2, 2)), "stem-act1")
        x = resnet_conv_block(g, (3, 3), (64, 64, 256), "2", "a", "stem-maxpool1",
                              stride=(1, 1))
        for blk in "bc":
            x = resnet_identity_block(g, (3, 3), (64, 64, 256), "2", blk, x)
        for stage, width, blocks in (("3", 128, "bcd"), ("4", 256, "bcdef"),
                                     ("5", 512, "bc")):
            filters = (width, width, 4 * width)
            x = resnet_conv_block(g, (3, 3), filters, stage, "a", x)
            for blk in blocks:
                x = resnet_identity_block(g, (3, 3), filters, stage, blk, x)
        g.add_layer("avgpool",
                    SubsamplingLayer(pooling_type="avg", kernel_size=(3, 3),
                                     stride=(1, 1), convolution_mode="same"), x)
        g.add_layer("globalpool", GlobalPoolingLayer(pooling_type="avg"), "avgpool")
        g.add_layer("fc1000", OutputLayer(n_out=self.num_labels, loss="mcxent",
                                          activation="softmax"), "globalpool")
        return g.set_outputs("fc1000").build()

    def init(self, device=None):
        """The initialized graph (seeded with this model's seed)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph(self.conf(), device=device).init(seed=self.seed)


def transformer_decoder_block(g, name: str, src: str, d_model: int,
                              n_heads: int, d_ff: int, max_len: int,
                              attn_dropout: float = 0.0) -> str:
    """One pre-LN causal decoder block (GPT-style): LN → causal
    self-attention → residual, LN → position-wise FFN → residual. Returns
    the output vertex name."""
    g.add_layer(f"{name}-ln1", LayerNormalizationLayer(), src)
    g.add_layer(f"{name}-att",
                CausalSelfAttentionLayer(n_heads=n_heads,
                                         head_size=d_model // n_heads,
                                         project_input=True,
                                         max_cache=max_len,
                                         attn_dropout=attn_dropout),
                f"{name}-ln1")
    g.add_vertex(f"{name}-res1", ElementWiseVertex(op="add"),
                 src, f"{name}-att")
    g.add_layer(f"{name}-ln2", LayerNormalizationLayer(), f"{name}-res1")
    g.add_layer(f"{name}-ff1", DenseLayer(n_in=d_model, n_out=d_ff,
                                          activation="gelu"), f"{name}-ln2")
    g.add_layer(f"{name}-ff2", DenseLayer(n_in=d_ff, n_out=d_model,
                                          activation="identity"),
                f"{name}-ff1")
    g.add_vertex(f"{name}-res2", ElementWiseVertex(op="add"),
                 f"{name}-res1", f"{name}-ff2")
    return f"{name}-res2"


class TransformerLM:
    """GPT-style causal-decoder language model: token ids [N,T] →
    embedding + learned positions → n pre-LN causal decoder blocks → final
    LayerNorm → per-timestep softmax over the vocabulary. Defaults are
    GPT-2-small (vocab 50257, 1024 positions, 12L / 768 / 12H / 3072)."""

    def __init__(self, num_labels: int = 0, seed: int = 123,
                 vocab_size: int = 50257, max_length: int = 1024,
                 n_layers: int = 12, d_model: int = 768, n_heads: int = 12,
                 d_ff: int = 3072, attn_dropout: float = 0.0):
        # for an LM the label space IS the vocabulary (the reference's rule)
        self.vocab_size = num_labels or vocab_size
        self.num_labels = self.vocab_size
        self.seed = seed
        self.max_length = max_length
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.attn_dropout = attn_dropout

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier")
             .updater(Adam(3e-4)).graph_builder()
             .add_inputs("tokens")
             .set_input_types(InputType.recurrent(1, self.max_length)))
        g.add_layer("embed",
                    EmbeddingSequenceLayer(n_in=self.vocab_size,
                                           n_out=self.d_model), "tokens")
        g.add_layer("pos", PositionalEmbeddingLayer(n_in=self.d_model,
                                                    max_len=self.max_length),
                    "embed")
        src = "pos"
        for i in range(self.n_layers):
            src = transformer_decoder_block(g, f"block{i}", src,
                                            self.d_model, self.n_heads,
                                            self.d_ff, self.max_length,
                                            self.attn_dropout)
        g.add_layer("ln_f", LayerNormalizationLayer(), src)
        g.add_layer("out", RnnOutputLayer(n_in=self.d_model,
                                          n_out=self.vocab_size,
                                          activation="softmax", loss="mcxent"),
                    "ln_f")
        g.set_outputs("out")
        return g.build()

    def init(self, device=None):
        """The initialized network (seeded with this model's seed)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph(self.conf(), device=device).init(seed=self.seed)


def lm_labels(tokens, vocab_size: int):
    """Next-token one-hot targets for causal LM training: labels[t] =
    onehot(tokens[t+1]); the last step repeats the last token."""
    ids = np.asarray(tokens).astype(np.int64)
    shifted = np.concatenate([ids[:, 1:], ids[:, -1:]], axis=1)
    out = np.zeros(shifted.shape + (vocab_size,), np.float32)
    np.put_along_axis(out, shifted[..., None], 1.0, axis=-1)
    return out


def generate(net, prompt_ids, n_new_tokens: int, temperature: float = 0.0,
             seed: int = 0):
    """Autoregressive sampling through ``net.rnn_time_step`` (a graph or a
    MultiLayerNetwork): the prompt once, then one step per token
    (``n_new_tokens - 1`` steps: the last token is not fed back). Each
    token's probabilities are read to numpy and sampled with
    ``np.random.default_rng(seed)``; ``temperature=0`` is greedy argmax.
    Returns ``[N, n_new_tokens]`` int64 ids."""
    rng = np.random.default_rng(seed)
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty
    net.rnn_clear_previous_state()
    # [N,T,1]: ids are features, and rnn_time_step keeps the time axis
    probs = net.rnn_time_step(ids[:, :, None].astype(np.float32))
    out = []
    for i in range(n_new_tokens):
        p_last = to_host(probs[:, -1, :] if probs.ndim == 3 else probs)
        if temperature and temperature > 0:
            logits = np.log(np.maximum(p_last, 1e-20)) / temperature
            z = np.exp(logits - logits.max(axis=-1, keepdims=True))
            p = (z / z.sum(axis=-1, keepdims=True)).astype(np.float64)
            p /= p.sum(axis=-1, keepdims=True)  # exact for rng.choice's check
            nxt = np.array([rng.choice(p.shape[-1], p=row) for row in p])
        else:
            nxt = np.argmax(p_last, axis=-1)
        out.append(nxt)
        if i < n_new_tokens - 1:
            probs = net.rnn_time_step(nxt[:, None, None].astype(np.float32))
    return np.stack(out, axis=1)


def _sampler(temperature: float, top_k: int, top_p: float, gen):
    """``sample(p) -> ids``: argmax when greedy; else the reference's
    filters over ``log(p) / temperature`` (top-k first, then the smallest
    nucleus whose mass reaches ``top_p``, at least one token) and one
    Gumbel-max draw from ``gen`` (what ``jax.random.categorical`` does)."""
    if not (temperature and temperature > 0):
        return lambda p: p.argmax(dim=-1)

    def sample(p):
        # masked_fill with Python scalars: no host-to-device copy in the loop
        ninf = float("-inf")
        logits = torch.log(p.clamp_min(1e-20)) / temperature
        if top_k or top_p:
            srt = torch.sort(logits, dim=-1, descending=True).values
            if top_k:
                kk = min(int(top_k), p.shape[-1])
                logits = logits.masked_fill(logits < srt[:, kk - 1:kk], ninf)
                # the nucleus then applies over the top-k survivors
                rank = torch.arange(srt.shape[-1], device=srt.device)
                srt = srt.masked_fill(rank >= kk, ninf)
            if top_p:
                probs = torch.softmax(srt, dim=-1)
                keep = torch.cumsum(probs, dim=-1) - probs < top_p
                cutoff = srt.masked_fill(~keep, -ninf).amin(dim=-1, keepdim=True)
                logits = logits.masked_fill(logits < cutoff, ninf)
        u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                       device=logits.device)
        u = u.clamp_min(torch.finfo(logits.dtype).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(dim=-1)

    return sample


def _prefill(net, ids):
    """The prompt ``ids`` [N,T] through ``net`` from fresh carries:
    ``(last step's probabilities [N,V], carries)``."""
    prompt = torch.as_tensor(ids, dtype=net.dtype).to(net.device)
    carries = net.init_carries(prompt.shape[0])
    acts, carries, _ = net._forward_all(net.params, {net.conf.inputs[0]: prompt},
                                        carries=carries)
    return acts[net.conf.outputs[0]][:, -1], carries


def _step(net, tok, carries):
    """One decode step of the sampled ids ``tok`` [N] (in range by
    construction, so the embedding does not read them back):
    ``(probabilities [N,V], carries)``."""
    x = tok[:, None, None].to(net.dtype)
    with unchecked_token_ids():
        acts, carries, _ = net._forward_all(net.params, {net.conf.inputs[0]: x},
                                            carries=carries)
    return acts[net.conf.outputs[0]][:, -1], carries


@contextlib.contextmanager
def _sync_check(on: bool, device):
    """With ``on`` and a CUDA network, the block runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that waits for the
    device raises."""
    if not (on and torch.device(device).type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def generate_on_device(net, prompt_ids, n_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       top_k: int = 0, top_p: float = 0.0, *,
                       check_no_sync: bool = False):
    """Autoregressive sampling with every token kept on the device: one
    prefill fills the KV caches, then one single-token step per token
    samples on the device (greedy argmax, or temperature with ``top_k``
    and ``top_p`` filters, drawn from a ``torch.Generator`` on the
    network's device seeded with ``seed``); the ids are read once, at the
    end. Greedy matches :func:`generate` exactly; sampled draws differ
    from the host loop's numpy draws (the distributions match).
    ``check_no_sync=True`` runs the loop (from the end of the prefill to
    the read) under ``torch.cuda.set_sync_debug_mode("error")``, so any
    call in it that waits for the device raises. Returns
    ``[N, n_new_tokens]`` int64 ids. A graph only: ``TypeError`` for
    other networks."""
    _require_graph(net, "generate_on_device")
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty
    greedy = not (temperature and temperature > 0)
    vocab_n = getattr(net.conf.vertices[net.conf.outputs[0]].obj, "n_out", 0)
    if greedy or top_k < 0 or (vocab_n and top_k >= vocab_n):
        top_k = 0
    if greedy or not (top_p and 0.0 < top_p < 1.0):
        top_p = 0.0
    gen = None
    if not greedy:
        gen = torch.Generator(device=net.device)
        gen.manual_seed(int(seed))
    sample = _sampler(temperature, top_k, top_p, gen)
    with torch.inference_mode():
        p, carries = _prefill(net, ids)
        with _sync_check(check_no_sync, net.device):
            toks = [sample(p)]
            for _ in range(n_new_tokens - 1):
                p, carries = _step(net, toks[-1], carries)
                toks.append(sample(p))
            out = torch.stack(toks, dim=1)
        return out.cpu().numpy().astype(np.int64)


def beam_search(net, prompt_ids, n_new_tokens: int, beam_size: int = 4,
                eos_id: int = None, length_penalty: float = 0.0):
    """Beam search on the device: the beams ride the batch axis (N*beam
    KV caches). One prefill per batch row; its caches are repeated across
    the beams; each step scores beam*vocab continuations, keeps the top
    ``beam_size`` and re-indexes every batch-leading carry leaf (KV caches
    included) by the surviving beams. With ``eos_id``, a finished beam only
    extends with ``eos_id`` at zero cost. ``length_penalty`` > 0 ranks the
    beams on ``score / length**length_penalty`` (GNMT-style; 0 ranks raw
    log-prob sums). Returns ``(tokens [N, n_new_tokens], scores [N])`` of
    each row's best beam. A graph only: ``TypeError`` for other
    networks."""
    _require_graph(net, "beam_search")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0 (got {length_penalty}); 0 disables "
            "normalization, larger values favor longer beams")
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty, np.zeros((ids.shape[0],), np.float32)
    n, b = ids.shape[0], int(beam_size)
    nb = n * b
    use_len = length_penalty > 0
    with torch.inference_mode():
        p, carries = _prefill(net, ids)
        logp = torch.log(p.clamp_min(1e-20)).float()
        v = logp.shape[-1]
        # the prompt's caches, repeated across the beam axis
        carries = {k: map_carry(
            lambda a: a.repeat_interleave(b, dim=0)
            if a.ndim >= 1 and a.shape[0] == n else a, c)
            for k, c in carries.items()}
        # the first selection: b distinct tokens of the prompt's distribution
        scores, tok = torch.topk(logp, b, dim=-1)            # [N, B]
        dev = scores.device
        finished = (tok == eos_id if eos_id is not None
                    else torch.zeros((n, b), dtype=torch.bool, device=dev))
        row = torch.arange(n, device=dev)[:, None] * b
        toks = torch.zeros((n, b, n_new_tokens), dtype=torch.int64, device=dev)
        toks[:, :, 0] = tok
        length = torch.ones((n, b), device=dev) if use_len else None
        if eos_id is not None:
            cont = torch.full((v,), -1e30, device=dev)
            cont[eos_id] = 0.0
        for i in range(1, n_new_tokens):
            p, carries = _step(net, tok.reshape(nb), carries)
            logp = torch.log(p.clamp_min(1e-20)).float().reshape(n, b, v)
            if eos_id is not None:
                logp = torch.where(finished[..., None], cont, logp)
            total = scores[..., None] + logp                  # [N, B, V]
            scores, flat = torch.topk(total.reshape(n, b * v), b, dim=-1)
            beam_idx = torch.div(flat, v, rounding_mode="floor")
            tok = flat % v
            flat_idx = (row + beam_idx).reshape(-1)
            carries = {k: map_carry(
                lambda a: a.index_select(0, flat_idx)
                if a.ndim >= 1 and a.shape[0] == nb else a, c)
                for k, c in carries.items()}
            toks = torch.gather(toks, 1, beam_idx[:, :, None].expand_as(toks))
            finished = torch.gather(finished, 1, beam_idx)
            if use_len:
                length = torch.gather(length, 1, beam_idx)
                length = torch.where(finished, length, length + 1.0)
            toks[:, :, i] = tok
            if eos_id is not None:
                finished = finished | (tok == eos_id)
        if use_len:
            scores = scores / length.clamp_min(1.0) ** length_penalty
        best = scores.argmax(dim=1)
        best_toks = toks[torch.arange(n, device=dev), best]
        best_scores = scores[torch.arange(n, device=dev), best]
        return (best_toks.cpu().numpy().astype(np.int64),
                best_scores.cpu().numpy())


def _require_graph(net, fn_name: str) -> None:
    """The on-device decode paths drive ``ComputationGraph`` internals; any
    other network gets the reference's ``TypeError`` (:func:`generate`
    serves a MultiLayerNetwork)."""
    conf = getattr(net, "conf", None)
    if not (hasattr(conf, "vertices") and hasattr(conf, "inputs")):
        raise TypeError(
            f"{fn_name} requires a ComputationGraph-based network "
            f"(e.g. TransformerLM.build()); got {type(net).__name__}. "
            "Use generate() for MultiLayerNetwork models.")


def _prep_prompt(net, prompt_ids, n_new_tokens: int):
    """The prompt as [N,T] and, for ``n_new_tokens <= 0``, the empty
    answer; refuses a prompt the decode caches cannot hold. Returns
    ``(ids, empty_result_or_None)``."""
    ids = np.asarray(prompt_ids)
    if ids.ndim == 1:
        ids = ids[None]
    if n_new_tokens <= 0:
        return ids, np.zeros((ids.shape[0], 0), np.int64)
    cap = _kv_capacity(net)
    total = ids.shape[1] + n_new_tokens - 1  # the last token is never fed back
    if cap is not None and total > cap:
        raise ValueError(
            f"prompt ({ids.shape[1]}) + {n_new_tokens} new tokens needs "
            f"{total} cache slots but the model holds {cap} "
            f"(max_length/max_cache)")
    return ids, None


def _kv_capacity(net):
    """The smallest stateful-decode capacity of the network's layers (KV
    caches and positional tables), or None when none has one."""
    layer_vertices = getattr(net.conf, "layer_vertices", None)
    layers = ([vd.obj for vd in layer_vertices()] if layer_vertices
              else getattr(net, "layers", []))
    caps = [obj.carry_capacity() for obj in layers
            if isinstance(obj, BaseRecurrentLayer)
            and obj.carry_capacity() is not None]
    return min(caps) if caps else None
