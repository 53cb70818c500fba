"""A network that is not float32 takes the plain path at the automatic
kernel seams, as the JAX package's does off the TPU.

The fused-LSTM kernel takes float32 only, the flash-attention kernels
float32 and bf16 (the TPU kernel's types; bf16 is the mixed-precision
path). With no helper registered, ``dot_product_attention`` sends a
float64 or f16 request to the plain math, never to ``_AUTO_FLASH``, and
a bf16 one to it; ``LSTMLayer.forward_seq`` sends a float64, bf16 or f16
request to the plain math, never to ``_AUTO_LSTM`` (checked with spies
in their place); a helper the caller registers still gets every request
its ``supports`` admits. On the CPU, a float64 char LSTM (``MultiLayerNetwork``) and a
float64 causal T = 128 graph (``ComputationGraph``) give the JAX
package's float64 output (``jax.enable_x64``) within 1e-10 relative:
float64 both ways, only the summation order differs. ``-m cuda`` tests in
``tests/test_torch_cuda.py`` hold the same two networks on the card to
their CPU output.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import CausalSelfAttentionLayer as JCausal
from deeplearning4j_tpu.nn.layers import EmbeddingSequenceLayer as JEmbed
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    CausalSelfAttentionLayer,
    EmbeddingSequenceLayer,
    LSTMLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers import attention, recurrent
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import load_reference_params

F64_RTOL = 1e-10
DTYPES = [torch.float64, torch.bfloat16, torch.float16]
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    helpers.clear_all_helpers()
    yield
    helpers.clear_all_helpers()


class _Spy:
    """Stands in for an automatic helper: admits everything, records what
    reaches it and answers with zeros."""

    def __init__(self):
        self.calls = []

    def supports(self, *args, **kwargs):
        return True

    def attend(self, q, k, v):
        self.calls.append(q.dtype)
        return torch.zeros_like(q)

    def forward_seq(self, layer, params, x, carry):
        self.calls.append(x.dtype)
        n, t = x.shape[:2]
        h = torch.zeros((n, layer.n_out), dtype=x.dtype)
        return torch.zeros((n, t, layer.n_out), dtype=x.dtype), (h, h)


class _FlashSpy(_Spy):
    """Stands in for ``_AUTO_FLASH``: admits what the flash helper admits
    (its ``supports`` holds the dtype gate), records what reaches it and
    answers with zeros."""

    def supports(self, *args, **kwargs):
        return ck.FlashAttentionHelper(causal=True).supports(*args, **kwargs)


def _qkv(dtype, t=128, dh=64):
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, 2, t, dh), generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_auto_flash_declines_other_dtypes(monkeypatch, dtype):
    spy = _FlashSpy()
    monkeypatch.setattr(attention, "_AUTO_FLASH", spy)
    q, k, v = _qkv(dtype)
    before = ck.flash_attention_fwd.launches
    out = attention.dot_product_attention(q, k, v, causal=True)
    if dtype == torch.bfloat16:
        # the flash kernels have a bf16 half (mixed precision): taken
        assert spy.calls == [dtype] and out.abs().sum() == 0
        return
    assert spy.calls == [] and ck.flash_attention_fwd.launches == before
    assert out.dtype == dtype and out.abs().sum() > 0
    ref = ck.flash_attention_plain(*(t.double() for t in (q, k, v)), True)
    tol = 1e-12 if dtype == torch.float64 else 5e-2
    torch.testing.assert_close(out.double(), ref, rtol=0, atol=tol)
    attention.dot_product_attention(*_qkv(torch.float32), causal=True)
    assert spy.calls == [torch.float32]  # the positive control


def test_a_registered_attention_helper_still_gets_float64():
    spy = _Spy()
    helpers.set_helper("attention", spy)
    attention.dot_product_attention(*_qkv(torch.float64), causal=True)
    assert spy.calls == [torch.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_auto_lstm_declines_other_dtypes(monkeypatch, dtype):
    spy = _Spy()
    monkeypatch.setattr(recurrent, "_AUTO_LSTM", spy)
    layer = LSTMLayer(n_in=3, n_out=4, activation="tanh")
    gen = torch.Generator().manual_seed(1)
    params = layer.init_params(gen, dtype)
    x = torch.randn((2, 5, 3), generator=gen).to(dtype)
    before = ck.lstm_sequence.launches
    ys, _ = layer.forward_seq(params, x)
    if dtype == torch.bfloat16:  # K1-bf16 takes it, as the reference's kernel does
        assert spy.calls == [torch.bfloat16]
    else:
        assert spy.calls == [] and ck.lstm_sequence.launches == before
        assert ys.dtype == dtype and ys.abs().sum() > 0
    layer.forward_seq(layer.init_params(gen, torch.float32), x.float())
    assert spy.calls[-1:] == [torch.float32]  # the positive control


def test_fused_lstm_helper_declines_a_float64_layer():
    layer = LSTMLayer(n_in=3, n_out=4, activation="tanh")
    assert ck.FusedLSTMHelper().supports(layer, None)
    layer.dtype = "float64"
    assert not ck.FusedLSTMHelper().supports(layer, None)


def _char_lstm(pkg):
    b, lstm, out, it = ((JNNC.builder(), JLSTM, JRnnOut, JIT) if pkg == "jax" else
                        (NeuralNetConfiguration.builder(), LSTMLayer,
                         RnnOutputLayer, InputType))
    return (b.seed(7).dtype("float64").list()
            .layer(lstm(n_out=16, activation="tanh"))
            .layer(lstm(n_out=16, activation="tanh"))
            .layer(out(n_out=12, activation="softmax", loss="mcxent"))
            .set_input_type(it.recurrent(12)).build())


def _causal_graph(pkg):
    b, emb, att, out, it = (
        (JNNC.builder(), JEmbed, JCausal, JRnnOut, JIT) if pkg == "jax" else
        (NeuralNetConfiguration.builder(), EmbeddingSequenceLayer,
         CausalSelfAttentionLayer, RnnOutputLayer, InputType))
    g = (b.seed(8).dtype("float64").graph_builder().add_inputs("tokens")
         .set_input_types(it.recurrent(1, 128)))
    g.add_layer("embed", emb(n_in=20, n_out=128), "tokens")
    g.add_layer("att", att(n_in=128, n_out=128, n_heads=2, head_size=64,
                           max_cache=128), "embed")
    g.add_layer("out", out(n_in=128, n_out=20), "att")
    g.set_outputs("out")
    return g.build()


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_float64_networks_match_the_reference():
    """float64 through both automatic seams, against the JAX package."""
    rng = np.random.default_rng(9)
    chars = np.eye(12)[rng.integers(0, 12, (3, 40))]
    tokens = rng.integers(0, 20, (2, 128)).astype(np.float64)
    with jax.enable_x64(True):
        jlstm = JaxMLN(_char_lstm("jax")).init()
        jgraph = JaxGraph(_causal_graph("jax")).init()
        ref_lstm = np.asarray(jlstm.output(chars))
        ref_graph = np.asarray(jgraph.output(tokens))
        lstm_params, graph_params = to_np(jlstm.params), to_np(jgraph.params)
    assert ref_lstm.dtype == ref_graph.dtype == np.float64
    lstm = load_reference_params(
        MultiLayerNetwork(_char_lstm("port"), device="cpu").init(), lstm_params)
    graph = load_reference_params(
        ComputationGraph(_causal_graph("port"), device="cpu").init(), graph_params)
    got_lstm, got_graph = lstm.output(chars), graph.output(tokens)
    assert got_lstm.dtype == got_graph.dtype == torch.float64
    rel_lstm, rel_graph = _rel(got_lstm.numpy(), ref_lstm), _rel(got_graph.numpy(), ref_graph)
    print(f"float64 relative difference: char LSTM {rel_lstm:.2g}, "
          f"causal graph {rel_graph:.2g}")  # shown with -s
    assert rel_lstm <= F64_RTOL and rel_graph <= F64_RTOL
