"""Truncated BPTT through ``ComputationGraph`` on the CPU, against the JAX
package, from the same weights.

- Example 11's TBPTT net (``TransformerLM`` with vocab 11, ``max_length``
  32, 1 layer, d_model 16, 2 heads, d_ff 32; ``tbptt_fwd_length`` 8) on
  its +3 successor data with the last label column masked: 3 ``fit``
  calls in both packages, parameters and Adam state within 2e-5 (the step
  tolerance of the other training tests), ``iteration`` equal (one per
  chunk). Also with 27 steps (a ragged last chunk).
- The same net with ``attn_dropout`` 0.1: both packages get the same
  masks from ``tests/torch_putin.py`` (the JAX step draws once at trace
  time; the port replays that draw every chunk), within 1e-5.
- An LSTM graph carries its LSTM state between chunks the same way.
- A sequence longer than the caches is refused before the first chunk,
  with the reference's message, and nothing is updated.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo import TransformerLM, lm_labels

from torch_putin import PutIn

VOCAB = 11
EX11_TBPTT = dict(vocab_size=VOCAB, max_length=32, n_layers=1, d_model=16,
                  n_heads=2, d_ff=32, seed=5)
CHUNK, FITS = 8, 3
STEP_TOL, DROPOUT_TOL = 2e-5, 1e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    thelpers.clear_all_helpers()
    yield
    thelpers.clear_all_helpers()


def _cycle(n, t, seed=0):
    start = np.random.default_rng(seed).integers(0, VOCAB, size=(n, 1))
    return ((start + 3 * np.arange(t)[None, :]) % VOCAB).astype(np.float32)


def _data(n=8, t=32):
    x = _cycle(n, t)
    y = lm_labels(x, VOCAB)
    lmask = np.ones(x.shape[:2], np.float32)
    lmask[:, -1] = 0.0  # the final step has no next token
    return x, y, lmask


def _tbptt(conf):
    conf.backprop_type = "truncated_bptt"  # example 11's way
    conf.tbptt_fwd_length = CHUNK
    return conf


def _pair(**extra):
    kw = dict(EX11_TBPTT, **extra)
    jnet = JaxGraph(_tbptt(jzoo.TransformerLM(**kw).conf())).init()
    tnet = ComputationGraph(_tbptt(TransformerLM(**kw).conf()), device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


def _assert_close(got, want, tol, what):
    for v, named in want.items():
        for n, w in named.items():
            if isinstance(w, dict):
                for s, ws in w.items():
                    np.testing.assert_allclose(got[v][n][s], ws, rtol=tol,
                                               atol=tol, err_msg=f"{what} {v}/{n}/{s}")
            else:
                np.testing.assert_allclose(got[v][n], w, rtol=tol, atol=tol,
                                           err_msg=f"{what} {v}/{n}")


@pytest.mark.parametrize("t", [32, 27])
def test_three_tbptt_fits_match_reference(t):
    jnet, tnet = _pair()
    x, y, lmask = _data(t=t)
    for _ in range(FITS):
        jnet.fit(JDataSet(x, y, labels_mask=lmask))
        tnet.fit(DataSet(x, y, labels_mask=lmask))
    chunks = -(-t // CHUNK)
    assert tnet.iteration == jnet.iteration == FITS * chunks
    assert tnet.last_batch_size == 8
    _assert_close(export_params(tnet), to_np(jnet.params), STEP_TOL, "params")
    _assert_close(export_updater_state(tnet), to_np(jnet.updater_states),
                  STEP_TOL, "updater")
    np.testing.assert_allclose(tnet.score_, float(jnet.score_), rtol=STEP_TOL)


def test_tbptt_with_attention_dropout_matches_reference(monkeypatch):
    jnet, tnet = _pair(attn_dropout=0.1)
    _, clean = _pair()
    putin = PutIn(monkeypatch, seed=11)
    x, y, lmask = _data()
    for _ in range(FITS):
        jnet.fit(JDataSet(x, y, labels_mask=lmask))
        tnet.fit(DataSet(x, y, labels_mask=lmask))
    # one draw at trace time, [N, H, chunk, max_cache]; replayed per chunk
    assert [a.shape for _, a in putin.drawn] == [(8, 2, CHUNK, 32)]
    assert putin.port_calls == FITS * 4
    assert tnet.iteration == jnet.iteration == FITS * 4
    _assert_close(export_params(tnet), to_np(jnet.params), DROPOUT_TOL, "params")
    for _ in range(FITS):
        clean.fit(DataSet(x, y, labels_mask=lmask))
    assert abs(clean.score_ - tnet.score_) > 1e-4  # the masks mattered


def _lstm_conf(b, lstm, out, it, adam):
    return (b.builder().seed(4).updater(adam(0.01)).graph_builder()
            .add_inputs("in").set_input_types(it.recurrent(VOCAB))
            .add_layer("lstm", lstm(n_out=12, activation="tanh"), "in")
            .add_layer("out", out(n_out=VOCAB, activation="softmax",
                                  loss="mcxent"), "lstm")
            .set_outputs("out").t_bptt_length(5).build())


def test_lstm_graph_tbptt_matches_reference():
    jnet = JaxGraph(_lstm_conf(JNNC, JLSTM, JRnnOut, JIT, JAdam)).init()
    tnet = load_reference_params(ComputationGraph(
        _lstm_conf(NeuralNetConfiguration, LSTMLayer, RnnOutputLayer,
                   InputType, Adam), device="cpu").init(), to_np(jnet.params))
    ids = np.random.default_rng(3).integers(0, VOCAB, (4, 13))
    eye = np.eye(VOCAB, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    for _ in range(FITS):
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert tnet.iteration == jnet.iteration == FITS * 3
    _assert_close(export_params(tnet), to_np(jnet.params), STEP_TOL, "params")


def test_overflow_is_refused_before_the_first_chunk():
    jnet, tnet = _pair()
    x, y, lmask = _data(t=40)
    before = export_params(tnet)
    errs = []
    for net, ds in ((jnet, JDataSet(x, y)), (tnet, DataSet(x, y))):
        with pytest.raises(ValueError) as e:
            net.fit(ds)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and errs[1].startswith("TBPTT: sequence length 40")
    assert tnet.iteration == 0
    _assert_close(export_params(tnet), before, 0.0, "params")
