"""Regularized training through the port against the JAX package, twin
nets on the CPU from the same weights and the same put-in draws
(``tests/torch_putin.py``), over 3 Adam steps with and without
``FusedUpdaterHelper``:

- example 17's regularization family (Dense 32 selu with AlphaDropout
  0.9, MaxNorm 2.0 on weights, NonNegative on biases, DropConnect 0.95 on
  every layer, Adam 5e-3);
- a narrow LeNet with constraints (MaxNorm on weights, NonNegative on
  biases, UnitNorm on the dense layer's weights), SpatialDropout on the
  second convolution's input, Dropout on the dense input, in each of the
  five gradient-normalization modes;
- a 2-layer narrow causal ``TransformerLM`` with ``attn_dropout`` 0.1:
  one train-mode loss and its gradients, then 3 fit steps.

Tolerances: params, Adam moments and scores after the steps 2e-5 (the
twin-net tolerance of tests/test_torch_lenet.py and
tests/test_torch_training.py); the transformer's train-mode loss 1e-6
relative and each gradient within 1e-5 of its tensor's largest entry.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import constraints as JC
from deeplearning4j_tpu.nn import dropout as JD
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn import weightnoise as JW
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.zoo.models import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import constraints as PC
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import dropout as PD
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn import weightnoise as PW
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.train_step import gradients
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo.models import TransformerLM as TorchLM
from deeplearning4j_tpu_torch.zoo.models import lm_labels
from torch_putin import PutIn

STEP_TOL = 2e-5
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
NORM_MODES = ["renormalize_l2_per_layer", "renormalize_l2_per_param_type",
              "clip_elementwise_absolute_value", "clip_l2_per_layer",
              "clip_l2_per_param_type"]
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _assert_tree(got, want, tol, what):
    if isinstance(want, dict):
        keys = list(want)
    else:
        keys = range(len(want))
    for k in keys:
        for n in want[k]:
            if isinstance(want[k][n], dict):
                for s in want[k][n]:
                    np.testing.assert_allclose(got[k][n][s], want[k][n][s],
                                               rtol=tol, atol=tol,
                                               err_msg=f"{what} {k}/{n}/{s}")
            else:
                np.testing.assert_allclose(got[k][n], want[k][n], rtol=tol,
                                           atol=tol, err_msg=f"{what} {k}/{n}")


def _three_steps(jnet, tnet, x, y, fused, batch):
    """One epoch of a shuffling iterator (2 steps of ``batch``), then one
    ``fit(x, y)`` of the first ``batch`` examples, on both nets."""
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    jnet.fit(JIter(JDataSet(x, y), batch, shuffle=True, seed=3))
    tnet.fit(ListDataSetIterator(DataSet(x, y), batch, shuffle=True, seed=3))
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    jnet.fit(x[:batch], y[:batch])
    tnet.fit(x[:batch], y[:batch])
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    assert tnet.iteration == jnet.iteration == 3
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states),
                 STEP_TOL, "state")


# ------------------------------------------------- example 17's family
def _family_conf(pkg):
    j = pkg == "jax"
    b, dense, out, it, adam = ((JNNC.builder(), JDense, JOut, JIT, JU.Adam) if j else
                               (NeuralNetConfiguration.builder(), DenseLayer,
                                OutputLayer, InputType, PU.Adam))
    C, D, W = (JC, JD, JW) if j else (PC, PD, PW)
    return (b.seed(1).updater(adam(5e-3))
            .constrain_weights(C.MaxNormConstraint(max_norm=2.0))
            .constrain_bias(C.NonNegativeConstraint())
            .weight_noise(W.DropConnect(p=0.95))
            .list()
            .layer(dense(n_out=32, activation="selu", dropout=D.AlphaDropout(p=0.9)))
            .layer(out(n_out=3))
            .set_input_type(it.feed_forward(10)).build())


def _family_data(n=32):
    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, n)
    x = rng.normal(0, 0.3, size=(n, 10)).astype(np.float32)
    x[np.arange(n), cls] += 2.0
    return x, np.eye(3, dtype=np.float32)[cls]


def test_family_conf_json_reads_both_ways():
    jc, tc = _family_conf("jax"), _family_conf("port")
    assert tc.to_dict() == jc.to_dict()
    assert MultiLayerConfiguration.from_json(jc.to_json()).to_dict() == jc.to_dict()
    assert type(jc).from_json(tc.to_json()).to_dict() == jc.to_dict()
    assert [type(c).__name__ for c in tc.layers[0].constraints] == \
        ["MaxNormConstraint", "NonNegativeConstraint"]


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_family_three_steps_match_reference(monkeypatch, fused):
    jnet = JaxMLN(_family_conf("jax")).init()
    tnet = load_reference_params(
        MultiLayerNetwork(_family_conf("port"), device="cpu").init(),
        to_np(jnet.params))
    putin = PutIn(monkeypatch, seed=1)
    x, y = _family_data()
    _three_steps(jnet, tnet, x, y, fused, batch=16)
    # the JAX step drew once at trace time: W0 mask, dropout mask, W1 mask
    assert [k for k, _ in putin.drawn] == ["bernoulli"] * 3
    assert [a.shape for _, a in putin.drawn] == [(10, 32), (16, 10), (32, 3)]
    assert putin.port_calls == 3 * len(putin.drawn)
    w = tnet.params[0]["W"]
    assert torch.sqrt((w * w).sum(0)).max() <= 2.0 + 1e-5
    assert tnet.params[0]["b"].min() >= 0 and tnet.params[1]["b"].min() >= 0


# ------------------------------------------------------- narrow LeNet
def _lenet_conf(pkg, mode):
    j = pkg == "jax"
    b, conv, pool, dense, out, it, adam = (
        (JNNC.builder(), JConv, JPool, JDense, JOut, JIT, JU.Adam) if j else
        (NeuralNetConfiguration.builder(), ConvolutionLayer, SubsamplingLayer,
         DenseLayer, OutputLayer, InputType, PU.Adam))
    C, D = (JC, JD) if j else (PC, PD)
    return (b.seed(42).updater(adam(1e-2))
            .constrain_weights(C.MaxNormConstraint(max_norm=0.5))
            .constrain_bias(C.NonNegativeConstraint())
            .gradient_normalization(mode, 0.05)
            .list()
            .layer(conv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(pool(kernel_size=(2, 2), stride=(2, 2), pooling_type="max"))
            .layer(conv(n_out=8, kernel_size=(3, 3), activation="relu",
                        dropout=D.SpatialDropout(0.7)))
            .layer(pool(kernel_size=(2, 2), stride=(2, 2), pooling_type="max",
                        convolution_mode="same"))
            .layer(dense(n_out=16, activation="relu", dropout=0.6,
                         constraints=[C.UnitNormConstraint(scope="weights")]))
            .layer(out(n_out=5, activation="softmax",
                       loss="negativeloglikelihood"))
            .set_input_type(it.convolutional(12, 12, 1)).build())


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
@pytest.mark.parametrize("mode", NORM_MODES)
def test_lenet_constraints_and_gradient_normalization_match_reference(
        monkeypatch, mode, fused):
    jc, tc = _lenet_conf("jax", mode), _lenet_conf("port", mode)
    assert tc.to_dict() == jc.to_dict()
    jnet = JaxMLN(jc).init()
    tnet = load_reference_params(MultiLayerNetwork(tc, device="cpu").init(),
                                 to_np(jnet.params))
    putin = PutIn(monkeypatch, seed=2)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.5, size=(16, 12, 12, 1)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    _three_steps(jnet, tnet, x, y, fused, batch=8)
    # SpatialDropout's mask covers [N, 1, 1, C] of the NHWC input
    assert [a.shape for _, a in putin.drawn] == [(8, 1, 1, 4), (8, 32)]
    w = tnet.params[4]["W"]
    np.testing.assert_allclose(torch.sqrt((w * w).sum(0)).numpy(), 1.0, atol=1e-4)
    w0 = tnet.params[0]["W"]  # HWIO: the norm over H, W and I
    assert (torch.sqrt((w0 * w0).sum((0, 1, 2))) <= 0.5 + 1e-6).all()


# ------------------------------------------- TransformerLM, attn dropout
SMALL = dict(vocab_size=50, max_length=128, n_layers=2, d_model=32,
             n_heads=2, d_ff=64, seed=1, attn_dropout=0.1)
T = 128


def _lm_pair():
    jnet = JaxGraph(JaxLM(**SMALL).conf()).init()
    tnet = load_reference_params(TorchLM(**SMALL).init(device="cpu"),
                                 to_np(jnet.params))
    rng = np.random.default_rng(7)
    ids = rng.integers(0, SMALL["vocab_size"], (2, T)).astype(np.float32)
    return jnet, tnet, ids, lm_labels(ids, SMALL["vocab_size"])


def test_transformer_attention_dropout_loss_and_gradients_match_reference(
        monkeypatch):
    jnet, tnet, ids, labels = _lm_pair()
    putin = PutIn(monkeypatch, seed=3)
    rng = jax.random.PRNGKey(0)

    def jloss(p):
        return jnet._loss_fn(p, jnet.states, {"tokens": jnp_ids}, [labels],
                             rng, None, None, train=True)[0]

    jnp_ids = jax.numpy.asarray(ids)
    loss_j, grads_j = jax.value_and_grad(jloss)(jnet.params)
    assert [a.shape for _, a in putin.drawn] == [(2, 2, T, T)] * 2
    inputs = {"tokens": torch.from_numpy(ids)}
    loss_t, grads_t, _ = gradients(
        lambda live: (tnet._loss_fn(live, inputs, [torch.from_numpy(labels)],
                                    None, None, train=True,
                                    gen=tnet.dropout_generator), None),
        tnet.params)
    assert putin.port_calls == 2
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)
    with torch.no_grad():  # the dropped weights moved the loss
        clean = tnet._loss_fn(tnet.params, inputs, [torch.from_numpy(labels)],
                              None, None)
    assert abs(float(clean) - float(loss_t)) > 1e-4
    for v, named in to_np(grads_j).items():
        for n, want in named.items():
            np.testing.assert_allclose(grads_t[v][n].numpy(), want, rtol=0,
                                       atol=GRAD_TOL * np.abs(want).max(),
                                       err_msg=f"{v}/{n}")


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_transformer_attention_dropout_three_steps_match_reference(
        monkeypatch, fused):
    jnet, tnet, ids, labels = _lm_pair()
    putin = PutIn(monkeypatch, seed=4)
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    for _ in range(3):
        jnet.fit(ids, labels)
        tnet.fit(ids, labels)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert putin.port_calls == 3 * len(putin.drawn) == 6
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states),
                 STEP_TOL, "state")
