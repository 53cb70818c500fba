"""LeNet through the port's MultiLayerNetwork on the CPU against the JAX
package's: the configuration DSL, ``output``, ``feed_forward``, 3 Adam
``fit`` steps from a ``ListDataSetIterator`` (with and without
``FusedUpdaterHelper``, whose kernel's plain version runs on CPU
tensors), ``evaluate``, the zoo's ``LeNet.conf()`` and the verify skill's
flow (builder, ``init``, ``fit``, ``evaluate``, ``save``/``load``).

The narrowed LeNet: 12x12x1 images, conv 3x3 of 4, max pool 2x2, conv 3x3
of 8, max pool 2x2 in "same" mode (3x3 -> 2x2), dense 32, 10 classes,
batch 16; weights copied from the JAX net with ``util/convert.py``. The
dense layer flattens 2x2x8 activations, and every image differs from its
transpose (image 0 is a ramp along the rows only), so a flatten in C, H, W
order fails.

Tolerances: outputs and activations rtol 2e-5 / atol 2e-6, params, Adam
moments and scores after the fit steps 2e-5: those of the JAX package's
helper tests (``tests/test_helpers.py:79,307``). ``evaluate``'s accuracy,
F1 and confusion matrix must be equal.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.eval.evaluation import Evaluation as JEvaluation
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.zoo.models import LeNet as JLeNet
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo.models import LeNet

SIDE, N, CLASSES = 12, 16, 10
RTOL, ATOL, STEP_TOL = 2e-5, 2e-6, 2e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _lenet_conf(pkg):
    """The narrowed LeNet in the JAX package (``pkg == "jax"``) or the port."""
    jax_side = pkg == "jax"
    b, conv, pool, dense, out, it, adam = (
        (JNNC.builder(), JConv, JPool, JDense, JOut, JIT, JU.Adam) if jax_side else
        (NeuralNetConfiguration.builder(), ConvolutionLayer, SubsamplingLayer,
         DenseLayer, OutputLayer, InputType, PU.Adam))
    return (b.seed(42).updater(adam(1e-3)).list()
            .layer(conv(n_out=4, kernel_size=(3, 3), activation="relu"))
            .layer(pool(kernel_size=(2, 2), stride=(2, 2), pooling_type="max"))
            .layer(conv(n_out=8, kernel_size=(3, 3), activation="relu"))
            .layer(pool(kernel_size=(2, 2), stride=(2, 2), pooling_type="max",
                        convolution_mode="same"))
            .layer(dense(n_out=32, activation="relu"))
            .layer(out(n_out=CLASSES, activation="softmax",
                       loss="negativeloglikelihood"))
            .set_input_type(it.convolutional(SIDE, SIDE, 1)).build())


def _pair():
    jnet = JaxMLN(_lenet_conf("jax")).init()
    tnet = MultiLayerNetwork(_lenet_conf("port"), device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


def _images(seed=0, n=N):
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, CLASSES, n)
    x = rng.normal(0, 0.3, size=(n, SIDE, SIDE, 1)).astype(np.float32)
    x[0, :, :, 0] = np.linspace(-1.0, 1.0, SIDE)[:, None]  # rows differ, columns do not
    for i in range(n):
        x[i, 1 + y_idx[i] % (SIDE - 2), :, 0] += 2.0
    assert not np.allclose(x[0], x[0].transpose(1, 0, 2))
    return x, np.eye(CLASSES, dtype=np.float32)[y_idx]


def _assert_tree(got, want, tol, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"{what} layer {i}"
        for n in w:
            if isinstance(w[n], dict):
                for s in w[n]:
                    np.testing.assert_allclose(g[n][s], w[n][s], rtol=tol, atol=tol,
                                               err_msg=f"{what} {i}/{n}/{s}")
            else:
                np.testing.assert_allclose(g[n], w[n], rtol=tol, atol=tol,
                                           err_msg=f"{what} {i}/{n}")


def test_conf_matches_reference():
    """Same shapes, preprocessors and JSON; the JSON reads back both ways."""
    jc, tc = _lenet_conf("jax"), _lenet_conf("port")
    assert [l.n_in for l in tc.layers if hasattr(l, "n_in")] == \
        [l.n_in for l in jc.layers if hasattr(l, "n_in")] == [1, 4, 32, 32]
    assert sorted(tc.preprocessors) == sorted(jc.preprocessors) == [4]
    assert tc.num_params() == jc.num_params()
    assert tc.to_dict() == jc.to_dict()
    assert MultiLayerConfiguration.from_json(jc.to_json()).to_dict() == jc.to_dict()
    assert type(jc).from_json(tc.to_json()).to_dict() == jc.to_dict()


def test_output_and_feed_forward_match_reference():
    jnet, tnet = _pair()
    x, _ = _images(1)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=RTOL, atol=ATOL)
    got, want = tnet.feed_forward(x), jnet.feed_forward(x)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"activation {i}")
    mid = tnet.feed_forward_to_layer(2, x)
    assert len(mid) == 4 and mid[-1].shape == (N, 3, 3, 8)
    np.testing.assert_array_equal(tnet.predict(x), np.asarray(jnet.predict(x)))
    np.testing.assert_allclose(tnet.label_probabilities(x).numpy(),
                               jnet.label_probabilities(x), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="out of range"):
        tnet.feed_forward_to_layer(6, x)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_three_adam_fit_steps_match_reference(fused):
    """3 Adam steps: one epoch of a shuffling ListDataSetIterator (16
    images, batch 8: 2 steps), then one more ``fit(x, y)``: params,
    moments, scores."""
    jnet, tnet = _pair()
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    x, y = _images(2)
    jit_ = JIter(JDataSet(x, y), 8, shuffle=True, seed=3)
    tit = ListDataSetIterator(DataSet(x, y), 8, shuffle=True, seed=3)
    jnet.fit(jit_)
    tnet.fit(tit)
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    jnet.fit(x[:8], y[:8])
    tnet.fit(x[:8], y[:8])
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (3, 2)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states), STEP_TOL,
                 "state")


def test_evaluate_matches_reference_exactly():
    jnet, tnet = _pair()
    x, y = _images(4, n=40)
    jnet.fit(x, y)
    tnet.fit(x, y)
    je = jnet.evaluate(JIter(JDataSet(x, y), 16))
    te = tnet.evaluate(ListDataSetIterator(DataSet(x, y), 16))
    assert te.accuracy() == je.accuracy()
    assert te.f1() == je.f1()
    assert te.precision() == je.precision() and te.recall() == je.recall()
    assert te.f_beta(0.5) == je.f_beta(0.5)
    np.testing.assert_array_equal(te.confusion_matrix(), je.confusion_matrix())
    assert te.stats() == je.stats()
    top3_t, top3_j = (tnet.evaluate(ListDataSetIterator(DataSet(x, y), 16), top_n=3),
                      jnet.evaluate(JIter(JDataSet(x, y), 16), top_n=3))
    assert top3_t.top_n_accuracy() == top3_j.top_n_accuracy()
    assert tnet.f1_score(x, y) == jnet.f1_score(x, y)


def test_evaluation_records_masks_and_micro_averages_as_the_reference():
    """The port's ``Evaluation`` on one set of arrays beside the JAX
    package's: recorded prediction errors, a masked [N,T,C] sequence and
    the micro-averaged F-beta."""
    rng = np.random.default_rng(6)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (6, 5))]
    preds = rng.random((6, 5, 4)).astype(np.float32)
    mask = (rng.random((6, 5)) > 0.3).astype(np.float32)
    meta = [f"record {i}" for i in range(6)]
    mine, ref = Evaluation(top_n=2), JEvaluation(top_n=2)
    for e in (mine, ref):
        e.eval(labels, preds, mask=mask, record_meta_data=meta)
        e.eval(labels[:, 0], preds[:, 0])
    np.testing.assert_array_equal(mine.confusion_matrix(), ref.confusion_matrix())
    assert [(p.actual, p.predicted, p.get_record_meta_data())
            for p in mine.get_prediction_errors()] == \
        [(p.actual, p.predicted, p.get_record_meta_data())
         for p in ref.get_prediction_errors()]
    assert mine.f_beta(2.0, averaging="micro") == ref.f_beta(2.0, averaging="micro")
    assert mine.f_beta(2.0, cls=1) == ref.f_beta(2.0, cls=1)
    assert mine.top_n_accuracy() == ref.top_n_accuracy()
    assert mine.stats() == ref.stats()
    with pytest.raises(ValueError, match="No evaluation data"):
        Evaluation().accuracy()


def test_parameter_accessors():
    jnet, tnet = _pair()
    assert sorted(tnet.param_table()) == sorted(jnet.param_table())
    assert tnet.num_labels() == jnet.num_labels() == CLASSES
    w = np.full((3, 3, 1, 4), 0.5, np.float32)
    before = tnet.get_param("0_W")
    tnet.set_param("0_W", w)
    assert tnet.get_param("0_W") is before  # written in place
    np.testing.assert_array_equal(before.numpy(), w)
    with pytest.raises(ValueError, match="shape mismatch"):
        tnet.set_param("0_W", np.zeros((3, 3, 1, 5), np.float32))


def test_zoo_lenet_matches_reference():
    """The zoo's LeNet: "same" 5x5 convolutions, AdaDelta, 28x28x1."""
    jconf, tconf = JLeNet().conf(), LeNet().conf()
    assert tconf.to_dict() == jconf.to_dict()
    jnet = JaxMLN(jconf).init()
    tnet = load_reference_params(LeNet().init(device="cpu"), to_np(jnet.params))
    x = np.random.default_rng(5).standard_normal((3, 28, 28, 1)).astype(np.float32)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=RTOL, atol=ATOL)
    y = np.eye(10, dtype=np.float32)[[1, 4, 7]]
    jnet.fit(x, y)
    tnet.fit(x, y)
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")


def test_verify_skill_flow(tmp_path):
    """The verify skill's LeNet flow through the port's entry points: its
    data (seeded 28x28x1 images with a planted row signal), builder,
    ``init``, 5 epochs of ``fit(ListDataSetIterator)``, ``evaluate``
    (accuracy >= 0.95), then ``save`` and ``MultiLayerNetwork.load``."""
    rng = np.random.default_rng(0)
    n = 1024
    y_idx = rng.integers(0, 10, n)
    x = rng.normal(0, 0.3, size=(n, 28, 28, 1)).astype(np.float32)
    for i in range(n):
        x[i, 2 + y_idx[i], :, 0] += 2.0
    y = np.eye(10, dtype=np.float32)[y_idx]
    conf = (NeuralNetConfiguration.builder().seed(1).updater(PU.Adam(1e-3)).list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), activation="relu"))
            .layer(SubsamplingLayer())
            .layer(DenseLayer(n_out=100, activation="relu"))
            .layer(OutputLayer(n_out=10))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())
    m = MultiLayerNetwork(conf, device="cpu").init()
    m.fit(ListDataSetIterator(DataSet(x, y), 128, shuffle=True), epochs=5)
    ev = m.evaluate(ListDataSetIterator(DataSet(x, y), 256))
    assert ev.accuracy() >= 0.95, ev.stats()
    path = tmp_path / "lenet.zip"
    m.save(path)
    back = MultiLayerNetwork.load(path, device="cpu")
    assert (back.iteration, back.epoch) == (m.iteration, m.epoch) == (40, 5)
    np.testing.assert_array_equal(back.output(x[:64]).numpy(), m.output(x[:64]).numpy())
