"""The training slice on the CPU: the port's ComputationGraph trains the
small TransformerLM of test_torch_transformer_lm.py from the JAX
package's weights, against the JAX package doing the same.

On CPU tensors the attention takes the flash seam's plain versions (the
forward with LSE, then the dq and dk/dv backward math) and the fused
updater helper its plain version, so the whole kernel path's arithmetic
is held against the reference here; tests/test_torch_cuda.py holds the
kernels against that arithmetic on the card.

Tolerances: the loss rtol 1e-6 and each gradient within 1e-5 of its
tensor's largest entry (float32 on the CPU, XLA's and ATen's summation
orders differ; measured 6e-7); after Adam steps params, moments and
scores within 2e-5, the twin-net tolerance of the JAX package's own
fused-updater tests (tests/test_helpers.py:307).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.datasets.dataset import batch_nbytes as j_nbytes
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.zoo.models import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    MultiDataSet,
    batch_nbytes,
)
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
    load_reference_updater_state,
)
from deeplearning4j_tpu_torch.zoo.models import TransformerLM as TorchLM
from deeplearning4j_tpu_torch.zoo.models import lm_labels

SMALL = dict(vocab_size=100, max_length=256, n_layers=2, d_model=128,
             n_heads=2, d_ff=256, seed=1)
T = 128  # a multiple of 128: the causal layers take the flash seam
STEP_TOL = 2e-5


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_flash_attention(True)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, SMALL["vocab_size"], (2, T)).astype(np.float32)
    return ids, lm_labels(ids, SMALL["vocab_size"])


@pytest.fixture(scope="module")
def reference(batch):
    """The JAX net's initial params, its gradient and score on the batch,
    and its params / Adam state / scores after 3 and after 4 fit steps."""
    jhelpers.clear_all_helpers()
    ids, labels = batch
    jnet = JaxGraph(JaxLM(**SMALL).conf()).init()
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    out = {"params0": to_np(jnet.params)}
    out["grads"], out["loss"] = jnet.compute_gradient_and_score(ids, labels)
    out["grads"] = to_np(out["grads"])
    scores = []
    for step in range(4):
        jnet.fit(ids, labels)
        scores.append(jnet.score_)
        if step == 2:
            out["params3"], out["state3"] = to_np(jnet.params), to_np(jnet.updater_states)
    out["params4"], out["state4"], out["scores"] = (
        to_np(jnet.params), to_np(jnet.updater_states), scores)
    return out


def _port_net(params):
    return load_reference_params(TorchLM(**SMALL).init(device="cpu"), params)


def _assert_tree(got, want, tol, what):
    for v in want:
        for n in want[v]:
            if isinstance(want[v][n], dict):
                for s in want[v][n]:
                    np.testing.assert_allclose(got[v][n][s], want[v][n][s],
                                               rtol=tol, atol=tol,
                                               err_msg=f"{what} {v}/{n}/{s}")
            else:
                np.testing.assert_allclose(got[v][n], want[v][n], rtol=tol,
                                           atol=tol, err_msg=f"{what} {v}/{n}")


def test_gradient_and_score_match_reference(reference, batch):
    tnet = _port_net(reference["params0"])
    grads, loss = tnet.compute_gradient_and_score(*batch)
    np.testing.assert_allclose(loss, reference["loss"], rtol=1e-6)
    assert set(grads) == set(reference["grads"])
    for v, named in reference["grads"].items():
        assert set(grads[v]) == set(named)
        for n, want in named.items():
            np.testing.assert_allclose(grads[v][n].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{v}/{n}")
    assert tnet.iteration == 0  # no update


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_three_adam_fit_steps_match_reference(reference, batch, fused):
    tnet = _port_net(reference["params0"])
    assert isinstance(tnet._updaters["out"]["W"], PU.Adam)
    assert tnet._updaters["out"]["W"].learning_rate == 3e-4
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    for step in range(3):
        tnet.fit(*batch)
        np.testing.assert_allclose(tnet.score_, reference["scores"][step],
                                   rtol=STEP_TOL, atol=STEP_TOL)
    assert (tnet.iteration, tnet.epoch, tnet.last_batch_size) == (3, 3, 2)
    _assert_tree(export_params(tnet), reference["params3"], STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), reference["state3"], STEP_TOL,
                 "state")


def test_resume_from_the_reference_optimizer_state(reference, batch):
    """The 4th step from the reference's params AND Adam moments after 3
    (bias correction at t = 4) lands on the reference's 4th step."""
    tnet = _port_net(reference["params3"])
    load_reference_updater_state(tnet, reference["state3"])
    tnet.iteration = 3
    thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    tnet.fit(*batch)
    np.testing.assert_allclose(tnet.score_, reference["scores"][3],
                               rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree(export_params(tnet), reference["params4"], STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), reference["state4"], STEP_TOL,
                 "state")


def test_updater_state_load_rejects_mismatches(reference):
    tnet = _port_net(reference["params0"])
    bad = {v: {n: dict(s) for n, s in d.items()}
           for v, d in reference["state3"].items()}
    del bad["out"]["W"]["v"]
    with pytest.raises(ValueError, match="missing out/W/v"):
        load_reference_updater_state(tnet, bad)
    bad = {v: d for v, d in reference["state3"].items() if v != "ln_f"}
    with pytest.raises(ValueError, match="missing vertex 'ln_f'"):
        load_reference_updater_state(tnet, bad)
    assert all(float(t.abs().sum()) == 0.0 for d in tnet.updater_states.values()
               for s in d.values() for t in s.values())  # nothing was copied


def test_fit_iterator_with_label_masks_matches_reference(reference):
    """Two epochs over a ListDataSetIterator of masked batches (labels
    masks per timestep, one row fully masked) on both sides."""
    rng = np.random.default_rng(8)
    ids = rng.integers(0, SMALL["vocab_size"], (4, T)).astype(np.float32)
    labels = lm_labels(ids, SMALL["vocab_size"])
    mask = (rng.uniform(size=(4, T)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    jhelpers.clear_all_helpers()
    jnet = JaxGraph(JaxLM(**SMALL).conf()).init()
    jnet.fit(JIter(JDataSet(ids, labels, labels_mask=mask), 2, shuffle=True,
                   seed=3), epochs=2)
    tnet = _port_net(reference["params0"])
    thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    tnet.fit(ListDataSetIterator(DataSet(ids, labels, labels_mask=mask), 2,
                                 shuffle=True, seed=3), epochs=2)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (4, 2)
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL,
                               atol=STEP_TOL)
    _assert_tree(export_params(tnet),
                 jax.tree_util.tree_map(np.asarray, jnet.params), STEP_TOL,
                 "param")
    assert tnet.transfer_bytes == jnet.transfer_bytes


def test_score_of_a_dataset_matches_reference(reference, batch):
    jnet = JaxGraph(JaxLM(**SMALL).conf()).init()
    tnet = _port_net(reference["params0"])
    ds_j, ds_t = JDataSet(*batch), DataSet(*batch)
    np.testing.assert_allclose(tnet.score(ds_t), jnet.score(ds_j), rtol=1e-6)
    assert np.isnan(tnet.score()) and tnet.iteration == 0


def test_fit_faces_are_one_step(reference, batch):
    """fit(x, y), fit(DataSet), fit(MultiDataSet) and fit([DataSet]) take
    the same step (to 1e-6: the CPU's embedding-gradient scatter-add may
    sum in another order from run to run)."""
    ids, labels = batch
    outs = []
    for data in ((ids, labels), (DataSet(ids, labels),),
                 (MultiDataSet([ids], [labels]),), ([DataSet(ids, labels)],)):
        tnet = _port_net(reference["params0"])
        tnet.fit(*data)
        outs.append(export_params(tnet))
    for other in outs[1:]:
        _assert_tree(other, outs[0], 1e-6, "param")


def test_training_leaves_the_serving_path_without_autograd(reference, batch):
    tnet = _port_net(reference["params0"])
    tnet.fit(*batch)
    assert not any(p.requires_grad for p in tnet.parameters())
    out = tnet.output(batch[0])
    assert not out.requires_grad and out.is_inference()
    assert all(isinstance(p, torch.nn.Parameter) for p in tnet.parameters())


def test_attention_dropout_refuses_to_train(batch):
    """The flash seam refuses a dropout-active request: ``fit`` with
    attention dropout trains on the plain math (the flash helper is never
    asked to attend), while the gradient hook and inference, which draw no
    dropout, take the flash path."""
    attended = []

    class Spy(ck.FlashAttentionHelper):
        def attend(self, q, k, v):
            attended.append(tuple(q.shape))
            return super().attend(q, k, v)

    net = TorchLM(**dict(SMALL, attn_dropout=0.1)).init(device="cpu")
    thelpers.set_helper("attention", Spy(causal=True))
    try:
        net.fit(*batch)
        assert attended == [] and np.isfinite(net.score_)
        grads, loss = net.compute_gradient_and_score(*batch)  # no dropout here
        assert np.isfinite(loss) and "embed" in grads
        assert len(attended) == SMALL["n_layers"]
        net.output(batch[0])
        assert len(attended) == 2 * SMALL["n_layers"]
    finally:
        thelpers.clear_helper("attention")


def test_updater_seam_consulted_per_tensor(reference, batch):
    calls = []

    class Spy(ck.FusedUpdaterHelper):
        def apply(self, updater, param, grad, state, lr, t):
            calls.append((tuple(param.shape), t))
            return super().apply(updater, param, grad, state, lr, t)

    tnet = _port_net(reference["params0"])
    thelpers.set_helper("updater", Spy())
    tnet.fit(*batch)
    n_tensors = sum(len(d) for d in tnet.params.values())
    assert len(calls) == n_tensors == 30 and {t for _, t in calls} == {1.0}
    thelpers.clear_helper("updater")
    calls.clear()
    tnet.fit(*batch)
    assert not calls


def _tiny_confs(jb, tb):
    """A two-layer classifier in both packages, with a network updater, a
    network bias updater and one layer's own updater."""
    jg = (jb.graph_builder().add_inputs("in")
          .set_input_types(JIT.feed_forward(6)))
    jg.add_layer("h", JDense(n_out=5, updater=JU.RmsProp(0.01)), "in")
    jg.add_layer("out", JOut(n_out=3), "h")
    tg = (tb.graph_builder().add_inputs("in")
          .set_input_types(InputType.feed_forward(6)))
    tg.add_layer("h", DenseLayer(n_out=5, updater=PU.RmsProp(0.01)), "in")
    tg.add_layer("out", OutputLayer(n_out=3), "h")
    return jg.set_outputs("out").build(), tg.set_outputs("out").build()


def test_updater_assignment_follows_reference():
    jc, tc = _tiny_confs(
        JNNC.builder().seed(3).updater("nadam").bias_updater(JU.Sgd(0.5)),
        NeuralNetConfiguration.builder().seed(3).updater("nadam")
        .bias_updater(PU.Sgd(0.5)))
    jnet, tnet = JaxGraph(jc).init(), ComputationGraph(tc, device="cpu").init()
    for v, named in jnet._updaters.items():
        for n, u in named.items():
            assert tnet._updaters[v][n].to_dict() == u.to_dict(), f"{v}/{n}"
            assert (sorted(tnet.updater_states[v][n])
                    == sorted(jnet.updater_states[v][n]))
    assert isinstance(tnet._updaters["h"]["b"], PU.Sgd)  # bias updater wins
    assert isinstance(tnet._updaters["h"]["W"], PU.RmsProp)
    _, tc2 = _tiny_confs(JNNC.builder(), NeuralNetConfiguration.builder())
    assert isinstance(ComputationGraph(tc2, device="cpu").init()
                      ._updaters["out"]["W"], PU.Sgd)  # Sgd(0.1) by default


def test_classifier_fit_matches_reference(rng):
    """A dense classifier (OutputLayer, 2-d labels, softmax + MCXENT) with
    mixed updaters, 3 steps from the same weights."""
    jc, tc = _tiny_confs(
        JNNC.builder().seed(3).updater(JU.Adam(1e-2)).bias_updater(JU.Sgd(0.5)),
        NeuralNetConfiguration.builder().seed(3).updater(PU.Adam(1e-2))
        .bias_updater(PU.Sgd(0.5)))
    jnet = JaxGraph(jc).init()
    tnet = load_reference_params(ComputationGraph(tc, device="cpu").init(),
                                 jax.tree_util.tree_map(np.asarray, jnet.params))
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    _assert_tree(export_params(tnet),
                 jax.tree_util.tree_map(np.asarray, jnet.params), STEP_TOL,
                 "param")


# --------------------------------------------------------- DataSet iterators
def _data(rng, n=7):
    f = rng.normal(size=(n, 4, 3)).astype(np.float32)
    l = rng.normal(size=(n, 4, 2)).astype(np.float32)
    fm = rng.integers(0, 2, (n, 4)).astype(np.float32)
    return f, l, fm


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_list_iterator_batches_match_reference(shuffle, drop_last, rng):
    f, l, fm = _data(rng)
    ji = JIter(JDataSet(f, l, features_mask=fm), 3, shuffle=shuffle, seed=4,
               drop_last=drop_last)
    ti = ListDataSetIterator(DataSet(f, l, features_mask=fm), 3,
                             shuffle=shuffle, seed=4, drop_last=drop_last)
    for _ in range(3):  # epochs: reset reshuffles
        ji.reset()
        ti.reset()
        jb, tb = list(ji), list(ti)
        assert len(jb) == len(tb) == (2 if drop_last else 3)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.features, a.features)
            np.testing.assert_array_equal(b.labels, a.labels)
            np.testing.assert_array_equal(b.features_mask, a.features_mask)
            assert b.labels_mask is None and a.labels_mask is None
            assert batch_nbytes(b) == j_nbytes(a)


def test_dataset_methods_match_reference(rng):
    f, l, fm = _data(rng)
    jd, td = JDataSet(f, l, features_mask=fm), DataSet(f, l, features_mask=fm)
    assert td.num_examples() == jd.num_examples() == 7
    jd.shuffle(seed=9)
    td.shuffle(seed=9)
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.features_mask, jd.features_mask)
    for a, b in zip(jd.split_test_and_train(5), td.split_test_and_train(5)):
        np.testing.assert_array_equal(b.features, a.features)
        np.testing.assert_array_equal(b.labels, a.labels)
    parts = [(f[:3], l[:3], fm[:3]), (f[3:], l[3:], None)]
    jm = JDataSet.merge([JDataSet(a, b, features_mask=c) for a, b, c in parts])
    tm = DataSet.merge([DataSet(a, b, features_mask=c) for a, b, c in parts])
    np.testing.assert_array_equal(tm.features_mask, jm.features_mask)
    assert tm.labels_mask is None and jm.labels_mask is None
    jmd = JMulti([f, f[:, :, :1]], [l], [fm, None])
    tmd = MultiDataSet([f, f[:, :, :1]], [l], [fm, None])
    assert tmd.num_examples() == jmd.num_examples()
    assert batch_nbytes(tmd) == j_nbytes(jmd)
    assert DataSet(torch.zeros(5, 2), torch.zeros(5, 1)).num_examples() == 5
