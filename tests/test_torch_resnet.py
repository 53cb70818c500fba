"""Zoo ResNet-50 in the port against the JAX package, on the CPU.

The configuration at ImageNet shape (1000 labels): the same vertex names,
topological order, parameter shapes, parameter count and JSON. Then the
full-depth network at 32x32x3 with 10 labels, the JAX network's weights
AND running statistics carried across (``util/convert.py``): the stem's
zero padding and 7x7/2 convolution, the 3x3/2 max pool and the "same" 3x3
average pool all run at that size. ``output`` on 2 images within 1e-4
relative (f32 through 53 convolutions, summed in another order); one
``fit`` step on 4 images with the zoo's Nesterovs(1e-2, 0.9), l1 1e-7 and
l2 5e-5: the loss within 1e-5 relative, every parameter within 2e-5 ×
its largest entry, every running statistic within 1e-5; the graph's
``evaluate``
equal to the JAX package's (accuracy and confusion matrix); and the zip
written by either package read by the other, outputs within 1e-6.

The step is held in float64 at those limits (``jax.enable_x64`` on the
JAX side; the running statistics stay float32 in both, as the reference
keeps them). A float32 train step of a randomly initialized ResNet-50 is
ill-conditioned: a handful of ReLU inputs lie within float32 rounding of
zero, so float32 and float64 disagree on their sign, and each such flip
passes or blocks a whole gradient entry that backpropagation carries to
every tensor below it. On this input the JAX package's own float32
gradients differ from its float64 ones by 2% to 36% of a tensor's
largest entry, in nearly every tensor
(``test_float32_step_is_ill_conditioned_in_the_reference`` holds and
prints it), so no float32 implementation can meet 2e-5 there. The
float32 step is held instead by what is well-conditioned in it: the
Nesterovs update of the same float32 gradients within 2e-5 x each
tensor's largest entry (parameters and momentum, every tensor); the
port's float32 gradients, loss before the step, output after it and
running statistics no farther from the float64 step's than the JAX
package's float32 ones are (a few times their error at most, each
tensor by itself and all of them together).

The JAX network is built once per module (its jit compiles take most of
this file's time).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JComputationGraph
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu.zoo.models import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import BatchNormalizationLayer
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    export_updater_state,
    load_reference_params,
    load_reference_states,
)
from deeplearning4j_tpu_torch.zoo.models import ResNet50

OUT_RTOL, STEP_TOL, STATE_TOL, ZIP_TOL = 1e-4, 2e-5, 1e-5, 1e-6
# how far the port's float32 step may stray from the float64 step, as a
# multiple of the JAX package's own float32 error: each tensor, all of them
F32_TENSOR_FACTOR, F32_TOTAL_FACTOR = 4.0, 2.5
SHAPE, LABELS = (3, 32, 32), 10
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _images(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (n, 32, 32, 3)).astype(np.float32)
    return x, np.eye(LABELS, dtype=np.float32)[rng.integers(0, LABELS, n)]


@pytest.fixture(scope="module")
def jnet():
    net = JResNet50(num_labels=LABELS, seed=3, input_shape=SHAPE).init()
    # running statistics off their initial values, so that inference
    # reads carried state
    rng = np.random.default_rng(9)
    for name, st in net.states.items():
        if st:
            c = st["mean"].shape[0]
            net.states[name] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                                "var": rng.uniform(0.8, 1.2, c).astype(np.float32)}
    return net


def _port(jnet, device="cpu"):
    tnet = ResNet50(num_labels=LABELS, seed=3, input_shape=SHAPE).init(device=device)
    load_reference_params(tnet, to_np(jnet.params))
    return load_reference_states(tnet, to_np(jnet.states))


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: jax.numpy.asarray(np.array(a)), tree)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_imagenet_conf_matches_reference():
    jc, tc = JResNet50(num_labels=1000).conf(), ResNet50(num_labels=1000).conf()
    assert tc.topo_order == jc.topo_order
    assert len(tc.topo_order) == 176 and tc.inputs == ["input"]
    assert tc.num_params() == jc.num_params() == 25_557_032
    shapes = {vd.name: vd.obj.param_shapes() for vd in tc.layer_vertices()}
    assert shapes == {vd.name: vd.obj.param_shapes() for vd in jc.layer_vertices()}
    bn = [vd.name for vd in tc.layer_vertices()
          if isinstance(vd.obj, BatchNormalizationLayer)]
    assert len(bn) == 53 and bn[:2] == ["stem-batch1", "bn2a_branch1"]
    assert tc.to_dict() == jc.to_dict()
    assert type(jc).from_json(tc.to_json()).to_dict() == jc.to_dict()
    assert type(tc).from_json(jc.to_json()).to_dict() == jc.to_dict()


def test_output_with_carried_weights_and_states(jnet):
    tnet = _port(jnet)
    x, _ = _images(1, 2)
    got, want = tnet.output(x).numpy(), np.asarray(jnet.output(x))
    assert got.shape == (2, LABELS)
    assert _rel(got, want) <= OUT_RTOL


def _conf64(model):
    conf = model.conf()
    conf.global_conf.dtype = "float64"
    return conf


def test_one_nesterovs_step(jnet):
    x, y = _images(2, 4)
    with jax.enable_x64(True):
        jtwin = JComputationGraph(_conf64(JResNet50(
            num_labels=LABELS, seed=3, input_shape=SHAPE))).init()
        jtwin.params = jax.tree_util.tree_map(
            lambda a: jax.numpy.asarray(np.asarray(a, np.float64)), jnet.params)
        jtwin.states = _copy(jnet.states)  # fit donates its buffers
        jtwin.fit(x, y)
        want_p, want_s = to_np(jtwin.params), to_np(jtwin.states)
        want_loss = jtwin.score_
    tnet = ComputationGraph(_conf64(ResNet50(num_labels=LABELS, seed=3,
                                             input_shape=SHAPE)),
                            device="cpu").init()
    load_reference_params(tnet, to_np(jnet.params))
    load_reference_states(tnet, to_np(jnet.states))
    tnet.fit(x, y)
    assert tnet.params["fc1000"]["W"].dtype == torch.float64
    assert abs(tnet.score_ - want_loss) <= STEP_TOL * abs(want_loss)
    got_p = export_params(tnet)
    for v, named in want_p.items():
        for n, w in named.items():
            err = np.abs(got_p[v][n] - w).max()
            assert err <= STEP_TOL * np.abs(w).max(), f"{v}/{n}: {err}"
    got_s = export_states(tnet)
    moved = 0
    for v, named in want_s.items():
        for n, w in named.items():
            np.testing.assert_allclose(got_s[v][n], w, rtol=STATE_TOL,
                                       atol=STATE_TOL, err_msg=f"{v}/{n}")
            moved += not np.array_equal(w, to_np(jnet.states)[v][n])
    assert moved == 2 * 53
    assert set(tnet.updater_states["fc1000"]["W"]) == {"v"}


def _jax64(jnet):
    """The JAX package's float64 twin of ``jnet``, weights and states
    carried (call under ``jax.enable_x64``)."""
    net = JComputationGraph(_conf64(JResNet50(
        num_labels=LABELS, seed=3, input_shape=SHAPE))).init()
    net.params = jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(np.asarray(a, np.float64)), jnet.params)
    net.states = _copy(jnet.states)
    return net


@pytest.fixture(scope="module")
def f32_grads(jnet):
    """Train-mode gradients on the step's input: the JAX package's in
    float32 and float64, and the port's in float32."""
    x, y = _images(2, 4)

    def grads(net, dtype):
        def loss(p):
            return net._loss_fn(p, _copy(jnet.states),
                                {"input": jax.numpy.asarray(x, dtype)},
                                [jax.numpy.asarray(y, dtype)], None, None, None,
                                train=True)[0]
        return to_np(jax.grad(loss)(net.params))

    jtwin = JResNet50(num_labels=LABELS, seed=3, input_shape=SHAPE).init()
    jtwin.params = _copy(jnet.params)
    g32 = grads(jtwin, np.float32)
    with jax.enable_x64(True):
        g64 = grads(_jax64(jnet), np.float64)
    tnet = _port(jnet)
    _, gp, _ = tnet._gradients({"input": torch.from_numpy(x)},
                               [torch.from_numpy(y)], train=True)
    gp = {v: {n: t.numpy() for n, t in named.items()} for v, named in gp.items()}
    return g32, g64, gp


def test_float32_step_is_ill_conditioned_in_the_reference(f32_grads):
    """Why the step is held in float64 at the 2e-5 limit: on this
    input the JAX package's own float32 gradients stray from its float64
    ones by more than the step tolerance allows, relative to a tensor's
    largest entry (``pytest -s`` prints the worst)."""
    g32, g64, _ = f32_grads
    worst, where = max((float(np.abs(g32[v][n] - w).max() / np.abs(w).max()), f"{v}/{n}")
                       for v, named in g64.items() for n, w in named.items())
    print(f"f32 against f64 gradients: worst {worst:.3g} x the largest entry of {where}")
    assert worst > STEP_TOL


def test_float32_gradients_as_accurate_as_the_reference(f32_grads):
    """The port's float32 gradients stray from the float64 ones no more
    than a few times as far as the JAX package's float32 gradients do,
    by the L2 norm of the error relative to the tensor's (``pytest -s``
    prints the worst ratio)."""
    g32, g64, gp = f32_grads
    ratios, port_sq, ref_sq = [], 0.0, 0.0
    for v, named in g64.items():
        for n, w in named.items():
            e_port = np.linalg.norm(gp[v][n] - w)
            e_ref = np.linalg.norm(g32[v][n] - w)
            assert e_port <= F32_TENSOR_FACTOR * e_ref + 1e-6 * np.linalg.norm(w), \
                f"{v}/{n}: port {e_port:.3g}, reference {e_ref:.3g}"
            ratios.append((e_port / e_ref, f"{v}/{n}"))
            port_sq, ref_sq = port_sq + e_port ** 2, ref_sq + e_ref ** 2
    print(f"worst ratio {max(ratios)}, whole gradient "
          f"{np.sqrt(port_sq / ref_sq):.3g}")
    assert np.sqrt(port_sq) <= F32_TOTAL_FACTOR * np.sqrt(ref_sq)


def test_float32_update_matches_reference(jnet, f32_grads):
    """The float32 Nesterovs step (lr 1e-2, momentum 0.9; l1 and l2 are in
    the gradients) of the same gradients: every parameter and its momentum
    within 2e-5 x the tensor's largest entry."""
    g32 = f32_grads[0]
    jtwin = JResNet50(num_labels=LABELS, seed=3, input_shape=SHAPE).init()
    want_p, want_s = jtwin._apply_updates(
        _copy(jnet.params), _copy(g32), jtwin.updater_states, 0, 0)
    want_p, want_s = to_np(want_p), to_np(want_s)
    tnet = _port(jnet)
    tnet._apply_updates({v: {n: torch.from_numpy(np.array(g)) for n, g in named.items()}
                         for v, named in g32.items()})
    got_p, got_s = export_params(tnet), export_updater_state(tnet)
    for v, named in want_p.items():
        for n, w in named.items():
            assert got_p[v][n].dtype == np.float32
            for got, want in ((got_p[v][n], w), (got_s[v][n]["v"], want_s[v][n]["v"])):
                err = np.abs(got - want).max()
                assert err <= STEP_TOL * np.abs(want).max(), f"{v}/{n}: {err}"


def test_float32_step_loss(jnet):
    """The float32 step on 16 images: the loss before it within 2e-5 of the
    JAX package's; the output after it (on 4 other images) and the running
    statistics no farther from the float64 step's than the JAX package's
    float32 ones are (``pytest -s`` prints both)."""
    x, y = _images(2, 16)
    probe, _ = _images(5, 4)
    with jax.enable_x64(True):
        j64 = _jax64(jnet)
        j64.fit(x, y)
        out64 = np.asarray(j64.output(probe.astype(np.float64)))
        st64 = to_np(j64.states)
    tnet = _port(jnet)
    jtwin = JResNet50(num_labels=LABELS, seed=3, input_shape=SHAPE).init()
    jtwin.params, jtwin.states = _copy(jnet.params), _copy(jnet.states)
    jtwin.fit(x, y)
    tnet.fit(x, y)
    assert abs(tnet.score_ - jtwin.score_) <= STEP_TOL * abs(jtwin.score_)
    assert tnet.iteration == jtwin.iteration == 1
    e_port = np.abs(tnet.output(probe).numpy() - out64).max()
    e_ref = np.abs(np.asarray(jtwin.output(probe)) - out64).max()
    print(f"output after the step: port {e_port:.3g}, reference {e_ref:.3g}")
    assert e_port <= F32_TOTAL_FACTOR * e_ref + 1e-7
    got_s, ref_s = export_states(tnet), to_np(jtwin.states)
    for v, named in st64.items():
        for n, w in named.items():
            e_port = np.abs(got_s[v][n] - w).max()
            e_ref = np.abs(ref_s[v][n] - w).max()
            assert e_port <= F32_TENSOR_FACTOR * e_ref + 1e-6 * np.abs(w).max(), \
                f"{v}/{n}: port {e_port:.3g}, reference {e_ref:.3g}"


def test_evaluate_matches_reference(jnet):
    tnet = _port(jnet)
    x, y = _images(3, 12)
    je, te = jnet.evaluate([JDataSet(x, y)]), tnet.evaluate(DataSet(x, y))
    assert te.accuracy() == je.accuracy()
    np.testing.assert_array_equal(te.confusion_matrix(), je.confusion_matrix())
    assert te.stats() == je.stats()


def test_zip_both_ways(jnet, tmp_path):
    tnet = _port(jnet)
    x, _ = _images(4, 2)
    jser.write_model(jnet, tmp_path / "jax.zip")
    tnet.save(tmp_path / "port.zip")
    from_jax = ComputationGraph.load(tmp_path / "jax.zip", device="cpu")
    from_port = jser.restore_computation_graph(tmp_path / "port.zip")
    np.testing.assert_allclose(from_jax.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=ZIP_TOL, atol=ZIP_TOL)
    np.testing.assert_allclose(np.asarray(from_port.output(x)),
                               tnet.output(x).numpy(), rtol=ZIP_TOL, atol=ZIP_TOL)
    for v, named in to_np(from_port.states).items():
        for n, w in named.items():
            np.testing.assert_array_equal(w, tnet.states[v][n].numpy())
