"""Object detection in the port against the JAX package.

``Yolo2OutputLayer.compute_loss`` and its gradient with respect to its
input (``jax.vjp`` on the reference's side), with the IoU as the held
confidence target and with a given ``conf_target``, on a 4x5 grid of 3
anchors and 3 classes whose labels put boxes of absolute grid
coordinates in some cells: within 1e-5 × max(1, the largest entry).
The decode (centres, sizes, confidences, class softmax),
``get_confidence_matrix`` and ``get_probability_matrix`` within 1e-6;
``nms`` on a hand-made list and ``get_predicted_objects`` (with and
without NMS) give the reference's list: the same detections in the same
order (example, class), boxes and confidences within 1e-5; the
reference's refusals.

The zoo's ``TinyYOLO`` and ``YOLO2`` at their published sizes from the
configuration only: the parameter count, the vertex names and inputs,
the JSON both ways and the defaults. Then reduced twins from the same
weights: ``TinyYOLO`` at 64x64 (a 2x2 grid) takes one Adam step in f64 in
both packages (its f32 step is ill-conditioned by its max pools'
near-ties, as the CNN zoo's, ROADMAP §C): the loss within 1e-10 relative
and every parameter within 1e-9 × its largest entry; ``YOLO2``'s
passthrough (a 1/2 map through ``SpaceToDepthLayer`` and a
``MergeVertex`` onto the deep 1/4 map, at narrow widths with each
package's ``darknet_block``) gives the reference's ``output`` within 1e-5
in f32.
TinyYOLO's sixth pool (2x2 at stride 1, "same": the pad on the high side
only, with -inf) on all-negative 13x13 maps gives the reference's forward
and input gradient.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import objdetect as JO
from deeplearning4j_tpu.zoo import models as J
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import objdetect as TO
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    export_updater_state,
)
from deeplearning4j_tpu_torch.zoo import models as P
from test_torch_conv_family import _close, to_np

TOL, DECODE_TOL = 1e-5, 1e-6
ANCHORS = ((1.0, 1.2), (2.0, 1.5), (0.6, 0.8))
N, H, W, C = 2, 4, 5, 3


def _raw(seed=1, scale=1.0, n=N, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, h, w, len(ANCHORS) * (5 + C)))).astype(np.float32)


def _labels(seed=2, n=N, h=H, w=W, c=C):
    """``[N, H, W, 5+C]``: a box in about a third of the cells, its centre
    in absolute grid units inside the cell, its size 0.3 to 3 cells."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, h, w, 5 + c), np.float32)
    for i, y, x in zip(*np.nonzero(rng.random((n, h, w)) < 0.35)):
        lab[i, y, x, :4] = [x + rng.random(), y + rng.random(), *rng.uniform(0.3, 3.0, 2)]
        lab[i, y, x, 4] = 1.0
        lab[i, y, x, 5 + rng.integers(0, c)] = 1.0
    return lab


def _layers():
    kw = dict(boxes=ANCHORS, n_classes=C, lambda_coord=5.0, lambda_no_obj=0.5)
    return JL.Yolo2OutputLayer(**kw), L.Yolo2OutputLayer(**kw)


@pytest.mark.parametrize("given_target", [False, True], ids=["iou_target", "conf_target"])
def test_yolo2_loss_and_gradient_match_the_reference(given_target):
    jl, tl = _layers()
    x, lab = _raw(), _labels()
    assert lab[..., 4].sum() >= 4
    target = (np.random.default_rng(3).random((N, H, W, len(ANCHORS))).astype(np.float32)
              if given_target else None)

    @jax.jit
    def reference(x_, lab_, t_):
        return jax.value_and_grad(lambda a: jl.compute_loss({}, a, lab_, conf_target=t_))(x_)

    loss, grad = reference(x, lab, target)
    leaf = torch.tensor(x, requires_grad=True)
    tloss = tl.compute_loss({}, leaf, torch.from_numpy(lab),
                            conf_target=None if target is None else torch.from_numpy(target))
    (tgrad,) = torch.autograd.grad(tloss, leaf)
    assert abs(float(tloss.detach()) - float(loss)) <= TOL * max(1.0, abs(float(loss)))
    _close(tgrad, grad, TOL)
    _close(tl.forward({}, torch.from_numpy(x)), x, 0.0)


def test_decode_and_matrices_match_the_reference():
    jl, tl = _layers()
    out = _raw(seed=4, scale=2.0)
    anchors = np.asarray(ANCHORS, np.float32)
    want = JO._decode_detections(jnp.asarray(out), len(ANCHORS), C, jnp.asarray(anchors))
    got = TO._decode_detections(torch.from_numpy(out), len(ANCHORS), C,
                                torch.from_numpy(anchors))
    for g, w in zip(got, want):
        _close(g, w, DECODE_TOL)
    _close(tl.get_confidence_matrix(out, 1, 2), jl.get_confidence_matrix(out, 1, 2),
           DECODE_TOL)
    _close(tl.get_probability_matrix(torch.from_numpy(out), 0, 1),
           jl.get_probability_matrix(out, 0, 1), DECODE_TOL)


def _same_objects(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.example, g.predicted_class) == (w.example, w.predicted_class)
        np.testing.assert_allclose(
            [g.center_x, g.center_y, g.width, g.height, g.confidence],
            [w.center_x, w.center_y, w.width, w.height, w.confidence], rtol=0, atol=TOL)
        np.testing.assert_allclose(g.class_predictions, w.class_predictions, rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("nms_threshold", [0.0, 0.4])
def test_predicted_objects_are_the_references(nms_threshold):
    jl, tl = _layers()
    out = _raw(seed=5, scale=2.0)
    want = jl.get_predicted_objects(out, 0.3, nms_threshold)
    got = tl.get_predicted_objects(torch.from_numpy(out), 0.3, nms_threshold)
    assert len(want) > 5
    _same_objects(got, want)
    if nms_threshold:
        assert len(want) < len(jl.get_predicted_objects(out, 0.3))
    _same_objects(TO.get_predicted_objects(ANCHORS, out, 0.5, n_classes=C),
                  JO.get_predicted_objects(ANCHORS, out, 0.5, n_classes=C))


def test_nms_and_iou_on_a_hand_made_list():
    def objects(mod):
        p = {0: np.array([0.7, 0.2, 0.1]), 1: np.array([0.1, 0.8, 0.1])}
        return [mod.DetectedObject(0, 2.0, 2.0, 2.0, 2.0, p[0], 0.6),
                mod.DetectedObject(0, 2.2, 2.1, 2.0, 2.0, p[0], 0.9),   # suppresses 0
                mod.DetectedObject(0, 2.1, 2.0, 2.0, 2.0, p[1], 0.5),   # another class
                mod.DetectedObject(1, 2.0, 2.0, 2.0, 2.0, p[0], 0.4),   # another example too
                mod.DetectedObject(0, 6.0, 6.0, 1.0, 1.0, p[0], 0.3),   # no overlap
                mod.DetectedObject(0, 2.2, 2.1, 2.0, 2.0, p[0], 0.9)]   # equal: both stay
    got, want = objects(TO), objects(JO)
    assert TO.iou(got[0], got[1]) == JO.iou(want[0], want[1]) > 0.5
    assert TO.iou(got[0], got[4]) == 0.0
    kept = TO.nms(got, 0.5)
    # the reference's NMS does not look at the example: the other
    # example's box goes too (ROADMAP §C)
    assert kept is got and len(got) == 4
    assert [o.confidence for o in got] == [0.9, 0.5, 0.3, 0.9]
    JO.nms(want, 0.5)
    _same_objects(got, want)
    assert got[0].top_left_xy() == want[0].top_left_xy()
    assert got[0].bottom_right_xy() == want[0].bottom_right_xy()


@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_nms_of_many_overlapping_detections_is_the_references(threshold):
    """The port holds each detection against all others at once (numpy);
    on 300 detections of 3 classes with tied confidences the kept list is
    the reference's pair loop's, object for object."""
    rng = np.random.default_rng(12)
    rows = [(int(rng.integers(0, 2)), *rng.uniform(0, 13, 2), *rng.uniform(0.2, 4, 2),
             rng.dirichlet(np.ones(3)), float(rng.choice([0.3, 0.5, rng.random()])))
            for _ in range(300)]
    got = TO.nms([TO.DetectedObject(*r) for r in rows], threshold)
    want = JO.nms([JO.DetectedObject(*r) for r in rows], threshold)
    assert 10 < len(want) < 300
    _same_objects(got, want)


def test_detection_refusals_are_the_references():
    out = _raw()
    for mod in (TO, JO):
        with pytest.raises(ValueError, match="confidence threshold"):
            mod.get_predicted_objects(ANCHORS, out, 1.5)
        with pytest.raises(ValueError, match="rank 4"):
            mod.get_predicted_objects(ANCHORS, out[0], 0.5)


def test_layer_serde_and_output_type_are_the_references():
    jl, tl = _layers()
    from deeplearning4j_tpu.nn.layers import base as jbase
    from deeplearning4j_tpu_torch.nn.layers import base as tbase
    d = json.loads(json.dumps(tl.to_dict()))
    assert d == json.loads(json.dumps(jl.to_dict()))
    back, there = tbase.layer_from_dict(d), jbase.layer_from_dict(d)
    assert back.boxes == there.boxes == ANCHORS
    from deeplearning4j_tpu_torch.nn.conf import InputType
    it = InputType.convolutional(H, W, len(ANCHORS) * (5 + C))
    assert tl.output_type(it) == it and tl.has_loss()


# ---------------------------------------------------------------- the zoo
@pytest.mark.parametrize("name", ["TinyYOLO", "YOLO2"])
def test_published_yolo_matches_the_reference(name):
    jm, pm = getattr(J, name)(), getattr(P, name)()
    jconf, conf = jm.conf(), pm.conf()
    assert conf.num_params() == jconf.num_params() == \
        {"TinyYOLO": 15861773, "YOLO2": 67445065}[name]
    assert list(conf.topo_order) == list(jconf.topo_order)
    assert [conf.vertices[n].inputs for n in conf.topo_order] == \
        [jconf.vertices[n].inputs for n in jconf.topo_order]
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    from_ref = ComputationGraphConfiguration.from_json(jconf.to_json())
    from_port = JGraphConf.from_json(conf.to_json())
    assert from_ref.to_dict() == conf.to_dict() and \
        from_port.num_params() == jconf.num_params()
    assert (pm.num_labels, pm.seed, pm.input_shape) == \
        (jm.num_labels, jm.seed, jm.input_shape)
    assert pm.PRETRAINED_URL == next(iter(jm.PRETRAINED_URLS.values()))
    assert pm.PRETRAINED_CHECKSUM == next(iter(jm.PRETRAINED_CHECKSUMS.values()))
    anchors = {"TinyYOLO": (P.TINY_YOLO_ANCHORS, J.TINY_YOLO_ANCHORS),
               "YOLO2": (P.YOLO2_ANCHORS, J.YOLO2_ANCHORS)}[name]
    assert anchors[0] == anchors[1] == conf.vertices["outputs"].obj.boxes
    assert type(conf.global_conf.updater).__name__ == "Adam"
    assert conf.global_conf.updater.learning_rate == 1e-3


def _reduced_twins(name, dtype):
    """The port's network of the model at 64x64 and the JAX package's with
    the port's weights, layer states and (zero) Adam state: the
    reference's ``init`` compiles a draw and a scaling for every new
    shape, which at these widths costs more than the check, and any
    weights serve for parity."""
    kw = dict(num_labels=C, input_shape=(3, 64, 64))
    conf = getattr(P, name)(**kw).conf()
    conf.global_conf.dtype = dtype
    net = ComputationGraph(conf, device="cpu").init()
    jconf = getattr(J, name)(**kw).conf()
    jconf.global_conf.dtype = dtype
    jnet = JGraph(jconf)
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    jnet._rng_key = jax.random.PRNGKey(0)
    jnet.params, jnet.states = as_jax(export_params(net)), as_jax(export_states(net))
    jnet.updater_states = as_jax(export_updater_state(net))
    g = jconf.global_conf
    jnet._updaters = {}
    for vd in jconf.layer_vertices():
        upd = vd.obj.updater or g.updater
        bias = vd.obj.bias_updater or g.bias_updater or upd
        jnet._updaters[vd.name] = {n: bias if n == "b" else upd
                                   for n in jnet.params[vd.name]}
    jnet.iteration = jnet.epoch = 0
    return jnet, net


def _scene(n=2, grid=2, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 32 * grid, 32 * grid, 3)).astype(np.float32)
    return x, _labels(seed, n, grid, grid, C)


def test_tiny_yolo_reduced_twin_step_in_f64():
    with jax.enable_x64(True):
        jnet, net = _reduced_twins("TinyYOLO", "float64")
        x, y = _scene()
        y[0, 0, 0, :5] = [0.5, 0.5, 1.5, 1.2, 1.0]  # at least one box
        y[0, 0, 0, 5:] = [0, 1, 0]
        start = export_params(net)
        jnet.fit(x, y)
        net.fit(x, y)
        assert abs(net.score_ - float(jnet.score_)) <= 1e-10 * abs(float(jnet.score_))
        want = to_np(jnet.params)
    moved = 0
    for key, named in export_params(net).items():
        for n, got in named.items():
            assert got.dtype == np.float64
            moved += not np.array_equal(got, start[key][n])
            np.testing.assert_allclose(got, want[key][n], rtol=0,
                                       atol=1e-9 * max(np.abs(want[key][n]).max(), 1e-30),
                                       err_msg=f"{key}/{n}")
    assert moved == sum(len(named) for named in want.values())


def _passthrough_conf(pkg, helpers, nnc, it, adam, vertices):
    """YOLO2's passthrough at narrow widths, built with each package's
    ``darknet_block`` and names: a 1/2 map (block 13's role) pooled and
    deepened (block 20's), reorganized by ``SpaceToDepthLayer(2)``, joined
    by a ``MergeVertex`` ("concat"), one more block and the YOLO head."""
    g = (nnc.builder().seed(9).weight_init("xavier").updater(adam(1e-3)).graph_builder()
         .add_inputs("input").set_input_types(it.convolutional(16, 16, 3)))
    x = helpers.darknet_block(g, 1, "input", 4, pool=2)
    passthrough = helpers.darknet_block(g, 13, x, 6)
    g.add_layer("maxpooling2d_13", pkg.SubsamplingLayer(pooling_type="max",
                                                        kernel_size=(2, 2), stride=(2, 2)),
                passthrough)
    x = helpers.darknet_block(g, 20, "maxpooling2d_13", 8)
    g.add_layer("reorg", pkg.SpaceToDepthLayer(block_size=2), passthrough)
    g.add_vertex("concat", vertices.MergeVertex(), "reorg", x)
    x = helpers.darknet_block(g, 21, "concat", 8)
    g.add_layer("convolution2d_22", pkg.ConvolutionLayer(
        n_out=len(ANCHORS) * (5 + C), kernel_size=(1, 1), convolution_mode="same",
        activation="identity"), x)
    g.add_layer("outputs", pkg.Yolo2OutputLayer(boxes=ANCHORS, n_classes=C),
                "convolution2d_22")
    return g.set_outputs("outputs").build()


def test_yolo2_passthrough_twin_output():
    """YOLO2's passthrough (SpaceToDepth of the 1/2 map merged onto the
    deep 1/4 map) at narrow widths from the same weights: the output within
    1e-5 in f32. The full-width YOLO2 is held by its configuration above
    and runs on the card in ``chip_smoke.py``; a step through the darknet
    blocks and the YOLO loss is TinyYOLO's f64 twin's."""
    from deeplearning4j_tpu.nn import vertices as jv
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.updaters import Adam as JAdam
    from deeplearning4j_tpu.zoo import helpers as jh
    from deeplearning4j_tpu_torch.nn import vertices as tv
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.util.convert import load_reference_params
    from deeplearning4j_tpu_torch.zoo import helpers as th
    from test_torch_conv_family import jax_init

    jconf = _passthrough_conf(JL, jh, JNNC, JIT, JAdam, jv)
    conf = _passthrough_conf(L, th, NeuralNetConfiguration, InputType, Adam, tv)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    jnet = jax_init(JGraph, jconf)
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(),
                                to_np(jnet.params))
    x = _scene(n=2, grid=1)[0][:, :16, :16]
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    assert got.shape == want.shape == (2, 4, 4, len(ANCHORS) * (5 + C))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def test_tiny_yolo_stride_one_pool_pads_high_with_minus_infinity():
    kw = dict(pooling_type="max", kernel_size=(2, 2), stride=(1, 1),
              convolution_mode="same")
    jl, tl = JL.SubsamplingLayer(**kw), L.SubsamplingLayer(**kw)
    x = -np.abs(np.random.default_rng(7).standard_normal((2, 13, 13, 4))).astype(
        np.float32) - 0.1
    cot = np.random.default_rng(8).standard_normal((2, 13, 13, 4)).astype(np.float32)
    out, pull = jax.vjp(lambda a: jl.forward({}, a)[0], jnp.asarray(x))
    leaf = torch.tensor(x, requires_grad=True)
    tout = tl.forward({}, leaf)
    (tgrad,) = torch.autograd.grad(tout, leaf, torch.from_numpy(cot))
    assert tuple(tout.shape) == (2, 13, 13, 4)
    _close(tout, out, 0.0)
    _close(tgrad, pull(jnp.asarray(cot))[0], 0.0)
    # the last row and column pool only themselves and their one neighbour
    np.testing.assert_array_equal(tout[:, -1, -1].detach().numpy(), x[:, -1, -1])
