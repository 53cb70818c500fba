"""Every graph vertex of the port against the JAX package's.

Each vertex's forward on the same seeded inputs (and masks, for the
sequence vertices) within 1e-6, its output type, its output mask, and its
configuration through JSON both ways. Then a small graph that uses the
vertices, with a conv → dense edge the graph reshapes by itself, through
``output`` and 3 ``fit`` steps beside the JAX package's, and its
configuration JSON read by either package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import (
    ComputationGraphConfiguration as JGraphConf,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn import vertices as TV
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer, DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

TOL, STEP_TOL = 1e-6, 2e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

_rng = np.random.default_rng(0)
FF = [_rng.normal(size=(4, 6)).astype(np.float32) for _ in range(3)]
SEQ = [_rng.normal(size=(3, 5, 4)).astype(np.float32) for _ in range(2)]
IMG = [_rng.normal(size=(2, 5, 5, 3)).astype(np.float32) for _ in range(2)]
MASK = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32)

# (vertex name, fields, inputs, masks, input types)
CASES = [
    ("MergeVertex", {}, FF[:3], None,
     [JIT.feed_forward(6)] * 3),
    ("MergeVertex", {}, IMG, None, [JIT.convolutional(5, 5, 3)] * 2),
    ("MergeVertex", {}, SEQ, None, [JIT.recurrent(4, 5)] * 2),
    ("ElementWiseVertex", {"op": "add"}, FF, None, None),
    ("ElementWiseVertex", {"op": "average"}, FF, None, None),
    ("ElementWiseVertex", {"op": "subtract"}, FF[:2], None, None),
    ("ElementWiseVertex", {"op": "product"}, FF, None, None),
    ("ElementWiseVertex", {"op": "max"}, FF, None, None),
    ("StackVertex", {}, FF, None, None),
    ("UnstackVertex", {"from_index": 1, "stack_size": 2}, FF[:1], None, None),
    ("SubsetVertex", {"from_index": 1, "to_index": 3}, FF[:1], None,
     [JIT.feed_forward(6)]),
    ("SubsetVertex", {"from_index": 0, "to_index": 2}, SEQ[:1], None,
     [JIT.recurrent(4, 5)]),
    ("ReshapeVertex", {"shape": (3, 2)}, FF[:1], None, [JIT.feed_forward(6)]),
    ("ReshapeVertex", {"shape": (5, 5, 3)}, [IMG[0].reshape(2, -1)], None,
     [JIT.feed_forward(75)]),
    ("ScaleVertex", {"scale_factor": -1.5}, FF[:1], None, None),
    ("ShiftVertex", {"shift_factor": 0.25}, FF[:1], None, None),
    ("L2NormalizeVertex", {}, IMG[:1], None, None),
    ("L2NormalizeVertex", {"eps": 1e-3}, FF[:1], None, None),
    ("L2Vertex", {}, FF[:2], None, [JIT.feed_forward(6)] * 2),
    ("PoolHelperVertex", {}, IMG[:1], None, [JIT.convolutional(5, 5, 3)]),
    ("LastTimeStepVertex", {"mask_input": "in"}, SEQ[:1], None,
     [JIT.recurrent(4, 5)]),
    ("LastTimeStepVertex", {"mask_input": "in"}, SEQ[:1], [MASK],
     [JIT.recurrent(4, 5)]),
    ("DuplicateToTimeSeriesVertex", {"ts_input": "seq"},
     [FF[0][:3, :4], SEQ[0]], [None, MASK],
     [JIT.feed_forward(4), JIT.recurrent(4, 5)]),
    ("ReverseTimeSeriesVertex", {}, SEQ[:1], None, None),
    ("ReverseTimeSeriesVertex", {"mask_input": "in"}, SEQ[:1], [MASK], None),
    ("PreprocessorVertex", {"preprocessor": "cnn_to_ff"}, IMG[:1], None,
     [JIT.convolutional(5, 5, 3)]),
    ("PreprocessorVertex", {"preprocessor": "standardize"}, FF[:1], None,
     [JIT.feed_forward(6)]),
]


def _ids():
    return [f"{i}-{c[0]}" for i, c in enumerate(CASES)]


def _port_type(t):
    return InputType.from_dict(t.to_dict())


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_vertex_matches_reference(case):
    name, fields, inputs, masks, types = case
    jv, tv = JV.VERTEX_REGISTRY[name](**fields), TV.VERTEX_REGISTRY[name](**fields)
    jmasks = None if masks is None else [None if m is None else jnp.asarray(m)
                                         for m in masks]
    tmasks = None if masks is None else [None if m is None else torch.from_numpy(m)
                                         for m in masks]
    want = np.asarray(jv.forward([jnp.asarray(a) for a in inputs], jmasks))
    got = tv.forward([torch.from_numpy(a) for a in inputs], tmasks).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    in_masks = masks or [None] * len(inputs)
    jm = jv.output_mask([None if m is None else jnp.asarray(m) for m in in_masks])
    tm = tv.output_mask([None if m is None else torch.from_numpy(m) for m in in_masks])
    assert (jm is None) == (tm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if types is not None:
        assert tv.output_type([_port_type(t) for t in types]).to_dict() == \
            jv.output_type(types).to_dict()


@pytest.mark.parametrize("case", CASES, ids=_ids())
def test_vertex_config_round_trips_both_ways(case):
    name, fields = case[:2]
    jv, tv = JV.VERTEX_REGISTRY[name](**fields), TV.VERTEX_REGISTRY[name](**fields)
    tj, jj = json.dumps(tv.to_dict()), json.dumps(jv.to_dict())
    assert json.loads(tj) == json.loads(jj)
    assert TV.GraphVertex.from_dict(json.loads(jj)) == tv
    assert JV.GraphVertex.from_dict(json.loads(tj)) == jv


def test_unknown_vertex_raises_naming_it():
    with pytest.raises(NotImplementedError, match="WarpVertex"):
        TV.GraphVertex.from_dict({"@vertex": "WarpVertex"})


def _graph_conf(pkg):
    """input [6,6,2] → conv 3x3 of 4 → dense 8 (the graph flattens the
    image itself) and a second dense 8 from a Subset of the same flatten's
    features; merged, scaled, shifted, an elementwise max, an output."""
    jax_side = pkg == "jax"
    b, conv, dense, out, it, V, sgd = (
        (JNNC.builder(), JConv, JDense, JOut, JIT, JV, JU.Sgd) if jax_side else
        (NeuralNetConfiguration.builder(), ConvolutionLayer, DenseLayer,
         OutputLayer, InputType, TV, PU.Sgd))
    g = (b.seed(11).updater(sgd(0.05)).graph_builder().add_inputs("in")
         .set_input_types(it.convolutional(6, 6, 2)))
    g.add_layer("conv", conv(n_out=4, kernel_size=(3, 3), activation="relu"), "in")
    g.add_layer("d1", dense(n_out=8, activation="tanh"), "conv")
    g.add_vertex("flat", V.PreprocessorVertex(preprocessor="cnn_to_ff"), "conv")
    g.add_vertex("sub", V.SubsetVertex(from_index=5, to_index=24), "flat")
    g.add_layer("d2", dense(n_out=8, activation="sigmoid"), "sub")
    g.add_vertex("merge", V.MergeVertex(), "d1", "d2")
    g.add_vertex("scale", V.ScaleVertex(scale_factor=0.5), "merge")
    g.add_vertex("shift", V.ShiftVertex(shift_factor=0.1), "scale")
    g.add_vertex("mx", V.ElementWiseVertex(op="max"), "shift", "merge")
    g.add_vertex("norm", V.L2NormalizeVertex(), "mx")
    g.add_layer("out", out(n_out=3, activation="softmax", loss="mcxent"), "norm")
    return g.set_outputs("out").build()


def test_graph_with_vertices_matches_reference():
    jc, tc = _graph_conf("jax"), _graph_conf("port")
    assert sorted(tc.preprocessors) == sorted(jc.preprocessors) == ["d1"]
    assert tc.to_dict() == jc.to_dict()
    assert ComputationGraphConfiguration.from_json(jc.to_json()).to_dict() == jc.to_dict()
    assert JGraphConf.from_json(tc.to_json()).to_dict() == jc.to_dict()
    jnet = JGraph(jc).init()
    tnet = load_reference_params(ComputationGraph(tc, device="cpu").init(),
                                 to_np(jnet.params))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=2e-6, atol=2e-6)
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    for v, named in to_np(jnet.params).items():
        for n, w in named.items():
            np.testing.assert_allclose(export_params(tnet)[v][n], w, rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{v}/{n}")
