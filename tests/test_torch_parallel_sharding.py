"""The port's sharding rules and mesh grammar against the JAX package's.

No process group is needed: these functions work on names, shapes and
specs. Each case runs the reference's case (``tests/test_sharding_2d.py``
``TestMatchPartitionRules`` and ``TestMeshGrammar``'s grammar cases,
``tests/test_parallel.py`` ``TestMegatronSpecs``' spec cases) on both
packages, with the port's networks built from the reference's weights
where a network is needed, and compares the port's specs with the
reference's, spec for spec (the port's ``P`` compares as the tuple of
its entries, as jax's does).
"""

from __future__ import annotations

import json
import re

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JElementWise
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.parallel import sharding as jsh
from deeplearning4j_tpu.zoo.models import TransformerEncoder as JEncoder
from deeplearning4j_tpu.zoo.models import TransformerLM as JLM
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.parallel import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import sharding as tsh
from deeplearning4j_tpu_torch.util import convert
from deeplearning4j_tpu_torch.zoo.models import TransformerEncoder, TransformerLM

P, JP = tsh.P, jsh.P


def same_spec(mine, theirs) -> bool:
    return tuple(mine) == tuple(theirs)


def same_specs(mine, theirs) -> None:
    """The port's spec tree (``{key: {param: P}}``) against the reference's
    (a list of layer dicts for a MultiLayerNetwork)."""
    if isinstance(theirs, list):
        theirs = dict(enumerate(theirs))
    assert set(mine) == set(theirs)
    for k in theirs:
        assert set(mine[k]) == set(theirs[k]), k
        for n in theirs[k]:
            assert same_spec(mine[k][n], theirs[k][n]), (k, n, mine[k][n], theirs[k][n])


def port_of(jnet, net):
    """``net`` (the port's) with the reference network's parameters."""
    return convert.load_reference_params(net, jax.tree_util.tree_map(np.asarray, jnet.params))


def tiny_lms():
    jnet = JLM(vocab_size=64, max_length=8, n_layers=1, d_model=16, n_heads=4,
               d_ff=32, seed=7).init()
    net = TransformerLM(vocab_size=64, max_length=8, n_layers=1, d_model=16, n_heads=4,
                        d_ff=32, seed=7).init(device="cpu")
    return jnet, port_of(jnet, net)


# ----------------------------------------------------------- rule matching
class TestMatchPartitionRules:
    def test_first_match_wins(self):
        params = {"block/ff1": {"W": np.zeros((4, 8))}}
        for order in (1, -1):  # the catch-all last, then first
            mine = tsh.match_partition_rules(
                [("ff1/W", P(None, "model")), (".*", P())][::order], params)
            theirs = jsh.match_partition_rules(
                [("ff1/W", JP(None, "model")), (".*", JP())][::order], params)
            assert same_spec(mine["block/ff1"]["W"], theirs["block/ff1"]["W"])
        assert tsh.match_partition_rules([("ff1/W", P(None, "model")), (".*", P())],
                                         params)["block/ff1"]["W"] == P(None, "model")
        assert tsh.match_partition_rules([(".*", P()), ("ff1/W", P(None, "model"))],
                                         params)["block/ff1"]["W"] == P()

    def test_scalar_leaves_never_partitioned(self):
        params = {"layer": {"W": np.zeros((4, 4)), "step": np.float32(3.0),
                            "one": np.zeros((1,))}}
        mine = tsh.match_partition_rules([(".*", P("model"))], params)
        theirs = jsh.match_partition_rules([(".*", JP("model"))], params)
        for n in ("W", "step", "one"):
            assert same_spec(mine["layer"][n], theirs["layer"][n]), n
        assert mine["layer"]["W"] == P("model")
        assert mine["layer"]["step"] == P() and mine["layer"]["one"] == P()

    def test_unmatched_path_fails_loudly(self):
        params = {"embed": {"W": np.zeros((8, 4))}}
        with pytest.raises(ValueError, match="Partition rule not found") as mine:
            tsh.match_partition_rules([("ff1/W", P())], params)
        with pytest.raises(ValueError, match="Partition rule not found") as theirs:
            jsh.match_partition_rules([("ff1/W", JP())], params)
        assert str(mine.value) == str(theirs.value)

    def test_default_rules_cover_transformer_lm(self):
        jnet, net = tiny_lms()
        mine = tsh.match_partition_rules(tsh.DEFAULT_2D_RULES, net.params)
        theirs = jsh.match_partition_rules(jsh.DEFAULT_2D_RULES, jnet.params)
        same_specs(mine, theirs)
        flat = {f"{k}/{n}": s for k, d in mine.items() for n, s in d.items()}
        embed = [s for n, s in flat.items() if "embed" in n and n.endswith("/W")]
        out_w = [s for n, s in flat.items()
                 if re.search(r"(out|output|logits|lm_head)[^/]*/W$", n)]
        assert embed and all(s == P("model", None) for s in embed)
        assert out_w and all(s == P(None, "model") for s in out_w)

    def test_lint_flags_unmatched_dead_and_shadowed(self):
        params = {"embed": {"W": np.zeros((8, 4))}, "out": {"W": np.zeros((4, 8))}}
        rules = [("embed/W", ("model", None)), ("qkv/W", (None, "model")), ("embed/.*", ())]
        mine = tsh.lint_partition_rules([(r, P(*s)) for r, s in rules], params)
        theirs = jsh.lint_partition_rules([(r, JP(*s)) for r, s in rules], params)
        assert mine == theirs
        text = "\n".join(mine)
        assert "'out/W' matches no rule" in text
        assert "matches no param" in text and "qkv/W" in text
        assert "fully shadowed" in text
        jnet, net = tiny_lms()
        assert tsh.lint_partition_rules(tsh.DEFAULT_2D_RULES, net.params) == [] \
            == jsh.lint_partition_rules(jsh.DEFAULT_2D_RULES, jnet.params)

    def test_load_sharding_rules_schema(self, tmp_path):
        spec = {"rules": [["embed/W$", ["model", None]], [".*", []]]}
        mine, theirs = tsh.load_sharding_rules(spec), jsh.load_sharding_rules(spec)
        assert [(r, tuple(s)) for r, s in mine] == [(r, tuple(s)) for r, s in theirs]
        assert mine[0][1] == P("model", None) and mine[1][1] == P()
        path = tmp_path / "rules.json"
        path.write_text(json.dumps(spec))
        assert tsh.load_sharding_rules(str(path)) == mine
        with pytest.raises(ValueError):
            tsh.load_sharding_rules({"rules": [["(unclosed", []]]})
        with pytest.raises((ValueError, KeyError, TypeError)):
            tsh.load_sharding_rules({"rules": "not-a-list"})


# ------------------------------------------------------------ mesh grammar
class TestMeshGrammar:
    def test_parse_format_round_trip(self):
        for text in ("data=4,model=2", "data=-1,model=2"):
            assert tmesh.parse_mesh_axes(text) == jmesh.parse_mesh_axes(text)
        axes = tmesh.parse_mesh_axes("data=4,model=2")
        assert axes == {"data": 4, "model": 2}
        assert tmesh.format_mesh_axes(axes) == jmesh.format_mesh_axes(axes) == "data=4,model=2"

    @pytest.mark.parametrize("bad", ["", "data", "data=x", "data=0",
                                     "data=4,data=2", "data=-1,model=-1",
                                     "data=-2"])
    def test_rejects_bad_specs(self, bad):
        with pytest.raises(ValueError) as mine:
            tmesh.parse_mesh_axes(bad)
        with pytest.raises(ValueError) as theirs:
            jmesh.parse_mesh_axes(bad)
        assert str(mine.value) == str(theirs.value)


# ----------------------------------------------------- Megatron pair specs
class TestMegatronSpecs:
    """The paired column→row tensor-parallel rule, spec for spec."""

    @staticmethod
    def _ffn():
        def build(nnc, dense, out, mln, **kw):
            conf = (nnc.builder().seed(3).list()
                    .layer(dense(n_in=32, n_out=128, activation="relu"))
                    .layer(dense(n_in=128, n_out=32, activation="identity"))
                    .layer(out(n_in=32, n_out=8, activation="softmax",
                               loss="negativeloglikelihood"))
                    .build())
            return mln(conf, **kw).init()

        jnet = build(JNNC, JDense, JOut, JMLN)
        return jnet, port_of(jnet, build(NeuralNetConfiguration, DenseLayer, OutputLayer,
                                         MultiLayerNetwork, device="cpu"))

    def test_pairing_on_mln_ffn(self):
        jnet, net = self._ffn()
        specs = tsh.tp_param_specs(net, "model")
        same_specs(specs, jsh.tp_param_specs(jnet, "model"))
        assert specs[0]["W"] == P(None, "model") and specs[0]["b"] == P("model")
        assert specs[1]["W"] == P("model", None) and specs[1]["b"] == P()
        assert specs[2]["W"] == P()

    def test_dense_to_output_pairs_as_row_end(self):
        def build(nnc, dense, out, mln, **kw):
            conf = (nnc.builder().seed(7).list()
                    .layer(dense(n_in=12, n_out=16, activation="tanh"))
                    .layer(out(n_in=16, n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
                    .build())
            return mln(conf, **kw).init()

        jnet = build(JNNC, JDense, JOut, JMLN)
        net = port_of(jnet, build(NeuralNetConfiguration, DenseLayer, OutputLayer,
                                  MultiLayerNetwork, device="cpu"))
        specs = tsh.tp_param_specs(net, "model")
        same_specs(specs, jsh.tp_param_specs(jnet, "model"))
        assert specs[0]["W"] == P(None, "model") and specs[1]["W"] == P("model", None)

    def test_attention_specs_on_graph(self):
        kw = dict(num_labels=2, vocab_size=32, max_length=8, n_layers=1, d_model=16,
                  n_heads=2, d_ff=32)
        jnet = JGraph(JEncoder(**kw).conf()).init()
        net = port_of(jnet, ComputationGraph(TransformerEncoder(**kw).conf(),
                                             device="cpu").init())
        specs = tsh.tp_param_specs(net, "model")
        same_specs(specs, jsh.tp_param_specs(jnet, "model"))
        att = specs["block0-att"]
        assert att["Wqkv"] == P(None, "model") and att["bqkv"] == P("model")
        assert att["Wo"] == P("model", None) and att["bo"] == P()
        assert specs["block0-ff1"]["W"] == P(None, "model")
        assert specs["block0-ff2"]["W"] == P("model", None)
        assert all(s == P() for s in specs["block0-ln1"].values())

    def test_residual_tap_breaks_pair(self):
        def build(nnc, it, dense, out, ew, graph, **kw):
            g = (nnc.builder().seed(0).graph_builder().add_inputs("in")
                 .set_input_types(it.feed_forward(16)))
            g.add_layer("d1", dense(n_in=16, n_out=16, activation="relu"), "in")
            g.add_layer("d2", dense(n_in=16, n_out=16, activation="identity"), "d1")
            g.add_vertex("res", ew(op="add"), "d1", "d2")
            g.add_layer("out", out(n_in=16, n_out=4, activation="softmax",
                                   loss="negativeloglikelihood"), "res")
            g.set_outputs("out")
            return graph(g.build(), **kw).init()

        jnet = build(JNNC, JIT, JDense, JOut, JElementWise, JGraph)
        net = port_of(jnet, build(NeuralNetConfiguration, InputType, DenseLayer,
                                  OutputLayer, ElementWiseVertex, ComputationGraph,
                                  device="cpu"))
        specs = tsh.tp_param_specs(net, "model")
        same_specs(specs, jsh.tp_param_specs(jnet, "model"))
        assert specs["d1"]["W"] == P() and specs["d2"]["W"] == P()


def test_make_mesh_opens_a_world_of_one_rank_and_needs_an_explicit_cpu():
    """With no process group, ``make_mesh()`` opens a world of one rank, as
    the reference's ``make_mesh()`` needs no setup: on ``cuda`` by default
    (refused without a card, never falling back to the CPU), on the CPU
    when asked. The mesh infers its axis as the reference's does."""
    import torch
    import torch.distributed as dist

    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
        assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh({"data": -1}, device_type="cpu")
        assert tmesh.mesh_axes(mesh) == {"data": 1}
        assert not tmesh.is_multiprocess(mesh)
        with pytest.raises(ValueError, match="mesh wants 2 devices, only 1 available"):
            tmesh.make_mesh({"data": 2}, device_type="cpu")
        ref = jmesh.make_mesh({"data": -1}, jax.devices()[:1])
        assert dict(ref.shape) == tmesh.mesh_axes(mesh)
    finally:
        dist.destroy_process_group()
