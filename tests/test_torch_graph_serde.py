"""ComputationGraph configuration serde and the graph model zip of the
port on the CPU, against the JAX package.

- Configuration JSON and YAML read both ways (port → JAX → port and the
  reverse give the same dict) for ``TransformerLM.conf()``, a truncated
  BPTT graph built with ``t_bptt_length`` and the regression graph; a
  vertex kind the port has not ported raises, naming it.
- ``tests/fixtures/regression_graph_v1.zip`` (written by the JAX package:
  attention, LayerNorm, an ElementWise vertex, two inputs; Adam state; no
  ``qkv_layout`` stamp, so its fused attention columns are repacked)
  restored by the port reproduces ``_expected.npz``'s output within rtol
  1e-5 / atol 1e-6 (the MultiLayerNetwork fixture's limit), its gradients
  agree within 1e-5 x each tensor's largest entry, and one more ``fit``
  step lands within 2e-5 of the JAX package's step from the same zip. One
  slice is held apart: the key bias (``bqkv``'s K columns) has an
  analytically zero gradient (softmax ignores a constant added to every
  score of a row), so both packages compute rounding noise of order 1e-9
  there, of either sign, which Adam's restored state (v of order 1e-20)
  turns into steps of order 1e-5; that slice is checked to have a
  gradient below 1e-7 on both sides instead.
- A port-written TransformerLM zip read by the JAX package, and the
  reverse: parameters and Adam state equal, outputs within 1e-5; a zip
  written without its updater state restores with fresh state.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import (
    ComputationGraphConfiguration as JGraphConf,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.vertices import MergeVertex as JMerge
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.util import model_serializer as ms
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo import TransformerLM, lm_labels

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GRAPH_ZIP = os.path.join(FIXTURES, "regression_graph_v1.zip")
FIXTURE_RTOL, FIXTURE_ATOL = 1e-5, 1e-6
STEP_TOL, OUT_TOL, GRAD_TOL, KEY_BIAS_GRAD = 2e-5, 1e-5, 1e-5, 1e-7
EX11 = dict(vocab_size=11, max_length=32, n_layers=2, d_model=32, n_heads=4,
            d_ff=64, seed=3)
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _assert_close(got, want, tol, what):
    assert set(got) == set(want), what
    for v, named in want.items():
        assert set(got[v]) == set(named), f"{what} {v}"
        for n, w in named.items():
            if isinstance(w, dict):
                assert set(got[v][n]) == set(w), f"{what} {v}/{n}"
                for s, ws in w.items():
                    np.testing.assert_allclose(got[v][n][s], ws, rtol=tol,
                                               atol=tol, err_msg=f"{what} {v}/{n}/{s}")
            else:
                np.testing.assert_allclose(got[v][n], w, rtol=tol, atol=tol,
                                           err_msg=f"{what} {v}/{n}")


def _tbptt_confs():
    def conf(b, lstm, out, it):
        return (b.builder().seed(4).graph_builder()
                .add_inputs("in").set_input_types(it.recurrent(5))
                .add_layer("lstm", lstm(n_out=6), "in")
                .add_layer("out", out(n_out=5), "lstm")
                .set_outputs("out").t_bptt_length(7, 3).build())
    return (conf(JNNC, JLSTM, JRnnOut, JIT),
            conf(NeuralNetConfiguration, LSTMLayer, RnnOutputLayer, InputType))


def _confs(which):
    if which == "transformer_lm":
        return jzoo.TransformerLM(**EX11).conf(), TransformerLM(**EX11).conf()
    if which == "tbptt":
        return _tbptt_confs()
    with zipfile.ZipFile(GRAPH_ZIP) as z:
        text = z.read("configuration.json").decode()
    return JGraphConf.from_json(text), ComputationGraphConfiguration.from_json(text)


@pytest.mark.parametrize("which", ["transformer_lm", "tbptt", "regression_graph"])
def test_configuration_reads_both_ways(which):
    jconf, tconf = _confs(which)
    want = json.loads(jconf.to_json())
    assert json.loads(tconf.to_json()) == want
    # port -> JAX -> port, and JAX -> port, through JSON and YAML
    assert json.loads(JGraphConf.from_json(tconf.to_json()).to_json()) == want
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == want
    assert json.loads(ComputationGraphConfiguration.from_yaml(
        jconf.to_yaml()).to_json()) == want
    assert json.loads(JGraphConf.from_yaml(tconf.to_yaml()).to_json()) == want
    assert back.topo_order == jconf.topo_order
    assert (back.backprop_type, back.tbptt_fwd_length, back.tbptt_bwd_length) \
        == (jconf.backprop_type, jconf.tbptt_fwd_length, jconf.tbptt_bwd_length)


def test_tbptt_builder_settings():
    _, tconf = _tbptt_confs()
    assert (tconf.backprop_type, tconf.tbptt_fwd_length,
            tconf.tbptt_bwd_length) == ("truncated_bptt", 7, 3)
    conf = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
            .add_layer("out", RnnOutputLayer(n_in=3, n_out=2), "in")
            .set_outputs("out").backprop_type("TBPTT").build())
    assert conf.backprop_type == "truncated_bptt"
    with pytest.raises(ValueError, match="unknown backprop_type"):
        NeuralNetConfiguration.builder().graph_builder().backprop_type("bogus")


def test_unported_vertex_is_refused_by_name():
    """Every vertex of the JAX package reads back (MergeVertex here); a
    vertex tag the port does not know is refused by name."""
    jconf = (JNNC.builder().graph_builder().add_inputs("a", "b")
             .add_vertex("merge", JMerge(), "a", "b")
             .add_layer("out", JRnnOut(n_in=6, n_out=2), "merge")
             .set_outputs("out").build())
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert conf.to_dict() == jconf.to_dict()
    d = jconf.to_dict()
    for vd in d["vertices"]:
        if vd["name"] == "merge":
            vd["def"]["@vertex"] = "WarpVertex"
    with pytest.raises(NotImplementedError, match="'WarpVertex' is not ported"):
        ComputationGraphConfiguration.from_dict(d)


def _graph_batch():
    rng = np.random.default_rng(1)
    xa = rng.normal(size=(2, 10, 6)).astype(np.float32)
    xb = rng.normal(size=(2, 10, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, (2, 10)).reshape(-1)].reshape(2, 10, 3)
    return xa, xb, y


def test_port_reproduces_the_graph_fixture_and_keeps_training():
    expected = np.load(os.path.join(FIXTURES, "regression_graph_v1_expected.npz"))
    net = ms.restore_computation_graph(GRAPH_ZIP, device="cpu")
    assert isinstance(net, ComputationGraph)
    assert (net.iteration, net.epoch) == (1, 1)
    out = net.output(expected["probe_a"], expected["probe_b"])
    np.testing.assert_allclose(out.numpy(), expected["output"],
                               rtol=FIXTURE_RTOL, atol=FIXTURE_ATOL)
    # the zip has no qkv_layout stamp: both packages repack alike
    jnet = jms.restore_computation_graph(GRAPH_ZIP)
    _assert_close(export_params(net), to_np(jnet.params), 0.0, "params")
    _assert_close(export_updater_state(net), to_np(jnet.updater_states), 0.0,
                  "state")
    xa, xb, y = _graph_batch()
    grads, _ = net.compute_gradient_and_score([xa, xb], [y])
    jgrads, _ = jnet.compute_gradient_and_score([xa, xb], [y])
    layer = net.conf.vertices["att"].obj
    key_bias = np.zeros((layer.n_heads, 3, layer._dh()), bool)
    key_bias[:, 1] = True  # head-major [H, 3, Dh] columns: K is part 1
    key_bias = key_bias.reshape(-1)
    for v, named in to_np(jgrads).items():
        for n, want in named.items():
            got = grads[v][n].numpy()
            np.testing.assert_allclose(got, want, rtol=0, err_msg=f"{v}/{n}",
                                       atol=GRAD_TOL * np.abs(want).max())
    for g in (grads["att"]["bqkv"].numpy(), np.asarray(jgrads["att"]["bqkv"])):
        assert np.abs(g[key_bias]).max() < KEY_BIAS_GRAD
    net.fit(MultiDataSet([xa, xb], [y]))
    jnet.fit([JMultiDataSet([xa, xb], [y])])
    assert net.iteration == jnet.iteration == 2
    np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
    got, want = export_params(net), to_np(jnet.params)
    got_s, want_s = export_updater_state(net), to_np(jnet.updater_states)
    for params, slots in ((got, got_s), (want, want_s)):
        params["att"]["bqkv"] = params["att"]["bqkv"][~key_bias]
        for s in slots["att"]["bqkv"]:
            slots["att"]["bqkv"][s] = slots["att"]["bqkv"][s][~key_bias]
    _assert_close(got, want, STEP_TOL, "params")
    _assert_close(got_s, want_s, STEP_TOL, "state")


def _trained_pair():
    jnet = JaxGraph(jzoo.TransformerLM(**EX11).conf()).init()
    x = np.random.default_rng(0).integers(0, 11, (4, 12)).astype(np.float32)
    jnet.fit(x, lm_labels(x, 11))
    return jnet, x


def test_transformer_zips_load_both_ways(tmp_path):
    jnet, x = _trained_pair()
    jzip, pzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jms.write_model(jnet, jzip)
    net = ComputationGraph.load(jzip, device="cpu")
    assert net.iteration == jnet.iteration == 1
    _assert_close(export_params(net), to_np(jnet.params), 0.0, "params")
    _assert_close(export_updater_state(net), to_np(jnet.updater_states), 0.0,
                  "state")
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(net.output(x).numpy(), want, rtol=0, atol=OUT_TOL)

    net.fit(x, lm_labels(x, 11))  # a step of the port's own, then its zip
    net.save(pzip)
    back = jms.restore_computation_graph(pzip)
    assert back.iteration == net.iteration == 2
    _assert_close(to_np(back.params), export_params(net), 0.0, "params")
    _assert_close(to_np(back.updater_states), export_updater_state(net), 0.0,
                  "state")
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x).numpy(),
                               rtol=0, atol=OUT_TOL)
    same = ms.restore_model(pzip, device="cpu")
    _assert_close(export_updater_state(same), export_updater_state(net), 0.0,
                  "state")
    with pytest.raises(ValueError) as terr:
        ms.restore_multi_layer_network(pzip, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jms.restore_multi_layer_network(pzip)
    assert str(terr.value) == str(jerr.value)


def test_zip_without_updater_state(tmp_path):
    jnet, x = _trained_pair()
    net = load_reference_params(TransformerLM(**EX11).init(device="cpu"),
                                to_np(jnet.params))
    net.fit(x, lm_labels(x, 11))
    path = tmp_path / "params_only.zip"
    net.save(path, save_updater=False)
    with zipfile.ZipFile(path) as z:
        assert "updater.npz" not in z.namelist()
    back = ComputationGraph.load(path, device="cpu")
    _assert_close(export_params(back), export_params(net), 0.0, "params")
    fresh = TransformerLM(**EX11).init(device="cpu")
    _assert_close(export_updater_state(back), export_updater_state(fresh), 0.0,
                  "state")
    jback = jms.restore_computation_graph(path)
    _assert_close(to_np(jback.params), export_params(net), 0.0, "params")
