"""The port's model zip (``util/model_serializer.py``) on the CPU, against
the JAX package's: the same entries and keys, read both ways.

- The committed fixture ``tests/fixtures/regression_model_v1.zip`` (a
  small conv net written by the JAX package, with Adam state and no
  ``qkv_layout`` stamp) restores in the port and reproduces
  ``regression_model_v1_expected.npz``'s output from its probe within
  rtol 1e-5 / atol 1e-6 (the CPU convolution sums in another order than
  XLA's), then takes one more ``fit`` step from the restored Adam state,
  as the JAX package does (2e-5, the step tolerance of
  ``tests/test_helpers.py:307``).
- A port zip restores in the JAX package and a JAX zip in the port: the
  same ``output`` within 1e-5 and the same ``params.npz`` and
  ``updater.npz`` keys and shapes (AMSGrad's ``v_hat`` included).
- A zip whose arrays disagree with its configuration is refused with the
  reference's message; so are a damaged one and layer state; a graph zip
  restores as a graph, and is refused as a MultiLayerNetwork with the
  reference's message.
- A zip without the ``qkv_layout`` stamp has its fused attention columns
  repacked as the reference repacks them.
"""

import io
import json
import os
import zipfile

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.layers import SelfAttentionLayer as JAttn
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as ms
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
    load_reference_updater_state,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
V1_ZIP = os.path.join(FIXTURES, "regression_model_v1.zip")
FIXTURE_RTOL, FIXTURE_ATOL = 1e-5, 1e-6
STEP_TOL, OUT_TOL = 2e-5, 1e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _assert_tree(got, want, tol, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"{what} layer {i}"
        for n in w:
            if isinstance(w[n], dict):
                assert set(g[n]) == set(w[n])
                for s in w[n]:
                    np.testing.assert_allclose(g[n][s], w[n][s], rtol=tol, atol=tol,
                                               err_msg=f"{what} {i}/{n}/{s}")
            else:
                np.testing.assert_allclose(g[n], w[n], rtol=tol, atol=tol,
                                           err_msg=f"{what} {i}/{n}")


def _entries(path):
    """{entry: {key: shape}} of a zip's npz entries, and its meta."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in ("params.npz", "updater.npz"):
            if name in z.namelist():
                data = np.load(io.BytesIO(z.read(name)))
                out[name] = {k: data[k].shape for k in data.files}
        meta = json.loads(z.read("meta.json"))
    return out, meta


def _conv_net(updater):
    conf = (JNNC.builder().seed(9).updater(updater).list()
            .layer(JConv(n_out=3, kernel_size=(3, 3), activation="relu"))
            .layer(JPool(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JOut(n_out=4))
            .set_input_type(JIT.convolutional(8, 7, 2)).build())
    return JaxMLN(conf).init()


def _data(seed, n=6, shape=(8, 7, 2), classes=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *shape)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def test_port_reproduces_the_v1_fixture():
    expected = np.load(os.path.join(FIXTURES, "regression_model_v1_expected.npz"))
    net = ms.restore_multi_layer_network(V1_ZIP, device="cpu")
    assert (net.iteration, net.epoch) == (2, 2)
    np.testing.assert_allclose(net.output(expected["probe"]).numpy(),
                               expected["output"], rtol=FIXTURE_RTOL,
                               atol=FIXTURE_ATOL)
    # one more step from the restored Adam state, beside the JAX package's
    jnet = jms.restore_multi_layer_network(V1_ZIP)
    _assert_tree(export_updater_state(net), to_np(jnet.updater_states), 0.0, "state")
    x, y = _data(1, n=16, shape=(8, 8, 1), classes=3)
    net.fit(DataSet(x, y))
    jnet.fit(x, y)
    assert net.iteration == jnet.iteration == 3
    np.testing.assert_allclose(net.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree(export_params(net), to_np(jnet.params), STEP_TOL, "param")
    _assert_tree(export_updater_state(net), to_np(jnet.updater_states), STEP_TOL,
                 "state")


@pytest.mark.parametrize("updater", ["adam", "amsgrad"])
def test_zips_load_both_ways(tmp_path, updater):
    ju = JU.Adam(1e-2) if updater == "adam" else JU.AMSGrad(1e-2)
    jnet = _conv_net(ju)
    x, y = _data(2)
    jnet.fit(x, y)
    jnet.fit(x, y)
    jzip, pzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jms.write_model(jnet, jzip)

    # a JAX zip restored by the port
    net = MultiLayerNetwork.load(jzip, device="cpu")
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch) == (2, 2)
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=OUT_TOL)
    _assert_tree(export_updater_state(net), to_np(jnet.updater_states), 0.0, "state")

    # a port zip restored by the JAX package
    net.save(pzip)
    back = jms.restore_multi_layer_network(pzip)
    assert back.conf.to_dict() == jnet.conf.to_dict()
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x).numpy(),
                               rtol=0, atol=OUT_TOL)
    _assert_tree(to_np(back.params), export_params(net), 0.0, "param")
    _assert_tree(to_np(back.updater_states), export_updater_state(net), 0.0, "state")
    (jent, jmeta), (pent, pmeta) = _entries(jzip), _entries(pzip)
    assert jent == pent and set(jent) == {"params.npz", "updater.npz"}
    if updater == "amsgrad":
        assert "0/W/v_hat" in pent["updater.npz"]
    assert {k: pmeta[k] for k in ("iteration", "epoch", "qkv_layout")} == \
        {k: jmeta[k] for k in ("iteration", "epoch", "qkv_layout")}
    assert pmeta["framework"] == "deeplearning4j_tpu_torch"


def test_save_without_updater(tmp_path):
    jnet = _conv_net(JU.Adam(1e-2))
    conf = MultiLayerConfiguration.from_dict(jnet.conf.to_dict())
    net = load_reference_params(MultiLayerNetwork(conf, device="cpu").init(),
                                to_np(jnet.params))
    net.save(tmp_path / "m.zip", save_updater=False)
    assert set(_entries(tmp_path / "m.zip")[0]) == {"params.npz"}
    back = MultiLayerNetwork.load(tmp_path / "m.zip", load_updater=False, device="cpu")
    _assert_tree(export_params(back), export_params(net), 0.0, "param")
    assert not ms.validate_model_zip(tmp_path / "m.zip")


def _rewrite_conf(src, dst, edit):
    with zipfile.ZipFile(src) as z:
        conf = json.loads(z.read("configuration.json"))
    with open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    edit(conf)
    ms.replace_zip_entry(dst, "configuration.json", json.dumps(conf).encode())


def test_shape_mismatch_is_refused_with_the_reference_message(tmp_path):
    bad = tmp_path / "bad.zip"

    def widen(conf):
        conf["layers"][2]["n_out"] = 5  # the dense W is [36, 12] in the zip
    _rewrite_conf(V1_ZIP, bad, widen)
    with pytest.raises(ValueError) as port_err:
        ms.restore_multi_layer_network(bad, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jms.restore_multi_layer_network(bad)
    assert "2/W has shape (36, 12) but the configuration allocates (36, 5)" in \
        str(port_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_damaged_graph_and_stateful_zips_are_refused(tmp_path):
    # a graph zip restores as a graph (test_torch_graph_serde.py holds it
    # to its expected output); asked for as a MultiLayerNetwork it is
    # refused with the reference's message
    graph_zip = os.path.join(FIXTURES, "regression_graph_v1.zip")
    graph = ms.restore_model(graph_zip, device="cpu")
    assert type(graph).__name__ == "ComputationGraph"
    assert sorted(graph.params) == sorted(jms.restore_model(graph_zip).params)
    with pytest.raises(ValueError) as port_err:
        ms.restore_multi_layer_network(graph_zip, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jms.restore_multi_layer_network(graph_zip)
    assert str(port_err.value) == str(jax_err.value)
    torn = tmp_path / "torn.zip"
    with open(V1_ZIP, "rb") as f:
        torn.write_bytes(f.read()[:300])
    assert ms.validate_model_zip(torn) == jms.validate_model_zip(torn) != []
    with pytest.raises(ValueError, match="failed integrity validation"):
        ms.restore_multi_layer_network(torn, device="cpu")
    stateful = tmp_path / "stateful.zip"
    with open(V1_ZIP, "rb") as f:
        stateful.write_bytes(f.read())
    buf = io.BytesIO()
    np.savez(buf, **{"1/mean": np.zeros(3, np.float32)})
    ms.replace_zip_entry(stateful, "states.npz", buf.getvalue())
    # a layer state the configuration does not hold (layer 1 has no
    # BatchNorm) is refused by name
    with pytest.raises(ValueError, match="1/mean is not a layer state"):
        ms.restore_multi_layer_network(stateful, device="cpu")
    with zipfile.ZipFile(stateful) as z, zipfile.ZipFile(V1_ZIP) as v1:
        # the other entries survive the rewrite
        assert sorted(z.namelist()) == sorted(v1.namelist() + ["states.npz"])


def test_unstamped_zip_repacks_fused_qkv_as_the_reference(tmp_path):
    conf = (JNNC.builder().seed(3).updater(JU.Adam(1e-2)).list()
            .layer(JAttn(n_out=8, n_heads=2, head_size=4))
            .layer(JRnnOut(n_out=3))
            .set_input_type(JIT.recurrent(6, 5)).build())
    jnet = JaxMLN(conf).init()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5))]
    jnet.fit(x, y)
    path = tmp_path / "legacy.zip"
    jms.write_model(jnet, path)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    del meta["qkv_layout"]
    ms.replace_zip_entry(path, "meta.json", json.dumps(meta).encode())
    net = ms.restore_multi_layer_network(path, device="cpu")
    ref = jms.restore_multi_layer_network(path)
    _assert_tree(export_params(net), to_np(ref.params), 0.0, "param")
    _assert_tree(export_updater_state(net), to_np(ref.updater_states), 0.0, "state")
    assert not np.allclose(export_params(net)[0]["Wqkv"], np.asarray(jnet.params[0]["Wqkv"]))
    # the same weights through the stamped zip need no repack
    stamped = load_reference_updater_state(
        load_reference_params(MultiLayerNetwork(net.conf, device="cpu").init(),
                              to_np(jnet.params)), to_np(jnet.updater_states))
    np.testing.assert_allclose(stamped.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=OUT_TOL)
