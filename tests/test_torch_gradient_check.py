"""The port's gradient check on the CPU against the JAX package's.

Narrow networks built by both packages with the JAX network's weights
carried across — dense (tanh, softmax, l2), convolutional (conv, max pool,
dense, softmax), recurrent (LSTM with a feature mask, RNN output) and a
two-input graph — go through ``check_model_gradients`` /
``check_graph_gradients`` in both, at the reference's epsilon (1e-6) and
max relative error (1e-5), on 6 sampled coordinates a parameter and on
every coordinate. Each gives the reference's verdict, checks the coordinates the
reference draws (its leaves in ``tree_flatten`` order, one
``default_rng(seed)``), and reports a worst relative error within 1e-6 of
the reference's (which prints it to 3 digits). A loss whose gradient is
cut fails in both, at the same coordinates.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.util import gradient_check as jgc
from deeplearning4j_tpu_torch.nn import layers as PL
from deeplearning4j_tpu_torch.nn import vertices as PV
from deeplearning4j_tpu_torch.util import gradient_check as tgc
from test_torch_earlystopping import REF, pair

ERR_TOL = 1e-6


def dense(s, kind="mln"):
    L = JL if s is REF else PL
    return (s.nnc.builder().seed(2).l2(1e-3).list()
            .layer(L.DenseLayer(n_out=5, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(s.it.feed_forward(4)).build())


def conv(s, kind="mln"):
    L = JL if s is REF else PL
    return (s.nnc.builder().seed(2).list()
            .layer(L.ConvolutionLayer(n_out=2, kernel_size=(3, 3), activation="tanh"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), pooling_type="max"))
            .layer(L.DenseLayer(n_out=4, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(s.it.convolutional(6, 6, 1)).build())


def lstm(s, kind="mln"):
    L = JL if s is REF else PL
    return (s.nnc.builder().seed(2).list()
            .layer(L.LSTMLayer(n_out=4, activation="tanh"))
            .layer(L.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(s.it.recurrent(3)).build())


def graph(s, kind="graph"):
    L, V = (JL, JV) if s is REF else (PL, PV)
    return (s.nnc.builder().seed(2).l2(1e-3).graph_builder()
            .add_inputs("a", "b")
            .set_input_types(s.it.feed_forward(3), s.it.feed_forward(2))
            .add_layer("da", L.DenseLayer(n_out=4, activation="tanh"), "a")
            .add_layer("db", L.DenseLayer(n_out=3, activation="sigmoid"), "b")
            .add_vertex("m", V.MergeVertex(), "da", "db")
            .add_layer("out", L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"), "m")
            .set_outputs("out").build())


def inputs(name):
    rng = np.random.default_rng(8)
    if name == "dense":
        return rng.normal(size=(5, 4)), np.eye(3)[rng.integers(0, 3, 5)], {}
    if name == "conv":
        return rng.normal(size=(3, 6, 6, 1)), np.eye(3)[rng.integers(0, 3, 3)], {}
    if name == "lstm":
        mask = np.ones((2, 5))
        mask[1, 3:] = 0.0
        return (rng.normal(size=(2, 5, 3)), np.eye(3)[rng.integers(0, 3, (2, 5))],
                {"features_mask": mask})
    return ([rng.normal(size=(4, 3)), rng.normal(size=(4, 2))],
            np.eye(2)[rng.integers(0, 2, 4)], {})


NETS = {"dense": dense, "conv": conv, "lstm": lstm, "graph": graph}


def reference_coordinates(params, subset, seed):
    rng = np.random.default_rng(seed)
    out = []
    for li, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        n = int(np.asarray(leaf).size)
        idxs = (rng.choice(n, size=min(subset, n), replace=False)
                if subset is not None and subset < n else range(n))
        out += [(li, int(i)) for i in idxs]
    return out


def worst_printed(text):
    return float(re.search(r"max rel error \(significant\): (\S+)", text).group(1))


# six sampled coordinates a parameter for every network (the reference's 64
# would take every coordinate of these narrow layers), every coordinate of
# the dense network and the graph
CASES = [(name, 6) for name in sorted(NETS)] + [("dense", None), ("graph", None)]


@pytest.mark.parametrize("name,subset", CASES)
def test_check_matches_the_reference(name, subset, capsys):
    kind = "graph" if name == "graph" else "mln"
    j, t = pair(NETS[name], kind)
    x, y, kw = inputs(name)
    report = {}
    if kind == "graph":
        want = jgc.check_graph_gradients(j, x, y, subset=subset, seed=3, print_results=True)
        printed = capsys.readouterr().out
        got = tgc.check_graph_gradients(t, x, y, subset=subset, seed=3, report=report)
    else:
        want = jgc.check_model_gradients(j, x, y, subset=subset, seed=3,
                                         print_results=True, **kw)
        printed = capsys.readouterr().out
        got = tgc.check_model_gradients(t, x, y, subset=subset, seed=3, report=report, **kw)
    assert got == want is True
    assert report["coordinates"] == reference_coordinates(j.params, subset, 3)
    assert abs(report["max_rel_error"] - worst_printed(printed)) <= ERR_TOL
    assert report["failures"] == []
    # the check ran on float64 copies: the network's tensors are untouched
    assert all(v.dtype == torch.float32 for named in t.params.values()
               for v in named.values())


def test_a_cut_gradient_fails_in_both_at_the_same_coordinates(capsys):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(3, 2)), rng.normal(size=4)

    def ref_loss(p):
        return jnp.sum(jnp.tanh(p["a"]) ** 2) + jnp.sum(jax.lax.stop_gradient(p["b"]) ** 2)

    def port_loss(p):
        return torch.sum(torch.tanh(p["a"]) ** 2) + torch.sum(p["b"].detach() ** 2)

    want = jgc.check_gradients_fn(ref_loss, {"b": b, "a": a}, print_results=True)
    fails = re.findall(r"FAIL leaf (\d+) idx (\d+)", capsys.readouterr().out)
    report = {}
    got = tgc.check_gradients_fn(port_loss, {"b": torch.tensor(b), "a": torch.tensor(a)},
                                 report=report)
    assert got is want is False
    assert [(li, i) for li, i, *_ in report["failures"]] == [(int(li), int(i))
                                                            for li, i in fails]
    assert {li for li, _ in report["coordinates"]} == {0, 1}
    assert len(report["failures"]) == 4  # every entry of "b" (leaf 1, after "a")
