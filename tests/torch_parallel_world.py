"""The port's side of the parallel-training parity tests, run in a gloo
world of several CPU ranks.

``tests/test_torch_parallel_trainer.py`` writes every scenario's inputs
(the JAX networks' initial parameters as numpy arrays, and the data) to a
pickle, then starts ``WORLD`` ranks of :func:`rank_main` with
``torch.multiprocessing`` and a ``file://`` store. Every rank runs every
scenario (each one's collectives need all of them) on one torch thread;
rank 0 writes each scenario's results (numpy arrays, numbers, strings) to
a second pickle, which the test cases hold against the JAX package's run
of the same scenario on a mesh of the same shape.

This module imports torch and the port only.
"""

from __future__ import annotations

import datetime
import pickle
import re
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ------------------------------------------------------------- the networks
def small_net(updater="sgd", lr=0.1, seed=7):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam, Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Sgd(lr) if updater == "sgd" else Adam(lr)).list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def ffn_net():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(DenseLayer(n_in=32, n_out=128, activation="relu"))
            .layer(DenseLayer(n_in=128, n_out=32, activation="identity"))
            .layer(OutputLayer(n_in=32, n_out=8, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def conv_bn_net(seed=3, lr=0.05):
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalizationLayer, ConvolutionLayer, DenseLayer, OutputLayer,
        SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr)).list()
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    convolution_mode="same", activation="identity"))
            .layer(BatchNormalizationLayer())
            .layer(ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                    convolution_mode="same", activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def lstm_net():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(0.01)).list()
            .layer(LSTMLayer(n_in=4, n_out=8))
            .layer(RnnOutputLayer(n_in=8, n_out=3))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def encoder(d_model=16, n_heads=2, d_ff=32, seed=11):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import TransformerEncoder

    return ComputationGraph(TransformerEncoder(
        num_labels=4, vocab_size=32, max_length=8, n_layers=1, d_model=d_model,
        n_heads=n_heads, d_ff=d_ff, seed=seed).conf(), device="cpu").init()


def tiny_lm(seed=7):
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    return TransformerLM(vocab_size=64, max_length=8, n_layers=1, d_model=16,
                         n_heads=4, d_ff=32, seed=seed).init(device="cpu")


def carried(net, inp):
    """``net`` with the reference's initial parameters (and layer states,
    when given) copied in."""
    from deeplearning4j_tpu_torch.util import convert

    convert.load_reference_params(net, inp["params"])
    if inp.get("states") is not None:
        convert.load_reference_states(net, inp["states"])
    return net


def exported(net) -> dict:
    from deeplearning4j_tpu_torch.util import convert

    return {"params": convert.export_params(net), "states": convert.export_states(net),
            "updater": convert.export_updater_state(net)}


def mesh(axes):
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes, device_type="cpu")


def batches(x, y, size):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    return [DataSet(x[s:s + size], y[s:s + size]) for s in range(0, len(x), size)]


def comm_counts(mode) -> dict:
    """``CommDebugMode``'s counts by collective name (all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, ...)."""
    out = {}
    for op, n in mode.get_comm_counts().items():
        name = re.sub(r"^.*\.", "", str(op))
        out[name] = out.get(name, 0) + int(n)
    return out


def specs_by_path(params) -> dict:
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of

    return {f"{k}/{n}": tuple(spec_of(t)) for k, named in params.items()
            for n, t in named.items()}


# ----------------------------------------------------------------- the mesh
@scenario
def mesh_infer(inp):
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_axes

    return {"axes": mesh_axes(mesh({"data": -1}))}


@scenario
def mesh_2d(inp):
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_axes

    return {"axes": mesh_axes(mesh({"data": 2, "model": 2}))}


@scenario
def mesh_infers_one_axis(inp):
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_axes, parse_mesh_axes

    return {"axes": mesh_axes(mesh(parse_mesh_axes("data=-1,model=2")))}


@scenario
def rules_degrade(inp):
    from deeplearning4j_tpu_torch.parallel.sharding import shard_model_with_rules

    net = carried(tiny_lm(), inp)
    shard_model_with_rules(net, mesh({"data": 4}))
    return {"specs": specs_by_path(net.params)}


# ---------------------------------------------------- ParallelWrapper modes
@scenario
def sg_matches_single(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(), inp)
    ParallelWrapper(net, mesh({"data": 4}), mode="shared_gradients").fit(inp["x"], inp["y"])
    return exported(net)


@scenario
def sg_adam_multi(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(updater="adam"), inp)
    ParallelWrapper(net, mesh({"data": 4}), mode="shared_gradients").fit(
        batches(inp["x"], inp["y"], 16), epochs=2)
    return exported(net)


@scenario
def avg_freq1(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(), inp)
    ParallelWrapper(net, mesh({"data": 4}), mode="averaging",
                    averaging_frequency=1).fit(inp["x"], inp["y"])
    return exported(net)


@scenario
def avg_freq4(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(), inp)
    heard = []

    class Listener:
        def iteration_done(self, model, iteration, epoch):
            heard.append(iteration)

    net.set_listeners(Listener())
    pw = ParallelWrapper(net, mesh({"data": 4}), mode="averaging", averaging_frequency=4)
    scores = []
    for _ in range(6):
        pw.fit(batches(inp["x"], inp["y"], 32))
        scores.append(net.score_)
    return {**exported(net), "scores": scores, "iteration": net.iteration,
            "heard": heard}


@scenario
def ragged_tail(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    out = {}
    for mode in ("shared_gradients", "averaging"):
        net = carried(small_net(), inp)
        ParallelWrapper(net, mesh({"data": 4}), mode=mode, averaging_frequency=1).fit(
            batches(inp["x"], inp["y"], 16))
        out[mode] = exported(net)
    return out


@scenario
def avg_rejects_tp(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    try:
        ParallelWrapper(small_net(), mesh({"data": 2, "model": 2}), mode="averaging",
                        tp_axis="model")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


@scenario
def tp_step(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(), inp)
    ParallelWrapper(net, mesh({"data": 2, "model": 2}), mode="shared_gradients",
                    tp_axis="model").fit(inp["x"], inp["y"])
    return {**exported(net), "specs": specs_by_path(net.params)}


@scenario
def tp_transformer(inp):
    from deeplearning4j_tpu_torch.parallel.sharding import shard_model

    net = carried(encoder(), inp)
    shard_model(net, mesh({"data": 2, "model": 2}), tp_axis="model")
    before = net.output_single(inp["x"]).numpy()
    net.fit(inp["x"], inp["y"])
    after = net.output_single(inp["x"]).numpy()
    return {"before": before, "after": after, "specs": specs_by_path(net.params)}


# ----------------------------------------------------------- conv + BatchNorm
@scenario
def bn_shared(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(conv_bn_net(), inp)
    pw = ParallelWrapper(net, mesh({"data": 4}), mode="shared_gradients")
    for _ in range(3):
        pw.fit(inp["x"], inp["y"])
    return exported(net)


@scenario
def bn_avg_sim(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.util import convert

    k, workers = 2, WORLD
    x, y = inp["x"], inp["y"]
    net = carried(conv_bn_net(), inp)
    ParallelWrapper(net, mesh({"data": workers}), mode="averaging",
                    averaging_frequency=k).fit(batches(x, y, 32))
    # the per-worker simulation: each worker's k local steps from the same
    # start on its block of each batch, then the plain average
    sims = []
    for w in range(workers):
        worker = carried(conv_bn_net(), inp)
        for step in range(k):
            xb, yb = x[step * 32:(step + 1) * 32], y[step * 32:(step + 1) * 32]
            lo, hi = w * (32 // workers), (w + 1) * (32 // workers)
            worker.fit(xb[lo:hi], yb[lo:hi])
        sims.append(exported(worker))
    mean = {part: _tree_mean([s[part] for s in sims]) for part in sims[0]}
    del convert
    return {"wrapper": exported(net), "simulation": mean}


def _tree_mean(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_mean([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_tree_mean([t[i] for t in trees]) for i in range(len(first))]
    return sum(np.asarray(t, np.float64) for t in trees) / len(trees)


@scenario
def bn_avg_mean(inp):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(conv_bn_net(), inp)
    ParallelWrapper(net, mesh({"data": 4}), mode="averaging",
                    averaging_frequency=1).fit(inp["x"], inp["y"])
    ref = carried(conv_bn_net(), inp)
    ref.fit(inp["x"], inp["y"])
    return {**exported(net), "single": exported(ref)}


# ---------------------------------------------------------------- evaluate
@scenario
def evaluate(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(small_net(), inp)
    net.fit(inp["x"], inp["y"])
    single = net.evaluate(ListDataSetIterator(DataSet(inp["x"], inp["y"]), 16))
    out = {"single": single.confusion.copy()}
    for mode in ("shared_gradients", "averaging"):
        pw = ParallelWrapper(net, mesh({"data": 4}), mode=mode)
        e = pw.evaluate(ListDataSetIterator(DataSet(inp["x"], inp["y"]), 16), top_n=2)
        ragged = pw.evaluate(ListDataSetIterator(DataSet(inp["x"], inp["y"]), 18))
        out[mode] = {"confusion": e.confusion.copy(), "accuracy": e.accuracy(),
                     "top_n": e.top_n_accuracy(), "ragged": ragged.confusion.copy()}
    return out


@scenario
def evaluate_masked(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    net = carried(lstm_net(), inp)
    ds = DataSet(inp["x"], inp["y"], inp["m"], inp["m"])
    single = net.evaluate(ListDataSetIterator(ds, 8))
    pw = ParallelWrapper(net, mesh({"data": 4}), mode="shared_gradients")
    dist_e = pw.evaluate(ListDataSetIterator(ds, 8))
    return {"single": single.confusion.copy(), "mesh": dist_e.confusion.copy()}


# ------------------------------------------------------- 2-D, rules, vocab
@scenario
def e2e_graph_2d(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.sharding import shard_model_with_rules

    net = carried(tiny_lm(seed=11), inp)
    shard_model_with_rules(net, mesh({"data": 2, "model": 2}))
    ds = DataSet(inp["x"], inp["y"])
    scores = []
    for _ in range(2):
        net.fit(ds)
        scores.append(net.score_)
    return {**exported(net), "scores": scores, "output": net.output(inp["x"]).numpy(),
            "specs": specs_by_path(net.params)}


@scenario
def e2e_mln_2d(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.sharding import P, shard_model_with_rules

    net = carried(small_net(seed=5), inp)
    shard_model_with_rules(net, mesh({"data": 2, "model": 2}), [
        ("(^|/)0/W$", P(None, "model")), ("(^|/)0/b$", P("model")),
        ("(^|/)1/W$", P("model", None)), (".*", P())])
    placed = specs_by_path(net.params)
    net.fit(DataSet(inp["x"], inp["y"]))
    return {**exported(net), "placed": placed, "after": specs_by_path(net.params),
            "score": net.score_, "output": net.output(inp["x"]).numpy()}


def _lm_forward_counts(net, x):
    from torch.distributed.tensor.debug import CommDebugMode

    from deeplearning4j_tpu_torch.nn.dtensor import mesh_scope
    from deeplearning4j_tpu_torch.parallel.sharding import place_batch

    xs = place_batch(torch.as_tensor(x), net._mesh)
    with torch.no_grad(), mesh_scope(net), CommDebugMode() as cm:
        net._forward_all(net.params, {"tokens": xs})
    return comm_counts(cm)


@scenario
def comm_vocab(inp):
    from torch.distributed.tensor.debug import CommDebugMode

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.sharding import place_batch, shard_model_with_rules

    m = mesh({"data": 2, "model": 2})
    net = carried(tiny_lm(), inp)
    shard_model_with_rules(net, m)
    forward = _lm_forward_counts(net, inp["x"])
    ds = DataSet(place_batch(inp["x"], m), place_batch(inp["y"], m))
    with CommDebugMode() as cm, net.training_step():
        net._fit_batch(ds)
    step = comm_counts(cm)
    after_fit = _lm_forward_counts(net, inp["x"])
    return {"forward": forward, "step": step, "after_fit": after_fit,
            "specs": specs_by_path(net.params)}


@scenario
def comm_megatron(inp):
    from torch.distributed.tensor.debug import CommDebugMode

    from deeplearning4j_tpu_torch.nn.dtensor import mesh_scope
    from deeplearning4j_tpu_torch.parallel.sharding import (
        P, _place, place_batch, tp_param_specs)

    m = mesh({"data": 2, "model": 2})

    def legacy_specs(net):
        # the replaced every-layer output-dim rule, the comparator
        out = {}
        for k, p in net.params.items():
            d = {}
            for n, v in p.items():
                if v.ndim >= 2 and v.shape[-1] > 1:
                    d[n] = P(*([None] * (v.ndim - 1)), "model")
                elif v.ndim == 1 and v.shape[0] > 1:
                    d[n] = P("model")
                else:
                    d[n] = P()
            out[k] = d
        return out

    counts = {}
    for name, specs_fn in (("legacy", legacy_specs),
                           ("megatron", lambda net: tp_param_specs(net, "model", m))):
        net = carried(ffn_net(), inp)
        _place(net, m, specs_fn(net))
        xs = place_batch(torch.as_tensor(inp["x"]), m)
        with torch.no_grad(), mesh_scope(net), CommDebugMode() as cm:
            net._forward_all(net.params, xs)
        counts[name] = comm_counts(cm)
    return counts


@scenario
def comm_attention(inp):
    from torch.distributed.tensor.debug import CommDebugMode

    from deeplearning4j_tpu_torch.nn.dtensor import mesh_scope
    from deeplearning4j_tpu_torch.parallel.sharding import place_batch, shard_model

    m = mesh({"data": 2, "model": 2})
    net = carried(encoder(d_model=32, n_heads=4, d_ff=64, seed=2), inp)
    shard_model(net, m, tp_axis="model")
    xs = place_batch(torch.zeros((8, 8)), m)
    with torch.no_grad(), mesh_scope(net), CommDebugMode() as cm:
        net._forward_all(net.params, {"tokens": xs})
    return {"counts": comm_counts(cm), "specs": specs_by_path(net.params)}


# --------------------------------------------------------- the draws
@scenario
def draws(inp):
    """Train-time draws under the wrapper: in shared-gradients mode the
    network's own generator draws each mask whole (the same on every
    rank), so a dropout step equals the unplaced step; in averaging mode
    each rank draws from a generator of its own, seeded from a draw of
    the network's generator and the rank."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.util import convert

    def dropout_net():
        conf = (NeuralNetConfiguration.builder().seed(9).updater(Sgd(0.1)).list()
                .layer(DenseLayer(n_in=12, n_out=16, activation="tanh", dropout=0.5))
                .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                                   loss="negativeloglikelihood", dropout=0.5))
                .build())
        return MultiLayerNetwork(conf, device="cpu").init()

    net, ref = dropout_net(), dropout_net()
    ParallelWrapper(net, mesh({"data": 4}), mode="shared_gradients").fit(inp["x"], inp["y"])
    ref.fit(inp["x"], inp["y"])
    a, b = convert.export_params(net), convert.export_params(ref)
    shared_err = max(float(np.abs(a[i][n] - b[i][n]).max()) for i in range(2) for n in a[i])
    avg = dropout_net()
    pw = ParallelWrapper(avg, mesh({"data": 4}), mode="averaging")
    state = avg.dropout_generator.get_state()
    first = torch.rand(4, generator=pw._rank_generator())
    avg.dropout_generator.set_state(state)
    again = torch.rand(4, generator=pw._rank_generator())
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, first.tolist())
    return {"shared_err": shared_err, "ranks": ranks,
            "repeat_equal": bool(torch.equal(first, again))}


# ------------------------------------------------------ the kernel seams
def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


@scenario
def kernel_placements(inp):
    """The kernel wrappers (their plain versions on the CPU) on DTensors:
    each admitted placement against the plain tensors' result, and each
    refused one's error."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    from deeplearning4j_tpu_torch.nn import cuda_kernels as ck

    m = mesh({"data": 2, "model": 2})
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 4, 64, 64, generator=g) for _ in range(3))

    def put(t, pl):
        return distribute_tensor(t, m, pl, src_data_rank=None)

    out = {}
    pl = [Shard(0), Shard(1)]
    qd, kd, vd = (put(t, pl).requires_grad_(True) for t in (q, k, v))
    o = ck.flash_attention(qd, kd, vd, True)
    grads = torch.autograd.grad((o * o).sum(), [qd, kd, vd])
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    op = ck.flash_attention(qp, kp, vp, True)
    gp = torch.autograd.grad((op * op).sum(), [qp, kp, vp])
    out["attention_err"] = max(float((o.full_tensor() - op).abs().max()),
                               *(float((a.full_tensor() - b).abs().max())
                                 for a, b in zip(grads, gp)))
    out["attention_placements"] = [str(tuple(o.placements))] + [
        str(tuple(x.placements)) for x in grads]
    out["attention_seq_shard"] = _raises(lambda: ck.flash_attention_fwd(
        *(put(t, [Shard(0), Shard(2)]) for t in (q, k, v)), True))
    out["attention_mixed"] = _raises(lambda: ck.flash_attention_fwd(
        put(q, pl), put(k, [Shard(0), Replicate()]), put(v, pl), True))
    out["attention_plain_mixed"] = _raises(lambda: ck.flash_attention_fwd(
        put(q, pl), k, put(v, pl), True))
    # K2: one placement for the parameter, its moments and its gradient
    p, mm, vv, gg = (torch.randn(16, 8, generator=g) for _ in range(4))
    vv = vv.abs()
    coef = ck.adam_coefficients(ck.Adam(1e-2), 1e-2, 3.0)
    ref = [t.clone() for t in (p, mm, vv)]
    ck.fused_adam(ck.ADAM, *ref, None, gg, coef)
    dts = [put(t.clone(), [Replicate(), Shard(1)]) for t in (p, mm, vv)]
    ck.fused_adam(ck.ADAM, *dts, None, put(gg, [Replicate(), Shard(1)]), coef)
    out["adam_err"] = max(float((a.full_tensor() - b).abs().max()) for a, b in zip(dts, ref))
    partial = DTensorPartial(gg, m)
    out["adam_partial"] = _raises(lambda: ck.fused_adam(
        ck.ADAM, *[put(t.clone(), [Replicate(), Replicate()]) for t in (p, mm, vv)],
        None, partial, coef))
    # K1: xw [T,N,4H] batch-sharded, rw replicated, plain carries
    xw = torch.randn(5, 4, 32, generator=g)
    rw = torch.randn(8, 32, generator=g) * 0.3
    h0, c0 = torch.zeros(4, 8), torch.zeros(4, 8)
    ys, hn, cn = ck.lstm_sequence(put(xw, [Shard(1), Replicate()]), put(rw, [Replicate()] * 2),
                                  h0, c0)
    yr, hr, cr = ck.lstm_sequence(xw, rw, h0, c0)
    out["lstm_err"] = max(float((a.full_tensor() - b).abs().max())
                          for a, b in ((ys, yr), (hn, hr), (cn, cr)))
    out["lstm_time_shard"] = _raises(lambda: ck.lstm_sequence(
        put(xw, [Shard(0), Replicate()]), put(rw, [Replicate()] * 2), h0, c0))
    return out


def DTensorPartial(t, m):
    """``t`` as a DTensor whose placement on the data axis is a ``Partial``
    sum (each rank holding t / 2, whose sum is t)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    return DTensor.from_local(t / 2, m, [Partial(), Replicate()], run_check=False)


@scenario
def flash_lm_2d(inp):
    """A causal LM at T = 128 (the flash kernels' seam takes its attention:
    their plain versions on the CPU) on data=2, model=2 under the default
    rules, one SGD step against the same step unplaced: each parameter's
    largest difference over its largest entry."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel.sharding import shard_model_with_rules
    from deeplearning4j_tpu_torch.util import convert
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    def lm():
        conf = TransformerLM(vocab_size=64, max_length=128, n_layers=1, d_model=256,
                             n_heads=4, d_ff=64, seed=5).conf()
        for vd in conf.vertices.values():
            if vd.is_layer:
                vd.obj.updater = Sgd(0.5)
        return ComputationGraph(conf, device="cpu").init()

    ref, net = lm(), lm()
    shard_model_with_rules(net, mesh({"data": 2, "model": 2}))
    ds = DataSet(inp["x"], inp["y"])
    ref.fit(ds)
    net.fit(ds)
    a, b = convert.export_params(ref), convert.export_params(net)
    return {"score": net.score_, "ref_score": ref.score_,
            "err": {f"{k}/{n}": float(np.abs(a[k][n] - b[k][n]).max()
                                      / max(1e-12, np.abs(a[k][n]).max()))
                    for k in a for n in a[k]}}


# ----------------------------------------------------------- early stopping
@scenario
def early_stopping(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize import earlystopping as es

    out = {}
    for mode in ("shared_gradients", "averaging"):
        net = carried(small_net(updater="adam", lr=0.01), inp)
        train = ListDataSetIterator(DataSet(inp["x"], inp["y"]), 16)
        test = ListDataSetIterator(DataSet(inp["xt"], inp["yt"]), 16)
        cfg = es.EarlyStoppingConfiguration(
            score_calculator=es.DataSetLossCalculator(test, average=True),
            epoch_termination_conditions=[es.MaxEpochsTerminationCondition(3)])
        result = es.EarlyStoppingParallelTrainer(
            cfg, net, train, mesh=mesh({"data": 4}), mode=mode,
            averaging_frequency=2).fit()
        out[mode] = {"scores": dict(result.score_vs_epoch), "best_epoch": result.best_model_epoch,
                     "reason": result.termination_reason, "epochs": result.total_epochs,
                     **exported(net)}
    return out


# ------------------------------------------------------------------- ranks
def rank_main(rank: int, world: int, store: str, inputs: str, outputs: str,
              modules: tuple = ()) -> None:
    """One rank of the world: every scenario that has inputs in turn,
    after importing ``modules`` (test helper modules that add scenarios
    of their own); rank 0 writes the results (an ``{"error": traceback}``
    entry for a scenario that raised). ``store`` is an ``init_method``
    URL, or ``host:port``: then the ranks join as a launcher joins them,
    through ``parallel.master.init_distributed``, rank 0 serving the TCP
    store on the loopback address."""
    import importlib

    for m in modules:
        importlib.import_module(m)
    torch.set_num_threads(1)
    # a rank that fails alone leaves the others waiting in a collective:
    # they give up after the timeout instead of holding the test run
    if "://" in store:
        dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
    else:
        from deeplearning4j_tpu_torch.parallel.master import init_distributed

        init_distributed(store, num_processes=world, process_id=rank,
                         coordinator_bind_address="127.0.0.1", device_type="cpu")
    try:
        with open(inputs, "rb") as fh:
            inp = pickle.load(fh)
        results = {}
        for name, fn in SCENARIOS.items():
            if name not in inp:
                continue
            try:
                results[name] = fn(inp[name])
            except Exception:  # noqa: BLE001 - each case reports its own failure
                results[name] = {"__error__": traceback.format_exc()}
            dist.barrier()
        if rank == 0:
            with open(outputs, "wb") as fh:
                pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def run_world(inputs: str, outputs: str, store: str, world: int = WORLD,
              deadline_s: float = 600.0, modules: tuple = ()) -> None:
    """Start ``world`` ranks of :func:`rank_main` and wait for them, at
    most ``deadline_s`` seconds (then every rank is killed and it raises).
    ``modules`` are imported in every rank before the scenarios run (the
    scenarios they add join :data:`SCENARIOS`); a world runs only the
    scenarios that ``inputs`` holds, so each test file's world runs its
    own."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(rank_main, args=(world, store, inputs, outputs,
                                              tuple(modules)),
                             nprocs=world, start_method="spawn", join=False)
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, end - time.monotonic()))):
            if time.monotonic() > end:
                raise TimeoutError(f"the {world}-rank world ran past {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
