"""The port's side of the sharded-serving parity tests
(``tests/test_torch_sharded_serving.py``), run in the 4-rank gloo world of
``tests/torch_parallel_world.py``: each scenario here joins its
``SCENARIOS`` when a rank imports this module.

Every rank makes the same ``register`` calls (the SPMD program); rank 0
takes the requests, and the other ranks run its forwards in lockstep
inside ``follow()`` until rank 0's shutdown stops them. Rank 0's result
holds the answers; each rank's ``follow()`` count and time go through an
``all_gather_object`` after the stream has stopped.

This module imports torch and the port only.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch.distributed as dist

from torch_parallel_world import carried, mesh, scenario


def dense(inp, seed):
    """The reference test's dense classifier (12 → 16 tanh → 4 softmax),
    from the reference's initial parameters of ``seed``."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="negativeloglikelihood"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    return carried(net, {"params": inp[f"v{seed}"]})


def rules():
    from deeplearning4j_tpu_torch.parallel.mesh import P

    return [("(^|/)0/W$", P(None, "model")), ("(^|/)1/W$", P("model", None)), (".*", P())]


def gathered(obj):
    """``obj`` of every rank, in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


@scenario
def sharded_hot_swap(inp):
    """Register v1 on data=2, model=2 by the rules, warm it, hot-swap to
    v2 under load from rank 0's client thread, then answer 1, 3, 4 and 8
    rows; the tracer's kernel builds counted after the swap."""
    from deeplearning4j_tpu_torch.observe import Tracer, disable_tracing, enable_tracing
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    m = mesh({"data": 2, "model": 2})
    tr = enable_tracing(Tracer())
    reg = ModelRegistry(max_batch_size=8, warmup="sync")
    out = {}
    try:
        v1 = reg.register("clf", dense(inp, 1), mesh=m, sharding_rules=rules(),
                          input_shape=(12,))
        served = reg._models["clf"]
        out["buckets"] = list(served.inference.buckets)
        out["describe_mesh"] = served.describe()["versions"][0]["mesh"]
        if dist.get_rank() != 0:
            v2 = reg.register("clf", dense(inp, 2), mesh=m, sharding_rules=rules(),
                              input_shape=(12,))
            t0 = time.monotonic()
            out["followed"] = reg.follow()
            out["follow_s"] = time.monotonic() - t0
        else:
            out["v1_answer"] = reg.predict("clf", inp["x3"])
            stop, loaded, errors, hammered = threading.Event(), threading.Event(), [], [0]

            def hammer():
                while not stop.is_set():
                    try:
                        reg.predict("clf", inp["x3"])
                        hammered[0] += 1
                        loaded.set()
                    except Exception as e:  # noqa: BLE001 - reported below
                        errors.append(repr(e))
                        loaded.set()
                        return

            t = threading.Thread(target=hammer)
            t.start()
            loaded.wait(60.0)  # the swap starts under load
            try:
                v2 = reg.register("clf", dense(inp, 2), mesh=m, sharding_rules=rules(),
                                  input_shape=(12,))
            finally:
                stop.set()
                t.join(60.0)
            out["errors"], out["hammered"] = errors, hammered[0]
            out["versions"] = [v1, v2, served.describe()["current_version"]]
            baseline = tr.compile_count
            out["answers"] = {n: reg.predict("clf", inp["x8"][:n]) for n in (1, 3, 4, 8)}
            out["pinned_v1"] = reg.predict("clf", inp["x3"], version=1)
            out["builds_after_swap"] = tr.compile_count - baseline
            out["batches"] = served.inference.batches_dispatched
            out["warm"] = reg.warmed()
    finally:
        reg.shutdown()  # rank 0: stop reaches every follow()
        disable_tracing()
    out["ranks"] = gathered({k: out.get(k) for k in ("followed", "follow_s")})
    return out


@scenario
def sharded_rejects_quantized(inp):
    from deeplearning4j_tpu_torch.serving import ModelRegistry

    reg = ModelRegistry(warmup="off")
    try:
        reg.register("q", dense(inp, 3), mesh=mesh({"data": 2, "model": 2}),
                     dtype_policy="int8")
        return {"raised": None}
    except ValueError as e:
        return {"raised": str(e)}
    finally:
        reg.shutdown()


@scenario
def cli_serve_mesh(inp):
    """``serve --mesh data=2,model=2`` on every rank: rank 0 answers one
    binary request over HTTP, then stops; the followers' ``serve`` returns
    when the stop reaches them."""
    from deeplearning4j_tpu_torch.cli import serve_main
    from deeplearning4j_tpu_torch.serving import ModelServingClient

    path = os.path.join(inp["dir"], "clf.zip")
    if dist.get_rank() == 0:
        dense(inp, 1).save(path)
    dist.barrier()
    argv = ["--model", f"clf={path}", "--port", "0", "--max-batch-size", "4",
            "--mesh", "data=2,model=2", "--device", "cpu", "--input-shape", "clf=12"]
    out = {}
    if dist.get_rank() == 0:
        server = serve_main(argv, block=False)
        try:
            out["answer"] = ModelServingClient(server.url, timeout=60.0).predict(
                "clf", inp["x3"], binary=True)
            out["describe"] = server.registry.get("clf").describe()["versions"][0]["mesh"]
        finally:
            server.stop(drain=True, shutdown_registry=True)
    else:
        t0 = time.monotonic()
        reg = serve_main(argv, block=True)
        out["follow_s"] = time.monotonic() - t0
        out["closed"] = reg is not None
    out["ranks"] = gathered({k: out.get(k) for k in ("follow_s", "closed")})
    return out


@scenario
def close_ends_follow(inp):
    """``ParallelInference`` on a placed network over data=4: three
    batched requests and a warm-up from rank 0, then its shutdown; every
    follower's ``follow()`` returns the operations it ran, within its
    timeout, after the stop."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference, lockstep

    m = mesh({"data": 4})
    pi = ParallelInference(dense(inp, 1), mesh=m, max_batch_size=4)
    out = {"buckets": list(pi.buckets)}
    t0 = time.monotonic()
    if dist.get_rank() == 0:
        ops0 = lockstep.stream().ops_sent
        pi.warmup((12,), buckets=[4])
        out["answers"] = [pi.output(inp["x3"][:k]) for k in (1, 2, 3)]
        out["ops"] = lockstep.stream().ops_sent - ops0
        time.sleep(2.5 * lockstep.HEARTBEAT_S)  # idle: only heartbeats flow
        t_close = time.monotonic()
        pi.shutdown()
        out["close_s"] = time.monotonic() - t_close
    else:
        done = [None]
        th = threading.Thread(target=lambda: done.__setitem__(0, pi.follow()))
        th.start()
        th.join(lockstep.BIND_TIMEOUT_S)
        out["returned"] = not th.is_alive()
        out["followed"] = done[0]
        pi.shutdown()
    out["elapsed_s"] = time.monotonic() - t0
    try:
        pi.output(inp["x3"])
        out["after_shutdown"] = "answered"
    except RuntimeError as e:
        out["after_shutdown"] = str(e)
    out["ranks"] = gathered({k: out.get(k) for k in ("returned", "followed", "elapsed_s")})
    return out
