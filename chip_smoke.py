#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
started together), prints the compiler's report (registers, spills) of the
flash-attention backward kernels, and runs five phases:

1. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and a few more, timed (CUDA events)
   beside its bound, its plain version and a PyTorch library call that
   computes the same function (with the names of the kernels that call
   runs, for the attention backward). A kernel whose work is f32 matrix
   products is bound at the 3xTF32 rate (three TF32 tensor-core products
   for each f32-accurate one), with the CUDA cores' f32 bound beside it;
2. serving: GPT-2-small (``TransformerLM`` at its published width, random
   seeded weights) answers 16 requests through ``ParallelInference``'s
   batched dispatcher; the answers are checked;
3. training: GPT-2-small takes 5 ``ComputationGraph.fit`` steps with Adam
   through the fused updater helper; the loss must fall, every kernel must
   launch its expected count per step, and one batch's loss and gradients
   must agree with the plain attention path's on a twin network. Two more
   steps run under ``torch.profiler``: their device time by kernel group
   and the device's busy share are printed;
4. LSTM kernel: the fused LSTM sequence kernel against its plain version at
   the character model's shapes and two wider ones, timed beside its
   bound, its plain version and cuDNN's LSTM (``torch.nn.LSTM``, a
   yardstick the port never calls);
5. character LSTM: DL4J's ``LSTMCharModellingExample`` configuration (2 x
   LSTM(200), 77 characters, Adam(0.005), l2 1e-4, TBPTT 50) built with
   ``list()`` as a ``MultiLayerNetwork`` trains on 2 minibatches of 32 x
   1000 characters of this repository's own text (40 TBPTT chunks; the
   loss must fall; 2 LSTM-kernel and 8 fused-Adam launches a chunk), one
   chunk's loss and gradients are checked against a twin on the plain
   recurrence, it answers ``output`` over a [32, 1000, 77] batch and
   samples 4 x 300 characters through ``rnn_time_step``.

Any failure raises (exit code != 0). The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the main paths, its error against the plain version
and its times beside its bound.

float32 matrix products run in full float32: TF32 is switched off.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SERVED_SHAPE = (8, 12, 1024, 64)  # [N, H, T, Dh] of GPT-2-small, batch 8
KERNEL_SHAPES = [(SERVED_SHAPE, True), ((1, 2, 2048, 64), True),
                 ((2, 4, 256, 128), False), ((2, 2, 128, 256), True)]
KERNEL_TOL = 1e-4  # f32 both ways; only the summation order differs
# backward: max |kernel - plain| over each gradient, relative to the
# gradient's largest entry (sums over up to T products of order 1)
BWD_TOL = 1e-4
BWD_SHAPES = [(SERVED_SHAPE, True), ((2, 4, 256, 128), False),
              ((2, 2, 128, 256), True)]
# fused updater: max |kernel - plain| over each of p, m, v (and v-hat),
# relative to that tensor's largest entry; the same float32 coefficients
# both ways, only the kernel's fused multiply-adds round differently
ADAM_TOL = 1e-5
# the served answer against the same row with the plain attention path:
# |a - b| <= ATOL + RTOL * |b| over softmax probabilities (f32 through 12
# blocks; attention sums in another order)
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-8
ROWSUM_TOL = 1e-4
N_CLIENTS, N_REQUESTS, T = 8, 16, 1024
TRAIN_N, TRAIN_STEPS, PROFILED_STEPS = 8, 5, 2
# profile groups: (group, substrings of a kernel's name), first match wins
KERNEL_GROUPS = (
    ("K3a flash_attention_fwd", ("flash_attention_fwd_kernel",)),
    ("K3b flash_attention_bwd_dq", ("flash_attention_bwd_dq_kernel",)),
    ("K3b flash_attention_bwd_dkv", ("flash_attention_bwd_dkv_kernel",)),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("K1 lstm_sequence", ("lstm_sequence_kernel",)),
    ("matrix products", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
    ("softmax", ("softmax",)),
    ("gathers and scatters", ("index", "scatter", "gather", "embedding")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the kernel path against the plain attention path on one batch: the loss
# within 1e-6 relative, each parameter's gradient within 1e-5 x its
# largest entry (f32 through 12 blocks, attention summed in another order;
# the first run on an H100 measured 0.0 and 7.4e-7)
LOSS_RTOL, GRAD_TOL = 1e-6, 1e-5
# K1 against its plain version: max |kernel - plain| over each of ys, hN,
# cN, relative to max(1, that output's largest entry): f32 both ways, the
# recurrent dot products summed in another order, each step's rounding
# carried into the next (the first H100 runs measured at most 7.1e-7, at
# H = 1500, and 1.8e-7 at the character model's shapes)
LSTM_TOL = 1e-5
LSTM_SHAPES = [(50, 32, 200), (1000, 32, 200), (1, 4, 200), (128, 64, 512),
               (35, 20, 1500)]  # [T, N, H]
# the character model (LSTMCharModellingExample): its 77-character set
# (CharacterIterator.getMinimalCharacterSet), widths, batch and TBPTT length
CHARS = ("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ" "0123456789"
         "!&()?-'\",.:; \n\t")
CHAR_WIDTH, CHAR_BATCH, CHAR_LEN, CHAR_TBPTT, CHAR_BATCHES = 200, 32, 1000, 50, 2
CORPUS = ("ARCHITECTURE.md", "SURVEY.md")  # the repository's own text
N_SAMPLES, SAMPLE_LEN, PRIME = 4, 300, "The network "
# the kernel path against the plain recurrence on a twin: one chunk's loss
# relative, each gradient relative to its tensor's largest entry; output
# probabilities absolute (the first H100 runs measured 0.0, 3.8e-7 and
# 2.1e-7: the backward is the same plain recomputation on both sides)
CHAR_LOSS_RTOL, CHAR_GRAD_TOL, CHAR_OUT_ATOL = 1e-6, 1e-5, 1e-5


def card_peaks(name: str):
    """The card's peaks from NVIDIA's data sheets (dense, at the full power
    limit): ``f32`` (non-tensor FLOP/s), ``tf32`` (tensor-core FLOP/s),
    ``mem`` (bytes/s) and a ``label``."""
    if "H100" in name and "PCIe" in name:
        f32, tf32, mem, label = 51e12, 378e12, 2.0e12, "H100 PCIe"
    elif "H100" in name and "NVL" in name:
        f32, tf32, mem, label = 60e12, 417e12, 3.9e12, "H100 NVL"
    elif "H200" in name:
        f32, tf32, mem, label = 67e12, 495e12, 4.8e12, "H200 SXM"
    else:
        f32, tf32, mem, label = 67e12, 495e12, 3.35e12, "H100 SXM"
    return {"f32": f32, "tf32": tf32, "mem": mem,
            "label": f"{label}: {f32 / 1e12:g} TFLOP/s f32, {tf32 / 1e12:g} "
                     f"TFLOP/s TF32, {mem / 1e12:g} TB/s"}


def bound(flops, nbytes, peaks, rate="f32"):
    """(least time in ms, what bounds it): the larger of the operations
    over the compute rate and the bytes over the memory rate. ``rate``
    "f32" is the CUDA cores' f32 rate; "3xtf32" counts each f32-accurate
    product as three TF32 products on the tensor cores."""
    if rate == "f32":
        t_ops = flops / peaks["f32"] * 1e3
    else:
        t_ops = 3.0 * flops / peaks["tf32"] * 1e3
    t_bytes = nbytes / peaks["mem"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bound(flops, nbytes, peaks):
    """The bound of a kernel whose work is f32 matrix products: ``bound_ms``
    at the 3xTF32 rate (the least time for the same f32-accurate work) and
    ``bound_simt_ms`` at the CUDA cores' f32 rate, as earlier rows had it."""
    ms, by = bound(flops, nbytes, peaks, "3xtf32")
    return {"bound_ms": ms, "bound_by": by,
            "bound_simt_ms": bound(flops, nbytes, peaks)[0]}


def flash_bound(shape, causal, peaks, products=2, heads_io=4, rows_io=0):
    """:func:`product_bound` of an attention kernel doing ``products`` [T x
    T x Dh] matrix products over the pairs this causality needs, reading
    and writing ``heads_io`` [N,H,T,Dh] and ``rows_io`` [N,H,T] f32 tensors
    once each. The forward: 2 products (q.kT, p.v), q, k, v in, o out."""
    n, h, t, dh = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * n * h * dh * pairs  # 2 flops per multiply-add
    nbytes = 4.0 * n * h * t * (heads_io * dh + rows_io)
    return product_bound(flops, nbytes, peaks)


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median per-launch time from CUDA events around each of ``runs``
    launches, enqueued back to back after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _randn(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(scale)).cuda()


def kernel_phase(ck, peaks):
    import torch.nn.functional as F
    rng = np.random.default_rng(0)
    rows = {}
    for shape, causal in KERNEL_SHAPES:
        q, k, v = (_randn(rng, shape) for _ in range(3))
        out, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        plain, plain_lse = ck.flash_attention_plain(q, k, v, causal,
                                                    return_lse=True)
        err = (out - plain).abs().max().item()
        lse_err = (lse - plain_lse).abs().max().item()
        if not (err <= KERNEL_TOL and lse_err <= KERNEL_TOL):
            raise RuntimeError(f"flash_attention_fwd {shape} causal={causal}: "
                               f"max abs err {err} (lse {lse_err}) > {KERNEL_TOL}")
        row = {
            "shape": list(shape), "causal": causal, "max_abs_err": err,
            "lse_max_abs_err": lse_err,
            "ms": median_ms(lambda: ck.flash_attention_fwd(q, k, v, causal)),
            "plain_ms": median_ms(lambda: ck.flash_attention_plain(q, k, v, causal)),
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
        }
        row.update(flash_bound(shape, causal, peaks))
        print("kernel flash_attention_fwd " + json.dumps(row), flush=True)
        rows[(shape, causal)] = row
        del q, k, v, out, lse, plain, plain_lse
    return rows[(SERVED_SHAPE, True)]


def backward_phase(ck, peaks):
    """K3b: the dq and dk/dv kernels against their plain versions on the
    forward kernel's own o and LSE; library: the backward of
    ``F.scaled_dot_product_attention`` (dq, dk and dv in one call)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(1)
    served = None
    for shape, causal in BWD_SHAPES:
        q, k, v, do = (_randn(rng, shape) for _ in range(4))
        o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
        torch.cuda.synchronize()
        p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, p_d, causal)
        errs = {}
        for name, got, ref in (("dq", dq, p_dq), ("d", d, p_d), ("dk", dk, p_dk),
                               ("dv", dv, p_dv)):
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            errs[name] = err
            if not err <= BWD_TOL * scale:
                raise RuntimeError(f"flash backward {shape} causal={causal}: "
                                   f"{name} max abs err {err} > {BWD_TOL} x {scale}")
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        lib_ms = median_ms(lib_bwd)
        if (shape, causal) == (SERVED_SHAPE, True):
            print("library kernels of SDPA's f32 backward "
                  + json.dumps(library_kernels(lib_bwd)), flush=True)
        rows = {
            "dq": {"max_abs_err": max(errs["dq"], errs["d"]),
                   "ms": median_ms(lambda: ck.flash_attention_bwd_dq(
                       q, k, v, o, lse, do, causal)),
                   "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dq_plain(
                       q, k, v, o, lse, do, causal)),
                   "library_ms": lib_ms},
            "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                    "ms": median_ms(lambda: ck.flash_attention_bwd_dkv(
                        q, k, v, lse, do, d, causal)),
                    "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dkv_plain(
                        q, k, v, lse, do, p_d, causal)),
                    "library_ms": lib_ms},
        }
        # dq: S, dP, dQ; reads q, k, v, o, dO and LSE, writes dQ and D.
        # dk/dv: S, dP, dV, dK; reads q, k, v, dO, LSE and D, writes dK, dV.
        rows["dq"].update(flash_bound(shape, causal, peaks, products=3,
                                      heads_io=6, rows_io=2))
        rows["dkv"].update(flash_bound(shape, causal, peaks, products=4,
                                       heads_io=6, rows_io=2))
        total = rows["dq"]["ms"] + rows["dkv"]["ms"]
        for name, row in rows.items():
            row.update(shape=list(shape), causal=causal, k3b_total_ms=total)
            print(f"kernel flash_attention_bwd_{name} " + json.dumps(row),
                  flush=True)
        if (shape, causal) == (SERVED_SHAPE, True):
            served = rows
        del q, k, v, do, o, lse, dq, d, dk, dv, p_dq, p_d, p_dk, p_dv
        del ql, kl, vl, lib_out
    return served


def adam_phase(ck, peaks):
    """K2 on GPT-2-small's own parameter shapes (the output matrix, its
    bias of odd length 50257, the first fused QKV matrix, and the bias as
    a view one float into its buffer, which takes the kernel's unaligned
    path) for Adam, AMSGrad and Nadam over steps t = 1..3; timed on the
    output matrix with Adam. Library: ``torch._fused_adam_`` on the same
    single tensor."""
    from deeplearning4j_tpu_torch.nn.updaters import AMSGrad, Adam, Nadam
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    conf = TransformerLM().conf()
    out_shapes = conf.vertices["out"].obj.param_shapes()
    tensors = {"out/W": out_shapes["W"], "out/b": out_shapes["b"],
               "block0-att/Wqkv": conf.vertices["block0-att"].obj.param_shapes()["Wqkv"],
               "out/b, unaligned": out_shapes["b"]}
    kinds = ((ck.ADAM, Adam(3e-4)), (ck.AMSGRAD, AMSGrad(3e-4)),
             (ck.NADAM, Nadam(3e-4)))
    rng = np.random.default_rng(2)
    worst, worst_rel = 0.0, 0.0
    for name, shape in tensors.items():
        for kind, upd in kinds:
            n = int(np.prod(shape))
            if name.endswith("unaligned"):
                p = _randn(rng, (n + 1,), 0.02)[1:]
            else:
                p = _randn(rng, shape, 0.02)
            m, v = torch.zeros_like(p), torch.zeros_like(p)
            vh = torch.zeros_like(p) if kind == ck.AMSGRAD else None
            ref = [t.clone() if t is not None else None for t in (p, m, v, vh)]
            for t in (1.0, 2.0, 3.0):
                g = _randn(rng, p.shape, 1e-2)
                coef = ck.adam_coefficients(upd, 3e-4, t)
                ck.fused_adam(kind, p, m, v, vh, g, coef)
                ck.fused_adam_plain(kind, *ref, g, coef)
                torch.cuda.synchronize()
                for label, got, want in zip(("p", "m", "v", "v_hat"),
                                            (p, m, v, vh), ref):
                    if want is None:
                        continue
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
                    if not err <= ADAM_TOL * scale:
                        raise RuntimeError(
                            f"fused_adam {name} {type(upd).__name__} t={t}: "
                            f"{label} max abs err {err} > {ADAM_TOL} x {scale}")
    p, g = _randn(rng, tensors["out/W"], 0.02), _randn(rng, tensors["out/W"], 1e-2)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    coef = ck.adam_coefficients(Adam(3e-4), 3e-4, 1.0)
    step = torch.ones((), device=p.device)
    row = {
        "shape": list(tensors["out/W"]), "updater": "Adam", "max_abs_err": worst,
        "max_err_rel_to_max": worst_rel,
        "ms": median_ms(lambda: ck.fused_adam(ck.ADAM, p, m, v, None, g, coef)),
        "plain_ms": median_ms(lambda: ck.fused_adam_plain(ck.ADAM, p, m, v, None,
                                                          g, coef)),
        "library_ms": median_ms(lambda: torch._fused_adam_(
            [p], [g], [m], [v], [], [step], lr=3e-4, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)),
    }
    # reads p, m, v, g and writes p, m, v: 28 bytes and ~12 flops an element
    row["bound_ms"], row["bound_by"] = bound(12.0 * p.numel(), 28.0 * p.numel(),
                                             peaks)  # bytes, at either rate
    print("kernel fused_adam " + json.dumps(row), flush=True)
    return row


def serving_phase(ck, card, served_ms):
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    t0 = time.perf_counter()
    net = TransformerLM().init()  # GPT-2-small defaults, f32, on cuda
    torch.cuda.synchronize()
    print(f"serve: TransformerLM init {time.perf_counter() - t0:.3f} s, "
          f"{net.conf.num_params()} params on {net.device}", flush=True)
    pi = ParallelInference(net, mode="batched", max_batch_size=8,
                           buckets=(1, 2, 4, 8))
    warm = pi.warmup((T,))
    print("serve: warmup s per bucket " + json.dumps(warm), flush=True)

    rng = np.random.default_rng(2026)
    reqs = rng.integers(0, net.conf.vertices["embed"].obj.n_in,
                        (N_REQUESTS, 1, T)).astype(np.float32)
    results, latency, errors = [None] * N_REQUESTS, [0.0] * N_REQUESTS, []

    def client(c):
        try:
            for j in range(c, N_REQUESTS, N_CLIENTS):
                t_req = time.perf_counter()
                results[j] = pi.output(reqs[j])
                latency[j] = time.perf_counter() - t_req
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    batches0 = pi.batches_dispatched
    ck.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = ck.flash_attention_fwd.launches
    batches = pi.batches_dispatched - batches0
    pi.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError(f"serving failed: {errors or 'client hung'}")

    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    if not (batches > 0 and launches == n_layers * batches):
        raise RuntimeError(f"flash kernel launches {launches} != {n_layers} x "
                           f"{batches} forwards")
    for j, r in enumerate(results):
        if r is None or r.shape != (1, T, 50257) or not np.isfinite(r).all():
            raise RuntimeError(f"request {j}: bad answer "
                               f"{None if r is None else r.shape}")
        dev = np.abs(r.sum(-1, dtype=np.float64) - 1.0).max()
        if not dev <= ROWSUM_TOL:
            raise RuntimeError(f"request {j}: softmax rows sum off by {dev}")

    # the same row through the plain attention path
    helpers.set_auto_flash_attention(False)
    ref = net.output(reqs[0])
    helpers.set_auto_flash_attention(True)
    got = torch.from_numpy(results[0]).cuda()
    diff = (got - ref).abs()
    worst = (diff - SERVE_RTOL * ref.abs()).max().item()
    if not worst <= SERVE_ATOL:
        raise RuntimeError(f"served answer disagrees with the plain path: "
                           f"max |a-b| - rtol|b| = {worst}")
    # where a batch-8 dispatch spends its time: the forward on the device
    # (CUDA events; its attention is 12 kernel launches) and the copy of
    # the [8, T, vocab] f32 answer to the host
    x8 = torch.from_numpy(reqs[:8].reshape(8, T)).cuda()
    fwd_ms = median_ms(lambda: net.output(x8), runs=5, warmup=1)
    out8 = net.output(x8)
    torch.cuda.synchronize()
    t_copy = time.perf_counter()
    host8 = out8.cpu()
    d2h_ms = (time.perf_counter() - t_copy) * 1e3
    del out8, host8
    lat = np.asarray(latency) * 1e3
    stats = {
        "card": card, "requests": N_REQUESTS, "clients": N_CLIENTS,
        "tokens_per_request": T, "wall_s": wall,
        "requests_per_s": N_REQUESTS / wall,
        "tokens_per_s": N_REQUESTS * T / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "batches_dispatched": batches, "flash_launches": launches,
        "max_abs_diff_vs_plain_attention": diff.max().item(),
        "batch8_forward_ms": fwd_ms,
        "batch8_attention_ms": n_layers * served_ms,
        "batch8_copy_to_host_ms": d2h_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serve " + json.dumps(stats), flush=True)
    return launches


def worst_gradient(got, ref):
    """``(name, ratio)`` of the gradient tensor whose largest difference
    from ``ref`` is the largest share of ``ref``'s largest entry."""
    worst_name, worst = None, 0.0
    for key, named in ref.items():
        for n, r in named.items():
            ratio = ((got[key][n] - r).abs().max()
                     / r.abs().max().clamp_min(1e-30)).item()
            if ratio > worst:
                worst_name, worst = f"{key}/{n}", ratio
    return worst_name, worst


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_ms_by_kernel(prof):
    """Device time (ms) by kernel name in a finished ``torch.profiler``
    run; raises when it recorded none."""
    per_kernel = {}
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3
    if not per_kernel:
        raise RuntimeError("torch.profiler recorded no device time")
    return per_kernel


def library_kernels(fn):
    """The device kernels one call of ``fn`` runs, with their ms, from
    one ``torch.profiler`` pass (names cut to 120 characters)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {k[:120]: ms for k, ms in sorted(device_ms_by_kernel(prof).items(),
                                              key=lambda kv: -kv[1])}


def ptxas_report(ck, source, key):
    """The ``-Xptxas -v`` lines (registers, spills, stack) of the kernels
    in the build log of ``csrc/<source>`` whose names contain ``key``, by
    kernel and template arguments (Dh, causal)."""
    with open(ck.build(source) + ".log") as f:
        lines = f.read().splitlines()
    report, cur = {}, None
    for line in lines:
        text = line.split(":", 1)[-1].strip() if line.startswith("ptxas") else line.strip()
        if "Compiling entry function" in line:
            m = re.search(r"(" + key + r"_[a-z]+_kernel)ILi(\d+)ELb(\d)E", line)
            cur = f"{m.group(1)}<{m.group(2)},{m.group(3)}>" if m else None
            if cur:
                report[cur] = []
        elif cur and ("spill" in text or text.startswith("Used")):
            report[cur].append(text)
    return report


def profile_steps(net, x, labels, fits=PROFILED_STEPS, steps_per_fit=1):
    """Device time of ``fits`` more fit calls (``steps_per_fit`` steps
    each) under torch.profiler, per step: by kernel group, in all, and as a
    share of the step's wall time (host clock around steps that end in a
    synchronize; kernels of one stream do not overlap), with the kernels
    that take the most."""
    from torch.profiler import ProfilerActivity, profile

    steps = fits * steps_per_fit
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(fits):
            net.fit(x, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    per_kernel = {k: ms / steps for k, ms in device_ms_by_kernel(prof).items()}
    groups = {}
    for name, ms in per_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "device_ms_per_step_by_group": dict(sorted(groups.items(),
                                                   key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[k[:100], v] for k, v in top],
    }


def training_phase(ck, card):
    """GPT-2-small takes TRAIN_STEPS fit steps on one seeded batch with the
    fused updater registered, then PROFILED_STEPS more under the profiler;
    then the parity check on a twin network."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM().init()  # GPT-2-small, f32, seed 123, on cuda
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = sum(len(named) for named in net.params.values())
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
    x = ids.float()  # token ids arrive as floats, as in serving
    # next-token one-hot labels, built on the device
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())

    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    for c in counters:
        c.launches = 0
    losses, events = [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net.score_)  # waits for the step
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    step_ms = [s.elapsed_time(e) for s, e in events]
    # the whole window, first start to last end (host gaps between steps
    # included), and the same without the first step's warm-up
    window_ms = events[0][0].elapsed_time(events[-1][1])
    warm_window_ms = events[1][0].elapsed_time(events[-1][1])

    want = {"flash_attention_fwd": n_layers, "flash_attention_bwd_dq": n_layers,
            "flash_attention_bwd_dkv": n_layers, "fused_adam": n_tensors}
    for name, per_step in want.items():
        if launches[name] != per_step * TRAIN_STEPS:
            raise RuntimeError(f"{name}: {launches[name]} launches in "
                               f"{TRAIN_STEPS} steps, expected {per_step} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not progress: losses {losses}")
    profile = profile_steps(net, x, labels)  # after the counts were read

    # parity on the card: the kernel path against the plain attention path
    # (and stock autograd) on a twin with the same weights, one batch
    twin = load_reference_params(TransformerLM().init(), export_params(net))
    g_k, loss_k = net.compute_gradient_and_score(x, labels)
    helpers.set_auto_flash_attention(False)
    try:
        g_p, loss_p = twin.compute_gradient_and_score(x, labels)
    finally:
        helpers.set_auto_flash_attention(True)
    del twin
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_name, worst = worst_gradient(g_k, g_p)
    if not (loss_rel <= LOSS_RTOL and worst <= GRAD_TOL):
        raise RuntimeError(f"kernel path disagrees with the plain path: loss "
                           f"{loss_k} vs {loss_p} (rel {loss_rel}), worst "
                           f"gradient {worst_name} at {worst} x its max")

    # one update of all the tensors: the fused kernel (one launch each)
    # against the stock updater math and one multi-tensor library call
    # (these launches come after the counts were read)
    flat = [(net.params[v][n], g_k[v][n], net.updater_states[v][n])
            for v in net.params for n in net.params[v]]
    update_ms = median_ms(lambda: net._apply_updates(g_k), runs=5, warmup=1)
    helpers.clear_helper("updater")
    stock_ms = median_ms(lambda: net._apply_updates(g_k), runs=5, warmup=1)
    step_t = [torch.ones((), device=x.device) for _ in flat]
    lib_ms = median_ms(lambda: torch._fused_adam_(
        [p for p, _, _ in flat], [g for _, g, _ in flat],
        [s["m"] for _, _, s in flat], [s["v"] for _, _, s in flat], [], step_t,
        lr=3e-4, beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
        amsgrad=False, maximize=False), runs=5, warmup=1)
    n_elems = sum(p.numel() for p, _, _ in flat)
    stats = {
        "card": card, "batch": [TRAIN_N, T], "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "window_ms": window_ms,
        "tokens_per_s": TRAIN_STEPS * TRAIN_N * T / (window_ms / 1e3),
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches, "launches_per_step": {
            k: v // TRAIN_STEPS for k, v in launches.items()},
        "parity_loss_kernel": loss_k, "parity_loss_plain": loss_p,
        "parity_loss_rel": loss_rel, "parity_worst_grad": worst_name,
        "parity_worst_grad_rel_to_max": worst,
        "update_all_tensors_ms": update_ms, "update_elements": n_elems,
        "update_stock_ms": stock_ms, "update_library_ms": lib_ms,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile,
    }
    print("train " + json.dumps(stats), flush=True)
    del net, g_k, g_p, flat, labels
    return launches


def lstm_bound(shape, peaks):
    """:func:`product_bound` of the LSTM sequence at [T, N, H]: the
    recurrent products (2 T N H 4H flops) and the xw additions, or reading
    xw, rw, h0, c0 and writing ys, hN, cN once each."""
    t, n, h = shape
    flops = 2.0 * t * n * h * 4 * h + t * n * 4 * h
    nbytes = 4.0 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h + 2 * n * h)
    return product_bound(flops, nbytes, peaks)


def ifgo(w, h):
    """IFOG column blocks of ``w`` (..., 4H) in torch.nn.LSTM's IFGO order."""
    return torch.cat([w[..., :2 * h], w[..., 3 * h:], w[..., 2 * h:3 * h]], -1)


def lstm_kernel_phase(ck, peaks):
    """K1 against its plain version at LSTM_SHAPES, on a layer's own
    inputs: x [T,N,H] and W, b give the hoisted xw = x W + b, with a
    Xavier-scale rw and non-zero h0, c0. Timed: the kernel alone, the
    kernel after the hoisted product (what FusedLSTMHelper launches), the
    plain recurrence, and the yardstick: a one-layer torch.nn.LSTM (cuDNN)
    with the same weights, which computes the product itself."""
    rng = np.random.default_rng(3)
    rows = {}
    for shape in LSTM_SHAPES:
        t, n, h = shape
        x = _randn(rng, (t, n, h))
        w = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h)))
        rw = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h)))
        b = _randn(rng, (4 * h,), 0.1)
        h0, c0 = _randn(rng, (n, h), 0.5), _randn(rng, (n, h))
        xw = x @ w + b
        got = ck.lstm_sequence(xw, rw, h0, c0)
        torch.cuda.synchronize()
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        errs = {}
        for name, g, ref in zip(("ys", "hN", "cN"), got, plain):
            errs[name] = (g - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            if not errs[name] <= LSTM_TOL * scale:
                raise RuntimeError(f"lstm_sequence {shape}: {name} max abs err "
                                   f"{errs[name]} > {LSTM_TOL} x {scale}")
        lib = torch.nn.LSTM(h, h).cuda()
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifgo(w, h).t())
            lib.weight_hh_l0.copy_(ifgo(rw, h).t())
            lib.bias_ih_l0.copy_(ifgo(b, h))
            lib.bias_hh_l0.zero_()
        state = (h0[None].contiguous(), c0[None].contiguous())
        with torch.no_grad():
            lib_ys = lib(x, state)[0]
            row = {
                "shape": list(shape), "max_abs_err": max(errs.values()),
                "max_abs_err_by_output": errs,
                "library_max_abs_diff_vs_plain": (lib_ys - plain[0]).abs().max().item(),
                "ms": median_ms(lambda: ck.lstm_sequence(xw, rw, h0, c0)),
                "ms_with_input_product": median_ms(lambda: ck.lstm_sequence(
                    (x @ w + b), rw, h0, c0)),
                "plain_ms": median_ms(lambda: ck.lstm_sequence_plain(xw, rw, h0, c0),
                                      runs=5 if t >= 1000 else 25),
                "library_ms": median_ms(lambda: lib(x, state)),
                "library": "torch.nn.LSTM on cuDNN, with its input product; "
                           "compare with ms_with_input_product",
            }
        row.update(lstm_bound(shape, peaks))
        print("kernel lstm_sequence " + json.dumps(row), flush=True)
        rows[shape] = row
        del x, w, rw, b, h0, c0, xw, got, plain, lib, lib_ys
    return rows[LSTM_SHAPES[0]]


def char_corpus(n_examples):
    """``n_examples`` non-overlapping character sequences of CHAR_LEN + 1
    from the repository's own text, with every character outside CHARS
    dropped (as the example's CharacterIterator drops them), as indices
    into CHARS (a [n_examples, CHAR_LEN + 1] int64 array)."""
    root = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(os.path.join(root, f), encoding="utf-8").read()
                   for f in CORPUS)
    index = {c: i for i, c in enumerate(CHARS)}
    ids = np.fromiter((index[c] for c in text if c in index), dtype=np.int64)
    need = n_examples * (CHAR_LEN + 1)
    if ids.size < need:
        raise RuntimeError(f"corpus has {ids.size} characters, {need} needed")
    return ids[:need].reshape(n_examples, CHAR_LEN + 1)


def char_lstm_conf():
    """LSTMCharModellingExample's configuration, through ``list()``."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    v = len(CHARS)
    return (NeuralNetConfiguration.builder().seed(12345).l2(1e-4)
            .weight_init("xavier").updater(Adam(0.005)).list()
            .layer(LSTMLayer(n_in=v, n_out=CHAR_WIDTH, activation="tanh"))
            .layer(LSTMLayer(n_in=CHAR_WIDTH, n_out=CHAR_WIDTH, activation="tanh"))
            .layer(RnnOutputLayer(n_in=CHAR_WIDTH, n_out=v, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(v))
            .backprop_type("TruncatedBPTT").t_bptt_length(CHAR_TBPTT).build())


def sample_from(probs, rng):
    """The example's sampleFromDistribution: the first index whose
    cumulative probability reaches a uniform draw."""
    return int(min(np.searchsorted(np.cumsum(probs, dtype=np.float64), rng.random()),
                   len(probs) - 1))


def char_lstm_phase(ck, card):
    """Train, serve and sample DL4J's character model (see the module
    docstring). Returns K1's launches by path and K2's in training."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)

    v = len(CHARS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ids = torch.from_numpy(char_corpus((CHAR_BATCHES + 1) * CHAR_BATCH)).cuda()
    onehot = F.one_hot(ids, v).float()  # [examples, CHAR_LEN + 1, 77]
    batches = [(onehot[i * CHAR_BATCH:(i + 1) * CHAR_BATCH, :-1],
                onehot[i * CHAR_BATCH:(i + 1) * CHAR_BATCH, 1:])
               for i in range(CHAR_BATCHES + 1)]
    net = MultiLayerNetwork(char_lstm_conf()).init()  # on cuda
    n_tensors = sum(len(named) for named in net.params.values())
    n_lstm = sum(1 for l in net.layers if type(l).__name__ == "LSTMLayer")
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    chunk_losses = []
    apply = net._apply_updates

    def record_and_apply(grads):  # each chunk's loss, a device scalar
        chunk_losses.append(net._score)
        apply(grads)

    net._apply_updates = record_and_apply
    chunks = CHAR_BATCHES * CHAR_LEN // CHAR_TBPTT
    ck.lstm_sequence.launches = ck.fused_adam.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for x, y in batches[:CHAR_BATCHES]:
        net.fit(x, y)
    end.record()
    torch.cuda.synchronize()
    del net._apply_updates
    window_ms = start.elapsed_time(end)
    train = {"lstm_sequence": ck.lstm_sequence.launches,
             "fused_adam": ck.fused_adam.launches}
    losses = [float(l) for l in chunk_losses]
    print("char-lstm chunk losses " + json.dumps(losses), flush=True)
    if train != {"lstm_sequence": n_lstm * chunks, "fused_adam": n_tensors * chunks}:
        raise RuntimeError(f"launches {train} in {chunks} chunks, expected "
                           f"{n_lstm} and {n_tensors} a chunk")
    if not (len(losses) == chunks and np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise RuntimeError(f"training did not progress: {losses}")
    peak_train_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_steps(net, *batches[0], fits=1,
                            steps_per_fit=CHAR_LEN // CHAR_TBPTT)

    # one chunk on a twin that takes the plain recurrence
    twin = load_reference_params(MultiLayerNetwork(char_lstm_conf()).init(),
                                 export_params(net))
    xc, yc = batches[0][0][:, :CHAR_TBPTT], batches[0][1][:, :CHAR_TBPTT]
    g_k, loss_k = net.compute_gradient_and_score(xc, yc)
    helpers.set_auto_fused_lstm(False)
    try:
        g_p, loss_p = twin.compute_gradient_and_score(xc, yc)
        x_out = batches[CHAR_BATCHES][0]
        ref_out = twin.output(x_out)
    finally:
        helpers.set_auto_fused_lstm(True)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst_name, worst = worst_gradient(g_k, g_p)
    if not (loss_rel <= CHAR_LOSS_RTOL and worst <= CHAR_GRAD_TOL):
        raise RuntimeError(f"char LSTM kernel path disagrees with the plain "
                           f"recurrence: loss {loss_k} vs {loss_p} (rel "
                           f"{loss_rel}), worst gradient {worst_name} at {worst}")
    del twin, g_k, g_p

    # serving: output over one unseen [32, 1000, 77] batch
    ck.lstm_sequence.launches = 0
    start.record()
    out = net.output(x_out)
    end.record()
    torch.cuda.synchronize()
    output_launches = ck.lstm_sequence.launches
    output_ms = start.elapsed_time(end)
    if output_launches != n_lstm or out.shape != (CHAR_BATCH, CHAR_LEN, v):
        raise RuntimeError(f"output: {output_launches} launches, shape "
                           f"{tuple(out.shape)}")
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    out_diff = (out - ref_out).abs().max().item()
    if not (rowsum_dev <= ROWSUM_TOL and out_diff <= CHAR_OUT_ATOL):
        raise RuntimeError(f"output: rows sum off by {rowsum_dev}, "
                           f"{out_diff} from the plain recurrence")
    del out, ref_out

    # sampling: prime with PRIME, then N_SAMPLES x SAMPLE_LEN characters
    rng = np.random.default_rng(12345)
    index = {c: i for i, c in enumerate(CHARS)}
    prime = F.one_hot(torch.tensor([index[c] for c in PRIME]), v).float()
    net.rnn_clear_previous_state()
    ck.lstm_sequence.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = net.rnn_time_step(prime[None].repeat(N_SAMPLES, 1, 1).cuda())[:, -1]
    samples = [[] for _ in range(N_SAMPLES)]
    for _ in range(SAMPLE_LEN):
        p = probs.cpu().numpy().astype(np.float64)
        nxt = [sample_from(p[k], rng) for k in range(N_SAMPLES)]
        for k, c in enumerate(nxt):
            samples[k].append(CHARS[c])
        probs = net.rnn_time_step(F.one_hot(torch.tensor(nxt), v).float().cuda())
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sample_launches = ck.lstm_sequence.launches
    if sample_launches != n_lstm * (1 + SAMPLE_LEN) or probs.shape != (N_SAMPLES, v):
        raise RuntimeError(f"sampling: {sample_launches} launches for "
                           f"{1 + SAMPLE_LEN} steps")
    texts = ["".join(t) for t in samples]
    print("char-lstm sample 0: " + json.dumps(PRIME + texts[0][:80]), flush=True)
    stats = {
        "card": card, "params": net.conf.num_params(), "chunks": chunks,
        "batch": [CHAR_BATCH, CHAR_LEN], "tbptt": CHAR_TBPTT,
        "first_5_mean_loss": float(np.mean(losses[:5])),
        "last_5_mean_loss": float(np.mean(losses[-5:])),
        "window_ms": window_ms,
        "trained_chars_per_s": CHAR_BATCHES * CHAR_BATCH * CHAR_LEN / (window_ms / 1e3),
        "ms_per_chunk": window_ms / chunks,
        "launches": train, "launches_per_chunk": {k: n // chunks for k, n in train.items()},
        "peak_device_mem_gb_train": peak_train_gb,
        "parity_loss_kernel": loss_k, "parity_loss_plain": loss_p,
        "parity_loss_rel": loss_rel, "parity_worst_grad": worst_name,
        "parity_worst_grad_rel_to_max": worst,
        "output_ms": output_ms, "output_chars_per_s": CHAR_BATCH * CHAR_LEN / (output_ms / 1e3),
        "output_launches": output_launches, "output_rowsum_dev": rowsum_dev,
        "output_max_abs_diff_vs_plain": out_diff,
        "sample_s": sample_s, "sampled_chars_per_s": N_SAMPLES * SAMPLE_LEN / sample_s,
        "sample_launches": sample_launches,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_per_chunk": profile,
    }
    print("char-lstm " + json.dumps(stats), flush=True)
    helpers.clear_helper("updater")
    del net, batches, onehot
    return ({"train": train["lstm_sequence"], "output": output_launches,
             "sample": sample_launches}, train["fused_adam"])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test needs an NVIDIA GPU")
    from deeplearning4j_tpu_torch.nn import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False)",
          flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"peaks: {peaks['label']}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"build: {ck.build_all():.3f} s for {len(ck.SOURCES)} kernel "
          f"source(s)", flush=True)
    print("ptxas flash_attention_bwd.cu " + json.dumps(
        ptxas_report(ck, "flash_attention_bwd.cu", "flash_attention_bwd")), flush=True)

    served = kernel_phase(ck, peaks)
    bwd = backward_phase(ck, peaks)
    adam = adam_phase(ck, peaks)
    serve_launches = serving_phase(ck, card, served["ms"])
    train_launches = training_phase(ck, card)
    lstm = lstm_kernel_phase(ck, peaks)
    char_launches, char_adam_launches = char_lstm_phase(ck, card)

    def entry(name, source, replaces, row, launches, **extra):
        return {"name": name, "route": "cuda",
                "source": f"deeplearning4j_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                **{k: row[k] for k in ("bound_simt_ms", "k3b_total_ms") if k in row},
                **extra}

    fwd = "flash_attention_fwd"
    print(json.dumps({"kernels": [
        entry(fwd, "flash_attention_fwd.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:359", served,
              serve_launches + train_launches[fwd],
              launches_by_path={"serve": serve_launches,
                                "train": train_launches[fwd]}),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dkv"],
              train_launches["flash_attention_bwd_dkv"]),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dq"],
              train_launches["flash_attention_bwd_dq"]),
        entry("fused_adam", "fused_adam.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:218", adam,
              train_launches["fused_adam"] + char_adam_launches,
              launches_by_path={"train": train_launches["fused_adam"],
                                "char_lstm_train": char_adam_launches}),
        entry("lstm_sequence", "lstm_sequence.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:66", lstm,
              sum(char_launches.values()), launches_by_path=char_launches,
              library="torch.nn.LSTM (cuDNN) with its input product: "
                      "compare with ms_with_input_product",
              ms_with_input_product=lstm["ms_with_input_product"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
