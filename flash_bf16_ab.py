#!/usr/bin/env python3
"""A/B timing of the bf16 kernels of several source trees, on one card, in
one process: the bf16 flash-attention forward, dq and dk/dv kernels and
K1-bf16 (the LSTM sequence kernel's cluster plan on bf16).

    python3 flash_bf16_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...] [kernels=fwd,dq,dkv,lstm,lstm_split]

Each CSRC_DIR is a copy of ``deeplearning4j_tpu_torch/csrc`` (a parent
commit's: ``git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C
<a directory .gitignore lists>``). Its ``flash_attention_fwd.cu``,
``flash_attention_bwd.cu`` and ``lstm_sequence.cu`` are built with the
port's flags into ``deeplearning4j_tpu_torch/build/ab/NAME/``. The bf16
flash kernels of every tree then run at GPT-2-small's [8, 12, 1024, 64],
causal and full, and K1-bf16 at the bf16 char-RNN's [128, 64, 512] and the
char model's [50, 32, 200], on the same inputs, in turns (the trees in
order, then in reverse), called directly through ctypes: each turn is a
CUDA-event median of 50 back-to-back launches and the device time a launch
under torch.profiler. K1-bf16 takes the working tree's cluster plan (S, R)
in every tree, with the card's whole opt-in shared memory a CTA (every
tree's layout fits it; the plan holds one CTA an SM either way). Every
tree's o, dq, dk, dv are held to the working tree's plain versions within
chip_smoke.py's max-abs limit, and its LSTM outputs within chip_smoke.py's
K1-bf16 limits, first. One JSON line per case; the card's name and power
limit first. Needs one NVIDIA GPU.

``lstm_split`` splits a K1-bf16 step of the working tree's
``lstm_sequence.cu`` at the same two shapes: the kernel built as it is,
without its products (-DDL4J_LSTM_SPLIT_NO_PRODUCTS), with a few adds in
place of its cell (-DDL4J_LSTM_SPLIT_NO_CELL) and without both, timed in
turns beside the plan's chain floor (the hand-over and barrier alone). The
cut builds compute wrong values by design and are held to no limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck

RUNS = 50
KERNELS = ("fwd", "dq", "dkv", "lstm", "lstm_split")
SPLIT_CUTS = {"full": (), "no_products": ("-DDL4J_LSTM_SPLIT_NO_PRODUCTS",),
              "no_cell": ("-DDL4J_LSTM_SPLIT_NO_CELL",),
              "neither": ("-DDL4J_LSTM_SPLIT_NO_PRODUCTS", "-DDL4J_LSTM_SPLIT_NO_CELL")}
LSTM_AB_SHAPES = (cs.LSTM_BF16_PATH, (50, 32, 200))


def build_tree(name: str, csrc: str) -> dict:
    """The bf16 forward, dq, dk/dv and cluster-plan LSTM C functions of one
    source tree."""
    out_dir = os.path.join(ck.BUILD_DIR, "ab", name)
    os.makedirs(out_dir, exist_ok=True)

    def build(source):
        lib = os.path.join(out_dir, f"lib{os.path.splitext(source)[0]}.so")
        proc = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", lib,
                               os.path.join(csrc, source)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed on {source}:\n{proc.stderr}")
        return source, lib

    sources = (ck._FWD_SRC, ck._BWD_SRC, ck._LSTM_SRC)
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:  # one nvcc a source
        libs = {source: ctypes.CDLL(lib) for source, lib in ex.map(build, sources)}
    fns = {}
    for kernel, source, symbol, args in (
            ("fwd", ck._FWD_SRC, "dl4j_flash_attention_fwd_bf16", ck._FWD_ARGS),
            ("dq", ck._BWD_SRC, "dl4j_flash_attention_bwd_dq_bf16", ck._BWD_ARGS),
            ("dkv", ck._BWD_SRC, "dl4j_flash_attention_bwd_dkv_bf16", ck._BWD_ARGS),
            ("lstm", ck._LSTM_SRC, "dl4j_lstm_sequence_cluster_bf16",
             ck._LSTM_CLUSTER_ARGS)):
        fn = getattr(libs[source], symbol)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[kernel] = fn
    return fns


def check(name, kernel, outs, limit_of):
    torch.cuda.synchronize()
    for got, ref in outs:
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= limit_of(ref):
            raise RuntimeError(f"{name} {kernel}: max abs err {err}")


def turns(order, trees, calls, row):
    """Times each tree's call in ``order`` into ``row`` and prints it."""
    row.update(turns=order, ms={name: [] for name in trees},
               device_ms={name: [] for name in trees})
    for name in order:
        fn = calls[name]
        row["ms"][name].append(cs.median_ms(fn, runs=RUNS))
        row["device_ms"][name].append(cs.device_ms_per_call(fn))
    print("ab " + json.dumps(row), flush=True)


def flash_ab(fns, trees, order, kernels, stream):
    shape = cs.SERVED_SHAPE
    n, h, t, dh = shape
    bf = torch.bfloat16
    rng = np.random.default_rng(2)
    flash_limit = lambda ref: cs.BF16_TOL * max(1.0, ref.float().abs().max().item())  # noqa: E731
    for causal in (True, False):
        q, k, v, do = (cs._randn(rng, shape).to(bf) for _ in range(4))
        p_o, lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
        p_dq, d = ck.flash_attention_bwd_dq_plain(q, k, v, p_o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
        o, dq, dk, dv = (torch.empty_like(x) for x in (q, q, k, v))
        d_out = torch.empty_like(d)
        calls = {}
        for name, fn in fns.items():
            calls[(name, "fwd")] = lambda f=fn["fwd"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, n * h, t, dh,
                int(causal), stream)
            calls[(name, "dq")] = lambda f=fn["dq"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), p_o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), dq.data_ptr(), d_out.data_ptr(), n * h, t, dh, int(causal),
                stream)
            calls[(name, "dkv")] = lambda f=fn["dkv"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
                d.data_ptr(), dk.data_ptr(), dv.data_ptr(), n * h, t, dh, int(causal), stream)
            for kernel, outs in (("fwd", ((o, p_o),)), ("dq", ((dq, p_dq), (d_out, d))),
                                 ("dkv", ((dk, p_dk), (dv, p_dv)))):
                if kernel not in kernels:
                    continue
                if calls[(name, kernel)]() != 0:
                    raise RuntimeError(f"{name} {kernel}: launch failed")
                check(name, f"{kernel} causal={causal}", outs, flash_limit)
        for kernel in ("fwd", "dq", "dkv"):
            if kernel in kernels:
                turns(order, trees, {name: calls[(name, kernel)] for name in trees},
                      {"kernel": kernel, "shape": list(shape), "causal": causal})
        del q, k, v, do, o, dq, dk, dv, p_o, p_dq, p_dk, p_dv, lse, d, d_out


def lstm_ab(fns, trees, order, stream):
    bf = torch.bfloat16
    rng = np.random.default_rng(4)
    smem = ck._device_lstm_limits(torch.cuda.current_device())[1]
    for shape in LSTM_AB_SHAPES:
        t, n, h = shape
        xw = cs._randn(rng, (t, n, 4 * h)).to(bf)
        rw = cs._randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        h0, c0 = cs._randn(rng, (n, h), 0.5).to(bf), cs._randn(rng, (n, h)).to(bf)
        plan = ck.lstm_plan_for(xw)
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        exact = ck.lstm_sequence_plain(xw.double(), rw.double(), h0.double(), c0.double())
        ys, hn, cn = (torch.empty_like(x) for x in plain)
        calls = {}
        for name, fn in fns.items():
            calls[name] = lambda f=fn["lstm"]: f(
                xw.data_ptr(), rw.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
                hn.data_ptr(), cn.data_ptr(), t, n, h, plan["S"], plan["R"], smem, stream)
            if calls[name]() != 0:
                raise RuntimeError(f"{name} lstm: launch failed")
            torch.cuda.synchronize()
            r = cs.bf16_lstm_readings((ys, hn, cn), plain, exact)
            if not (r["elem_units"] <= cs.LSTM_BF16_ELEM_TOL
                    and r["rel_frob"] <= cs.LSTM_BF16_FROB_TOL
                    and r["f64_ratio"] <= cs.LSTM_BF16_F64_RATIO):
                raise RuntimeError(f"{name} lstm {shape}: {json.dumps(r)}")
        turns(order, trees, calls, {"kernel": "lstm_bf16", "shape": list(shape),
                                    "S": plan["S"], "R": plan["R"], "smem": smem})
        del xw, rw, h0, c0, plain, exact, ys, hn, cn


def lstm_split(stream):
    """The working tree's K1-bf16 built whole and cut (SPLIT_CUTS), timed
    in turns beside the chain floor; no limits (the cuts are wrong)."""
    out_dir = os.path.join(ck.BUILD_DIR, "ab", "split")
    os.makedirs(out_dir, exist_ok=True)

    def build(cut):
        lib = os.path.join(out_dir, f"liblstm_sequence_{cut}.so")
        proc = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, *SPLIT_CUTS[cut], "-o", lib,
                               os.path.join(ck.CSRC_DIR, ck._LSTM_SRC)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"split {cut}: nvcc failed:\n{proc.stderr}")
        fn = ctypes.CDLL(lib).dl4j_lstm_sequence_cluster_bf16
        fn.argtypes, fn.restype = ck._LSTM_CLUSTER_ARGS, ctypes.c_int
        return cut, fn

    with ThreadPoolExecutor(max_workers=len(SPLIT_CUTS)) as ex:
        fns = dict(ex.map(build, SPLIT_CUTS))
    bf = torch.bfloat16
    rng = np.random.default_rng(4)
    smem = ck._device_lstm_limits(torch.cuda.current_device())[1]
    for shape in LSTM_AB_SHAPES:
        t, n, h = shape
        xw = cs._randn(rng, (t, n, 4 * h)).to(bf)
        rw = cs._randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        h0, c0 = cs._randn(rng, (n, h), 0.5).to(bf), cs._randn(rng, (n, h)).to(bf)
        plan = ck.lstm_plan_for(xw)
        ys = torch.empty((t, n, h), dtype=bf, device=xw.device)
        hn, cn = torch.empty_like(h0), torch.empty_like(c0)
        calls = {cut: (lambda f=fn: f(xw.data_ptr(), rw.data_ptr(), h0.data_ptr(),
                                      c0.data_ptr(), ys.data_ptr(), hn.data_ptr(),
                                      cn.data_ptr(), t, n, h, plan["S"], plan["R"], smem,
                                      stream))
                 for cut, fn in fns.items()}
        for cut, call in calls.items():
            if call() != 0:
                raise RuntimeError(f"split {cut}: launch failed")
        torch.cuda.synchronize()
        row = {"kernel": "lstm_bf16_split", "shape": list(shape), "S": plan["S"],
               "R": plan["R"], "device_ms": {cut: [] for cut in SPLIT_CUTS}}
        for cut in list(SPLIT_CUTS) + list(SPLIT_CUTS)[::-1]:
            row["device_ms"][cut].append(cs.device_ms_per_call(calls[cut]))
        row["chain_floor_ms"] = cs.device_ms_per_launch(
            lambda: ck.lstm_chain_floor(t, plan, n, h), "lstm_chain_floor")
        print("ab " + json.dumps(row), flush=True)
        del xw, rw, h0, c0, ys, hn, cn


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bf16_ab: needs an NVIDIA GPU")
    args = dict(arg.split("=", 1) for arg in sys.argv[1:])
    kernels = args.pop("kernels", ",".join(KERNELS)).split(",")
    trees = args
    if (not trees and kernels != ["lstm_split"]) or any(k not in KERNELS for k in kernels):
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    if trees:
        with ThreadPoolExecutor(max_workers=len(trees)) as ex:  # every tree's nvcc at once
            built = dict(zip(trees, ex.map(build_tree, trees, trees.values())))
        fns = {name: built[name] for name in trees}
        order = list(trees) + list(trees)[::-1]
        if any(k in kernels for k in ("fwd", "dq", "dkv")):
            flash_ab(fns, trees, order, kernels, stream)
        if "lstm" in kernels:
            lstm_ab(fns, trees, order, stream)
    if "lstm_split" in kernels:
        lstm_split(stream)

if __name__ == "__main__":
    main()
