#!/usr/bin/env python3
"""A/B timing of the bf16 flash-attention kernels of several source trees,
on one card, in one process.

    python3 flash_bf16_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR is a copy of ``deeplearning4j_tpu_torch/csrc`` (a parent
commit's: ``git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C
<a directory .gitignore lists>``). Its ``flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` are built with the port's flags into
``deeplearning4j_tpu_torch/build/ab/NAME/``. The bf16 forward and dk/dv
kernels of every tree then run at GPT-2-small's [8, 12, 1024, 64], causal
and full, on the same inputs, in turns (the trees in order, then in
reverse), called directly through ctypes: each turn is a CUDA-event median
of 50 back-to-back launches and the device time a launch under
torch.profiler. Every tree's o, dk and dv are held to the working tree's
plain versions within chip_smoke.py's max-abs limit first. One JSON line
per case; the card's name and power limit first. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck

RUNS = 50


def build_tree(name: str, csrc: str) -> dict:
    """The bf16 forward and dk/dv C functions of one source tree."""
    out_dir = os.path.join(ck.BUILD_DIR, "ab", name)
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for kernel, source, symbol, args in (
            ("fwd", ck._FWD_SRC, "dl4j_flash_attention_fwd_bf16", ck._FWD_ARGS),
            ("dkv", ck._BWD_SRC, "dl4j_flash_attention_bwd_dkv_bf16", ck._BWD_ARGS)):
        lib = os.path.join(out_dir, f"lib{os.path.splitext(source)[0]}.so")
        proc = subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS, "-o", lib,
                               os.path.join(csrc, source)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed on {source}:\n{proc.stderr}")
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[kernel] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bf16_ab: needs an NVIDIA GPU")
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not trees:
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    fns = {name: build_tree(name, csrc) for name, csrc in trees.items()}
    shape = cs.SERVED_SHAPE
    n, h, t, dh = shape
    bf = torch.bfloat16
    rng = np.random.default_rng(2)
    stream = torch.cuda.current_stream().cuda_stream
    for causal in (True, False):
        q, k, v, do = (cs._randn(rng, shape).to(bf) for _ in range(4))
        p_o, lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
        _, d = ck.flash_attention_bwd_dq_plain(q, k, v, p_o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
        o, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        calls = {}
        for name, fn in fns.items():
            calls[(name, "fwd")] = lambda f=fn["fwd"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, n * h, t, dh,
                int(causal), stream)
            calls[(name, "dkv")] = lambda f=fn["dkv"]: f(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
                d.data_ptr(), dk.data_ptr(), dv.data_ptr(), n * h, t, dh, int(causal), stream)
            for kernel, outs in (("fwd", ((o, p_o),)), ("dkv", ((dk, p_dk), (dv, p_dv)))):
                if calls[(name, kernel)]() != 0:
                    raise RuntimeError(f"{name} {kernel}: launch failed")
                torch.cuda.synchronize()
                for got, ref in outs:
                    err = (got.float() - ref.float()).abs().max().item()
                    if not err <= cs.BF16_TOL * max(1.0, ref.float().abs().max().item()):
                        raise RuntimeError(f"{name} {kernel} causal={causal}: max abs "
                                           f"err {err}")
        order = list(trees) + list(trees)[::-1]
        for kernel in ("fwd", "dkv"):
            row = {"kernel": kernel, "shape": list(shape), "causal": causal, "turns": order,
                   "ms": {name: [] for name in trees},
                   "device_ms": {name: [] for name in trees}}
            for name in order:
                fn = calls[(name, kernel)]
                row["ms"][name].append(cs.median_ms(fn, runs=RUNS))
                row["device_ms"][name].append(cs.device_ms_per_call(fn))
            print("ab " + json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
