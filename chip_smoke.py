#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
started together), prints the compiler's report (registers, spills) of
every kernel, and runs eighteen phases:

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
4. LSTM kernel: the fused LSTM sequence kernel, each plan it takes
   (cluster and grid), against its plain version at the character model's
   shapes (a training chunk, ``output``'s whole example, the sampling
   prime and one sampled step) and two wider ones, timed beside its bound,
   its chain floor (the cluster plan's hand-over of h and barrier alone,
   no arithmetic), its plain version and cuDNN's LSTM (``torch.nn.LSTM``,
   a yardstick the port never calls), with the host time of one call at
   the sampling shape;
5. character LSTM: DL4J's ``LSTMCharModellingExample`` configuration (2 x
   LSTM(200), 77 characters, Adam(0.005), l2 1e-4, TBPTT 50) built with
   ``list()`` as a ``MultiLayerNetwork`` trains on 2 minibatches of 32 x
   1000 characters of this repository's own text (40 TBPTT chunks; the
   loss must fall; 2 LSTM-kernel and 8 fused-Adam launches a chunk, every
   LSTM-kernel launch of training, ``output`` and sampling on the cluster
   plan), one
   chunk's loss and gradients are checked against a twin on the plain
   recurrence, it answers ``output`` over a [32, 1000, 77] batch and
   samples 4 x 300 characters through ``rnn_time_step``;
6. LeNet (``__graft_entry__._lenet``) through ``MultiLayerNetwork``: 5
   epochs with the fused updater, ``evaluate``, a timed window, a twin on
   stock Adam and the model zip on the card and the CPU;
7. regularizers: every dropout and weight-noise variant draws on the card
   at [4096, 4096] (SpatialDropout at [64, 32, 32, 64]) from a CUDA
   generator, and its statistics, its scaling and its determinism under a
   seed are checked; then example 17's regularization family (AlphaDropout,
   MaxNorm, NonNegative, DropConnect) trains 15 epochs with the fused
   updater, its constraints must hold and its accuracy match the JAX
   package's; then LeNet again with dropout 0.5 on the dense layer and
   per-layer L2 gradient renormalization, fed through a fitted
   ``NormalizerStandardize`` and the default prefetch, beside a twin fed
   with ``prefetch_depth=0``: both must evaluate >= 0.95; the step times
   of both ways, and of both ways fed batches made before the window
   (which leaves the producer only the pin and the copy), are printed
   with the device's busy share, and the prefetched batches must come
   from pinned memory on a side stream;
8. GPT-2-small with attention dropout 0.1: 5 ``ComputationGraph.fit``
   steps through a prefetching iterator (150 fused-Adam launches a step,
   no flash launch: the seam declines a dropout-active request), one
   ``output`` (12 flash-forward launches), and a step repeated from the
   dropout generator's saved state must give the same loss;
9. decode: GPT-2-small prefills 8 x 240 seeded ids through
   ``rnn_time_step`` and takes 16 single-token steps through the KV
   caches (no flash launch), each step's probabilities within 1e-4 of
   ``output`` over the same 256 ids (12 flash-forward launches); then
   ``generate`` (the host loop) and ``generate_on_device`` (greedy: the
   same tokens; sampled at temperature 0.8, top_k 40, top_p 0.95: in the
   vocabulary, decided by the seed, and no synchronising call between
   the prefill and the read) from 8 prompts of 128 ids, and
   ``beam_search`` (2 prompts x beam 4, length penalty 1; beam 1 equals
   greedy); each is timed (ms a token from CUDA events at each step,
   tokens/s), profiled (device busy share, launches a step) and set
   beside the bytes bound of its step;
10. GPT-2-small trained by truncated BPTT (chunks of 256 through the
   carried KV caches) with the fused updater: 2 fit calls on one 8 x 1024
   batch (4 chunks and 4 iterations a fit, 150 fused-Adam launches and no
   flash launch a chunk, the mean loss falling), its model zip without
   the updater state restored on the card (the same output) and the CPU
   (within 1e-5), and example 11's TBPTT net's zip with its Adam state;
11. ResNet-50 (the zoo's ``ResNet50``, 1000 labels, seed 1) trained through
   ``ComputationGraph.fit`` at 224x224x3, batch 256 (halved until it
   fits, each batch tried printed with its peak), f32, with the zoo's
   Nesterovs updater: 3 warm-up and 10 timed steps on seeded images
   (images/s, median step, peak memory; finite losses; every running mean
   and variance moved; no launch of K1, K2, K3a or K3b: the reference's
   path has no kernel either), 2 steps under the profiler (busy share,
   kernel groups; the Nesterovs update profiled alone), the step's FLOP
   bound at the f32 CUDA-core peak, ``output`` images/s at batch 256;
   then one step at batch 2 on the card against the same step in the
   port on the CPU (in f64, where the step is well-conditioned: loss,
   parameters and states; in f32: the loss, the Nesterovs update of the
   same gradients, and the gradients no farther from the CPU's f64 ones
   than the CPU's f32 ones are, a few times at most: RESNET_F32_FACTOR;
   the output after the step printed beside the CPU's) and the zip with its layer states restored on the card
   (``output`` equal bit for bit); the Nesterovs update timed alone last,
   so that its extra steps move no weight another check reads;
12. DL4J checkpoints: the four DL4J-format fixtures in ``tests/fixtures``
   restored with ``device="cuda"`` reproduce their recorded outputs, and
   the convnet one fits 3 more steps from its restored Adam state on the
   fused updater (8 K2 launches a step);
13. bf16 kernels (run second, after the f32 kernels): the bf16 flash
   forward and backward kernels against their plain versions (the TPU
   kernel's rounding points; the largest error, each entry's and the
   relative Frobenius error) at GPT-2-small's shape, causal and full, at
   T = 192 (a last block of 64 rows), at N*H = 97 and at Dh 128 and 256,
   each shape with the design that served it (Dh 64: the Hopper design of
   TMA, mbarriers and wgmma; Dh 128 and 256: mma.sync), timed (CUDA-event
   medians and the profiler's device time a launch) beside their bound at
   the tensor cores' bf16 rate, their plain versions and SDPA in bf16
   (its event median and device time too). Before the phases, a SASS check
   of the built libraries: the Hopper kernels hold HGMMA and UTMALDG, the
   mma.sync ones neither;
14. GPT-2-small in mixed precision (``compute_dtype = "bfloat16"``, f32
   masters): 5 fit steps on integer ids with the fused updater (12 / 12 /
   12 bf16 flash launches, no f32 flash launch and 150 fused-Adam
   launches a step), profiled, one bf16 ``output``, and one batch's loss
   and gradients against an f32 twin no farther than a bf16 twin on the
   plain attention is (BF16_WHOLE_RATIO);
15. ResNet-50 in mixed precision as ``bench.py`` runs its headline (batch
   256, 224x224x3): timed, profiled, the FLOP bound at the bf16 rate, the
   running statistics f32 and moved, no kernel launch, the zip restored
   bit for bit, and the card's bf16 gradients at batch 2 against the
   CPU's f64 ones no farther than the CPU's bf16 ones are;
16. LSTM kernel on bf16 (run after the f32 LSTM kernel): K1-bf16 against
   its plain version (``lstm_sequence_plain`` on the same bf16 tensors,
   the TPU kernel's rounding points) at the bf16 path's [128, 64, 512],
   the char model's [50, 32, 200] and [12, 4, 200], [35, 20, 1500] (grid
   plan) and [128, 64, 512] on the grid plan: the largest error, each
   entry's in units of 2^-8 x max(|plain|, 2^-6), the relative Frobenius
   error and the distance from an f64 recurrence against the plain
   version's, each beside its limit; timed beside its bound at the bf16
   tensor-core rate, its chain floor, its plain version and cuDNN's bf16
   LSTM;
17. the bf16 LSTM path at ``bench.py``'s recurrent configuration (2 x
   512, 77 characters, B 64, T 128, Adam(1e-3), ``compute_dtype =
   "bfloat16"``, ordinary fit): its GravesLSTM network as it is (the plain
   loop, 0 K1), the same network on DL4J's standard LSTM (2 K1-bf16 and 8
   K2 launches a step, 2 K1-bf16 in ``output``, no f32 K1; median step,
   characters/s, peak memory, busy share, device time by group; losses
   falling; masters and gradients f32; one batch against an f32 twin no
   farther than a bf16 twin on the plain recurrence is; the zip restored
   with ``output`` equal bit for bit), and a Bidirectional(LSTM(512)) +
   LastTimeStep(LSTM(512)) classifier (3 K1-bf16 launches a forward);
18. the recurrent stack (SimpleRnn, GRU both ways, Bidirectional,
   GravesBidirectionalLSTM, LastTimeStep, MaskZeroLayer, ConvLSTM2D) at
   small width on the card, f32 and bf16, with and without a mask, against
   the same layer on the CPU, with each forward's K1 launches (an unmasked
   Bidirectional or LastTimeStep over a standard LSTM launches K1 of its
   dtype, a masked one does not).

Any failure raises (exit code != 0). The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the main paths, its error against the plain version
and its times beside its bound.

float32 matrix products run in full float32: TF32 is switched off.
"""

from __future__ import annotations

import json
import math
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
# the bf16 flash kernels against their plain versions (the TPU kernel's
# rounding points): o, dq, dk, dv within BF16_TOL x max(1, largest entry)
# (one bf16 ulp is 3.9e-3 relative: the kernel rounds P against its
# running row max, the plain version against the final one, and sums in
# another order), the f32 LSE and D within BF16_ROW_TOL absolute. That
# limit follows the largest entry, which under a causal mask is row 0
# (o[0] = v[0]), so it cannot see a fault in the small late rows. So each
# entry x = sum_j term_j is also held to BF16_ELEM_TOL x (|plain| + A),
# A = sum_j |term_j| (P·|V| for o, |dS|·|K| for dq, |dS|ᵀ·|Q| for dk, Pᵀ·|dO|
# for dv): each version rounds each bf16 term (P or dS) once and the
# result once, at unit roundoff 2^-8, so two right versions differ by at
# most 2^-7 of that, and rows whose terms cancel keep their slack (the
# kernel's exp differs from torch's in the last f32 bits, which flips a
# rare P across a bf16 rounding boundary). dS = P ∘ (dO·Vᵀ − D) is itself
# an f32 difference that cancels (to 0 in row 0 of a causal head), so its
# magnitude in A carries 2^-7 of its own terms, P ∘ (|dO|·|V|ᵀ + |D|), far
# above any f32 evaluation error of it. The whole tensor is held to
# BF16_FROB_TOL in relative Frobenius norm, ||kernel - plain|| / ||plain||
BF16_TOL, BF16_ROW_TOL = 1e-2, 1e-4
BF16_ELEM_TOL, BF16_FROB_TOL = 2 ** -7, 4e-3
# the bf16 wrappers' host time a call: back-to-back calls at a shape whose
# kernels take a few microseconds, on the host clock
FLASH_HOST_SHAPE = (1, 1, 64, 64)
FLASH_BF16_SHAPES = [(SERVED_SHAPE, True), (SERVED_SHAPE, False),
                     ((1, 12, 192, 64), True), ((1, 12, 192, 64), False),
                     ((1, 97, 1024, 64), True),
                     ((2, 4, 256, 128), True), ((2, 4, 256, 128), False),
                     ((2, 2, 256, 256), True), ((2, 2, 256, 256), False)]
# the SASS of the bf16 kernels and of the cluster LSTM kernels: (library
# source, a pattern that matches the start of the kernel's label (name and
# template arguments, kernel_label), instructions it must hold ("A|B": A or
# B), instructions it must not)
HOPPER_SASS = (
    ("flash_attention_fwd.cu", r"flash_attention_fwd_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dkv_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dq_bf16_wgmma_kernel<",
     ("HGMMA", "UTMALDG"), ()),
    ("flash_attention_fwd.cu", r"flash_attention_fwd_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dkv_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd.cu", r"flash_attention_bwd_dq_bf16_kernel<",
     ("HMMA",), ("HGMMA", "UTMALDG")),
    # K1-bf16's cluster plan multiplies on the tensor cores, K1's (f32) on
    # the CUDA cores
    ("lstm_sequence.cu", r"lstm_sequence_cluster_kernel<\d+,bf16>",
     ("HMMA|HGMMA",), ()),
    ("lstm_sequence.cu", r"lstm_sequence_cluster_kernel<\d+>",
     (), ("HMMA", "HGMMA")),
)
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
    ("convolutions and pooling", ("conv", "fprop", "dgrad", "wgrad", "pool")),
    ("K3b flash_attention_bwd_dq", ("flash_attention_bwd_dq_kernel",)),
    ("K3b flash_attention_bwd_dkv", ("flash_attention_bwd_dkv_kernel",)),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("K1 lstm_sequence", ("lstm_sequence_kernel", "lstm_sequence_cluster_kernel")),
    ("random draws", ("distribution", "philox", "bernoulli")),
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
# [T, N, H] of the character model's paths: a TBPTT chunk, output over a
# whole example, the sampling prime ("The network ", 12 characters) and one
# sampled character; then two wider shapes that take the grid plan
LSTM_PATHS = {"train": (50, 32, 200), "output": (1000, 32, 200),
              "sample_prime": (12, 4, 200), "sample": (1, 4, 200)}
LSTM_SHAPES = list(LSTM_PATHS.values()) + [(128, 64, 512), (35, 20, 1500)]
HOST_CALLS = 1000  # back-to-back calls timed on the host clock at the sampling shape
# K1-bf16 against its plain version (lstm_sequence_plain on the same bf16
# tensors: the TPU kernel's rounding points) at the bf16 path's shape
# (bench.py's recurrent configuration: 2 x 512, B 64, T 128), the char
# model's training chunk and sampling prime, and one more on the grid plan
# (H = 1500, whose bf16 rw fits no cluster); [128, 64, 512] once more on
# the grid plan. The two versions round at the same points and differ only
# in the order of the f32 sums of h@rw, so a sum near a bf16 rounding
# boundary rounds the other way and the step carries it on. Held: each
# entry within LSTM_BF16_ELEM_TOL units of 2^-8 x max(|plain|, 2^-6) (one
# bf16 ulp is 1 to 2 such units), the relative Frobenius error within
# LSTM_BF16_FROB_TOL, and the kernel's relative Frobenius distance from an
# f64 recurrence on the same bf16 inputs within LSTM_BF16_F64_RATIO x the
# plain version's
LSTM_BF16_PATH = (128, 64, 512)
LSTM_BF16_SHAPES = [(LSTM_BF16_PATH, "auto"), ((50, 32, 200), "auto"),
                    ((12, 4, 200), "auto"), ((35, 20, 1500), "auto"),
                    (LSTM_BF16_PATH, "grid")]
# The limits, from the first H100 run (2x its worst readings, over these
# five shapes): worst entry 64 units (an entry near 0, where a one-ulp flip
# of a term of magnitude 1/2 to 1 cancels: c = f c + i g), relative
# Frobenius 2.29e-3 (H = 1500), f64 ratio 0.998 to 1.0002
LSTM_BF16_ELEM_TOL, LSTM_BF16_FROB_TOL, LSTM_BF16_F64_RATIO = 128.0, 5e-3, 1.05
# the bf16 LSTM path at bench.py's recurrent configuration (_bench_graveslstm:
# 2 x 512, 77 characters, B 64, T 128, Adam(1e-3), bf16 compute): its
# GravesLSTM network as it is, the same network on DL4J's standard LSTM
# (K1-bf16), and a Bidirectional + LastTimeStep LSTM classifier (2 classes)
LB_BATCH, LB_T, LB_VOCAB, LB_WIDTH = 64, 128, 77, 512
LB_WARMUP, LB_TIMED, LB_GRAVES_TIMED, LB_CLASSIFIER_STEPS = 3, 10, 5, 3
LB_TENSORS = 8  # W, RW, b of each LSTM, W and b of the output layer
# the recurrent stack at small width on the card against the same port
# layer on the CPU (same weights and inputs): f32 within the CPU tests'
# 1e-5 x max(1, largest entry) (outputs) and 1e-5 x the largest entry
# (each gradient); bf16 in the ratio form against the CPU's f64 result
# (BF16_WHOLE_RATIO for the output and the whole gradient, each tensor
# BF16_TENSOR_RATIO or BF16_TENSOR_FLOOR of its norm)
RS_N, RS_T, RS_IN, RS_H, RS_TOL = 4, 10, 12, 16, 1e-5
# the character model (LSTMCharModellingExample): its 77-character set
# (CharacterIterator.getMinimalCharacterSet), widths, batch and TBPTT length
CHARS = ("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ" "0123456789"
         "!&()?-'\",.:; \n\t")
CHAR_WIDTH, CHAR_BATCH, CHAR_LEN, CHAR_TBPTT, CHAR_BATCHES = 200, 32, 1000, 50, 2
CORPUS = ("ARCHITECTURE.md", "SURVEY.md")  # the repository's own text
N_SAMPLES, SAMPLE_LEN, PRIME = 4, 300, "The network "
# LeNet (__graft_entry__._lenet through the port's DSL) on the verify
# skill's data: 1024 seeded 28x28x1 images with a planted row signal, 5
# epochs of batch 128, then a timed window of LENET_TIMED steps after
# LENET_WARMUP, and output at batch LENET_OUT_BATCH
LENET_N, LENET_BATCH, LENET_EPOCHS, LENET_TENSORS = 1024, 128, 5, 8
LENET_WARMUP, LENET_TIMED, LENET_OUT_BATCH, LENET_MIN_ACCURACY = 2, 64, 256, 0.95
# the fused updater against stock Adam on a twin over 3 steps (cuDNN
# deterministic on both): each parameter within 1e-5 x its largest entry,
# the loss within 1e-6 relative; the zip's reload (card and CPU) within
# 1e-5 of the saved net's output
LENET_TWIN_STEPS, LENET_PARAM_TOL, LENET_LOSS_RTOL, LENET_ZIP_ATOL = 3, 1e-5, 1e-6, 1e-5
# the kernel path against the plain recurrence on a twin: one chunk's loss
# relative, each gradient relative to its tensor's largest entry; output
# probabilities absolute (the first H100 runs measured 0.0, 3.8e-7 and
# 2.1e-7: the backward is the same plain recomputation on both sides)
CHAR_LOSS_RTOL, CHAR_GRAD_TOL, CHAR_OUT_ATOL = 1e-6, 1e-5, 1e-5
# regularizer draws: a keep fraction within 5 standard errors of p; the
# noise's mean and variance within 1e-2 (AlphaDropout on N(0,1)) and 1%
# (GaussianDropout, the noise of GaussianNoise and WeightNoise)
DRAW_SHAPE, SPATIAL_SHAPE, KEEP_SIGMAS = (4096, 4096), (64, 32, 32, 64), 5.0
ALPHA_TOL, NOISE_RTOL = 1e-2, 1e-2
# example 17's regularization family at its own settings; its accuracy on
# the JAX package on the CPU (``examples/17_...py``'s regularization_family
# run alone) is 1.0, and the port's must lie within 0.05 of it
EX17_N, EX17_BATCH, EX17_EPOCHS, EX17_TENSORS = 512, 128, 15, 4
EX17_JAX_ACCURACY, EX17_ACCURACY_TOL, EX17_MAX_NORM = 1.0, 0.05, 2.0
# the regularized LeNet: 5 epochs each way, then LENET_REG_WINDOW_EPOCHS // 2
# timed epochs of each of four ways in turns (after a warm-up round); a
# step is the interval between two step starts of one epoch (the wait for
# the batch included)
LENET_REG_WINDOW_EPOCHS = 8
# GPT-2-small with attention dropout: 5 fit steps, a repeat within 1e-6
GPT2_DROPOUT, GPT2_REPEAT_RTOL = 0.1, 1e-6
# decode at GPT-2-small width: 8 x 240 seeded ids prefilled through
# rnn_time_step, then 16 single-token steps, each step's probabilities
# within 1e-4 absolute of output over the same 256 ids (the served-answer
# limit: the flash kernel sums in another order); generate, greedy, and
# generate_on_device from 8 prompts of 128 ids; sampling at temperature
# 0.8, top_k 40, top_p 0.95; beam_search on 2 prompts x beam 4
DECODE_N, DECODE_PREFILL, DECODE_STEPS, DECODE_ATOL = 8, 240, 16, 1e-4
GEN_PROMPT, GEN_TOKENS, GEN_PROFILED = 128, 64, 32
SAMPLE_KW = dict(temperature=0.8, top_k=40, top_p=0.95)
BEAM_N, BEAM_SIZE, BEAM_TOKENS, BEAM_PENALTY = 2, 4, 32, 1.0
# GPT-2-small trained by truncated BPTT: chunks of 256 of one 8 x 1024
# batch (the last label column masked, as in example 11), two fit calls;
# the zip of the trained net without its updater state restored on the
# card (output on 2 x 128 ids exact) and the CPU (within 1e-5)
TBPTT_LEN, TBPTT_FITS, ZIP_CPU_ATOL, ZIP_IDS = 256, 2, 1e-5, (2, 128)
# ResNet-50 at ImageNet shape: the batch tried first (halved until a step
# fits), warm-up and timed fit steps, profiled steps; the card's step
# against the CPU's at batch 2: the loss within 1e-5 relative in f32 and
# f64, and in f64 each parameter within 1e-4 x its largest entry and each
# running statistic within 1e-5. A randomly initialized ResNet-50's f32
# step is ill-conditioned (a few ReLU inputs within f32 rounding of zero
# flip sign between two summation orders, and each flip moves whole
# gradient entries), so in f32 the card's parameters after a step are
# printed, not held; held are the Nesterovs update of the same gradients
# (each parameter and its momentum within 2e-5 x the largest entry) and
# the card's f32 gradients against the CPU's f64 ones: the L2 norm of the
# error within RESNET_F32_FACTOR x the CPU's own f32 error, for the whole
# gradient and for each tensor (or within 1% of the tensor's gradient,
# where the CPU's f32 error happens to be smaller than that). The largest
# error of the output after the step is printed beside the CPU's, not
# held: their ratio ranged from 0.20 to 5.6 over three runs
RESNET_BATCH, RESNET_WARMUP, RESNET_TIMED, RESNET_PROFILED = 256, 3, 10, 2
RESNET_SIDE, RESNET_LABELS, RESNET_TWIN_BATCH = 224, 1000, 2
RESNET_LOSS_RTOL, RESNET_PARAM_TOL, RESNET_STATE_TOL = 1e-5, 1e-4, 1e-5
RESNET_UPDATE_TOL, RESNET_F32_FACTOR = 2e-5, 4.0
RESNET_GROUPS = (
    ("pooling", ("pool",)),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                      "xmma", "cudnn", "gemm", "sm90_", "sm80_", "cutlass")),
    ("BN reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# the bf16 paths (mixed precision, compute_dtype "bfloat16", f32 masters):
# GPT-2-small trained as the training phase trains it, on integer ids; its
# one-batch parity in the ratio form: the distance of the kernel path's
# loss and gradients from an f32 twin's (f32 kernels, the same weights)
# over the distance of a bf16 twin on the plain attention (auto-flash
# off) from it: the whole gradient within 2x, each tensor within 3x or
# within 2% of its f32 gradient's norm, the loss within 3x or 1e-3
# relative (bf16 rounds in other places on the two paths, so neither is
# the other's oracle; tests/test_torch_mixed_precision.py holds the same
# form against the JAX package on the CPU)
BF16_WHOLE_RATIO, BF16_TENSOR_RATIO, BF16_TENSOR_FLOOR = 2.0, 3.0, 2e-2
BF16_LOSS_RATIO, BF16_LOSS_FLOOR = 3.0, 1e-3
GPT2_BF16_GROUPS = (
    ("K3a-bf16", ("flash_attention_fwd_bf16_",)),  # either design
    ("K3b-dq-bf16", ("flash_attention_bwd_dq_bf16_",)),
    ("K3b-dkv-bf16", ("flash_attention_bwd_dkv_bf16_",)),
    ("K3 f32", ("flash_attention_fwd_kernel", "flash_attention_bwd_dq_kernel",
                "flash_attention_bwd_dkv_kernel")),
    ("K2 fused_adam", ("fused_adam_kernel",)),
    ("softmax", ("softmax",)),
    ("gathers and scatters", ("index", "scatter", "gather", "embedding")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# GEMM kernels by their names; f32 ones among them by these markers (on
# the bf16 path the f32 products are the loss head's)
GEMM_MARKS = ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "nvjet")
F32_GEMM_MARKS = ("sgemm", "f32f32_f32", "tf32", "nvjet_sss", "_s1688", "simt")
# ResNet-50 in bf16 as bench.py runs it (its headline): the same batch,
# steps and twin batch as the f32 phase; the card's bf16 gradients at
# batch 2 against the CPU's f64 ones, over the CPU's own bf16 distance
# from them, in the same ratio form (per tensor within 3x or 5% of its
# f64 gradient's norm: a random ResNet-50's step is ill-conditioned, and
# bf16 flips more ReLU inputs than f32 does)
RESNET_BF16_TENSOR_FLOOR = 5e-2
# the DL4J-format fixtures (tests/fixtures): output within rtol 1e-5 / atol
# 1e-6 of the recorded one (the CPU tests' limit); the convnet's 3 more
# fit steps on the fused updater, 8 K2 launches a step
DL4J_FIXTURES = ("convnet", "lstm", "graph", "branchy_graph")
DL4J_RTOL, DL4J_ATOL, DL4J_FIT_STEPS, DL4J_CONVNET_TENSORS = 1e-5, 1e-6, 3, 8


def card_peaks(name: str):
    """The card's peaks from NVIDIA's data sheets (dense, at the full power
    limit): ``f32`` (non-tensor FLOP/s), ``tf32`` and ``bf16`` (tensor-core
    FLOP/s), ``mem`` (bytes/s) and a ``label``."""
    if "H100" in name and "PCIe" in name:
        f32, tf32, bf16, mem, label = 51e12, 378e12, 756e12, 2.0e12, "H100 PCIe"
    elif "H100" in name and "NVL" in name:
        f32, tf32, bf16, mem, label = 60e12, 417e12, 835e12, 3.9e12, "H100 NVL"
    elif "H200" in name:
        f32, tf32, bf16, mem, label = 67e12, 495e12, 989e12, 4.8e12, "H200 SXM"
    else:
        f32, tf32, bf16, mem, label = 67e12, 495e12, 989e12, 3.35e12, "H100 SXM"
    return {"f32": f32, "tf32": tf32, "bf16": bf16, "mem": mem,
            "label": f"{label}: {f32 / 1e12:g} TFLOP/s f32, {tf32 / 1e12:g} "
                     f"TFLOP/s TF32, {bf16 / 1e12:g} TFLOP/s bf16, "
                     f"{mem / 1e12:g} TB/s"}


def bound(flops, nbytes, peaks, rate="f32"):
    """(least time in ms, what bounds it): the larger of the operations
    over the compute rate and the bytes over the memory rate. ``rate``
    "f32" is the CUDA cores' f32 rate; "3xtf32" counts each f32-accurate
    product as three TF32 products on the tensor cores; "bf16" is the
    tensor cores' dense bf16 rate."""
    if rate == "f32":
        t_ops = flops / peaks["f32"] * 1e3
    elif rate == "bf16":
        t_ops = flops / peaks["bf16"] * 1e3
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


def flash_bound_bf16(shape, causal, peaks, products=2, heads_io=4, rows_io=0):
    """The bound of a bf16 attention kernel: ``products`` [T x T x Dh] bf16
    matrix products over the pairs this causality needs at the tensor
    cores' bf16 rate, against ``heads_io`` bf16 [N,H,T,Dh] and ``rows_io``
    f32 [N,H,T] tensors read or written once each."""
    n, h, t, dh = shape
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * n * h * dh * pairs
    nbytes = n * h * t * (2.0 * heads_io * dh + 4.0 * rows_io)
    ms, by = bound(flops, nbytes, peaks, "bf16")
    return {"bound_ms": ms, "bound_by": by}


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


def bf16_term_sums(ck, q, k, v, lse, do, d, causal):
    """Each bf16 output's sum of absolute terms A, from the plain version's
    f32 P and scaled dS: ``{"o": P·|V|, "dq": |dS|·|K|, "dk": |dS|ᵀ·|Q|,
    "dv": Pᵀ·|dO|}``, with |dS| = |bf16(dS)| + BF16_ELEM_TOL x P ∘ (|dO|·|V|ᵀ
    + |D|)·scale (dS's own terms)."""
    p, ds = ck._p_ds_bf16(q, k, v, lse, do, d, causal)
    own = torch.einsum("nhqd,nhkd->nhqk", do.float().abs(), v.float().abs())
    own = p * (own + d.abs()[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    ds = ds.to(torch.bfloat16).float().abs() + BF16_ELEM_TOL * own
    del own
    out = {"o": torch.einsum("nhqk,nhkd->nhqd", p, v.float().abs()),
           "dq": torch.einsum("nhqk,nhkd->nhqd", ds, k.float().abs()),
           "dk": torch.einsum("nhqk,nhqd->nhkd", ds, q.float().abs()),
           "dv": torch.einsum("nhqk,nhqd->nhkd", p, do.float().abs())}
    del p, ds
    return out


def bf16_readings(got, ref, terms):
    """A bf16 kernel output against its plain version: the max abs error,
    the largest |got - ref| / (BF16_ELEM_TOL (|ref| + terms)) (at most 1
    passes; ``terms`` is the entry's sum of absolute terms) and the
    relative Frobenius error."""
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    scale = BF16_ELEM_TOL * (r.abs() + terms.double())
    return {"max_abs_err": diff.max().item(),
            "elem_ratio": (diff / scale.clamp_min(1e-30)).max().item(),
            "frob_rel_err": (diff.norm() / r.norm().clamp_min(1e-30)).item()}


def flash_bf16_phase(ck, peaks):
    """The bf16 flash kernels (K3a-bf16, K3b-dq-bf16, K3b-dkv-bf16) against
    their plain versions (the TPU kernel's rounding points) on the card,
    causal and full, Dh 64/128/256: o, dq, dk, dv within BF16_TOL x max(1,
    largest entry), each entry within BF16_ELEM_TOL x (|plain| + its sum
    of absolute terms) and the whole within BF16_FROB_TOL relative
    Frobenius error, the f32 LSE and D within BF16_ROW_TOL; the backward
    kernels take the forward kernel's own o and LSE. Timed (CUDA-event
    medians of 25, and the profiler's device time a launch) beside their
    bf16 bound, their plain versions and SDPA in bf16 (forward; its
    backward for dq + dk/dv in one call; both timed the same two ways).
    Each shape prints the design that served the forward, the dq and the
    dk/dv kernel. Returns the rows at GPT-2-small's training shape, causal."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    bf = torch.bfloat16
    served = None
    for shape, causal in FLASH_BF16_SHAPES:
        q, k, v, do = (_randn(rng, shape).to(bf) for _ in range(4))
        o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
        torch.cuda.synchronize()
        p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
        p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
        p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
        if not all(t.dtype == bf for t in (o, dq, dk, dv)) or not all(
                t.dtype == torch.float32 for t in (lse, d)):
            raise RuntimeError("bf16 flash kernels: o, dq, dk, dv must be bf16 "
                               "and the LSE and D f32")
        terms = bf16_term_sums(ck, q, k, v, lse, do, d, causal)
        errs, readings = {}, {}
        for name, got, ref, row_stat in (
                ("o", o, p_o, False), ("lse", lse, p_lse, True),
                ("dq", dq, p_dq, False), ("d", d, p_d, True),
                ("dk", dk, p_dk, False), ("dv", dv, p_dv, False)):
            if row_stat:
                err = (got - ref).abs().max().item()
                ok = err <= BF16_ROW_TOL
                reading = {"max_abs_err": err, "limit": BF16_ROW_TOL}
            else:
                reading = bf16_readings(got, ref, terms[name])
                err = reading["max_abs_err"]
                reading.update(limit=BF16_TOL * max(1.0, ref.float().abs().max().item()),
                               elem_limit=1.0, frob_limit=BF16_FROB_TOL)
                ok = (err <= reading["limit"] and reading["elem_ratio"] <= 1.0
                      and reading["frob_rel_err"] <= BF16_FROB_TOL)
            errs[name], readings[name] = err, reading
            if not ok:
                raise RuntimeError(f"bf16 flash {shape} causal={causal}: {name} "
                                   f"outside its limits: {json.dumps(reading)}")
        del terms
        design = {kernel: ck.flash_bf16_tiles(kernel, shape[-1])[0]
                  for kernel in ("fwd", "dq", "dkv")}
        print(f"flash_bf16 agreement {list(shape)} causal={causal} design="
              f"{json.dumps(design)} " + json.dumps(readings), flush=True)
        ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        lib_bwd_ms = median_ms(lib_bwd)
        lib_bwd_device_ms = device_ms_per_call(lib_bwd)
        lib_fwd = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        fwd = lambda: ck.flash_attention_fwd(q, k, v, causal)  # noqa: E731
        dq_call = lambda: ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)  # noqa: E731
        dkv = lambda: ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)  # noqa: E731
        if (shape, causal) == (SERVED_SHAPE, True):
            print("library kernels of SDPA's bf16 forward and backward "
                  + json.dumps({"forward": library_kernels(lib_fwd),
                                "backward": library_kernels(lib_bwd)}), flush=True)
        rows = {
            "fwd": {"max_abs_err": errs["o"], "lse_max_abs_err": errs["lse"],
                    "design": design["fwd"], "ms": median_ms(fwd),
                    "device_ms": device_ms_per_launch(fwd, "flash_attention_fwd_bf16_"),
                    "plain_ms": median_ms(lambda: ck.flash_attention_plain(
                        q, k, v, causal)),
                    "library_ms": median_ms(lib_fwd),
                    "library_device_ms": device_ms_per_call(lib_fwd),
                    **flash_bound_bf16(shape, causal, peaks)},
            "dq": {"max_abs_err": errs["dq"], "d_max_abs_err": errs["d"],
                   "design": design["dq"], "ms": median_ms(dq_call),
                   "device_ms": device_ms_per_launch(dq_call, "flash_attention_bwd_dq_bf16_"),
                   "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dq_plain(
                       q, k, v, o, lse, do, causal)),
                   "library_ms": lib_bwd_ms, "library_device_ms": lib_bwd_device_ms,
                   **flash_bound_bf16(shape, causal, peaks, products=3,
                                      heads_io=6, rows_io=2)},
            "dkv": {"max_abs_err": max(errs["dk"], errs["dv"]),
                    "design": design["dkv"], "ms": median_ms(dkv),
                    "device_ms": device_ms_per_launch(dkv, "flash_attention_bwd_dkv_bf16_"),
                    "plain_ms": median_ms(lambda: ck.flash_attention_bwd_dkv_plain(
                        q, k, v, lse, do, d, causal)),
                    "library_ms": lib_bwd_ms, "library_device_ms": lib_bwd_device_ms,
                    **flash_bound_bf16(shape, causal, peaks, products=4,
                                       heads_io=6, rows_io=2)},
        }
        total = rows["dq"]["ms"] + rows["dkv"]["ms"]
        for name, row in rows.items():
            row.update(shape=list(shape), causal=causal)
            if name != "fwd":
                row["k3b_total_ms"] = total
            print(f"kernel flash_bf16_{name} " + json.dumps(row), flush=True)
        if (shape, causal) == (SERVED_SHAPE, True):
            served = rows
        del q, k, v, do, o, lse, dq, d, dk, dv, p_o, p_lse, p_dq, p_d, p_dk, p_dv
        del ql, kl, vl, lib_out, lib_fwd, fwd, dq_call, dkv
    # the wrappers' host time a call: at the served shape the kernels take
    # about as long, so back-to-back CUDA-event medians there can time the
    # host (compare "ms" with "device_ms")
    q, k, v, do = (_randn(rng, FLASH_HOST_SHAPE).to(bf) for _ in range(4))
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    _, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    for name, fn in (("fwd", lambda: ck.flash_attention_fwd(q, k, v, True)),
                     ("dq", lambda: ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)),
                     ("dkv", lambda: ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, True))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        served[name]["host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
        served[name]["host_shape"] = list(FLASH_HOST_SHAPE)
    print("flash_bf16 host " + json.dumps({n: served[n]["host_us_per_call"]
                                           for n in ("fwd", "dq", "dkv")}), flush=True)
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
    # and LeNet's eight tensors, the shapes its fit path gives the kernel
    for i, layer in enumerate(lenet_conf().layers):
        tensors.update({f"lenet {i}/{n}": shape
                        for n, shape in layer.param_shapes().items()})
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


def kernel_group(name: str, groups=KERNEL_GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
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


def profiled(fn, cpu=True, attempts=3):
    """``(profile, wall_ms, device ms by kernel)`` of one synchronised run
    of ``fn()`` under torch.profiler. The profiler on the card has been
    seen to hand back a profile with no device events now and then (the
    same command recorded them in another run); such a profile is run
    again, up to ``attempts`` times, and the last one's error raises.
    ``fn`` must be safe to repeat."""
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        try:
            return prof, wall, device_ms_by_kernel(prof)
        except RuntimeError:
            if attempt == attempts - 1:
                raise
            print(f"profiler: no device time recorded, attempt {attempt + 1} "
                  f"of {attempts}", flush=True)


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


def kernel_label(mangled: str):
    """``name<template args>`` of a mangled kernel name: the length-prefixed
    identifier ending in ``_kernel`` and the integer and bool template
    arguments after it; None for anything else."""
    i = 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        ident, i = mangled[j:j + n], j + n
        if ident.endswith("_kernel"):
            tail = mangled[i:]
            tmpl = tail[:tail.find("EEv") + 1] if tail.startswith("I") else ""
            args = re.findall(r"L[ib](\d+)E", tmpl)
            if "__nv_bfloat16" in tmpl:  # a kernel instantiated on bf16 storage
                args.append("bf16")
            return f"{ident}<{','.join(args)}>"
    return None


def ptxas_report(ck, source):
    """The ``-Xptxas -v`` lines (registers, spills, stack) of every kernel
    in the build log of ``csrc/<source>``, by kernel and template
    arguments (e.g. Dh and causal, or rows and registers of rw)."""
    with open(ck.build(source) + ".log") as f:
        lines = f.read().splitlines()
    report, cur = {}, None
    for line in lines:
        text = line.split(":", 1)[-1].strip() if line.startswith("ptxas") else line.strip()
        if "Compiling entry function" in line:
            m = re.search(r"'(_Z\w+)'", line)
            cur = kernel_label(m.group(1)) if m else None
            if cur:
                report[cur] = []
        elif cur and ("spill" in text or text.startswith("Used")):
            report[cur].append(text)
    return report


def profile_steps(net, x, labels, fits=PROFILED_STEPS, steps_per_fit=1,
                  groups=KERNEL_GROUPS, classify=kernel_group):
    """Device time of ``fits`` more fit calls (``steps_per_fit`` steps
    each) under torch.profiler, per step: by kernel group (``classify(name,
    groups)``), in all, and as a share of the step's wall time (host clock
    around steps that end in a synchronize; kernels of one stream do not
    overlap), with the kernels that take the most."""
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
    by_group = {}
    for name, ms in per_kernel.items():
        g = classify(name, groups)
        by_group[g] = by_group.get(g, 0.0) + ms
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "device_ms_per_step_by_group": dict(sorted(by_group.items(),
                                                   key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [[k[:100], v] for k, v in top],
    }


def gemm_group(name: str, groups):
    """:func:`kernel_group`, with matrix products split into bf16 and f32
    ones by the kernel's name."""
    low = name.lower()
    group = kernel_group(name, groups)
    if group == "other" and any(k in low for k in GEMM_MARKS):
        return ("f32 matrix products (the loss head)"
                if any(k in low for k in F32_GEMM_MARKS) else "bf16 matrix products")
    return group


def ratio_form(port, yard, ref, loss_port, loss_yard, loss_ref, tensor_floor):
    """The distance of ``port``'s gradients (``{key: {name: tensor}}``) and
    loss from ``ref``'s over the distance of ``yard``'s from them: the
    whole gradient (L2), each tensor (with its distance over ``ref``'s
    norm) and the loss; ``ok`` when within BF16_WHOLE_RATIO, each tensor
    within BF16_TENSOR_RATIO or ``tensor_floor`` of its norm, the loss
    within BF16_LOSS_RATIO or BF16_LOSS_FLOOR relative."""
    rows, p_sq, y_sq = [], 0.0, 0.0
    for v, named in ref.items():
        for n, w in named.items():
            w = w.double()
            e_p = (port[v][n].double().to(w.device) - w).norm().item()
            e_y = (yard[v][n].double().to(w.device) - w).norm().item()
            rel = e_p / max(w.norm().item(), 1e-30)
            rows.append((e_p / max(e_y, 1e-30), f"{v}/{n}", rel,
                         e_p <= BF16_TENSOR_RATIO * e_y or rel <= tensor_floor))
            p_sq, y_sq = p_sq + e_p ** 2, y_sq + e_y ** 2
    whole = math.sqrt(p_sq / max(y_sq, 1e-60))
    lp, ly = abs(loss_port - loss_ref), abs(loss_yard - loss_ref)
    worst = max(rows)
    out = {"grad_l2_ratio_whole": whole,
           "grad_l2_ratio_worst": [worst[0], worst[1], worst[2]],
           "grad_tensors_within": sum(r[3] for r in rows),
           "grad_tensors": len(rows), "loss_err": lp, "yardstick_loss_err": ly}
    out["ok"] = (whole <= BF16_WHOLE_RATIO and out["grad_tensors_within"] == len(rows)
                 and lp <= max(BF16_LOSS_RATIO * ly, BF16_LOSS_FLOOR * abs(loss_ref)))
    return out


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


def gpt2_bf16_phase(ck, card):
    """GPT-2-small in bf16 (``compute_dtype``, f32 masters): TRAIN_STEPS fit
    steps at TRAIN_N x T on integer ids with the fused updater (each step
    12 K3a-bf16, 12 K3b-dq-bf16, 12 K3b-dkv-bf16 and 150 K2 launches, no
    f32 flash launch), PROFILED_STEPS more under the profiler (bf16 and f32
    matrix products apart, the f32 loss head's three products timed alone
    beside them), one ``output`` (12 K3a-bf16), then one batch's loss and
    gradients in the ratio form (BF16_WHOLE_RATIO). Returns the launch
    counts of the steps and of the ``output``."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    def bf16_net():
        conf = TransformerLM().conf()  # GPT-2-small, seed 123
        conf.global_conf.compute_dtype = "bfloat16"
        return ComputationGraph(conf).init()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = bf16_net()
    vocab = net.conf.vertices["embed"].obj.n_in
    d_model = net.conf.vertices["embed"].obj.n_out
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = sum(len(named) for named in net.params.values())
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()  # integer ids
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    flash = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
             ck.flash_attention_bwd_dkv)

    def zero():
        for c in (*flash, ck.fused_adam):
            c.launches = 0
        for c in flash:
            c.launches_bf16 = 0

    def read():
        got = {f"{c.__name__}_bf16": c.launches_bf16 for c in flash}
        got.update({c.__name__: c.launches - c.launches_bf16 for c in flash})
        got["fused_adam"] = ck.fused_adam.launches
        return got

    zero()
    losses, events = [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(ids, labels)
        end.record()
        events.append((start, end))
        losses.append(net.score_)
    torch.cuda.synchronize()
    launches = read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    warm_window_ms = events[1][0].elapsed_time(events[-1][1])
    want = {"flash_attention_fwd_bf16": n_layers, "flash_attention_bwd_dq_bf16": n_layers,
            "flash_attention_bwd_dkv_bf16": n_layers, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_adam": n_tensors}
    bad_counts = {k: launches[k] for k, per in want.items()
                  if launches[k] != per * TRAIN_STEPS}
    profile = profile_steps(net, ids, labels, groups=GPT2_BF16_GROUPS,
                            classify=gemm_group)
    # the three f32 products of the loss head alone: logits, their data and
    # weight gradients ([8192, 768] x [768, 50257] and its transposes)
    h32 = torch.randn((TRAIN_N * T, d_model), device="cuda")
    w32 = torch.randn((d_model, vocab), device="cuda") * 0.02
    g32 = torch.randn((TRAIN_N * T, vocab), device="cuda")
    head_ms = median_ms(lambda: (h32 @ w32, g32 @ w32.T, h32.T @ g32),
                        runs=5, warmup=1)
    del h32, w32, g32

    # one bf16 output: 12 K3a-bf16 launches
    zero()
    out = net.output(ids[:2])
    torch.cuda.synchronize()
    out_launches = read()
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (2, T, vocab)
              and bool(torch.isfinite(out.float()).all()))
    del out

    # parity: the kernel path, a bf16 twin on the plain attention and an
    # f32 twin (the f32 kernels), one batch, the same weights
    weights = export_params(net)
    g_k, loss_k = net.compute_gradient_and_score(ids, labels)
    plain = load_reference_params(bf16_net(), weights)
    helpers.set_auto_flash_attention(False)
    try:
        g_p, loss_p = plain.compute_gradient_and_score(ids, labels)
    finally:
        helpers.set_auto_flash_attention(True)
    del plain
    ref = load_reference_params(TransformerLM().init(), weights)
    g_r, loss_r = ref.compute_gradient_and_score(ids, labels)
    del ref
    parity = ratio_form(g_k, g_p, g_r, loss_k, loss_p, loss_r, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values()
                    for t in named.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    helpers.clear_helper("updater")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "steps": TRAIN_STEPS,
        "compute_dtype": "bfloat16", "ids": "int64",
        "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)), "window_ms": window_ms,
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "output_launches": out_launches,
        "peak_device_mem_gb": peak_gb,
        "loss_head_f32_products_ms": head_ms,
        "profile": profile,
        "parity": {"loss_kernel": loss_k, "loss_plain_bf16": loss_p,
                   "loss_f32": loss_r, **parity},
        "grads_f32": grads_f32, "masters_f32": masters_f32,
    }
    print("gpt2_bf16 " + json.dumps(stats), flush=True)
    if bad_counts:
        raise RuntimeError(f"gpt2_bf16: launches {bad_counts} in {TRAIN_STEPS} "
                           f"steps, expected {want} a step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"gpt2_bf16 training did not progress: {losses}")
    if not (out_ok and out_launches["flash_attention_fwd_bf16"] == n_layers
            and out_launches["flash_attention_fwd"] == 0):
        raise RuntimeError(f"gpt2_bf16 output: {out_launches}, ok {out_ok}")
    if not (parity["ok"] and grads_f32 and masters_f32):
        raise RuntimeError(f"gpt2_bf16 parity: {parity}, f32 gradients "
                           f"{grads_f32}, f32 masters {masters_f32}")
    del net, g_k, g_p, g_r, labels, weights
    torch.cuda.empty_cache()
    return {"train": launches, "output": out_launches}


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


def device_ms_per_launch(fn, key: str, launches: int = 20) -> float:
    """Device time (ms) of the kernel whose name contains ``key`` that one
    call of ``fn`` launches, averaged over ``launches`` calls under
    torch.profiler: at T = 1 a kernel is shorter than its host call, so
    CUDA events around back-to-back calls would time the host."""
    fn()

    def calls():
        for _ in range(launches):
            fn()

    _, _, per_kernel = profiled(calls, cpu=False)
    total = sum(ms for k, ms in per_kernel.items() if key in k)
    if total == 0:
        raise RuntimeError(f"torch.profiler recorded no {key} kernel")
    return total / launches  # one such kernel a call


def device_ms_per_call(fn, calls: int = 20) -> float:
    """Device time (ms) of every kernel that one call of ``fn`` launches,
    averaged over ``calls`` calls under torch.profiler (a library call
    may launch several kernels)."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    _, _, per_kernel = profiled(run, cpu=False)
    return sum(per_kernel.values()) / calls


def sass_check(ck):
    """The instructions of the bf16 flash kernels and the cluster LSTM
    kernels in the built libraries (``cuobjdump -sass``): each HOPPER_SASS
    kernel must hold the instructions it lists (one of each "A|B") and none
    of those it must not. Returns, by kernel, the count of each of HGMMA,
    UTMALDG and HMMA; raises on a kernel that breaks its row or is
    missing."""
    tool = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    found, bad = {}, []
    for source in sorted({row[0] for row in HOPPER_SASS}):
        sass = subprocess.run([tool, "-sass", ck.build(source)], capture_output=True,
                              text=True, check=True).stdout
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            label = kernel_label(body.split("\n", 1)[0].strip())
            if label is None:
                continue
            ops = re.findall(r"\b(HGMMA|UTMALDG|HMMA)\.", body)
            counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
            for src, key, need, forbid in HOPPER_SASS:
                if src == source and re.match(key, label):
                    found[label] = counts
                    if (not all(any(counts[op] for op in alt.split("|")) for alt in need)
                            or any(counts[op] for op in forbid)):
                        bad.append(label)
    missing = [key for _, key, _, _ in HOPPER_SASS
               if not any(re.match(key, label) for label in found)]
    if bad or missing:
        raise RuntimeError(f"SASS check: {bad} break their rows, {missing} missing: "
                           f"{json.dumps(found)}")
    return found


def lstm_kernel_phase(ck, peaks):
    """K1 against its plain version at LSTM_SHAPES, on a layer's own
    inputs: x [T,N,H] and W, b give the hoisted xw = x W + b, with a
    Xavier-scale rw and non-zero h0, c0; each plan the shape can take (the
    cluster plan where rw fits one cluster, and the grid plan), its plan
    (S, R, C, shared memory), its time by CUDA events and its device time
    a launch by the profiler, per step, and for the cluster plan its chain
    floor. Timed for the plan "auto" takes: the kernel after the hoisted
    product (what FusedLSTMHelper launches), the plain recurrence, and the
    yardstick: a one-layer torch.nn.LSTM (cuDNN) with the same weights,
    which computes the product itself. At the sampling shape, the host
    time of one call, both plans. Returns the rows by shape."""
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
        auto = ck.lstm_plan_for(xw)
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        runs = 5 if t >= 1000 else 25
        by_plan = {}
        for plan in ("cluster", "grid") if auto["plan"] == "cluster" else ("grid",):
            got = ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
            torch.cuda.synchronize()
            errs = {}
            for name, g, ref in zip(("ys", "hN", "cN"), got, plain):
                errs[name] = (g - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                if not errs[name] <= LSTM_TOL * scale:
                    raise RuntimeError(f"lstm_sequence {shape} {plan} plan: {name} max "
                                       f"abs err {errs[name]} > {LSTM_TOL} x {scale}")
            row = {"max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
                   "ms": median_ms(lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan),
                                   runs=runs),
                   "device_ms": device_ms_per_launch(
                       lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan),
                       "lstm_sequence", launches=5 if t >= 1000 else 20)}
            row["device_ms_per_step"] = row["device_ms"] / t
            if plan == "cluster":
                row.update({k: auto[k] for k in ("S", "U", "R", "C", "smem")})
                row["resident_clusters"] = ck.cluster_occupancy(auto, h)
                row["chain_floor_ms"] = device_ms_per_launch(
                    lambda: ck.lstm_chain_floor(t, auto, n, h), "lstm_chain_floor",
                    launches=5 if t >= 1000 else 20)
                row["chain_floor_ms_per_step"] = row["chain_floor_ms"] / t
            if shape == LSTM_PATHS["sample"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
                row["host_us_per_call"] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS
                torch.cuda.synchronize()
            by_plan[plan] = row
            print(f"kernel lstm_sequence {plan} plan " + json.dumps(
                {"shape": list(shape), **row}), flush=True)
        mine = by_plan[auto["plan"]]
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
                "shape": list(shape), "plan": auto["plan"],
                "max_abs_err": max(r["max_abs_err"] for r in by_plan.values()),
                "ms": mine["ms"], "device_ms": mine["device_ms"],
                "chain_floor_ms": mine.get("chain_floor_ms"),
                "library_max_abs_diff_vs_plain": (lib_ys - plain[0]).abs().max().item(),
                "ms_with_input_product": median_ms(lambda: ck.lstm_sequence(
                    (x @ w + b), rw, h0, c0), runs=runs),
                "plain_ms": median_ms(lambda: ck.lstm_sequence_plain(xw, rw, h0, c0),
                                      runs=5 if t >= 1000 else 25),
                "library_ms": median_ms(lambda: lib(x, state), runs=runs),
                "library": "torch.nn.LSTM on cuDNN, with its input product; "
                           "compare with ms_with_input_product",
            }
        row.update(lstm_bound(shape, peaks))
        print("kernel lstm_sequence " + json.dumps(row), flush=True)
        rows[shape] = row
        del x, w, rw, b, h0, c0, xw, plain, lib, lib_ys
    return rows


def lstm_bound_bf16(shape, peaks):
    """The bound of K1-bf16 at [T, N, H]: the recurrent products (2 T N H 4H
    flops) at the tensor cores' bf16 rate, or reading xw, rw, h0, c0 and
    writing ys, hN, cN once each in bf16."""
    t, n, h = shape
    flops = 2.0 * t * n * h * 4 * h
    nbytes = 2.0 * (t * n * 4 * h + h * 4 * h + 2 * n * h + t * n * h + 2 * n * h)
    ms, by = bound(flops, nbytes, peaks, "bf16")
    return {"bound_ms": ms, "bound_by": by}


def bf16_lstm_readings(got, plain, exact):
    """K1-bf16's outputs ``got`` against ``plain`` (both (ys, hN, cN)) and
    an f64 recurrence ``exact`` on the same inputs: the largest error, the
    worst entry in units of 2^-8 x max(|plain|, 2^-6), the relative
    Frobenius error, and each version's relative Frobenius distance from
    ``exact`` with their ratio; over the three outputs together."""
    g = torch.cat([t.double().reshape(-1) for t in got])
    p = torch.cat([t.double().reshape(-1) for t in plain])
    e = torch.cat([t.reshape(-1) for t in exact])
    err = (g - p).abs()
    units = err / (2.0 ** -8 * p.abs().clamp_min(2.0 ** -6))
    d_k = ((g - e).norm() / e.norm()).item()
    d_p = ((p - e).norm() / e.norm()).item()
    return {"max_abs_err": err.max().item(), "elem_units": units.max().item(),
            "rel_frob": ((g - p).norm() / p.norm()).item(),
            "f64_dist_kernel": d_k, "f64_dist_plain": d_p,
            "f64_ratio": d_k / max(d_p, 1e-30)}


def lstm_bf16_kernel_phase(ck, peaks):
    """K1-bf16 against its plain version on the card at LSTM_BF16_SHAPES,
    on a bf16 layer's own inputs (xw = x W + b in bf16, as FusedLSTMHelper
    computes it, a Xavier-scale rw, non-zero h0, c0): its plan, the
    readings of :func:`bf16_lstm_readings` against their limits, its time
    (CUDA events, median of 25) and device time a launch (profiler) beside
    its bound, the cluster plan's chain floor, the plain version's time and
    the yardstick: a bf16 ``torch.nn.LSTM`` (cuDNN) with the same weights
    and its input product. Raises when a limit fails; returns the rows by
    (shape, plan)."""
    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    rows = {}
    for shape, plan in LSTM_BF16_SHAPES:
        t, n, h = shape
        x = _randn(rng, (t, n, h)).to(bf)
        w = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        rw = _randn(rng, (h, 4 * h), np.sqrt(2.0 / (5 * h))).to(bf)
        b = _randn(rng, (4 * h,), 0.1).to(bf)
        h0, c0 = _randn(rng, (n, h), 0.5).to(bf), _randn(rng, (n, h)).to(bf)
        xw = x @ w + b
        chosen = ck.lstm_plan_for(xw) if plan == "auto" else {"plan": "grid"}
        before = dict(ck.lstm_sequence.launches_by_dtype)
        got = ck.lstm_sequence(xw, rw, h0, c0, plan=plan)
        torch.cuda.synchronize()
        if (ck.lstm_sequence.launches_by_dtype["bf16"] != before["bf16"] + 1
                or ck.lstm_sequence.launches_by_dtype["f32"] != before["f32"]
                or any(o.dtype != bf for o in got)):
            raise RuntimeError(f"lstm_sequence bf16 {shape}: not one bf16 launch "
                               f"with bf16 outputs")
        plain = ck.lstm_sequence_plain(xw, rw, h0, c0)
        exact = ck.lstm_sequence_plain(xw.double(), rw.double(), h0.double(), c0.double())
        row = {"shape": list(shape), "plan": chosen["plan"], "requested": plan,
               **{k: chosen[k] for k in ("S", "U", "R", "C", "smem") if k in chosen},
               **bf16_lstm_readings(got, plain, exact)}
        if chosen["plan"] == "cluster":  # the tensor cores' tiles (M, N, K padded)
            row["mma"] = ck._cluster_mma(h, chosen["S"], chosen["R"])
        row["limits"] = {"elem_units": LSTM_BF16_ELEM_TOL, "rel_frob": LSTM_BF16_FROB_TOL,
                         "f64_ratio": LSTM_BF16_F64_RATIO}
        row["ok"] = (math.isfinite(row["max_abs_err"])
                     and row["elem_units"] <= LSTM_BF16_ELEM_TOL
                     and row["rel_frob"] <= LSTM_BF16_FROB_TOL
                     and row["f64_ratio"] <= LSTM_BF16_F64_RATIO)
        print("lstm_bf16 agreement " + json.dumps(row), flush=True)
        if not row["ok"]:
            raise RuntimeError(f"lstm_sequence bf16 {shape} {plan}: {row}")
        row["ms"] = median_ms(lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan))
        row["device_ms"] = device_ms_per_launch(
            lambda: ck.lstm_sequence(xw, rw, h0, c0, plan=plan), "lstm_sequence")
        row["device_ms_per_step"] = row["device_ms"] / t
        if chosen["plan"] == "cluster":
            row["resident_clusters"] = ck.cluster_occupancy(chosen, h)
            row["chain_floor_ms"] = device_ms_per_launch(
                lambda: ck.lstm_chain_floor(t, chosen, n, h), "lstm_chain_floor")
            row["chain_floor_ms_per_step"] = row["chain_floor_ms"] / t
        row["plain_ms"] = median_ms(lambda: ck.lstm_sequence_plain(xw, rw, h0, c0))
        lib = torch.nn.LSTM(h, h).cuda().to(bf)
        with torch.no_grad():
            lib.weight_ih_l0.copy_(ifgo(w, h).t())
            lib.weight_hh_l0.copy_(ifgo(rw, h).t())
            lib.bias_ih_l0.copy_(ifgo(b, h))
            lib.bias_hh_l0.zero_()
            state = (h0[None].contiguous(), c0[None].contiguous())
            row["library_max_abs_diff_vs_plain"] = (
                lib(x, state)[0].float() - plain[0].float()).abs().max().item()
            row["library_ms"] = median_ms(lambda: lib(x, state))
            row["ms_with_input_product"] = median_ms(
                lambda: ck.lstm_sequence(x @ w + b, rw, h0, c0, plan=plan))
        row["library"] = ("torch.nn.LSTM in bf16 on cuDNN, with its input product; "
                          "compare with ms_with_input_product")
        row.update(lstm_bound_bf16(shape, peaks))
        print("kernel lstm_sequence_bf16 " + json.dumps(row), flush=True)
        rows[(shape, plan)] = row
        del x, w, rw, b, h0, c0, xw, got, plain, exact, lib
    return rows


def lstm_bf16_conf(layer_cls):
    """bench.py's recurrent configuration (_bench_graveslstm) through the
    port's DSL, on ``layer_cls`` (GravesLSTMLayer as bench.py has it, or
    LSTMLayer), compute dtype bf16."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    v, w = LB_VOCAB, LB_WIDTH
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-3)).list()
            .layer(layer_cls(n_in=v, n_out=w, activation="tanh"))
            .layer(layer_cls(n_in=w, n_out=w, activation="tanh"))
            .layer(RnnOutputLayer(n_in=w, n_out=v, activation="softmax",
                                  loss="negativeloglikelihood"))
            .set_input_type(InputType.recurrent(v, LB_T)).build())
    conf.global_conf.compute_dtype = "bfloat16"
    return conf


def lstm_classifier_conf():
    """A sequence classifier at the same width: Bidirectional(LSTM(512))
    (concat), LastTimeStep(LSTM(512)), a 2-class softmax; bf16."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (BidirectionalWrapper,
                                                    LastTimeStepWrapper, LSTMLayer,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    w = LB_WIDTH
    conf = (NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-3)).list()
            .layer(BidirectionalWrapper(layer=LSTMLayer(n_in=LB_VOCAB, n_out=w,
                                                        activation="tanh")))
            .layer(LastTimeStepWrapper(layer=LSTMLayer(n_in=2 * w, n_out=w,
                                                       activation="tanh")))
            .layer(OutputLayer(n_in=w, n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(LB_VOCAB, LB_T)).build())
    conf.global_conf.compute_dtype = "bfloat16"
    return conf


def k1_counts(ck):
    """K1's launches since the last reset, by dtype."""
    return dict(ck.lstm_sequence.launches_by_dtype)


def timed_fits(net, x, y, steps):
    """``steps`` fit steps, each between two CUDA events; returns (step
    ms, losses)."""
    events, losses = [], []
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, y)
        end.record()
        events.append((start, end))
        losses.append(net.score_)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], [float(v) for v in losses]


def lstm_bf16_phase(ck, card):
    """The bf16 LSTM path at full width (see the module docstring). Returns
    K1's launches by path and dtype, and K2's."""
    import tempfile

    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTMLayer, LSTMLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (export_params,
                                                       load_reference_params)

    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, LB_VOCAB, (LB_BATCH, LB_T))).cuda()
    x = F.one_hot(ids, LB_VOCAB).float()
    y = F.one_hot(torch.roll(ids, -1, 1), LB_VOCAB).float()
    chars = LB_BATCH * LB_T
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    paths, out = {}, {}

    def counted(fn):
        ck.reset_lstm_counts()
        ck.fused_adam.launches = 0
        got = fn()
        torch.cuda.synchronize()
        return got, {**k1_counts(ck), "fused_adam": ck.fused_adam.launches}

    # 1. bench.py's GravesLSTM network, unchanged: the plain loop (peepholes)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graves = MultiLayerNetwork(lstm_bf16_conf(GravesLSTMLayer)).init()
    steps = LB_WARMUP + LB_GRAVES_TIMED
    (g_ms, g_losses), paths["graveslstm_bf16_train"] = counted(
        lambda: timed_fits(graves, x, y, steps))
    out["graveslstm"] = {
        "median_step_ms": float(np.median(g_ms[LB_WARMUP:])), "step_ms": g_ms,
        "chars_per_s": chars / (float(np.median(g_ms[LB_WARMUP:])) / 1e3),
        "losses": g_losses, "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": paths["graveslstm_bf16_train"]}
    del graves
    if (paths["graveslstm_bf16_train"]["f32"] or paths["graveslstm_bf16_train"]["bf16"]
            or paths["graveslstm_bf16_train"]["fused_adam"] != LB_TENSORS * steps
            or not np.isfinite(g_losses).all()):
        raise RuntimeError(f"lstm_bf16 GravesLSTM: {out['graveslstm']}")

    # 2. the standard-LSTM network: K1-bf16 in every forward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = MultiLayerNetwork(lstm_bf16_conf(LSTMLayer)).init()
    steps = LB_WARMUP + LB_TIMED
    (s_ms, s_losses), paths["lstm_bf16_train"] = counted(
        lambda: timed_fits(net, x, y, steps))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_steps(net, x, y)
    profile_counts = k1_counts(ck)  # launched under the profiler (not a path)
    o, paths["lstm_bf16_output"] = counted(lambda: net.output(x))
    out_ok = (o.dtype == torch.bfloat16 and tuple(o.shape) == (LB_BATCH, LB_T, LB_VOCAB)
              and bool(torch.isfinite(o.float()).all()))
    med = float(np.median(s_ms[LB_WARMUP:]))
    out["lstm"] = {"median_step_ms": med, "step_ms": s_ms, "chars_per_s": chars / (med / 1e3),
                   "losses": s_losses, "peak_device_mem_gb": peak_gb, "profile": profile,
                   "launches": paths["lstm_bf16_train"],
                   "output_launches": paths["lstm_bf16_output"],
                   "profiled_launches": profile_counts}
    # one batch against twins: f32 (plain recurrence: no f32 K1 in this
    # phase) and bf16 on the plain recurrence, the same weights
    weights = export_params(net)
    g_k, loss_k = net.compute_gradient_and_score(x, y)
    helpers.set_auto_fused_lstm(False)
    try:
        plain = load_reference_params(MultiLayerNetwork(lstm_bf16_conf(LSTMLayer)).init(),
                                      weights)
        g_p, loss_p = plain.compute_gradient_and_score(x, y)
        del plain
        f32_conf = lstm_bf16_conf(LSTMLayer)
        f32_conf.global_conf.compute_dtype = None
        ref = load_reference_params(MultiLayerNetwork(f32_conf).init(), weights)
        g_r, loss_r = ref.compute_gradient_and_score(x, y)
        del ref
    finally:
        helpers.set_auto_fused_lstm(True)
    parity = ratio_form(g_k, g_p, g_r, loss_k, loss_p, loss_r, BF16_TENSOR_FLOOR)
    grads_f32 = all(t.dtype == torch.float32 for named in g_k.values() for t in named.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    out["lstm"]["parity"] = {"loss_kernel": loss_k, "loss_plain_bf16": loss_p,
                             "loss_f32": loss_r, **parity}
    # the zip restored on the card: output bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lstm_bf16.zip")
        net.save(path)
        back = MultiLayerNetwork.load(path)
        zip_equal = bool(torch.equal(back.output(x), o))
        del back
    out["lstm"]["zip_output_bit_for_bit"] = zip_equal
    del net, g_k, g_p, g_r, o

    # 3. the bidirectional classifier: 3 K1-bf16 launches a forward
    torch.cuda.empty_cache()
    cls = MultiLayerNetwork(lstm_classifier_conf()).init()
    labels = F.one_hot(torch.from_numpy(rng.integers(0, 2, LB_BATCH)).cuda(), 2).float()
    (c_ms, c_losses), paths["bidi_classifier_train"] = counted(
        lambda: timed_fits(cls, x, labels, LB_CLASSIFIER_STEPS))
    co, paths["bidi_classifier_output"] = counted(lambda: cls.output(x))
    out["classifier"] = {"step_ms": c_ms, "losses": c_losses,
                         "launches": paths["bidi_classifier_train"],
                         "output_launches": paths["bidi_classifier_output"],
                         "output_shape": list(co.shape)}
    cls_ok = (tuple(co.shape) == (LB_BATCH, 2) and bool(torch.isfinite(co.float()).all())
              and np.isfinite(c_losses).all())
    del cls, co
    helpers.clear_helper("updater")
    print("lstm_bf16 " + json.dumps({"card": card, "batch": [LB_BATCH, LB_T],
                                     "width": LB_WIDTH, "vocab": LB_VOCAB, **out}),
          flush=True)

    want = {"lstm_bf16_train": {"f32": 0, "bf16": 2 * steps, "fused_adam": LB_TENSORS * steps},
            "lstm_bf16_output": {"f32": 0, "bf16": 2, "fused_adam": 0},
            "bidi_classifier_train": {"f32": 0, "bf16": 3 * LB_CLASSIFIER_STEPS,
                                      "fused_adam": 11 * LB_CLASSIFIER_STEPS},
            "bidi_classifier_output": {"f32": 0, "bf16": 3, "fused_adam": 0}}
    bad = {p: paths[p] for p in want if paths[p] != want[p]}
    if bad:
        raise RuntimeError(f"lstm_bf16 launches {bad}, expected {want}")
    if not (np.isfinite(s_losses).all() and np.mean(s_losses[-3:]) < np.mean(s_losses[:3])):
        raise RuntimeError(f"lstm_bf16 training did not progress: {s_losses}")
    if not (out_ok and cls_ok and zip_equal and grads_f32 and masters_f32 and parity["ok"]):
        raise RuntimeError(f"lstm_bf16: output ok {out_ok}, classifier ok {cls_ok}, zip "
                           f"{zip_equal}, f32 gradients {grads_f32}, f32 masters "
                           f"{masters_f32}, parity {parity}")
    return paths


def recurrent_stack_layers():
    """(name, port layer, input kind, K1 launches of an unmasked forward)
    for each layer of the recurrent stack at small width."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf import InputType

    n_in, h = RS_IN, RS_H
    conv = L.ConvLSTM2DLayer(n_in=2, n_out=4, convolution_mode="same")
    conv.output_type(InputType.recurrent_convolutional(8, 8, 2, RS_T))
    return [("simple_rnn", L.SimpleRnnLayer(n_in=n_in, n_out=h), "rnn", 0),
            ("gru_reset_after", L.GRULayer(n_in=n_in, n_out=h), "rnn", 0),
            ("gru_classic", L.GRULayer(n_in=n_in, n_out=h, reset_after=False), "rnn", 0),
            ("bidirectional_lstm",
             L.BidirectionalWrapper(layer=L.LSTMLayer(n_in=n_in, n_out=h)), "rnn", 2),
            ("graves_bidirectional_lstm",
             L.GravesBidirectionalLSTMLayer(n_in=n_in, n_out=h), "rnn", 0),
            ("last_time_step_lstm",
             L.LastTimeStepWrapper(layer=L.LSTMLayer(n_in=n_in, n_out=h)), "rnn", 1),
            ("mask_zero_lstm", L.MaskZeroLayer(layer=L.LSTMLayer(n_in=n_in, n_out=h)),
             "rnn", 0),
            ("conv_lstm2d", conv, "cnn_seq", 0)]


def _stack_run(layer, params, x, mask, w, dtype):
    """One layer's output and the gradients of sum(out * w) by parameter,
    with the parameters and x in ``dtype``."""
    live = {k: v.to(dtype).detach().requires_grad_(True) for k, v in params.items()}
    xd = x.to(dtype)
    if type(layer).__name__ == "LastTimeStepWrapper":
        y = layer.forward(live, xd, mask=mask)
    else:
        y = layer.forward_seq(live, xd, mask=mask)[0]
    grads = torch.autograd.grad((y.double() * w.to(y.device)).sum(), list(live.values()))
    return y.detach(), dict(zip(live, grads))


def recurrent_stack_phase(ck, card):
    """Each layer of the recurrent stack on the card against the same port
    layer on the CPU (same weights, inputs and mask), f32 and bf16, with
    and without a mask; the K1 launches of each card forward. Returns K1's
    launches on the card by dtype."""
    rng = np.random.default_rng(21)
    mask = np.ones((RS_N, RS_T), np.float32)
    mask[1, 6:] = 0.0
    mask[2, 3] = 0.0
    totals = {"f32": 0, "bf16": 0}
    rows, failures = [], []
    for name, layer, kind, unmasked_launches in recurrent_stack_layers():
        params = layer.init_params(torch.Generator().manual_seed(3))
        shape = ((RS_N, RS_T, RS_IN) if kind == "rnn" else (RS_N, RS_T, 8, 8, 2))
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        if name == "mask_zero_lstm":
            x[0, 7] = 0.0
        for with_mask in (False, True):
            m = torch.from_numpy(mask) if with_mask else None
            y_shape = _stack_run(layer, params, x, m, torch.zeros(()), torch.float64)[0].shape
            w = torch.from_numpy(rng.standard_normal(tuple(y_shape)))
            exact, g_exact = _stack_run(layer, params, x, m, w, torch.float64)
            for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                cpu, g_cpu = _stack_run(layer, params, x, m, w, dtype)
                ck.reset_lstm_counts()
                card_p = {k: v.cuda() for k, v in params.items()}
                got, g_got = _stack_run(layer, card_p, x.cuda(),
                                        None if m is None else m.cuda(), w, dtype)
                torch.cuda.synchronize()
                launched = k1_counts(ck)
                totals = {k: totals[k] + launched[k] for k in totals}
                want_launch = {"f32": 0, "bf16": 0}
                if not with_mask:
                    want_launch[tag] = unmasked_launches
                row = {"layer": name, "dtype": tag, "mask": with_mask,
                       "k1_launches": launched, "k1_expected": want_launch}
                got, cpu = got.double().cpu(), cpu.double()
                if tag == "f32":
                    row["out_err"] = (got - cpu).abs().max().item()
                    row["out_limit"] = RS_TOL * max(1.0, cpu.abs().max().item())
                    row["grad_err_rel_to_max"] = max(
                        (g_got[k].double().cpu() - g_cpu[k].double()).abs().max().item()
                        / max(g_cpu[k].abs().max().item(), 1e-30) for k in g_cpu)
                    ok = (row["out_err"] <= row["out_limit"]
                          and row["grad_err_rel_to_max"] <= RS_TOL)
                else:
                    d_card = (got - exact).norm().item()
                    d_cpu = (cpu - exact).norm().item()
                    row["out_ratio"] = d_card / max(d_cpu, 1e-30)
                    parity = ratio_form({0: {k: g.cpu() for k, g in g_got.items()}},
                                        {0: g_cpu}, {0: g_exact}, 0.0, 0.0, 0.0,
                                        BF16_TENSOR_FLOOR)
                    row["grad_ratio_whole"] = parity["grad_l2_ratio_whole"]
                    row["grad_ratio_worst"] = parity["grad_l2_ratio_worst"]
                    ok = (row["out_ratio"] <= BF16_WHOLE_RATIO
                          or d_card <= BF16_TENSOR_FLOOR * exact.norm().item()) and parity["ok"]
                ok = ok and launched == want_launch
                row["ok"] = ok
                rows.append(row)
                print("recurrent_stack " + json.dumps(row), flush=True)
                if not ok:
                    failures.append((name, tag, with_mask))
    print("recurrent_stack_summary " + json.dumps({"card": card, "layers": len(rows) // 4,
                                                  "runs": len(rows), "k1_launches": totals}),
          flush=True)
    if failures:
        raise RuntimeError(f"recurrent_stack: {failures}")
    return totals


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
    by_plan = {}  # the LSTM kernel's launches on each path, by plan

    reset_counts = ck.reset_lstm_counts
    reset_counts()
    ck.fused_adam.launches = 0
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
    by_plan["train"] = dict(ck.lstm_sequence.launches_by_plan)
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
    reset_counts()
    start.record()
    out = net.output(x_out)
    end.record()
    torch.cuda.synchronize()
    output_launches = ck.lstm_sequence.launches
    by_plan["output"] = dict(ck.lstm_sequence.launches_by_plan)
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
    reset_counts()
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
    by_plan["sample"] = dict(ck.lstm_sequence.launches_by_plan)
    if sample_launches != n_lstm * (1 + SAMPLE_LEN) or probs.shape != (N_SAMPLES, v):
        raise RuntimeError(f"sampling: {sample_launches} launches for "
                           f"{1 + SAMPLE_LEN} steps")
    # every main-path launch of the LSTM kernel took the cluster plan
    launched = {"train": train["lstm_sequence"], "output": output_launches,
                "sample": sample_launches}
    for path, counts in by_plan.items():
        if counts != {"cluster": launched[path], "grid": 0}:
            raise RuntimeError(f"{path}: LSTM kernel launches by plan {counts}, "
                               f"expected all {launched[path]} on the cluster plan")
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
        "sample_launches": sample_launches, "lstm_launches_by_plan": by_plan,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_per_chunk": profile,
    }
    print("char-lstm " + json.dumps(stats), flush=True)
    helpers.clear_helper("updater")
    del net, batches, onehot
    return launched, by_plan, train["fused_adam"]


def lenet_conf(regularized=False):
    """``__graft_entry__._lenet``'s LeNet, through the port's DSL: conv 5x5
    20, max pool 2x2, conv 5x5 50, max pool 2x2, dense 500, output 10;
    Adam(1e-3), seed 42, f32, 28x28x1. ``regularized``: dropout 0.5 on the
    dense layer's input and per-layer L2 gradient renormalization."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                    OutputLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    b = NeuralNetConfiguration.builder().seed(42).updater(Adam(1e-3))
    if regularized:
        b = b.gradient_normalization("renormalize_l2_per_layer")
    return (b.list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                    padding=(0, 0), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                    padding=(0, 0), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                    pooling_type="max"))
            .layer(DenseLayer(n_out=500, activation="relu",
                              dropout=0.5 if regularized else None))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="negativeloglikelihood"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())


def lenet_data():
    """The verify skill's data: seeded Gaussian images with row 2 + class
    raised by 2, and one-hot labels."""
    rng = np.random.default_rng(0)
    y_idx = rng.integers(0, 10, LENET_N)
    x = rng.normal(0, 0.3, size=(LENET_N, 28, 28, 1)).astype(np.float32)
    x[np.arange(LENET_N), 2 + y_idx, :, 0] += 2.0
    return x, np.eye(10, dtype=np.float32)[y_idx]


def lenet_phase(ck, card):
    """LeNet through ``MultiLayerNetwork`` on the card: 5 epochs of
    ``fit(ListDataSetIterator)`` with the fused updater, ``evaluate``, a
    timed window of fit steps, 2 profiled steps, ``output`` at batch 256,
    a twin on stock Adam, and the model zip reloaded on the card and on
    the CPU. Returns K2's launches on its fit path."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_updater_state, load_reference_params,
        load_reference_updater_state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = lenet_data()
    data = DataSet(x, y)
    steps_per_epoch = LENET_N // LENET_BATCH
    net = MultiLayerNetwork(lenet_conf()).init()  # on cuda
    n_tensors = sum(len(named) for named in net.params.values())
    if n_tensors != LENET_TENSORS:
        raise RuntimeError(f"LeNet has {n_tensors} parameter tensors")
    helpers.set_helper("updater", ck.FusedUpdaterHelper())

    # 5 epochs through the entry point, counted
    ck.fused_adam.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    net.fit(ListDataSetIterator(data, LENET_BATCH, shuffle=True), epochs=LENET_EPOCHS)
    end.record()
    torch.cuda.synchronize()
    fit_launches = ck.fused_adam.launches
    fit_steps = LENET_EPOCHS * steps_per_epoch
    if fit_launches != LENET_TENSORS * fit_steps or net.iteration != fit_steps:
        raise RuntimeError(f"LeNet fit: {fit_launches} fused_adam launches in "
                           f"{net.iteration} steps, expected {LENET_TENSORS} a step")
    epochs_ms = start.elapsed_time(end)
    ev = net.evaluate(ListDataSetIterator(data, LENET_OUT_BATCH))
    accuracy = ev.accuracy()
    if not accuracy >= LENET_MIN_ACCURACY:
        raise RuntimeError(f"LeNet evaluate: accuracy {accuracy} after "
                           f"{LENET_EPOCHS} epochs\n{ev.stats()}")

    # the timed window: fit steps of batch 128 from the iterator, each
    # between CUDA events, after the warm-up steps
    it = ListDataSetIterator(data, LENET_BATCH, shuffle=True, seed=1)
    batches = []
    while len(batches) < LENET_WARMUP + LENET_TIMED:
        it.reset()
        batches += list(it)
    ck.fused_adam.launches = 0
    events = []
    for i, ds in enumerate(batches[:LENET_WARMUP + LENET_TIMED]):
        if i == LENET_WARMUP:
            torch.cuda.synchronize()
        s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s_.record()
        net.fit(ds)
        e_.record()
        if i >= LENET_WARMUP:
            events.append((s_, e_))
    torch.cuda.synchronize()
    window_launches = ck.fused_adam.launches
    steps = LENET_WARMUP + LENET_TIMED
    if window_launches != LENET_TENSORS * steps:
        raise RuntimeError(f"LeNet window: {window_launches} fused_adam launches "
                           f"in {steps} steps")
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    xb = torch.from_numpy(x[:LENET_BATCH]).cuda()
    yb = torch.from_numpy(y[:LENET_BATCH]).cuda()
    profile = profile_steps(net, xb, yb)

    # output at batch 256 from host images, as a caller hands them over
    x_out = x[:LENET_OUT_BATCH]
    out_ms = median_ms(lambda: net.output(x_out), runs=25, warmup=3)
    out = net.output(x_out)
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    if not (out.shape == (LENET_OUT_BATCH, 10) and rowsum_dev <= ROWSUM_TOL):
        raise RuntimeError(f"LeNet output: shape {tuple(out.shape)}, rows sum "
                           f"off by {rowsum_dev}")

    # twin on stock Adam from the same weights and Adam state
    twin = load_reference_updater_state(
        load_reference_params(MultiLayerNetwork(lenet_conf()).init(),
                              export_params(net)), export_updater_state(net))
    twin.iteration, twin.epoch = net.iteration, net.epoch
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(LENET_TWIN_STEPS):
            net.fit(xb, yb)
        helpers.clear_helper("updater")
        for _ in range(LENET_TWIN_STEPS):
            twin.fit(xb, yb)
    finally:
        torch.backends.cudnn.deterministic = False
        helpers.clear_helper("updater")
    loss_rel = abs(net.score_ - twin.score_) / abs(twin.score_)
    worst_name, worst = "", 0.0
    for i, named in twin.params.items():
        for n, t in named.items():
            rel = ((net.params[i][n] - t).abs().max() / t.abs().max()).item()
            if rel >= worst:
                worst_name, worst = f"{i}/{n}", rel
    if not (loss_rel <= LENET_LOSS_RTOL and worst <= LENET_PARAM_TOL):
        raise RuntimeError(f"LeNet fused updater disagrees with stock Adam: loss "
                           f"rel {loss_rel}, worst parameter {worst_name} {worst}")
    del twin

    # the model zip: saved on the card, loaded on the card and on the CPU
    ref = net.output(x_out)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lenet.zip")
        net.save(path)
        zip_bytes = os.path.getsize(path)
        on_card = MultiLayerNetwork.load(path)
        on_cpu = MultiLayerNetwork.load(path, device="cpu")
    zip_err = {"card": (on_card.output(x_out) - ref).abs().max().item(),
               "cpu": (on_cpu.output(x_out) - ref.cpu()).abs().max().item()}
    if not (on_card.params[0]["W"].is_cuda and not on_cpu.params[0]["W"].is_cuda
            and on_card.iteration == net.iteration
            and max(zip_err.values()) <= LENET_ZIP_ATOL):
        raise RuntimeError(f"LeNet zip round trip: {zip_err}")

    stats = {
        "card": card, "params": net.conf.num_params(), "images": LENET_N,
        "batch": LENET_BATCH, "epochs": LENET_EPOCHS,
        "fit_5_epochs_ms": epochs_ms,
        "fit_5_epochs_images_per_s": LENET_EPOCHS * LENET_N / (epochs_ms / 1e3),
        "evaluate_accuracy": accuracy, "evaluate_f1": ev.f1(),
        "fused_adam_launches": {"fit": fit_launches, "window": window_launches},
        "fused_adam_launches_per_step": fit_launches // fit_steps,
        "window_steps": LENET_TIMED, "window_ms": window_ms,
        "train_images_per_s": LENET_TIMED * LENET_BATCH / (window_ms / 1e3),
        "median_step_ms": float(np.median(step_ms)),
        "train_images_per_s_at_median_step":
            LENET_BATCH / (float(np.median(step_ms)) / 1e3),
        "mean_step_ms": float(np.mean(step_ms)),
        "step_ms_p10_p90": [float(np.percentile(step_ms, 10)),
                            float(np.percentile(step_ms, 90))],
        # the slowest steps of the window, [index, ms]: where its mean
        # leaves its median
        "slowest_steps_ms": [[int(i), step_ms[i]]
                             for i in np.argsort(step_ms)[::-1][:5]],
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / float(np.median(step_ms)),
        "output_batch": LENET_OUT_BATCH, "output_ms": out_ms,
        "output_images_per_s": LENET_OUT_BATCH / (out_ms / 1e3),
        "output_rowsum_dev": rowsum_dev,
        "twin_loss_rel": loss_rel, "twin_worst_param": worst_name,
        "twin_worst_param_rel_to_max": worst,
        "zip_bytes": zip_bytes, "zip_reload_max_abs_diff": zip_err,
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_per_step": profile,
    }
    print("lenet " + json.dumps(stats), flush=True)
    del net, on_card, on_cpu
    return fit_launches + window_launches


def keep_stats(keep, p):
    """The keep fraction of a boolean mask and its distance from ``p`` in
    standard errors; raises beyond KEEP_SIGMAS."""
    n = keep.numel()
    frac = keep.float().mean().item()
    sigmas = (frac - p) / math.sqrt(p * (1.0 - p) / n)
    if not abs(sigmas) <= KEEP_SIGMAS:
        raise RuntimeError(f"keep fraction {frac} over {n} draws is "
                           f"{sigmas:.2f} standard errors from p = {p}")
    return {"p": p, "keep_fraction": frac, "sigmas": sigmas, "draws": n}


def moments(t):
    t = t.double()
    return t.mean().item(), t.var().item()


def draws_phase(card):
    """Every dropout and weight-noise variant draws on the card from a
    CUDA generator; keep fractions, scaling, moments and determinism."""
    from deeplearning4j_tpu_torch.nn.dropout import (AlphaDropout, Dropout,
                                                     GaussianDropout,
                                                     GaussianNoise,
                                                     SpatialDropout)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer
    from deeplearning4j_tpu_torch.nn.train_step import dropout_generator
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect, WeightNoise
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    gen = dropout_generator(7, "cuda")
    src = torch.Generator(device="cuda").manual_seed(8)
    # positive inputs: an output of 0 means dropped
    pos = torch.rand(DRAW_SHAPE, device="cuda", generator=src) + 0.5
    out = {}

    y = Dropout(0.9).apply(pos, gen, True)
    keep = y != 0
    out["Dropout"] = keep_stats(keep, 0.9)
    out["Dropout"]["scaling_exact"] = torch.equal(y[keep], pos[keep] / 0.9)

    xs = torch.rand(SPATIAL_SHAPE, device="cuda", generator=src) + 0.5
    ys = SpatialDropout(0.8).apply(xs, gen, True)
    ks = ys != 0
    out["SpatialDropout"] = keep_stats(ks[:, 0, 0, :], 0.8)
    out["SpatialDropout"].update(
        constant_over_hw=torch.equal(ks.all(dim=2).all(dim=1), ks.any(dim=2).any(dim=1)),
        scaling_exact=torch.equal(ys[ks], xs[ks] / 0.8))

    z = torch.randn(DRAW_SHAPE, device="cuda", generator=src)
    ad = AlphaDropout(0.9)
    ya = ad.apply(z, gen, True)
    f32 = np.float32
    ap = ad.alpha_prime
    a = f32(1.0) / np.sqrt(f32(0.9 + ap * ap * 0.9 * 0.1))
    b = -a * f32(0.1) * f32(ap)
    out["AlphaDropout"] = keep_stats(ya == float(a) * z + float(b), 0.9)
    mean, var = moments(ya)
    out["AlphaDropout"].update(mean=mean, var=var)
    if not (abs(mean) <= ALPHA_TOL and abs(var - 1.0) <= ALPHA_TOL):
        raise RuntimeError(f"AlphaDropout on N(0,1): mean {mean}, var {var}")

    ones = torch.ones(DRAW_SHAPE, device="cuda")
    mean, var = moments(GaussianDropout(0.3).apply(ones, gen, True))
    want = 0.3 / 0.7
    out["GaussianDropout"] = {"mean": mean, "var": var, "var_expected": want}
    if not (abs(mean - 1.0) <= NOISE_RTOL and abs(var / want - 1.0) <= NOISE_RTOL):
        raise RuntimeError(f"GaussianDropout(0.3) noise: {out['GaussianDropout']}")

    zeros = torch.zeros(DRAW_SHAPE, device="cuda")
    mean, var = moments(GaussianNoise(0.1).apply(zeros, gen, True))
    out["GaussianNoise"] = {"mean": mean, "std": math.sqrt(var)}
    if not (abs(mean) <= NOISE_RTOL * 0.1 and abs(math.sqrt(var) / 0.1 - 1.0) <= NOISE_RTOL):
        raise RuntimeError(f"GaussianNoise(0.1) noise: {out['GaussianNoise']}")

    layer = DenseLayer(n_in=DRAW_SHAPE[0], n_out=DRAW_SHAPE[1])
    params = {"W": pos, "b": torch.zeros(DRAW_SHAPE[1], device="cuda")}
    dc = DropConnect(p=0.95).apply(layer, params, gen, True)
    kw = dc["W"] != 0
    out["DropConnect"] = keep_stats(kw, 0.95)
    out["DropConnect"].update(kept_unscaled=torch.equal(dc["W"][kw], pos[kw]),
                              bias_untouched=dc["b"] is params["b"])
    for name, wn, noise_of, want_mean, want_std in (
            ("WeightNoise additive", WeightNoise(),
             lambda w: w - pos, 0.0, 0.01),
            ("WeightNoise multiplicative",
             WeightNoise(distribution=Distribution(kind="normal", mean=1.0, std=0.1),
                         additive=False),
             lambda w: w / pos, 1.0, 0.1)):
        mean, var = moments(noise_of(wn.apply(layer, params, gen, True)["W"]))
        out[name] = {"mean": mean, "std": math.sqrt(var)}
        if not (abs(mean - want_mean) <= NOISE_RTOL * max(want_mean, want_std)
                and abs(math.sqrt(var) / want_std - 1.0) <= NOISE_RTOL):
            raise RuntimeError(f"{name}: {out[name]}")
    for name in ("Dropout", "SpatialDropout"):
        for k in ("scaling_exact", "constant_over_hw"):
            if out[name].get(k) is False:
                raise RuntimeError(f"{name}: {k} fails")
    if not (out["DropConnect"]["kept_unscaled"] and out["DropConnect"]["bias_untouched"]):
        raise RuntimeError(f"DropConnect: {out['DropConnect']}")

    # determinism: the same seed draws the same masks and noise, another
    # seed others
    def draw(seed):
        g = dropout_generator(seed, "cuda")
        return (Dropout(0.9).apply(pos, g, True) != 0,
                GaussianNoise(0.1).apply(zeros, g, True))
    (m1, n1), (m2, n2), (m3, n3) = draw(11), draw(11), draw(12)
    out["same_seed_identical"] = torch.equal(m1, m2) and torch.equal(n1, n2)
    out["other_seed_differs"] = not torch.equal(m1, m3) and not torch.equal(n1, n3)
    if not (out["same_seed_identical"] and out["other_seed_differs"]):
        raise RuntimeError(f"draws under a seed: {out}")
    # a CPU generator never draws for a CUDA tensor
    try:
        Dropout(0.9).apply(pos, torch.Generator(), True)
    except ValueError:
        out["cpu_generator_refused"] = True
    else:
        raise RuntimeError("a CPU generator drew for a CUDA tensor")
    out["dropout_ms"] = median_ms(lambda: Dropout(0.9).apply(pos, gen, True))
    out.update(card=card, shape=list(DRAW_SHAPE), spatial_shape=list(SPATIAL_SHAPE))
    print("regularizers " + json.dumps(out), flush=True)
    del pos, xs, z, ones, zeros, params


def ex17_conf():
    """Example 17's regularization family through the port's DSL: Dense 32
    selu with AlphaDropout(0.9), MaxNorm(2.0) on every layer's weights,
    NonNegative on the biases, DropConnect(0.95), Adam(5e-3), seed 1."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.constraints import (MaxNormConstraint,
                                                         NonNegativeConstraint)
    from deeplearning4j_tpu_torch.nn.dropout import AlphaDropout
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect

    return (NeuralNetConfiguration.builder().seed(1).updater(Adam(5e-3))
            .constrain_weights(MaxNormConstraint(max_norm=EX17_MAX_NORM))
            .constrain_bias(NonNegativeConstraint())
            .weight_noise(DropConnect(p=0.95))
            .list()
            .layer(DenseLayer(n_out=32, activation="selu",
                              dropout=AlphaDropout(p=0.9)))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(10)).build())


def ex17_phase(ck, card):
    """Example 17's regularization family on the card at its own settings
    (512 seeded examples, 15 epochs of batch 128) with the fused updater;
    the constraints must hold after the last step and the accuracy lie
    within EX17_ACCURACY_TOL of the JAX package's. Returns K2's launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, EX17_N)
    x = rng.normal(0, 0.3, size=(EX17_N, 10)).astype(np.float32)
    x[np.arange(EX17_N), cls] += 2.0
    y = np.eye(3, dtype=np.float32)[cls]
    net = MultiLayerNetwork(ex17_conf()).init()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    ck.fused_adam.launches = 0
    try:
        net.fit(ListDataSetIterator(DataSet(x, y), EX17_BATCH, shuffle=True),
                epochs=EX17_EPOCHS)
        torch.cuda.synchronize()
    finally:
        helpers.clear_helper("updater")
    launches = ck.fused_adam.launches
    steps = EX17_EPOCHS * EX17_N // EX17_BATCH
    if launches != EX17_TENSORS * steps or net.iteration != steps:
        raise RuntimeError(f"example 17: {launches} fused_adam launches in "
                           f"{net.iteration} steps")
    col_norm = max(torch.sqrt((net.params[i]["W"] ** 2).sum(0)).max().item()
                   for i in net.params)
    min_bias = min(net.params[i]["b"].min().item() for i in net.params)
    accuracy = net.evaluate(ListDataSetIterator(DataSet(x, y), 256)).accuracy()
    stats = {"card": card, "steps": steps, "fused_adam_launches": launches,
             "max_column_norm": col_norm, "min_bias": min_bias,
             "accuracy": accuracy, "jax_cpu_accuracy": EX17_JAX_ACCURACY}
    print("ex17 " + json.dumps(stats), flush=True)
    if not (col_norm <= EX17_MAX_NORM + 1e-5 and min_bias >= 0.0
            and abs(accuracy - EX17_JAX_ACCURACY) <= EX17_ACCURACY_TOL):
        raise RuntimeError(f"example 17's family: {stats}")
    return launches


def profile_device_ms(run, steps):
    """Device ms a step of ``run()`` (``steps`` steps) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(device_ms_by_kernel(prof).values()) / steps


def lenet_regularized_phase(ck, card):
    """LeNet with dropout 0.5 on the dense input and per-layer L2 gradient
    renormalization, fed through ``NormalizerStandardize`` (fitted on the
    verify skill's data): one net with the default prefetch, a twin from
    the same seed with ``prefetch_depth=0``, 5 epochs each (8 K2 launches
    a step), ``evaluate`` >= 0.95 each; then the producer's host cost a
    batch, and timed epochs of four ways on the first net. Returns K2's
    launches on the two 5-epoch fits."""
    from deeplearning4j_tpu_torch.datasets import (DataSet, ListDataSetIterator,
                                                   NormalizerStandardize,
                                                   NormalizingIterator)
    from deeplearning4j_tpu_torch.datasets import iterators
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    torch.cuda.empty_cache()
    x, y = lenet_data()
    norm = NormalizerStandardize().fit(DataSet(x, y))
    steps_per_epoch = LENET_N // LENET_BATCH

    def batches(seed):
        return NormalizingIterator(
            ListDataSetIterator(DataSet(x, y), LENET_BATCH, shuffle=True, seed=seed), norm)

    ways = {"prefetch": None, "prefetch_depth_0": 0}
    nets, stats = {}, {"card": card, "normalizer": {"mean": norm.mean.tolist(),
                                                    "std": norm.std.tolist()}}
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    launches = 0
    try:
        for way, depth in ways.items():
            net = MultiLayerNetwork(lenet_conf(regularized=True)).init()
            ck.fused_adam.launches = 0
            iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
            net.fit(batches(0), epochs=LENET_EPOCHS, prefetch_depth=depth)
            torch.cuda.synchronize()
            fit_steps = LENET_EPOCHS * steps_per_epoch
            copies = dict(iterators.COPY_STATS)
            want_copies = fit_steps if depth is None else 0
            if (ck.fused_adam.launches != LENET_TENSORS * fit_steps
                    or net.iteration != fit_steps
                    or copies != {"batches": want_copies, "pinned": want_copies,
                                  "side_stream": want_copies}):
                raise RuntimeError(f"regularized LeNet ({way}): "
                                   f"{ck.fused_adam.launches} fused_adam launches "
                                   f"in {net.iteration} steps; copies {copies}")
            launches += ck.fused_adam.launches
            ev = net.evaluate(NormalizingIterator(
                ListDataSetIterator(DataSet(x, y), LENET_OUT_BATCH), norm))
            stats[way] = {"evaluate_accuracy": ev.accuracy(), "copies": copies,
                          "fused_adam_launches_per_step":
                              ck.fused_adam.launches // fit_steps}
            if not ev.accuracy() >= LENET_MIN_ACCURACY:
                raise RuntimeError(f"regularized LeNet ({way}): accuracy "
                                   f"{ev.accuracy()}\n{ev.stats()}")
            nets[way] = net
        # the same seeds, batches and draws both ways
        stats["params_max_abs_diff_between_ways"] = max(
            (nets["prefetch"].params[i][n] - t).abs().max().item()
            for i, named in nets["prefetch_depth_0"].params.items()
            for n, t in named.items())

        # the producer's host work a batch, alone on this thread: the
        # gather and the normalizer, then the pin and the copy's launch
        # (the second pass, on pinned blocks the allocator has cached)
        t0 = time.perf_counter()
        prepared = list(batches(7))
        t1 = time.perf_counter()
        for _ in range(2):
            t2 = time.perf_counter()
            moved = [iterators.device_put_batch(ds, "cuda") for ds in prepared]
            t3 = time.perf_counter()
            for ds in moved:
                iterators.finish_device_put(ds)
            torch.cuda.synchronize()
            del moved
        stats["producer_host_ms_per_batch"] = {
            "gather_and_normalize": (t1 - t0) * 1e3 / len(prepared),
            "pin_and_copy": (t3 - t2) * 1e3 / len(prepared)}

        # timed epochs on one net, the ways in turn, round after round:
        # both ways from the iterator, and both from batches made (gathered
        # and normalized) before the window, which leaves the producer
        # only the pin and the copy; each step start is an event, and each
        # epoch is bracketed by two
        net = nets["prefetch"]
        timed_ways = {
            "prefetch": (None, batches), "prefetch_depth_0": (0, batches),
            "made_before_prefetch": (
                None, lambda seed: iterators.ExistingDataSetIterator(prepared)),
            "made_before_prefetch_depth_0": (
                0, lambda seed: iterators.ExistingDataSetIterator(prepared))}
        starts = {w: [] for w in timed_ways}
        epochs_ms = {w: [] for w in timed_ways}
        fit_batch = net._fit_batch

        def timed_fit_batch(ds):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            current.append(e)
            fit_batch(ds)

        net._fit_batch = timed_fit_batch
        iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
        rounds = LENET_REG_WINDOW_EPOCHS // 2 + 1
        for rnd in range(rounds):
            for way, (depth, source) in timed_ways.items():
                current = []
                s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                s_.record()
                net.fit(source(100 + rnd), epochs=1, prefetch_depth=depth)
                e_.record()
                if rnd > 0:  # the first round warms up
                    starts[way].append(current)
                    epochs_ms[way].append((s_, e_))
        torch.cuda.synchronize()
        del net._fit_batch
        copies = dict(iterators.COPY_STATS)
        want = 2 * rounds * steps_per_epoch  # the two prefetching ways
        if copies != {"batches": want, "pinned": want, "side_stream": want}:
            raise RuntimeError(f"prefetched batches of the timed epochs: {copies}")
        for way, (depth, source) in timed_ways.items():
            step_ms = [a.elapsed_time(b) for ep in starts[way]
                       for a, b in zip(ep[:-1], ep[1:])]
            ep_ms = [a.elapsed_time(b) for a, b in epochs_ms[way]]
            median = float(np.median(step_ms))
            busy_ms = profile_device_ms(
                lambda: net.fit(source(999), epochs=1, prefetch_depth=depth),
                steps_per_epoch)
            stats.setdefault(way, {}).update({
                "timed_epochs": len(ep_ms), "steps": len(step_ms),
                "median_step_ms": median,
                "step_ms_p10_p90": [float(np.percentile(step_ms, 10)),
                                    float(np.percentile(step_ms, 90))],
                "mean_step_ms": float(np.mean(step_ms)),
                "window_images_per_s": len(ep_ms) * LENET_N / (sum(ep_ms) / 1e3),
                "epoch_ms": ep_ms,
                "device_ms_per_step": busy_ms,
                "device_busy_share_of_median_step": busy_ms / median,
            })
        stats["timed_copies"] = copies
    finally:
        helpers.clear_helper("updater")
    print("lenet_regularized " + json.dumps(stats), flush=True)
    del nets
    return launches


def gpt2_attn_dropout_phase(ck, card):
    """GPT-2-small with attention dropout: TRAIN_STEPS fit steps through a
    prefetching iterator with the fused updater (150 K2, no flash launch a
    step), one ``output`` (12 K3a), a step repeated from the dropout
    generator's saved state, 2 profiled steps. Returns the launches."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets import iterators
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM(attn_dropout=GPT2_DROPOUT).init()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    n_tensors = sum(len(named) for named in net.params.values())
    rng = np.random.default_rng(123)
    ids = rng.integers(0, vocab, (TRAIN_N, T))
    x_host = ids.astype(np.float32)  # token ids from the host, as floats
    ids_dev = torch.from_numpy(ids).cuda()
    labels = F.one_hot(torch.cat([ids_dev[:, 1:], ids_dev[:, -1:]], 1), vocab).float()
    batches = iterators.ExistingDataSetIterator(
        [DataSet(x_host, labels) for _ in range(TRAIN_STEPS)])
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        events, losses = [], []
        fit_batch = net._fit_batch

        def timed_fit_batch(ds):
            s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s_.record()
            fit_batch(ds)
            e_.record()
            events.append((s_, e_))
            losses.append(net._score)

        net._fit_batch = timed_fit_batch
        for c in counters:
            c.launches = 0
        iterators.COPY_STATS.update(batches=0, pinned=0, side_stream=0)
        net.fit(batches)  # the default prefetch
        torch.cuda.synchronize()
        del net._fit_batch
        launches = {c.__name__: c.launches for c in counters}
        copies = dict(iterators.COPY_STATS)
        losses = [float(l) for l in losses]
        step_ms = [a.elapsed_time(b) for a, b in events]
        warm_window_ms = events[1][0].elapsed_time(events[-1][1])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0, "fused_adam": n_tensors * TRAIN_STEPS}
        if launches != want:
            raise RuntimeError(f"attention-dropout fit launches {launches}, "
                               f"expected {want}")
        if copies != {"batches": TRAIN_STEPS, "pinned": TRAIN_STEPS,
                      "side_stream": TRAIN_STEPS}:
            raise RuntimeError(f"prefetched batches: {copies}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"attention-dropout training did not progress: "
                               f"losses {losses}")

        # one output: the seam takes the flash forward again (no dropout)
        for c in counters:
            c.launches = 0
        out = net.output(x_host)
        torch.cuda.synchronize()
        output_launches = ck.flash_attention_fwd.launches
        rowsum_dev = (out[:, ::64].double().sum(-1) - 1.0).abs().max().item()
        if not (output_launches == n_layers and ck.flash_attention_bwd_dq.launches == 0
                and out.shape == (TRAIN_N, T, vocab) and rowsum_dev <= ROWSUM_TOL):
            raise RuntimeError(f"output: {output_launches} flash launches, shape "
                               f"{tuple(out.shape)}, rows off by {rowsum_dev}")
        del out

        # a step repeated from the saved generator state gives the same
        # loss; a step from the state after it draws other masks
        with torch.no_grad():
            saved_p = {k: {n: t.clone() for n, t in d.items()} for k, d in net.params.items()}
            saved_s = {k: {n: {s: t.clone() for s, t in st.items()} for n, st in d.items()}
                       for k, d in net.updater_states.items()}
        gen_state, it = net.dropout_generator.get_state(), net.iteration

        def restore():
            with torch.no_grad():
                for k, d in saved_p.items():
                    for n, t in d.items():
                        net.params[k][n].copy_(t)
                for k, d in saved_s.items():
                    for n, st in d.items():
                        for s_name, t in st.items():
                            net.updater_states[k][n][s_name].copy_(t)
            net.iteration = it

        xb = torch.from_numpy(x_host).cuda()
        net.fit(xb, labels)
        loss_a = net.score_
        restore()
        net.dropout_generator.set_state(gen_state)
        net.fit(xb, labels)
        loss_b = net.score_
        restore()
        net.fit(xb, labels)  # the generator has moved on
        loss_c = net.score_
        del saved_p, saved_s
        repeat_rel = abs(loss_a - loss_b) / abs(loss_a)
        if not (repeat_rel <= GPT2_REPEAT_RTOL and loss_c != loss_a):
            raise RuntimeError(f"repeated step: losses {loss_a}, {loss_b} (rel "
                               f"{repeat_rel}); from the next state {loss_c}")
        profile = profile_steps(net, xb, labels)
    finally:
        helpers.clear_helper("updater")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "attn_dropout": GPT2_DROPOUT,
        "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
        "median_step_ms": float(np.median(step_ms)),
        "tokens_per_s_after_first_step":
            (TRAIN_STEPS - 1) * TRAIN_N * T / (warm_window_ms / 1e3),
        "launches": launches, "launches_per_step": {
            k: v // TRAIN_STEPS for k, v in launches.items()},
        "prefetched_copies": copies,
        "output_flash_fwd_launches": output_launches,
        "repeat_losses": [loss_a, loss_b], "repeat_rel": repeat_rel,
        "next_state_loss": loss_c, "peak_device_mem_gb": peak_gb,
        "profile": profile,
    }
    print("gpt2_attn_dropout " + json.dumps(stats), flush=True)
    del net, labels, xb
    return {"train": launches, "fused_adam": launches["fused_adam"],
            "output_fwd": output_launches}


def gpt2_block_and_head_bytes(net):
    """The f32 bytes a decode step reads of the weights: every parameter
    but the embedding table and the positions (a step gathers one row of
    each)."""
    return 4.0 * sum(t.numel() for v, named in net.params.items()
                     if v not in ("embed", "pos") for t in named.values())


def kv_cache_bytes(net, batch):
    """The f32 bytes of every attention layer's full-capacity K and V
    caches at ``batch`` rows."""
    total = 0
    for vd in net.conf.layer_vertices():
        layer = vd.obj
        if hasattr(layer, "max_cache"):
            total += 2 * batch * layer.n_heads * layer.max_cache * layer._dh()
    return 4.0 * total


def profile_call(fn):
    """``(wall_ms, device ms by kernel group, kernel launches)`` of one
    call of ``fn`` under torch.profiler (the host clock around a
    synchronised call)."""
    prof, wall, per_kernel = profiled(fn)
    launches = sum(e.count for e in prof.key_averages()
                   if "cuda" in str(getattr(e, "device_type", "")).lower())
    groups = {}
    for name, ms in per_kernel.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    return wall, groups, launches


class StepEvents:
    """Records a CUDA event as each decode step of ``models._step`` (the
    on-device paths) or each ``rnn_time_step`` call of ``net`` (the host
    loop) starts; ``ms()`` is the median interval between consecutive
    starts, one token's period."""

    def __init__(self, models, net, host_loop):
        self.events, self.host_loop = [], host_loop
        self.target = (net, "rnn_time_step") if host_loop else (models, "_step")
        self.orig = getattr(*self.target)

    def __enter__(self):
        def recorded(*a, **kw):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
            return self.orig(*a, **kw)
        setattr(*self.target, recorded)
        return self

    def __exit__(self, *exc):
        if self.host_loop:
            delattr(*self.target)  # the instance attribute hid the method
        else:
            setattr(*self.target, self.orig)

    def ms(self):
        torch.cuda.synchronize()
        gaps = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        return float(np.median(gaps))


def decode_phase(ck, card, peaks):
    """GPT-2-small decoding: the KV-cache steps against ``output``, then
    ``generate``, ``generate_on_device`` (greedy and sampled, the loop
    checked for synchronisation) and ``beam_search``, each timed and
    profiled beside the bytes bound of its step. Returns the launches."""
    from deeplearning4j_tpu_torch.zoo import models
    from deeplearning4j_tpu_torch.zoo.models import (TransformerLM, beam_search,
                                                     generate, generate_on_device)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = TransformerLM().init()  # GPT-2-small, f32, seed 123, on cuda
    vocab = net.conf.vertices["embed"].obj.n_in
    n_layers = sum(1 for n in net.conf.topo_order if n.endswith("-att"))
    rng = np.random.default_rng(123)
    ids = rng.integers(0, vocab, (DECODE_N, DECODE_PREFILL + DECODE_STEPS))
    x = ids.astype(np.float32)
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv)

    # the KV-cache path against the whole sequence
    for c in counters:
        c.launches = 0
    net.rnn_clear_previous_state()
    probs = [net.rnn_time_step(x[:, :DECODE_PREFILL, None])]
    for j in range(DECODE_PREFILL, x.shape[1]):
        probs.append(net.rnn_time_step(x[:, j:j + 1]))
    torch.cuda.synchronize()
    decode_launches = {c.__name__: c.launches for c in counters}
    full = net.output(x)
    torch.cuda.synchronize()
    output_launches = ck.flash_attention_fwd.launches - decode_launches["flash_attention_fwd"]
    err = max((probs[0] - full[:, :DECODE_PREFILL]).abs().max().item(),
              max((p - full[:, DECODE_PREFILL + i]).abs().max().item()
                  for i, p in enumerate(probs[1:])))
    del probs, full
    if any(decode_launches.values()) or output_launches != n_layers:
        raise RuntimeError(f"decode launched {decode_launches} (expected none); "
                           f"output {output_launches} flash launches, expected "
                           f"{n_layers}")
    if not err <= DECODE_ATOL:
        raise RuntimeError(f"decode disagrees with output: max |a-b| {err}")

    prompts = x[:, :GEN_PROMPT]
    weights_b = gpt2_block_and_head_bytes(net)

    def run(fn, rows, new_tokens, host_loop=False, beams=1, cache_passes=1):
        """fn() once after a short warm-up call, timed (CUDA events at each
        step's start, host wall), then profiled at GEN_PROFILED tokens and
        at 1 (prefill only). ``rows`` sequences come back, each decoded as
        ``beams`` hypotheses (the step's batch is rows x beams)."""
        fn(2)
        torch.cuda.synchronize()
        with StepEvents(models, net, host_loop) as ev:
            t0 = time.perf_counter()
            out = fn(new_tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        wall_1, groups_1, k_1 = profile_call(lambda: fn(1))
        wall_p, groups_p, k_p = profile_call(lambda: fn(GEN_PROFILED + 1))
        dev_1, dev_p = sum(groups_1.values()), sum(groups_p.values())
        steps = GEN_PROFILED
        by_group = {g: (ms - groups_1.get(g, 0.0)) / steps
                    for g, ms in sorted(groups_p.items(), key=lambda kv: -kv[1])}
        nbytes = weights_b + cache_passes * kv_cache_bytes(net, rows * beams)
        bound_ms = nbytes / peaks["mem"] * 1e3
        ms_tok = ev.ms()
        return out, {
            "rows": rows, "beams": beams, "new_tokens": new_tokens,
            "ms_per_token": ms_tok, "tokens_per_s": rows * new_tokens / wall,
            "wall_s": wall,
            "profiled_tokens": steps, "busy_share": dev_p / wall_p,
            "busy_share_steps_only": (dev_p - dev_1) / (wall_p - wall_1),
            "launches_per_step": (k_p - k_1) / steps,
            "device_ms_per_step": (dev_p - dev_1) / steps,
            "device_ms_per_step_by_group": by_group,
            "step_bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms_tok}

    for c in counters:
        c.launches = 0
    host, host_stats = run(lambda n: generate(net, prompts, n), DECODE_N,
                           GEN_TOKENS, host_loop=True)
    dev, dev_stats = run(lambda n: generate_on_device(net, prompts, n),
                         DECODE_N, GEN_TOKENS)
    if not np.array_equal(host, dev):
        raise RuntimeError("generate_on_device (greedy) differs from generate: "
                           f"{(host != dev).sum()} of {host.size} tokens")
    sampled = generate_on_device(net, prompts, GEN_TOKENS, seed=1,
                                 check_no_sync=True, **SAMPLE_KW)
    again = generate_on_device(net, prompts, GEN_TOKENS, seed=1,
                               check_no_sync=True, **SAMPLE_KW)
    other = generate_on_device(net, prompts, GEN_TOKENS, seed=2,
                               check_no_sync=True, **SAMPLE_KW)
    if not (sampled.shape == (DECODE_N, GEN_TOKENS)
            and ((sampled >= 0) & (sampled < vocab)).all()
            and np.array_equal(sampled, again) and not np.array_equal(sampled, other)):
        raise RuntimeError("sampled decode: ids out of the vocabulary, or the "
                           "seed does not decide the draws")
    _, sample_stats = run(
        lambda n: generate_on_device(net, prompts, n, seed=1, **SAMPLE_KW),
        DECODE_N, GEN_TOKENS)
    beam_prompts = prompts[:BEAM_N]
    (beam_toks, beam_scores), beam_stats = run(
        lambda n: beam_search(net, beam_prompts, n, beam_size=BEAM_SIZE,
                              length_penalty=BEAM_PENALTY),
        BEAM_N, BEAM_TOKENS, beams=BEAM_SIZE, cache_passes=3)
    greedy_beam, _ = beam_search(net, beam_prompts, BEAM_TOKENS, beam_size=1)
    if not (np.array_equal(greedy_beam, dev[:BEAM_N, :BEAM_TOKENS])
            and beam_toks.shape == (BEAM_N, BEAM_TOKENS)
            and np.isfinite(beam_scores).all()):
        raise RuntimeError("beam_search: beam 1 differs from greedy, or bad beams")
    gen_launches = {c.__name__: c.launches for c in counters}
    if any(gen_launches.values()):
        raise RuntimeError(f"generation launched flash kernels: {gen_launches}")
    stats = {
        "card": card, "prefill": [DECODE_N, DECODE_PREFILL],
        "steps": DECODE_STEPS, "max_abs_err_vs_output": err,
        "decode_flash_launches": decode_launches,
        "output_flash_fwd_launches": output_launches,
        "generation_flash_launches": gen_launches,
        "generate": host_stats, "generate_on_device": dev_stats,
        "generate_on_device_sampled": dict(sample_stats, **SAMPLE_KW),
        "beam_search": dict(beam_stats, length_penalty=BEAM_PENALTY,
                            scores=beam_scores.tolist(),
                            note="step bytes count the cache gather's read and write"),
        "greedy_equal": True, "sampled_ids": sampled[0, :16].tolist(),
        "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("decode " + json.dumps(stats), flush=True)
    del net
    return {"decode": decode_launches, "output_fwd": output_launches}


def gpt2_tbptt_phase(ck, card):
    """GPT-2-small trained by truncated BPTT (chunks of TBPTT_LEN through
    the carried caches) with the fused updater: TBPTT_FITS fit calls on one
    batch (150 K2 and no flash launch a chunk; the mean loss falls); then
    the model zip without its updater state on the card and the CPU, and
    example 11's TBPTT net with its updater state. Returns the launches."""
    import tempfile

    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import helpers
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import TransformerLM, lm_labels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = TransformerLM().conf()
    conf.backprop_type, conf.tbptt_fwd_length = "truncated_bptt", TBPTT_LEN
    net = ComputationGraph(conf).init()
    vocab = net.conf.vertices["embed"].obj.n_in
    n_tensors = sum(len(named) for named in net.params.values())
    rng = np.random.default_rng(123)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_N, T))).cuda()
    x = ids.float()
    labels = F.one_hot(torch.cat([ids[:, 1:], ids[:, -1:]], 1), vocab).float()
    lmask = torch.ones((TRAIN_N, T), device=x.device)
    lmask[:, -1] = 0.0  # the last step has no next token
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv, ck.fused_adam)
    chunks_per_fit = -(-T // TBPTT_LEN)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        events, losses = [], []
        apply = net._apply_updates

        def timed_apply(grads):
            apply(grads)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
            losses.append(net._score)

        net._apply_updates = timed_apply
        for c in counters:
            c.launches = 0
        iterations = [net.iteration]
        for _ in range(TBPTT_FITS):
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            events.append(e0)
            net.fit(DataSet(x, labels, labels_mask=lmask))
            iterations.append(net.iteration)
        torch.cuda.synchronize()
        del net._apply_updates
    finally:
        helpers.clear_helper("updater")
    launches = {c.__name__: c.launches for c in counters}
    per_fit = chunks_per_fit + 1
    chunk_ms = [events[f * per_fit + i].elapsed_time(events[f * per_fit + i + 1])
                for f in range(TBPTT_FITS) for i in range(chunks_per_fit)]
    losses = [float(l) for l in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunks = TBPTT_FITS * chunks_per_fit
    want = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_adam": n_tensors * chunks}
    if launches != want:
        raise RuntimeError(f"TBPTT fit launches {launches}, expected {want}")
    if np.diff(iterations).tolist() != [chunks_per_fit] * TBPTT_FITS:
        raise RuntimeError(f"iterations {iterations}: expected "
                           f"{chunks_per_fit} a fit")
    fit_means = [float(np.mean(losses[f * chunks_per_fit:(f + 1) * chunks_per_fit]))
                 for f in range(TBPTT_FITS)]
    if not (np.isfinite(losses).all() and fit_means[-1] < fit_means[0]):
        raise RuntimeError(f"TBPTT did not progress: losses {losses}")
    del labels, lmask

    # the zip of the trained net without its updater state
    probe = np.random.default_rng(7).integers(0, vocab, ZIP_IDS).astype(np.float32)
    want_out = net.output(probe)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt2.zip")
        t0 = time.perf_counter()
        net.save(path, save_updater=False)
        write_s = time.perf_counter() - t0
        zip_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = ComputationGraph.load(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        card_diff = (back.output(probe) - want_out).abs().max().item()
        del back
        t0 = time.perf_counter()
        cpu = ComputationGraph.load(path, device="cpu")
        read_cpu_s = time.perf_counter() - t0
        cpu_diff = (cpu.output(probe) - want_out.cpu()).abs().max().item()
        del cpu
    if not (card_diff == 0.0 and cpu_diff <= ZIP_CPU_ATOL):
        raise RuntimeError(f"GPT-2 zip: card output off by {card_diff}, CPU by "
                           f"{cpu_diff}")
    del net, want_out

    # example 11's TBPTT net, with its updater state, on the card
    ex = TransformerLM(vocab_size=11, max_length=32, n_layers=1, d_model=16,
                       n_heads=2, d_ff=32, seed=5).conf()
    ex.backprop_type, ex.tbptt_fwd_length = "truncated_bptt", 8
    small = ComputationGraph(ex).init()
    start = np.random.default_rng(0).integers(0, 11, (64, 1))
    xs = ((start + 3 * np.arange(32)[None, :]) % 11).astype(np.float32)
    small_mask = np.ones(xs.shape, np.float32)
    small_mask[:, -1] = 0.0
    for _ in range(3):
        small.fit(DataSet(xs, lm_labels(xs, 11), labels_mask=small_mask))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ex11.zip")
        small.save(path)
        again = ComputationGraph.load(path)
    same = all(torch.equal(again.params[v][n], t)
               for v, named in small.params.items() for n, t in named.items())
    same_state = all(torch.equal(again.updater_states[v][n][s], t)
                     for v, named in small.updater_states.items()
                     for n, slots in named.items() for s, t in slots.items())
    if not (same and same_state and again.iteration == small.iteration == 12):
        raise RuntimeError("example 11's zip: parameters or Adam state differ")
    stats = {
        "card": card, "batch": [TRAIN_N, T], "tbptt_length": TBPTT_LEN,
        "fits": TBPTT_FITS, "chunks_per_fit": chunks_per_fit,
        "iterations": iterations, "chunk_losses": losses,
        "fit_mean_losses": fit_means, "chunk_ms": chunk_ms,
        "median_chunk_ms": float(np.median(chunk_ms)),
        "tokens_per_s_median_chunk": TRAIN_N * TBPTT_LEN / (np.median(chunk_ms) / 1e3),
        "launches": launches, "launches_per_chunk": {
            k: v // chunks for k, v in launches.items()},
        "peak_device_mem_gb": peak_gb,
        "zip": {"bytes": zip_bytes, "write_s": write_s, "read_card_s": read_s,
                "read_cpu_s": read_cpu_s, "card_max_abs_diff": card_diff,
                "cpu_max_abs_diff": cpu_diff},
        "ex11_zip_with_updater": {"params_equal": same, "adam_state_equal": same_state,
                                  "iteration": again.iteration},
    }
    print("gpt2_tbptt " + json.dumps(stats), flush=True)
    return {"train": launches, "fused_adam": launches["fused_adam"]}


def resnet_train_flops(conf, batch):
    """The multiply-add FLOPs of one training step of a CNN graph, from
    its layer shapes: each convolution and dense product forward, its
    weight gradient, and its data gradient where autograd needs one (its
    input depends on a parameter: not the stem, behind the zero padding
    of the network's input)."""
    from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer, DenseLayer

    total, has_grad = 0.0, set()
    for name in conf.topo_order:
        vd = conf.vertices[name]
        needs_dgrad = any(s in has_grad for s in vd.inputs)
        if needs_dgrad or (vd.is_layer and vd.obj.param_shapes()):
            has_grad.add(name)
        if not vd.is_layer:
            continue
        layer, it = vd.obj, conf.vertex_input_types[name][0]
        if isinstance(layer, ConvolutionLayer):
            ot = layer.output_type(it)
            kh, kw = layer.kernel_size
            fwd = 2.0 * ot.height * ot.width * ot.channels * kh * kw * layer.n_in
        elif isinstance(layer, DenseLayer):  # the output layer too
            fwd = 2.0 * layer.n_in * layer.n_out
        else:
            continue
        total += fwd * (3 if needs_dgrad else 2)
    return total * batch


def resnet_images(batch, seed):
    """Seeded normal NHWC images and one-hot labels, made on the card."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((batch, RESNET_SIDE, RESNET_SIDE, 3), generator=gen,
                    device="cuda")
    idx = torch.randint(0, RESNET_LABELS, (batch,), generator=gen, device="cuda")
    return x, F.one_hot(idx, RESNET_LABELS).float()


def _worst_rel(got, want):
    """``(name, difference)`` of the tensor whose largest difference is the
    largest relative to its own largest entry, over two trees of tensors."""
    worst_name, worst = "", 0.0
    for v, named in want.items():
        for n, t in named.items():
            diff = (got[v][n].cpu().double() - t.cpu().double()).abs().max().item()
            rel = diff / max(t.abs().max().item(), 1e-30)
            if rel >= worst:
                worst_name, worst = f"{v}/{n}", rel
    return worst_name, worst


def resnet_twins(net_card):
    """One step at RESNET_TWIN_BATCH on the card and on the CPU from
    ``net_card``'s weights and states, in f64 and in f32 (see
    RESNET_F32_FACTOR). Returns the f64 and f32 comparisons; raises when
    one misses its limit."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_states, load_reference_params,
        load_reference_states)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    params, states = export_params(net_card), export_states(net_card)
    x, y = resnet_images(RESNET_TWIN_BATCH, seed=5)
    probe, _ = resnet_images(RESNET_TWIN_BATCH, seed=6)
    x, y, probe = x.cpu().numpy(), y.cpu().numpy(), probe.cpu().numpy()

    def twin(device, dtype):
        conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
        conf.global_conf.dtype = dtype
        net = ComputationGraph(conf, device=device).init()
        return load_reference_states(load_reference_params(net, params), states)

    def grads(net):
        _, g, _ = net._gradients({"input": net._as_tensor(x)},
                                 [net._as_tensor(y)], train=True)
        return g

    def stepped(net):
        net.fit(x, y)
        return net, net.output(probe).cpu().double()

    out = {}
    cpu64, ref_out = stepped(twin("cpu", "float64"))
    card64, _ = stepped(twin("cuda", "float64"))
    ref_grads = grads(twin("cpu", "float64"))
    name, rel = _worst_rel(card64.params, cpu64.params)
    out["f64"] = {
        "loss_rel": abs(card64.score_ - cpu64.score_) / abs(cpu64.score_),
        "worst_param": name, "worst_param_rel_to_max": rel,
        "worst_state_abs": max(
            (card64.states[v][n].cpu() - t).abs().max().item()
            for v, named in cpu64.states.items() for n, t in named.items())}
    del card64, cpu64

    # f32: the gradients against the CPU's f64 ones, then the step
    card32, cpu32 = twin("cuda", "float32"), twin("cpu", "float32")
    g_card, g_cpu = grads(card32), grads(cpu32)
    ratios, card_sq, cpu_sq = [], 0.0, 0.0
    for v, named in ref_grads.items():
        for n, w in named.items():
            e_card = (g_card[v][n].cpu().double() - w).norm().item()
            e_cpu = (g_cpu[v][n].double() - w).norm().item()
            ratios.append((e_card / max(e_cpu, 1e-30), f"{v}/{n}",
                           e_card <= max(RESNET_F32_FACTOR * e_cpu,
                                         1e-2 * w.norm().item())))
            card_sq, cpu_sq = card_sq + e_card ** 2, cpu_sq + e_cpu ** 2
    del g_card
    (card32, card_out), (cpu32, cpu_out) = stepped(card32), stepped(cpu32)
    name, rel = _worst_rel(card32.params, cpu32.params)
    out["f32"] = {
        "loss_rel": abs(card32.score_ - cpu32.score_) / abs(cpu32.score_),
        "worst_param": name, "worst_param_rel_to_max": rel,
        "grad_l2_ratio_worst": list(max(ratios)[:2]),
        "grad_l2_ratio_whole": math.sqrt(card_sq / cpu_sq),
        "grad_tensors_within": sum(r[2] for r in ratios),
        "grad_tensors": len(ratios),
        "output_after_step_err": (card_out - ref_out).abs().max().item(),
        "cpu_output_after_step_err": (cpu_out - ref_out).abs().max().item()}
    del card32, cpu32

    # f32: the Nesterovs update of the CPU's gradients on both
    card32, cpu32 = twin("cuda", "float32"), twin("cpu", "float32")
    card32._apply_updates({v: {n: t.cuda() for n, t in named.items()}
                           for v, named in g_cpu.items()})
    cpu32._apply_updates(g_cpu)
    p_name, p_rel = _worst_rel(card32.params, cpu32.params)
    v_name, v_rel = _worst_rel(
        {k: {n: st["v"] for n, st in named.items()}
         for k, named in card32.updater_states.items()},
        {k: {n: st["v"] for n, st in named.items()}
         for k, named in cpu32.updater_states.items()})
    out["f32"].update(update_worst_param=p_name, update_param_rel_to_max=p_rel,
                      update_worst_momentum=v_name,
                      update_momentum_rel_to_max=v_rel)
    del card32, cpu32, g_cpu, ref_grads

    f32, f64 = out["f32"], out["f64"]
    if not (f64["loss_rel"] <= RESNET_LOSS_RTOL
            and f64["worst_param_rel_to_max"] <= RESNET_PARAM_TOL
            and f64["worst_state_abs"] <= RESNET_STATE_TOL
            and f32["loss_rel"] <= RESNET_LOSS_RTOL
            and f32["update_param_rel_to_max"] <= RESNET_UPDATE_TOL
            and f32["update_momentum_rel_to_max"] <= RESNET_UPDATE_TOL
            and f32["grad_tensors_within"] == f32["grad_tensors"]
            and f32["grad_l2_ratio_whole"] <= RESNET_F32_FACTOR):
        raise RuntimeError(f"ResNet-50 card step disagrees with the CPU's: {out}")
    return out


def resnet50_phase(ck, card, peaks):
    """The zoo's ResNet-50 trained at ImageNet shape on the card (see the
    module docstring, phase 11). Returns the launches of the four kernels
    in its timed fit steps (all 0)."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    counters = (ck.lstm_sequence, ck.fused_adam, ck.flash_attention_fwd,
                ck.flash_attention_bwd_dq, ck.flash_attention_bwd_dkv)
    tried, batch, net = [], RESNET_BATCH, None
    while batch >= 1:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            net = ResNet50(num_labels=RESNET_LABELS, seed=1).init()
            x, labels = resnet_images(batch, seed=1)
            for c in counters:
                c.launches = 0
            net.fit(x, labels)  # the first warm-up step
            torch.cuda.synchronize()
            tried.append({"batch": batch, "fits": True,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            break
        except torch.OutOfMemoryError:
            tried.append({"batch": batch, "fits": False,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            net = x = labels = None
            batch //= 2
    print("resnet50_batches " + json.dumps(tried), flush=True)
    if net is None:
        raise RuntimeError("ResNet-50: no batch fits on the card")
    n_bn = sum(1 for st in net.states.values() if st)
    before = {v: {n: t.clone() for n, t in st.items()}
              for v, st in net.states.items() if st}
    for _ in range(RESNET_WARMUP - 1):
        net.fit(x, labels)
    events, losses = [], []
    for _ in range(RESNET_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net._score)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    if any(launches.values()):
        raise RuntimeError(f"ResNet-50 fit launched a kernel: {launches}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"ResNet-50 losses not finite: {losses}")
    unmoved = [f"{v}/{n}" for v, st in before.items() for n, t in st.items()
               if torch.equal(net.states[v][n], t)]
    if n_bn != 53 or unmoved:
        raise RuntimeError(f"ResNet-50 running statistics: {n_bn} BatchNorm "
                           f"layers, unmoved {unmoved[:5]}")
    profile = profile_steps(net, x, labels, fits=RESNET_PROFILED,
                            groups=RESNET_GROUPS)
    flops = resnet_train_flops(net.conf, batch)
    bound_ms = flops / peaks["f32"] * 1e3
    median_step = float(np.median(step_ms))

    # inference: output at the same batch, under inference mode
    out_ms = median_ms(lambda: net.output(x), runs=5, warmup=1)
    out = net.output(x)
    rowsum_dev = (out.double().sum(-1) - 1.0).abs().max().item()
    if not (out.shape == (batch, RESNET_LABELS) and rowsum_dev <= ROWSUM_TOL):
        raise RuntimeError(f"ResNet-50 output: shape {tuple(out.shape)}, rows "
                           f"sum off by {rowsum_dev}")
    del out, x, labels
    torch.cuda.empty_cache()

    # the card's step against the CPU's at batch 2
    twins = resnet_twins(net)

    # the zip with its layer states, restored on the card
    probe, _ = resnet_images(4, seed=7)
    torch.backends.cudnn.deterministic = True
    try:
        want = net.output(probe)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50.zip")
            t0 = time.perf_counter()
            net.save(path, save_updater=False)
            write_s = time.perf_counter() - t0
            zip_bytes = os.path.getsize(path)
            back = ComputationGraph.load(path)
        got = back.output(probe)
    finally:
        torch.backends.cudnn.deterministic = False
    states_equal = all(torch.equal(back.states[v][n], t)
                       for v, st in net.states.items() for n, t in st.items())
    if not (torch.equal(got, want) and states_equal):
        raise RuntimeError(f"ResNet-50 zip: output off by "
                           f"{(got - want).abs().max().item()}, states equal "
                           f"{states_equal}")
    del back, got, want
    torch.cuda.empty_cache()

    # the Nesterovs update of every tensor, profiled alone on one batch's
    # gradients; last, as its extra steps move the weights
    x, labels = resnet_images(batch, seed=1)
    grads, _ = net.compute_gradient_and_score(x, labels)
    del x, labels
    _, update_wall_ms, update_kernels = profiled(lambda: net._apply_updates(grads))
    update_ms = median_ms(lambda: net._apply_updates(grads), runs=5, warmup=1)
    del grads
    stats = {
        "card": card, "params": net.conf.num_params(), "batch": batch,
        "image": [RESNET_SIDE, RESNET_SIDE, 3], "labels": RESNET_LABELS,
        "batches_tried": tried, "timed_steps": RESNET_TIMED,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_step,
        "window_ms": window_ms,
        "train_images_per_s": RESNET_TIMED * batch / (window_ms / 1e3),
        "train_images_per_s_at_median_step": batch / (median_step / 1e3),
        "peak_device_mem_gb": peak_gb,
        "launches": launches,
        "flops_per_step": flops, "flop_bound_ms_f32": bound_ms,
        "bound_share_of_median_step": bound_ms / median_step,
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / median_step,
        "profile_per_step": profile,
        "nesterovs_update_ms": update_ms,
        "nesterovs_update_profiled_device_ms": sum(update_kernels.values()),
        "nesterovs_update_profiled_kernels": len(update_kernels),
        "nesterovs_update_profiled_wall_ms": update_wall_ms,
        "output_batch": batch, "output_ms": out_ms,
        "output_images_per_s": batch / (out_ms / 1e3),
        "twin_batch": RESNET_TWIN_BATCH,
        "twin_f32": twins["f32"], "twin_f64": twins["f64"],
        "zip": {"bytes": zip_bytes, "write_s": write_s, "output_equal": True,
                "states_equal": states_equal},
    }
    print("resnet50 " + json.dumps(stats), flush=True)
    del net
    torch.cuda.empty_cache()
    return launches


def resnet_bf16_twins(net_card):
    """One batch of RESNET_TWIN_BATCH from ``net_card``'s weights and
    states: the card's bf16 gradients (train mode) against the CPU's f64
    ones, over the CPU's own bf16 distance from them (:func:`ratio_form`,
    RESNET_BF16_TENSOR_FLOOR)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.convert import (
        export_params, export_states, load_reference_params,
        load_reference_states)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    params, states = export_params(net_card), export_states(net_card)
    x, y = resnet_images(RESNET_TWIN_BATCH, seed=5)
    x, y = x.cpu().numpy(), y.cpu().numpy()

    def twin(device, dtype, compute_dtype):
        conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
        conf.global_conf.dtype = dtype
        conf.global_conf.compute_dtype = compute_dtype
        net = ComputationGraph(conf, device=device).init()
        return load_reference_states(load_reference_params(net, params), states)

    def grads(net):
        loss, g, _ = net._gradients({"input": net._as_tensor(x)},
                                    [net._as_tensor(y)], train=True)
        return g, float(loss)

    g64, l64 = grads(twin("cpu", "float64", None))
    g_cpu, l_cpu = grads(twin("cpu", "float32", "bfloat16"))
    g_card, l_card = grads(twin("cuda", "float32", "bfloat16"))
    return ratio_form(g_card, g_cpu, g64, l_card, l_cpu, l64,
                      RESNET_BF16_TENSOR_FLOOR)


def resnet50_bf16_phase(ck, card, peaks):
    """bench.py's headline in bf16: the zoo's ResNet-50 (1000 labels, seed
    1) with ``compute_dtype = "bfloat16"`` trained at RESNET_BATCH x
    224x224x3 through ``ComputationGraph.fit``: images/s over RESNET_TIMED
    steps, median step, peak memory, busy share and the FLOP bound share at
    the tensor cores' bf16 rate; every running statistic f32 and moved; no
    launch of the port's kernels (cuDNN's bf16 convolutions and the eager
    BatchNorm, as the reference has no Pallas kernel there); the zip
    restored with ``output`` equal bit for bit; the card's bf16 step at
    batch 2 against the CPU's in the ratio form. Returns the launches."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    counters = (ck.lstm_sequence, ck.fused_adam, ck.flash_attention_fwd,
                ck.flash_attention_bwd_dq, ck.flash_attention_bwd_dkv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    conf = ResNet50(num_labels=RESNET_LABELS, seed=1).conf()
    conf.global_conf.compute_dtype = "bfloat16"  # as bench.py sets it
    net = ComputationGraph(conf).init()
    batch = RESNET_BATCH
    x, labels = resnet_images(batch, seed=1)
    for c in counters:
        c.launches = 0
    before = {v: {n: t.clone() for n, t in st.items()}
              for v, st in net.states.items() if st}
    for _ in range(RESNET_WARMUP):
        net.fit(x, labels)
    events, losses = [], []
    for _ in range(RESNET_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.fit(x, labels)
        end.record()
        events.append((start, end))
        losses.append(net._score)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    step_ms = [s_.elapsed_time(e_) for s_, e_ in events]
    window_ms = events[0][0].elapsed_time(events[-1][1])
    unmoved = [f"{v}/{n}" for v, st in before.items() for n, t in st.items()
               if torch.equal(net.states[v][n], t)]
    states_f32 = all(t.dtype == torch.float32 for st in net.states.values()
                     for t in st.values())
    masters_f32 = all(t.dtype == torch.float32 for named in net.params.values()
                      for t in named.values())
    profile = profile_steps(net, x, labels, fits=RESNET_PROFILED,
                            groups=RESNET_GROUPS)
    flops = resnet_train_flops(net.conf, batch)
    bound_ms = flops / peaks["bf16"] * 1e3
    median_step = float(np.median(step_ms))
    out_ms = median_ms(lambda: net.output(x), runs=5, warmup=1)
    out = net.output(x)
    out_ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == (batch, RESNET_LABELS)
              and bool(torch.isfinite(out.float()).all()))
    del out, x, labels
    torch.cuda.empty_cache()

    # the zip (f32 params.npz and states.npz, compute_dtype in the
    # configuration), restored on the card
    probe, _ = resnet_images(4, seed=7)
    torch.backends.cudnn.deterministic = True
    try:
        want = net.output(probe)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "resnet50_bf16.zip")
            net.save(path, save_updater=False)
            back = ComputationGraph.load(path)
        got = back.output(probe)
    finally:
        torch.backends.cudnn.deterministic = False
    zip_ok = (back.compute_dtype == torch.bfloat16 and torch.equal(got, want)
              and all(torch.equal(back.states[v][n], t)
                      for v, st in net.states.items() for n, t in st.items()))
    del back, got, want
    torch.cuda.empty_cache()
    twins = resnet_bf16_twins(net)
    stats = {
        "card": card, "compute_dtype": "bfloat16", "batch": batch,
        "image": [RESNET_SIDE, RESNET_SIDE, 3], "labels": RESNET_LABELS,
        "timed_steps": RESNET_TIMED, "losses": losses, "step_ms": step_ms,
        "median_step_ms": median_step, "window_ms": window_ms,
        "train_images_per_s": RESNET_TIMED * batch / (window_ms / 1e3),
        "train_images_per_s_at_median_step": batch / (median_step / 1e3),
        "peak_device_mem_gb": peak_gb, "launches": launches,
        "flops_per_step": flops, "flop_bound_ms_bf16": bound_ms,
        "bound_share_of_median_step": bound_ms / median_step,
        "device_busy_share_of_median_step":
            profile["device_ms_per_step"] / median_step,
        "profile_per_step": profile,
        "output_ms": out_ms, "output_images_per_s": batch / (out_ms / 1e3),
        "running_stats_f32": states_f32, "masters_f32": masters_f32,
        "unmoved_stats": unmoved[:5], "zip_output_equal": zip_ok,
        "twin_batch": RESNET_TWIN_BATCH, "twin": twins,
    }
    print("resnet50_bf16 " + json.dumps(stats), flush=True)
    if any(launches.values()):
        raise RuntimeError(f"ResNet-50 bf16 fit launched a kernel: {launches}")
    if not (np.isfinite(losses).all() and out_ok and states_f32 and masters_f32
            and not unmoved and zip_ok and twins["ok"]):
        raise RuntimeError("ResNet-50 bf16: losses finite "
                           f"{np.isfinite(losses).all()}, output {out_ok}, "
                           f"stats f32 {states_f32}, masters f32 {masters_f32}, "
                           f"unmoved {unmoved[:5]}, zip {zip_ok}, twins {twins}")
    del net
    torch.cuda.empty_cache()
    return launches


def dl4j_import_phase(ck, card):
    """The DL4J-format fixtures restored on the card; the convnet one fits
    DL4J_FIT_STEPS more steps from its restored Adam state on the fused
    updater. Returns the five kernels' launches in that fit."""
    import warnings

    from deeplearning4j_tpu_torch.modelimport.dl4j import (
        restore_computation_graph, restore_multi_layer_network)
    from deeplearning4j_tpu_torch.nn import helpers

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    errors, restore_s = {}, {}
    for name in DL4J_FIXTURES:
        path = os.path.join(fixtures, f"dl4j_checkpoint_{name}.zip")
        exp = np.load(os.path.join(fixtures, f"dl4j_checkpoint_{name}_expected.npz"))
        restore = (restore_computation_graph if "graph" in name
                   else restore_multi_layer_network)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no order warning for these
            net = restore(path, device="cuda")
        restore_s[name] = time.perf_counter() - t0
        out = net.output(exp["x"])
        if not out.is_cuda:
            raise RuntimeError(f"DL4J {name}: output not on the card")
        got = out.cpu().numpy()
        errors[name] = float(np.abs(got - exp["out"]).max())
        np.testing.assert_allclose(got, exp["out"], rtol=DL4J_RTOL,
                                   atol=DL4J_ATOL, err_msg=f"DL4J {name}")
        if name == "convnet":
            convnet = net
    n_tensors = sum(len(named) for named in convnet.params.values())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    counters = (ck.lstm_sequence, ck.fused_adam, ck.flash_attention_fwd,
                ck.flash_attention_bwd_dq, ck.flash_attention_bwd_dkv)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    try:
        it0 = convnet.iteration
        losses = []
        for c in counters:
            c.launches = 0
        for _ in range(DL4J_FIT_STEPS):
            convnet.fit(x, y)
            losses.append(convnet.score_)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
    finally:
        helpers.clear_helper("updater")
    want = {c.__name__: 0 for c in counters}
    want["fused_adam"] = DL4J_CONVNET_TENSORS * DL4J_FIT_STEPS
    if not (n_tensors == DL4J_CONVNET_TENSORS and launches == want
            and convnet.iteration == it0 + DL4J_FIT_STEPS
            and np.isfinite(losses).all()):
        raise RuntimeError(f"DL4J convnet fit: launches {launches} for "
                           f"{n_tensors} tensors, losses {losses}")
    stats = {"card": card, "max_abs_err": errors, "restore_s": restore_s,
             "convnet_fit_steps": DL4J_FIT_STEPS, "convnet_fit_losses": losses,
             "convnet_launches": launches,
             "convnet_k2_launches_per_step": launches["fused_adam"] // DL4J_FIT_STEPS,
             "convnet_running_mean": convnet.states[1]["mean"].tolist()}
    print("dl4j_import " + json.dumps(stats), flush=True)
    return launches


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
    for source in ck.SOURCES:
        print(f"ptxas {source} " + json.dumps(ptxas_report(ck, source)), flush=True)
    print("sass " + json.dumps(sass_check(ck)), flush=True)

    served = kernel_phase(ck, peaks)
    bwd = backward_phase(ck, peaks)
    bf16 = flash_bf16_phase(ck, peaks)
    adam = adam_phase(ck, peaks)
    serve_launches = serving_phase(ck, card, served["ms"])
    train_launches = training_phase(ck, card)
    lstm_rows = lstm_kernel_phase(ck, peaks)
    lstm_bf16_rows = lstm_bf16_kernel_phase(ck, peaks)
    char_launches, char_by_plan, char_adam_launches = char_lstm_phase(ck, card)
    lenet_adam_launches = lenet_phase(ck, card)
    draws_phase(card)
    ex17_adam_launches = ex17_phase(ck, card)
    lenet_reg_adam_launches = lenet_regularized_phase(ck, card)
    gpt2_drop = gpt2_attn_dropout_phase(ck, card)
    decode = decode_phase(ck, card, peaks)
    tbptt = gpt2_tbptt_phase(ck, card)
    resnet = resnet50_phase(ck, card, peaks)
    dl4j = dl4j_import_phase(ck, card)
    gpt2_bf16 = gpt2_bf16_phase(ck, card)
    resnet_bf16 = resnet50_bf16_phase(ck, card, peaks)
    lstm_bf16 = lstm_bf16_phase(ck, card)
    stack = recurrent_stack_phase(ck, card)
    lstm = lstm_rows[LSTM_PATHS["train"]]
    lstm_bf16_row = lstm_bf16_rows[(LSTM_BF16_PATH, "auto")]

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

    def later_paths(kernel):
        """The kernel's launches in each path after the char LSTM's, as
        each phase counted them."""
        return {"gpt2_attn_dropout_train": gpt2_drop["train"].get(kernel),
                "decode": decode["decode"].get(kernel),
                "gpt2_tbptt_train": tbptt["train"].get(kernel),
                "resnet50_train": resnet[kernel],
                "dl4j_import_train": dl4j[kernel],
                "gpt2_bf16_train": gpt2_bf16["train"].get(kernel),
                "resnet50_bf16_train": resnet_bf16.get(kernel),
                **{path: counts.get(kernel) for path, counts in lstm_bf16.items()}}

    def measured(by_path):
        return {p: n for p, n in by_path.items() if n is not None}

    print(json.dumps({"kernels": [
        entry(fwd, "flash_attention_fwd.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:359", served,
              serve_launches + train_launches[fwd] + gpt2_drop["output_fwd"]
              + decode["output_fwd"] + gpt2_bf16["output"][fwd],
              launches_by_path=measured({
                  "serve": serve_launches, "train": train_launches[fwd],
                  **later_paths(fwd),
                  "gpt2_attn_dropout_output": gpt2_drop["output_fwd"],
                  "decode_check_output": decode["output_fwd"],
                  "gpt2_bf16_output": gpt2_bf16["output"][fwd]})),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dkv"],
              train_launches["flash_attention_bwd_dkv"],
              launches_by_path=measured({
                  "train": train_launches["flash_attention_bwd_dkv"],
                  **later_paths("flash_attention_bwd_dkv")})),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bwd["dq"],
              train_launches["flash_attention_bwd_dq"],
              launches_by_path=measured({
                  "train": train_launches["flash_attention_bwd_dq"],
                  **later_paths("flash_attention_bwd_dq")})),
        entry("fused_adam", "fused_adam.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:218", adam,
              train_launches["fused_adam"] + char_adam_launches
              + lenet_adam_launches + ex17_adam_launches
              + lenet_reg_adam_launches + gpt2_drop["fused_adam"]
              + tbptt["fused_adam"] + dl4j["fused_adam"]
              + gpt2_bf16["train"]["fused_adam"]
              + sum(c["fused_adam"] for c in lstm_bf16.values()),
              launches_by_path=measured({
                  "train": train_launches["fused_adam"],
                  "char_lstm_train": char_adam_launches,
                  "lenet_train": lenet_adam_launches,
                  "ex17_train": ex17_adam_launches,
                  "lenet_regularized_train": lenet_reg_adam_launches,
                  **later_paths("fused_adam")})),
        entry("lstm_sequence", "lstm_sequence.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:66", lstm,
              sum(char_launches.values()) + stack["f32"],
              launches_by_path=measured({
                  **char_launches, **later_paths("lstm_sequence"),
                  **{p: c["f32"] for p, c in lstm_bf16.items()},
                  "recurrent_stack": stack["f32"]}),
              launches_by_plan=char_by_plan,
              library="torch.nn.LSTM (cuDNN) with its input product: "
                      "compare with ms_with_input_product",
              ms_with_input_product=lstm["ms_with_input_product"],
              # device time a launch (profiler) at each path's shape; the
              # sample path's launches are [1,4,200] but for 2 at [12,4,200]
              shape_by_path={p: list(sh) for p, sh in LSTM_PATHS.items()},
              ms_by_path={p: lstm_rows[sh]["device_ms"] for p, sh in LSTM_PATHS.items()},
              bound_by_path={p: lstm_rows[sh]["bound_ms"] for p, sh in LSTM_PATHS.items()},
              chain_floor_by_path={p: lstm_rows[sh]["chain_floor_ms"]
                                   for p, sh in LSTM_PATHS.items()}),
        entry("lstm_sequence_bf16", "lstm_sequence.cu",
              "deeplearning4j_tpu/nn/pallas_kernels.py:66 on bf16 xw", lstm_bf16_row,
              sum(c["bf16"] for c in lstm_bf16.values()) + stack["bf16"],
              launches_by_path={**{p: c["bf16"] for p, c in lstm_bf16.items()},
                                "recurrent_stack": stack["bf16"]},
              shape=list(LSTM_BF16_PATH), plan=lstm_bf16_row["plan"],
              device_ms=lstm_bf16_row["device_ms"],
              chain_floor_ms=lstm_bf16_row.get("chain_floor_ms"),
              library="torch.nn.LSTM in bf16 (cuDNN) with its input product: "
                      "compare with ms_with_input_product",
              ms_with_input_product=lstm_bf16_row["ms_with_input_product"],
              agreement={k: lstm_bf16_row[k] for k in (
                  "elem_units", "rel_frob", "f64_ratio", "limits")}),
        entry(f"{fwd}_bf16", "flash_attention_fwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:758 on bf16 "
              "q, k, v (via deeplearning4j_tpu/nn/pallas_kernels.py:359)",
              bf16["fwd"], gpt2_bf16["train"][f"{fwd}_bf16"]
              + gpt2_bf16["output"][f"{fwd}_bf16"],
              launches_by_path={"gpt2_bf16_train": gpt2_bf16["train"][f"{fwd}_bf16"],
                                "gpt2_bf16_output": gpt2_bf16["output"][f"{fwd}_bf16"]},
              **{k: bf16["fwd"][k] for k in ("device_ms", "library_device_ms", "design",
                                             "host_us_per_call")}),
        entry("flash_attention_bwd_dkv_bf16", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:941 on bf16 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bf16["dkv"],
              gpt2_bf16["train"]["flash_attention_bwd_dkv_bf16"],
              launches_by_path={"gpt2_bf16_train":
                                gpt2_bf16["train"]["flash_attention_bwd_dkv_bf16"]},
              **{k: bf16["dkv"][k] for k in ("device_ms", "library_device_ms", "design",
                                             "host_us_per_call")}),
        entry("flash_attention_bwd_dq_bf16", "flash_attention_bwd.cu",
              "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 on bf16 "
              "(via deeplearning4j_tpu/nn/pallas_kernels.py:359)", bf16["dq"],
              gpt2_bf16["train"]["flash_attention_bwd_dq_bf16"],
              launches_by_path={"gpt2_bf16_train":
                                gpt2_bf16["train"]["flash_attention_bwd_dq_bf16"]},
              **{k: bf16["dq"][k] for k in ("device_ms", "library_device_ms", "design",
                                            "host_us_per_call")}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
