#!/usr/bin/env python3
"""Smoke run of the idgrec_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1-K13 from idgrec_torch/csrc and holds
each against its plain PyTorch version at the shapes of the main paths:
LightGCN (d=64, 3 layers; int8 and int4 chains, the exact bfloat16 mode,
the bitpack backend, the batch-row partial product) and EGCF (d=64, 3
tanh layers after the seed sweep) over the yelp2018-scale synthetic
dataset, random weights from a seed.
K1, K7, K8 and K6 share one scan of the count matrix (csrc/dual_scan.cuh:
its non-zero entries taken a warp each; int32 atomics, K6 64-bit
fixed-point ones); K1 turns the chain's [d, N] activations to [N, d] and
its sums back around it, three launches a call, and is held to its plain
version and across two launches; K11 scans the packed row groups and
adds only the set bits; the device launches a call of K1, K5, K7, K8, K6,
K11 and the chain's sweeps are counted at the end (torch.profiler slows
later launches). K5 (the dual product on the nibble-packed matrix: K1's
turns around K8's scan of the packed bytes) is also held to K1 on the
unpacked matrix and across two launches, and
the int4 chain, backward chain and one step's gradients to int8's, all
exactly. The chain's sweeps run K2's epilogue (forward and inject) in
K1's or K5's turn-out: each sweep, int8 and int4, forward and inject,
with and without a next input, is held to the dual followed by two K2
launches and to its plain version, bit for bit; K2 itself runs only in
the chain's prologues. The sweeps take the previous sweep's float32 z
and its amax and round them in the turn-in as K3 does: each quantizing
sweep (the linear and the tanh chain's, int8 and int4, every combine and
inject, with and without a next input, the seed sweeps' sides, zero
inputs, infinite and NaN amax, NaN over a whole block) is held to K3 on
each input followed by the sweep on (q, s), and to its plain version
where the rounding stays inside int8's range, bit for bit; K3 runs on no
chain of a path. One int8 and one int4 chain forward and backward
run under ``torch.cuda.set_sync_debug_mode("error")``. K7 and K8 (the
per-application duals in [N, d] layout) are held to K1 and K5 on the
transposed activations, K8 to K7 on the unpacked matrix, and three
`FusedSquareAdj.matmul` calls to the chain's layers, exactly;
K6 (the bfloat16 dual) to its plain version within a stated tolerance
at d = 64 and 128, where its launcher reports one read of M,
bit-equal across two launches, one call under
``torch.cuda.set_sync_debug_mode("error")``, and its backward to
autograd through the plain version. K4 is held to its plain version bit
for bit through the training step's entry (one launch per table, no
range check) and the public one, on 4,096 copies of one row, and across
two launches; the
gathers' backward runs under ``torch.cuda.set_sync_debug_mode("error")``.
K7 and K8 are held across two launches at d = 64 and d = 128, where
their launcher reports one read of the stored matrix (`fusedmm.scan_passes`
states the same rule). Then it drives the paths, each with the
launch counts set to 0 just before and read just after:

* serving, int8: `serving.Recommender` answers four requests, checked
  against the plain path;
* training, int8: `NegativeSampler.sample_epoch`, two full epochs of
  `EpochRunner.run_epoch` (605 steps of 2,048 triples each),
  `Evaluator.evaluate`, `BestResults`; the backward chain and one
  step's gradients are held to the plain path first; then one int4
  epoch through the same runner, for the int8-vs-int4 times;
* the run harness, int4: `engine.loop.train_model` for two full epochs
  with logs and checkpoints, then `Recommender.from_train_result` and
  `Recommender.from_checkpoint` answer the four requests with equal
  items, checked against the plain path;
* the command lines: `idgrec_torch.main` trains and
  `idgrec_torch.serve` serves, in process, on a 2,000 x 3,000 dataset
  written to a temporary directory;
* the exact mode, bfloat16 on the fused backend (every layer, forward
  and backward, one launch of K6): `serving.Recommender` answers the
  four requests, checked against the float32 gather model with the same
  weights; two runs of 128 full steps through `EpochRunner`, the BPR
  sum falling; one `Evaluator.evaluate` sweep;
* the other exact backends and dense int8 (dense bfloat16 on K6, dense
  int8 on K7, dense float32, gather float32): eval embeddings held to
  each other (dense bfloat16 equal to fused bfloat16 bit for bit, dense
  int8 equal to its plain route, K7's raw sums on the dense matrix equal
  to its plain version's), then a few tens of steps each; K6 and K7 run
  one launch an application, dense float32 and gather no kernel;
* LightGCN int8 and int4 at embedding_size 128, a width the chain's
  kernels decline: a few steps through the per-application loop, K7 and
  K8 in both directions;
* EGCF (configure/EGCF.txt: ssl_lambda 0.1, temperature 0.1, parallel
  mode) in int8 on the tanh chain (K1 with K3's rounding in its turn-in
  and K9's and K10's epilogues in its turn-out; K2 for the item
  prologue, K10 for the backward's):
  K9 and K10 against their plain versions on the seed chain's first
  sweeps; each tanh sweep, int8 and int4, forward (every combine) and
  inject, with and without a next input, the seed sweeps' per-side
  cases, infinite and NaN scales and NaN over a whole block, against
  the dual followed by K9 or K10 on each side that runs, bit for bit
  (and its plain version where finite; the fused h is torch.tanh); one
  int8 and one int4 tanh + seed chain forward and backward under
  ``torch.cuda.set_sync_debug_mode("error")``, no K9 launch; the
  3-layer tanh + seed chain forward and backward
  against the plain chain and int4 against int8 (exact), its forward
  against `fused_chain_t` (exact; the gap of its autograd gradient is
  printed); serving four requests through `Recommender`, one step's
  gradient and loss terms against the plain path, two full epochs and
  an evaluation; 24 int4 steps equal to int8's; bfloat16 on the fused
  backend (K6 per application with tanh) served against the float32
  gather EGCF and trained 24 steps; `train_model` for one epoch with a
  checkpoint, both `Recommender` constructors, and
  `main.main(["--model=EGCF", ...])` on the command-line dataset;
* the bitpack backend (K11, one call per direction): K11 against its
  plain version, itself and K6 on the same binary matrix, its backward
  against autograd through the plain version, one call under sync debug
  mode "error"; LightGCN in bfloat16 and
  float32 (both feed K11 bfloat16 activations): eval embeddings against
  bfloat16-fused, four requests against the float32 gather model, two
  runs of 64 steps with the BPR sum falling, one evaluation; EGCF
  bfloat16 served against the float32 gather EGCF and trained 24 steps;
* the batch-row partial product (K12 forward, K13 backward): both
  against their plain versions in bfloat16 and float32 at the step's
  rows, across two launches, one call each under sync debug mode
  "error", one LightGCN bfloat16 step on `dense` with
  `batch_rows_propagation = 1` against the full propagation's, then
  2 x 12 steps with and without batch rows in turns (the full layers on
  K6);
* the rectangular adjacency R̃ (`build_rect_adjacency`, one direction a
  call) on every backend against dense float32 (gather within F32_SUM,
  dense bfloat16 within BF16 of the largest entry, bitpack within TIGHT
  of dense bfloat16), the int8 product's raw int32 sums (`torch._int_mm`,
  Mᵀ stored for the transposed direction) equal to its plain version and
  its products to their plain route, K11's single direction
  (`bitmm.bit_rect_matmul`) and its backward bit-equal to K11 on each
  packing, across two launches and within TIGHT of its plain version,
  every op once under sync debug mode "error", each direction timed
  beside its bound and a library call; then the bfloat16 dense route on
  K6 (M's columns padded to 256; one K6 launch a direction with the
  other side left out, `DenseRectAdj.matmul_both` one launch for both)
  at d = 64 and 128: each one-sided launch within TIGHT of its plain
  version, bit-equal to the same side of the two-sided launch and across
  two launches, its backward bit-equal to the one-sided launch on the
  cotangent, the two-direction call bit-equal to the two one-direction
  calls, each under sync debug mode "error", timed beside its bound, its
  plain version (the route it replaced) and torch.matmul on a bfloat16
  copy of M;
* EGCF, ``mode = alternating`` (the user/item ping-pong over R̃): int8 on
  dense serves four requests checked against the plain route, one step
  against it at tests/test_torch_egcf.py's bars, two full epochs with
  the summed loss falling (K4 in the backward; its BPR sum rises over
  these epochs, in the JAX package too) and an evaluation, its step
  time beside the parallel mode's; bfloat16 on bitpack (K11) serves
  against the float32 gather EGCF, one step against the plain route and
  24 steps; bfloat16 on dense (K6, one launch a direction, 12 a step)
  one step against the plain route at K6's rules and one under sync
  debug mode "error";
* the zoo: MFBPR, DirectAU, MAWU, SCCF, SimGCL, XSimGCL, LightGCN_pp,
  BIGCF, CGCL, NCL, HCCF, IMPGCN, NGCF, GCMC, GCCF, LightGODE and RecDCL
  at their published configs on the yelp2018-scale set, LightCCF, LightCSCF and MixRec on an
  amazon-book-scale one (52,643 x 91,599, M 4.83 GB int8), each model's
  batch size, bfloat16 on `auto` (dense: K6 a layer each way under the
  LightGCN encoder and in every propagation of the others; SimGCL's three
  chains in one at d = 192, LightGCN_pp's on the `gen` scaling, IMPGCN's
  six layers with its three groups in one at d = 192 and its Â·E, which
  feeds only its gates, forward alone; NGCF's and GCCF's three layers on
  the `self` adjacency, GCMC's one; LightGODE's one Euler step under its
  MF_init; RecDCL's two layers at d = 2,048, sixteen reads of M a
  launch): one step against the plain route (K6's plain version), the
  step's noise from a fresh CUDA generator seeded alike for both (RecDCL
  from the same histories, which both steps rewrite alike), one step under sync debug mode "error", a
  request of 256 users against the plain route's server (the eval
  generator seeded 0 in both), ZOO_STEPS steps with finite loss terms
  and gradients (LightGCN_pp's with an item that has no train edge;
  IMPGCN's grouping tables with none, and unmoved), each model's own K6
  launches a step and a representation, ms per step and eval embeddings
  beside K6's bound, a step's memory beyond the model's (no float copy
  of M: below M's bytes, for CGCL and NCL plus the float32 score
  matrices their contrasts against a full table keep for the backward,
  for RecDCL plus a K6 launch's scratch and output at d = 2,048 and the
  float32 [N, d] tensors its step keeps, and then one RecDCL step at
  d = 64 below M's bytes alone);
  NCL past its warm-up: its k-means at k = 2,000 on both tables (the
  sums on K4) under sync debug mode "error", equal bit for bit to the
  same clustering on K4's plain version, timed, its steps with a
  non-zero prototype term and the 24 steps' path clustering first; K6 on
  amazon-book's M timed beside its bound; K6 at d = 192 on SimGCL's M
  (three reads of M a launch) held to its plain version and timed beside
  three d = 64 applications and its bound; K6 at d = 2,048 on RecDCL's
  M (sixteen reads of M a launch) held to its plain version and timed
  beside its bound and a library call; one NGCF step with node dropout
  (the gather backend, the dropped edge values' transpose through the
  graph's permutation) under sync debug mode "error"; MAWU through
  `main.main(["--model=MAWU", ...])` from files;
* the rectangular models at their published configs on the
  yelp2018-scale set: LightGCL (2 layers, both directions of a layer one
  K6 launch; its SVD branch from the host's factorisation, timed) and
  CVGA (its encoder R̃ @ q_w one K6 launch at d = 128; user-row
  batches): one step against the plain route with the same noise, one
  under sync debug mode "error", a step's memory under a bar from the
  shapes (M's bytes and LightGCL's kept contrast scores, CVGA's [B, I]
  rows), K6 launches a step and a representation (LightGCL 4 and 2, CVGA
  2 and 1), ZOO_STEPS steps, eval embeddings timed, a request of
  ZOO_REQUEST users against the plain route's server (CVGA's dict
  representation); CVGA through `train_model` for one epoch of user rows,
  served from its result;
* learnability: LightGCN int8 and int4 through `train_model` on
  `make_latent_synthetic_dataset` (learnable low-rank data) for
  LEARN_EPOCHS epochs, recall@20 after the last at least LEARN_FACTOR
  times the first evaluation's (the popularity level), int4's metrics
  and loss sums equal to int8's; then DirectAU (LightGCN encoder, dense
  bfloat16 on K6, its published config) the same way, its last recall@20
  at least LEARN_FACTOR times the popularity level and not below its
  first; whether it also holds LightGCN's bar (LEARN_FACTOR times its own
  first evaluation, which is already far above popularity) is printed.

It times each kernel beside its bound, its plain version and a library
call, and the paths end to end.

Output: progress lines, the card's name and power limit, one
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
there is no CUDA device, when the package is missing, or when any phase
fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# yelp2018 scale as bench.py builds it (users, items, train, test; seed 0)
YELP = (31_668, 38_048, 1_237_259, 324_147)
DIM, LAYERS, K = 64, 3, 20
DEVICE = "cuda"
REQUEST_SIZES = (1, 17, 256, 2048)
BATCH, EPOCHS, TOP_KS = 2048, 2, (10, 20)
# the command-line phase: users, items, train, test of its dataset
QUICK = (2000, 3000, 60_000, 10_000)
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s,
# dense bf16 ops/s
PEAKS = {"H100": (3.35e12, 1979e12, 989e12)}
# float32 outside the tensor cores (the same data sheet): K9's and K10's work
F32_OPS = 67e12
# tolerances: K1's raw integer products, K3's scales and integers, the
# 3-layer chain and the served scores are equal to the plain versions'
# (K2 is built with -fmad=false and keeps the plain operation order);
# K2 within TIGHT; served ids equal except among scores tied within TIE.
# K2's inject mode, K4 (no atomics, batch order), the 3-layer backward
# chain and one training step's gradients and loss terms are equal to
# the plain versions'. K5's raw integer products are equal to its plain
# version's and to K1's on the unpacked matrix; the int4 chain, backward
# chain and one step's gradients and loss terms are equal to int8's;
# the two Recommender constructors of the run harness serve equal items
# and scores.
# K7's and K8's raw integer products are equal to their plain versions',
# to K1's and K5's on the transposed activations and to each other;
# three `FusedSquareAdj.matmul` calls equal the chain's layers. K6 is
# within TIGHT of its plain version (identical bfloat16 operands, exact
# products each rounded once to 64-bit fixed point at 2**-31 of the
# largest activation, integer sums) and equal
# across two launches; its backward is within BF16 of the largest
# gradient of autograd through the plain version (the kernel rounds the
# cotangent to bfloat16 going in, autograd rounds the gradient coming
# out). The bfloat16 model's scores are within BF16_SCORE of the float32
# gather model's for the same weights (logits below 0.01 at these random
# weights, three layers of operands rounded at 2**-9), and its served
# ids equal except among such scores (EGCF's bar follows the same rule,
# 2**-7 of the largest logit times the sigmoid's slope 1/4, from its own
# logits). K11 is within TIGHT of its plain version, K12 and K13 within
# TIGHT's rtol and its atol times their largest entry (K13's cotangents
# are far below unit scale), each equal across two launches; K11 within
# TIGHT of K6 on the same binary
# matrix (the same bfloat16 operands and exact products), its backward
# within BF16 (K6's rule); bitpack eval embeddings within TIGHT of
# bfloat16-fused's, its served scores within BF16_SCORE of the float32
# gather model's; one batch-rows step's loss terms within TIGHT and its
# gradients within BF16 of the full propagation's (the partial rounds the
# cotangent to bfloat16 where the dense product rounds elsewhere).
# K9 and K10, the tanh chain's sweeps (K9's and K10's epilogues in the
# dual's turn-out, equal to the dual and the separate K9 or K10 launches,
# non-finite inputs included), the tanh + seed chain forward and
# backward, one EGCF step and EGCF's int4 run are equal to the plain
# versions' and to int8's; torch.tanh on the card is the CUDA math
# library's tanhf, which K9 and the turn-out call. Eval embeddings: dense
# float32 against gather within F32_SUM of the largest entry, bfloat16 dense
# against bfloat16 fused equal (both K6 on the same counts: integer sums at
# a scale set by the largest activation, whatever the padding), dense int8
# against its plain route equal, bfloat16 against float32 within BF16 of the
# largest entry. A zoo step against the plain route: loss terms within
# TIGHT, gradients within BF16 of the largest entry (K6's rules); under MF
# equal; its server's scores within TIE of the plain route's.
TIGHT = dict(rtol=3e-5, atol=3e-6)
TIE = 1e-5
BF16 = 2.0 ** -7
BF16_SCORE = 2e-5
F32_SUM = 1e-5
# the exact paths: steps of 2,048 triples per run
BF16_STEPS, OTHER_STEPS, WIDE_STEPS, WIDE_DIM = 128, 24, 12, 128
# the bitpack path: two runs of BIT_STEPS steps per compute dtype
BIT_STEPS = 64
# the learnability check: LightGCN int8 and int4 on the latent set at
# LEARN_SCALE of yelp2018 scale for LEARN_EPOCHS epochs (learn_rate 0.005,
# the convergence script's config), evaluated after the first and the
# last; the last recall@20 at least LEARN_FACTOR times the first
LEARN_SCALE, LEARN_EPOCHS, LEARN_FACTOR = 0.5, 12, 2.0
# the zoo: MFBPR, the encoder-switch family, LightGCN_pp and the models that
# draw noise in their steps at their published configs (configure/<model>.txt:
# d = 64, 3 layers, each model's batch size, bfloat16 on `auto`, which is
# dense: K6 under the LightGCN encoder and in every propagation of the last
# five; SimGCL's three chains at d = 192), each on the dataset its config
# names at that dataset's scale (amazon-book's from bench.py --scale
# amazon-book), ZOO_STEPS steps each
NOISE_ZOO = ("SimGCL", "XSimGCL", "LightGCN_pp", "BIGCF", "MixRec")
# the full-pool contrasts (CGCL, NCL with its k-means), HCCF and IMPGCN (6
# layers, its three groups at d = 192)
CONTRAST_ZOO = ("CGCL", "NCL", "HCCF", "IMPGCN")
# per-layer weight tables and message dropout: NGCF (batch 1,024) and GCCF
# on the `self` adjacency, 3 layers, GCMC on `sym`, 1 layer
WEIGHTED_ZOO = ("NGCF", "GCMC", "GCCF")
# LightGODE's graph ODE (MF_init: one application in training too) and RecDCL
# (d = 2,048, 2 layers; its target histories are model state)
STATE_ZOO = ("LightGODE", "RecDCL")
# the zoo models whose every embedding goes through the adjacency (the
# encoder-switch family does under its LightGCN encoder)
PROPAGATING = NOISE_ZOO + CONTRAST_ZOO + WEIGHTED_ZOO + STATE_ZOO
ZOO = ("MFBPR", "DirectAU", "MAWU", "SCCF", "LightCCF", "LightCSCF") + PROPAGATING
# the models on the rectangular adjacency, at their published configs:
# LightGCL (RECT_LAYERS layers, its SVD branch) and CVGA (user-row batches)
RECT_ZOO = ("LightGCL", "CVGA")
RECT_LAYERS = 2
# the layers each earlier zoo model's published config names (the others:
# LAYERS); the models of WEIGHTED_ZOO and RecDCL run their config's
# GCN_layer, LightGODE one application (its one Euler step)
ZOO_LAYERS = {"IMPGCN": 6}
# the width each zoo model's published config names (the others: DIM)
ZOO_DIMS = {"RecDCL": 2048}
# IMPGCN's grouping tables: no gradient (the gates are a top-1 mask)
NO_GRAD = {"IMPGCN": ("fc_b", "fc_group_b", "fc_group_w", "fc_w")}
# NCL's k-means: Lloyd iterations a table, one K4 launch each
KMEANS_ITERS = 20
# the seed of the CUDA generator a zoo step draws its noise from: the kernel
# step and the plain one each get their own, seeded alike
ZOO_NOISE_SEED = 17
AMAZON = (52_643, 91_599, 2_380_730, 603_378)
ZOO_STEPS, ZOO_REQUEST = 24, 256


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float, float, str]:
    for key, (bw, ops, bf16_ops) in PEAKS.items():
        if key in name:
            note = "H100 SXM data sheet" + ("" if ("HBM3" in name or "SXM" in name)
                                           else " (assumed for this H100 variant)")
            return bw, ops, bf16_ops, note
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_launches(fn) -> int:
    """Kernels and memsets that one call of ``fn`` puts on the device, as
    torch.profiler records them (0 where it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


def host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def assert_close(got: torch.Tensor, want: torch.Tensor, what: str, rtol: float, atol: float):
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
                                 f"atol={atol}, max abs err {float(err.max())}")


class PlainChainModel:
    """The served model with its chain run through the kernels' plain
    versions: the reference the kernel path is held to."""

    def __init__(self, model):
        self.model = model
        self.device = model.device

    @torch.no_grad()
    def eval_embeddings(self, generator=None):
        from idgrec_torch.ops import chainmm, scatter

        with plain_kernels(chainmm, scatter):
            return self.model.eval_embeddings(generator)

    def score_batch(self, repr_, users):
        return self.model.score_batch(repr_, users)


@contextlib.contextmanager
def plain_kernels(chainmm, scatter):
    """Route the chain and the batch scatter through the kernels' plain
    versions: the reference a training step is held to."""
    saved = chainmm.KERNELS, scatter.scatter_add_rows, scatter.scatter_add_rows_unchecked
    chainmm.KERNELS = chainmm.PLAIN
    scatter.scatter_add_rows = scatter.scatter_add_rows_plain
    scatter.scatter_add_rows_unchecked = scatter.scatter_add_rows_plain
    try:
        yield
    finally:
        (chainmm.KERNELS, scatter.scatter_add_rows,
         scatter.scatter_add_rows_unchecked) = saved


@contextlib.contextmanager
def plain_rect(propagate, bitmm, chainmm, scatter):
    """Route the rectangular adjacency's products through their plain
    versions (the int8 product's float64 sums, K11's plain version) and
    the batch scatter through K4's: the reference an alternating EGCF is
    held to."""
    saved = propagate.int8_matmul, bitmm.bit_matmul
    propagate.int8_matmul = lambda m, m_t, q, transpose=False: propagate.int8_matmul_plain(
        m, q, transpose)
    bitmm.bit_matmul = lambda packed, x, n_rows, plan=None: bitmm.bit_matmul_plain(
        packed, x, n_rows)
    try:
        with plain_kernels(chainmm, scatter):
            yield
    finally:
        propagate.int8_matmul, bitmm.bit_matmul = saved


@contextlib.contextmanager
def plain_duals(fusedmm, propagate):
    """Route kernels K6 and K7, the dense and fused backends' products,
    through their plain versions: the reference a zoo model's step and
    server, and dense int8's eval embeddings, are held to. K6's plain
    version runs with K6's backward rule, the same product on the swapped
    cotangents rounded to bfloat16 going in (`propagate.exact_dual_matmul`,
    which saves M alone: autograd through `fused_adj_matmul_plain` would
    keep every float32 block of M for the backward, 19 GB an application
    at amazon-book scale). A one-sided call (the rectangular adjacency's)
    runs `propagate.exact_matmul`, the route K6 replaced there."""
    def k6_plain(m8, zu, zi):
        if zu is None or zi is None:
            # one direction (the rectangular adjacency): `propagate.exact_matmul`,
            # the route K6 replaced there, with the same backward rule
            transpose = zi is None
            z = zu if transpose else zi
            y = propagate.exact_matmul(transpose, m8, propagate._pad_rows(
                z, m8.shape[0] if transpose else m8.shape[1]), torch.bfloat16)
            return (None, y) if transpose else (y, None)
        nu, ni = zu.shape[0], zi.shape[0]
        yu, yi = propagate.exact_dual_matmul(m8, propagate._pad_rows(zi, m8.shape[1]),
                                             propagate._pad_rows(zu, m8.shape[0]),
                                             torch.bfloat16)
        return yu[:nu], yi[:ni]

    saved = fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_int8
    fusedmm.fused_adj_matmul = k6_plain
    fusedmm.fused_adj_matmul_int8 = fusedmm.fused_adj_matmul_int8_plain
    try:
        yield
    finally:
        fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_int8 = saved


def zoo_k6_launches(name: str, propagates: bool, layers: int) -> tuple[int, int]:
    """(K6 launches of one training step, of one representation) of a zoo
    model: none under MF; a layer (LightGODE: its one application) each
    way in a step and one a layer in a representation elsewhere (the
    first layer's input is the tables, which take a gradient); IMPGCN's
    Â·E feeds only its gates (no backward), its groups' layers 1 .. L - 1
    run each way."""
    if not propagates:
        return 0, 0
    if name == "IMPGCN":
        return 1 + 2 * (layers - 1), layers
    return 2 * layers, layers


def kept_score_bytes(name: str, batch: int, num_users: int, num_items: int) -> int:
    """Bytes of the float32 [batch, rows] score matrices a step keeps for
    its backward (the ``exp`` of each contrast against a full table,
    `losses.infonce_loss_sum`): CGCL's three heads each contrast with the
    full user and the full item table, NCL's structural term once."""
    heads = {"CGCL": 3, "NCL": 1}.get(name, 0)
    return 4 * batch * (num_users + num_items) * heads


def wide_step_bytes(adj, layers: int, d: int) -> dict[str, int]:
    """The device bytes beyond M's that a step of a LightGCN-mean model at a
    wide d (RecDCL's 2,048) holds at its peak, from the shapes: one K6
    launch's scratch (the library's ``dual_bf16_scratch_bytes``, 10 bytes
    a padded row and feature), its float32 output over the padded rows,
    and the float32 [N, d] tensors the step keeps (the tables'
    concatenation, each layer's output, the running sum, the mean, the
    tables' gradient: layers + 4)."""
    from idgrec_torch.ops import fusedmm

    n = adj.num_users + adj.num_items
    u_pad, i_pad = adj.m.shape
    lib = fusedmm._lib(fusedmm._K6)
    return {"k6_scratch": int(lib.dual_bf16_scratch_bytes(u_pad, i_pad, d)),
            "k6_output": 4 * (u_pad + i_pad) * d, "kept_f32": (layers + 4) * 4 * n * d}


def write_dataset(directory: str, data) -> None:
    """Write ``data`` in the reference format, one line per user:
    ``uid iid iid ...`` in train.txt and test.txt."""
    os.makedirs(directory, exist_ok=True)
    for fname, users, items in (("train.txt", data.train_user, data.train_item),
                                ("test.txt", data.test_user, data.test_item)):
        order = np.argsort(users, kind="stable")
        users, items = np.asarray(users)[order], np.asarray(items)[order]
        uids, starts = np.unique(users, return_index=True)
        with open(os.path.join(directory, fname), "w") as f:
            for u, row in zip(uids.tolist(), np.split(items, starts[1:])):
                f.write(f"{u} " + " ".join(map(str, row.tolist())) + "\n")


def masked_ratings(rec, users: np.ndarray) -> torch.Tensor:
    """The full masked score rows ``rec`` ranks for ``users``."""
    u = torch.from_numpy(users).to(rec.device)
    r = rec.model.score_batch(rec._repr, u).float()
    r = torch.nn.functional.pad(r, (0, 1))
    r.scatter_(1, torch.from_numpy(rec._excl[users]).to(rec.device), -1e9)
    return r[:, : rec.data.num_items]


def check_answers(ref_rec, data, users: np.ndarray, items, scores) -> None:
    n = users.size
    require(items.shape == (n, K) and scores.shape == (n, K), f"shape {items.shape}")
    require(np.isfinite(scores).all(), "non-finite scores")
    require(((items >= 0) & (items < data.num_items)).all(), "item id out of range")
    require((np.diff(scores, axis=1) <= 0).all(), "scores not non-increasing")
    for row, u in enumerate(users.tolist()):
        seen = data.col_idx[data.row_ptr[u]: data.row_ptr[u + 1]]
        require(not np.isin(items[row], seen).any(), f"user {u}: a train positive was served")
    ref_items, ref_scores = ref_rec.recommend(users, k=K)
    require(np.array_equal(scores, ref_scores),
            f"served scores differ from the plain path: max abs err "
            f"{float(np.abs(scores.astype(np.float64) - ref_scores).max())}")
    ratings = masked_ratings(ref_rec, users).cpu().numpy()
    chosen = np.take_along_axis(ratings, items, axis=1)
    tied = np.abs(chosen - ref_scores) <= TIE
    require(((items == ref_items) | tied).all(),
            f"{int((~((items == ref_items) | tied)).sum())} served ids differ from the "
            "plain path outside ties")


def check_answers_close(ref_rec, data, users: np.ndarray, items, scores, tol: float) -> None:
    """`check_answers` against a reference model in another arithmetic:
    each served score within ``tol`` of the reference's score of the
    same item, ids equal except among reference scores within ``tol``
    of the reference's at that rank."""
    n = users.size
    require(items.shape == (n, K) and scores.shape == (n, K), f"shape {items.shape}")
    require(np.isfinite(scores).all(), "non-finite scores")
    require(((items >= 0) & (items < data.num_items)).all(), "item id out of range")
    require((np.diff(scores, axis=1) <= 0).all(), "scores not non-increasing")
    for row, u in enumerate(users.tolist()):
        seen = data.col_idx[data.row_ptr[u]: data.row_ptr[u + 1]]
        require(not np.isin(items[row], seen).any(), f"user {u}: a train positive was served")
    ref_items, ref_scores = ref_rec.recommend(users, k=K)
    ratings = masked_ratings(ref_rec, users).cpu().numpy()
    chosen = np.take_along_axis(ratings, items, axis=1)
    err = float(np.abs(scores.astype(np.float64) - chosen).max())
    require(err <= tol, f"served scores differ from the reference model's by {err} > {tol}")
    near = np.abs(chosen - ref_scores) <= tol
    require(((items == ref_items) | near).all(),
            f"{int((~((items == ref_items) | near)).sum())} served ids differ from the "
            f"reference model's outside scores within {tol}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from idgrec_torch import convert
        from idgrec_torch import main as cli_main
        from idgrec_torch import serve as cli_serve
        from idgrec_torch.config import default_configure_dir, load_model_config
        from idgrec_torch.data.dataset import (make_latent_synthetic_dataset,
                                               make_synthetic_dataset)
        from idgrec_torch.engine import checkpoint as ckpt_lib
        from idgrec_torch.engine import loop as loop_lib
        from idgrec_torch.engine import sampler as sampler_lib
        from idgrec_torch.engine.evaluator import BestResults, Evaluator
        from idgrec_torch.engine.trainer import EpochRunner
        from idgrec_torch.models import base as base_lib
        from idgrec_torch.models import get_model
        from idgrec_torch.models.base import concat_user_item
        from idgrec_torch.ops import (_build, bitmm, chainmm, fusedmm, gathermm, losses, noise,
                                      propagate, scatter)
        from idgrec_torch.serving import Recommender
    except ImportError as e:
        print(f"chip_smoke: the idgrec_torch package is missing beside this script: {e}",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    bw, int8_ops, bf16_ops, peak_note = peaks_for(name)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks from the {peak_note}")

    # ---- build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)

    # ---- data and model at full width
    t0 = time.perf_counter()
    data = make_synthetic_dataset(*YELP, seed=0, name="yelp2018-scale")
    log(f"dataset {data.num_users} users x {data.num_items} items, {data.num_train} train, "
        f"{data.num_test} test, built in {time.perf_counter() - t0:.1f} s")
    cfg = load_model_config("LightGCN").updated(
        embedding_size=DIM, GCN_layer=LAYERS, compute_dtype="int8", batch_size=BATCH,
        test_batch_size=2048, top_K=list(TOP_KS))
    t0 = time.perf_counter()
    model = get_model("LightGCN")(cfg, data, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    adj = model.graph
    u_pad, i_pad = adj.padded_shape
    nu, ni = data.num_users, data.num_items
    log(f"adjacency int8 [{u_pad}, {i_pad}] on the card in {time.perf_counter() - t0:.1f} s")
    require((u_pad, i_pad) == (-(-nu // fusedmm.TU) * fusedmm.TU, -(-ni // fusedmm.TI) * fusedmm.TI),
            f"padded shape {(u_pad, i_pad)}")
    max_deg = int(max(np.diff(data.row_ptr).max(), np.bincount(data.col_idx).max()))
    require(max_deg < 132_000, f"degree {max_deg}: int32->f32 sums may round")

    # the same model in int4: equal tables, the matrix nibble-packed
    cfg4 = cfg.updated(compute_dtype="int4")
    t0 = time.perf_counter()
    model4 = get_model("LightGCN")(cfg4, data, device=dev,
                                   generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    adj4 = model4.graph
    i_pad4 = adj4.padded_shape[1]
    log(f"adjacency int4 {list(adj4.m8.shape)} packed (logical [{u_pad}, {i_pad4}]) on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    require(adj4.quant == "int4" and adj4.padded_shape == (
        u_pad, -(-ni // fusedmm.PACK_TILE) * fusedmm.PACK_TILE)
        and tuple(adj4.m8.shape) == (u_pad, i_pad4 // 2), f"int4 shapes {adj4.padded_shape}")
    require(torch.equal(model4.user_emb, model.user_emb)
            and torch.equal(model4.item_emb, model.item_emb), "int4 and int8 tables differ")

    # ---- each kernel against its plain version, on the main path's inputs
    embT = concat_user_item(model.user_emb, model.item_emb).detach().T
    xu = propagate._pad_cols(embT[:, :nu], u_pad)
    xi = propagate._pad_cols(embT[:, nu:], i_pad)
    ru, ri, lu, li = chainmm._vectors(adj, u_pad, i_pad)
    ones_d = torch.ones(DIM, device=dev)
    errs = {}

    def both_epilogue(y, s, post, pre, c, combine, want):
        c_k, c_p = c.clone(), c.clone()
        zk, ak = chainmm.chain_sweep_epilogue(y, s, post, pre, c_k, combine, want)
        zp, ap = chainmm.chain_sweep_epilogue_plain(y, s, post, pre, c_p, combine, want)
        assert_close(zk, zp, "K2 z", **TIGHT)
        assert_close(ak, ap, "K2 amax", **TIGHT)
        assert_close(c_k, c_p, "K2 combine", **TIGHT)
        errs["K2"] = max(errs.get("K2", 0.0), max_abs(zk, zp), max_abs(ak, ap), max_abs(c_k, c_p))
        return zk, ak, c_k

    zu, au, cu = both_epilogue(xu, ones_d, torch.ones(u_pad, device=dev), ru,
                               torch.empty_like(xu), chainmm.COMBINE_SET, True)
    zi, ai, ci = both_epilogue(xi, ones_d, torch.ones(i_pad, device=dev), ri,
                               torch.empty_like(xi), chainmm.COMBINE_SET, True)
    quant = {}
    for side, z, a in (("u", zu, au), ("i", zi, ai)):
        qk, sk = propagate.quantize_rows(z, a)
        qp, sp = propagate.quantize_rows_plain(z, a)
        require(torch.equal(sk, sp), "K3 scales differ from the plain version")
        diff = (qk.int() - qp.int()).abs()
        require(torch.equal(qk, qp), f"K3 side {side}: {int((diff > 0).sum())} of "
                                     f"{diff.numel()} integers differ from the plain version")
        errs["K3"] = max(errs.get("K3", 0.0), float(diff.max()))
        quant[side] = (qk, sk)
    (qu, su), (qi, si) = quant["u"], quant["i"]
    yu, yi = fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi)
    yu_p, yi_p = fusedmm.fused_adj_matmul_int8_t_plain(adj.m8, qu, qi)
    require(torch.equal(yu, yu_p) and torch.equal(yi, yi_p),
            f"K1 differs from its plain version: max abs err "
            f"{max(max_abs(yu, yu_p), max_abs(yi, yi_p))}")
    errs["K1"] = max(max_abs(yu, yu_p), max_abs(yi, yi_p))
    yu_b, yi_b = fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi)
    require(torch.equal(yu.view(torch.int32), yu_b.view(torch.int32))
            and torch.equal(yi.view(torch.int32), yi_b.view(torch.int32)),
            "K1: two launches differ")
    del yu_b, yi_b, yu_p, yi_p
    log(f"K1 equals its plain version exactly ({int((yu != 0).sum())} + "
        f"{int((yi != 0).sum())} non-zero sums), two launches bit-equal")
    both_epilogue(yu, si[:, 0], lu, ru, cu, chainmm.COMBINE_ADD, True)
    both_epilogue(yi, su[:, 0], li, ri, ci, chainmm.COMBINE_ADD, True)
    log(f"K2 matches its plain version, max abs err {errs['K2']}")
    log("K3 equals its plain version exactly")

    # ---- K5 on the packed matrix, at the inputs the int4 chain gives it:
    # the same activations, the item side padded to the packed tile
    ri4, li4 = chainmm._vectors(adj4, u_pad, i_pad4)[1::2]
    xi4 = propagate._pad_cols(embT[:, nu:], i_pad4)
    zi4, ai4 = chainmm.chain_sweep_epilogue(xi4, ones_d, torch.ones(i_pad4, device=dev), ri4,
                                            torch.empty_like(xi4), chainmm.COMBINE_SET, True)
    qi4, si4 = propagate.quantize_rows(zi4, ai4)
    require(torch.equal(qi4[:, :i_pad], qi) and not bool(qi4[:, i_pad:].any())
            and torch.equal(si4, si), "the int4 chain's first activations differ from int8's")
    m_unpacked = fusedmm.unpack_nibbles(adj4.m8)
    require(torch.equal(m_unpacked[:, :i_pad], adj.m8) and not bool(m_unpacked[:, i_pad:].any()),
            "the unpacked int4 matrix is not the int8 matrix")
    yu4, yi4 = fusedmm.fused_adj_matmul_int4_t(adj4.m8, qu, qi4)
    yu4_p, yi4_p = fusedmm.fused_adj_matmul_int4_t_plain(adj4.m8, qu, qi4)
    yu4_k1, yi4_k1 = fusedmm.fused_adj_matmul_int8_t(m_unpacked, qu, qi4)
    errs["K5"] = max(max_abs(yu4, yu4_p), max_abs(yi4, yi4_p))
    require(torch.equal(yu4, yu4_p) and torch.equal(yi4, yi4_p),
            f"K5 differs from its plain version: max abs err {errs['K5']}")
    require(torch.equal(yu4, yu4_k1) and torch.equal(yi4, yi4_k1),
            f"K5 differs from K1 on the unpacked matrix: max abs err "
            f"{max(max_abs(yu4, yu4_k1), max_abs(yi4, yi4_k1))}")
    require(torch.equal(yu4, yu) and torch.equal(yi4[:, :i_pad], yi),
            "K5 differs from K1 on the int8 adjacency")
    yu4_b, yi4_b = fusedmm.fused_adj_matmul_int4_t(adj4.m8, qu, qi4)
    require(torch.equal(yu4.view(torch.int32), yu4_b.view(torch.int32))
            and torch.equal(yi4.view(torch.int32), yi4_b.view(torch.int32)),
            "K5: two launches differ")
    del yu4_b, yi4_b
    log(f"K5 equals its plain version and K1 on the unpacked matrix exactly "
        f"({int((yu4 != 0).sum())} + {int((yi4 != 0).sum())} non-zero sums), two launches "
        "bit-equal")
    del yu4_p, yi4_p, yu4_k1, yi4_k1, xi4

    emb0 = concat_user_item(model.user_emb, model.item_emb).detach()
    chain_k = chainmm.fused_chain_resident(adj, emb0, LAYERS)
    chain_p = chainmm.fused_chain_resident_plain(adj, emb0, LAYERS)
    require(tuple(chain_k.shape) == (nu + ni, DIM), f"chain shape {tuple(chain_k.shape)}")
    require(bool(torch.isfinite(chain_k).all()), "non-finite chain output")
    require(torch.equal(chain_k, chain_p),
            f"3-layer chain differs from the plain chain: max abs err {max_abs(chain_k, chain_p)}")
    log("3-layer chain equals the plain chain")
    chain_4 = chainmm.fused_chain_resident(adj4, emb0, LAYERS)
    require(torch.equal(chain_4, chain_k),
            f"3-layer int4 chain differs from the int8 chain: max abs err "
            f"{max_abs(chain_4, chain_k)}")
    log("3-layer int4 chain equals the int8 chain")
    del chain_k, chain_p, chain_4

    # ---- the training kernels on one real batch
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    neg_sampler = sampler_lib.NegativeSampler(data)
    torch.cuda.synchronize()
    log(f"sampler: {neg_sampler.rounds} resample rounds, positives bitmap "
        f"{0 if neg_sampler.bitmap_flat is None else neg_sampler.bitmap_flat.numel()} bytes, "
        f"built in {time.perf_counter() - t0:.1f} s")
    users_e, pos_e, neg_e = neg_sampler.sample_epoch(gen)
    batch = {"user": users_e[:BATCH].contiguous(), "pos": pos_e[:BATCH].contiguous(),
             "neg": neg_e[:BATCH].contiguous()}
    idx_u, idx_i = batch["user"], torch.cat([batch["pos"], batch["neg"]])
    dup_u = BATCH - int(torch.unique(idx_u).numel())
    dup_i = 2 * BATCH - int(torch.unique(idx_i).numel())
    require(dup_u > 0 and dup_i > 0, "the batch has no duplicate rows to order")

    # the batch cotangents: d bpr / d (gathered rows), as the step's backward sees them
    with torch.no_grad():
        final = chainmm.fused_chain_resident(adj, emb0, LAYERS)
    rows = [final[:nu][batch["user"]], final[nu:][batch["pos"]], final[nu:][batch["neg"]]]
    rows = [r.clone().requires_grad_(True) for r in rows]
    losses.bpr_loss(*rows).backward()
    vals_u = rows[0].grad.contiguous()
    vals_i = torch.cat([rows[1].grad, rows[2].grad]).contiguous()
    k4_cases = ((idx_u, vals_u, nu), (idx_i, vals_i, ni))
    vals_p, vals_n = rows[1].grad, rows[2].grad

    def k4_step():
        """K4 as the gathers' backward calls it: the step's entry (no range
        check, nothing read back), one launch per table, the item table's
        positives and negatives concatenated."""
        return (scatter.scatter_add_rows_unchecked(batch["user"], vals_u, nu),
                scatter.scatter_add_rows_unchecked(torch.cat([batch["pos"], batch["neg"]]),
                                                   torch.cat([vals_p, vals_n]), ni))

    cot_parts = k4_step()
    again = k4_step()
    for (idx, vals, n_rows), got, got2 in zip(k4_cases, cot_parts, again):
        want = scatter.scatter_add_rows_plain(idx, vals, n_rows)
        public = scatter.scatter_add_rows(idx, vals, n_rows)
        require(torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(public.view(torch.int32), want.view(torch.int32)),
                f"K4 into [{n_rows}, {DIM}] differs from its plain version: max abs err "
                f"{max(max_abs(got, want), max_abs(public, want))}")
        require(torch.equal(got.view(torch.int32), got2.view(torch.int32)),
                f"K4 into [{n_rows}, {DIM}]: two launches differ")
        errs["K4"] = max(errs.get("K4", 0.0), max_abs(got, want), max_abs(public, want))
    # a batch of 4,096 copies of one row: the hot-row path of the kernel
    one_row = torch.full((2 * BATCH,), int(idx_i[0]), dtype=torch.int64, device=dev)
    got = scatter.scatter_add_rows(one_row, vals_i, ni)
    want = scatter.scatter_add_rows_plain(one_row, vals_i, ni)
    require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
            f"K4 on {2 * BATCH} copies of one row differs from its plain version: max abs err "
            f"{max_abs(got, want)}")
    errs["K4"] = max(errs["K4"], max_abs(got, want))
    # the gathers' backward on the step's path issues no synchronisation
    ua, ia = (t_.detach().clone().requires_grad_(True) for t_ in (final[:nu], final[nu:]))
    gathered = base_lib.batch_final_embeddings(ua, ia, batch, "int8")
    gather_loss = losses.bpr_loss(*gathered)
    k4_before = scatter.scatter_add_rows.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gather_loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(scatter.scatter_add_rows.launches == k4_before + 2,
            "the gathers' backward did not take one K4 launch per table")
    require(torch.equal(ua.grad, cot_parts[0]) and torch.equal(ia.grad, cot_parts[1]),
            "the gathers' backward differs from K4 on the batch cotangents")
    log(f"K4 equals its plain version exactly, the step's entry (one launch per table) and "
        f"the public one, two launches bit-equal, {2 * BATCH} copies of one row too "
        f"({dup_u} duplicate user rows, {dup_i} duplicate item rows in the batch); the gathers' "
        f"backward ran under sync debug mode 'error' without a synchronisation")
    cot = torch.cat(cot_parts)  # [N, d]: the combine's cotangent of this batch
    del final, rows, again, ua, ia, gathered

    gT = propagate.true_divide(cot.T.contiguous(), float(LAYERS + 1))
    gu = propagate._pad_cols(gT[:, :nu], u_pad).contiguous()
    gi = propagate._pad_cols(gT[:, nu:], i_pad).contiguous()
    for inject, want_next in ((True, True), (True, False), (False, False)):
        for y, s_, post, pre, g in ((yu, si[:, 0], ru, lu, gu), (yi, su[:, 0], ri, li, gi)):
            ok, ak = chainmm.chain_sweep_inject(y, s_, post, pre, g, inject, want_next)
            op, ap = chainmm.chain_sweep_inject_plain(y, s_, post, pre, g, inject, want_next)
            same = torch.equal(ok, op) and (not want_next or torch.equal(ak, ap))
            require(same, f"K2 inject={inject} want_next={want_next} differs from its plain "
                          f"version: max abs err {max_abs(ok, op)}")
            errs["K2i"] = max(errs.get("K2i", 0.0), max_abs(ok, op))
    log("K2 inject mode equals its plain version exactly")

    # ---- the chain's sweeps: K1 or K5 with K2's epilogue in the turn-out,
    # on the first sweep's inputs, against the dual followed by two K2
    # launches (the route they replaced) and their plain version, bit for bit
    ci4 = propagate._pad_cols(ci, i_pad4).contiguous()
    gi4 = propagate._pad_cols(gi, i_pad4).contiguous()
    sweep_cases = {"int8": (adj.m8, qi, si, (lu, li), (ru, ri), (cu, ci), (gu, gi)),
                   "int4": (adj4.m8, qi4, si4, (lu, li4), (ru, ri4), (cu, ci4), (gu, gi4))}
    duals = {"int8": fusedmm.fused_adj_matmul_int8_t, "int4": fusedmm.fused_adj_matmul_int4_t}
    sweep_fns = {(False, False): chainmm.dual_sweep, (False, True): chainmm.dual_sweep_plain,
                 (True, False): chainmm.dual_sweep_inject,
                 (True, True): chainmm.dual_sweep_inject_plain}

    def separate_sweep(quant, inject, flag, want_next, ext):
        """The dual kernel, then K2 (or its inject mode) on each side."""
        m_, qi_, si_, post, pre = sweep_cases[quant][:5]
        ys = duals[quant](m_, qu, qi_)
        epi = chainmm.chain_sweep_inject if inject else chainmm.chain_sweep_epilogue
        return (*epi(ys[0], si_[:, 0], post[0], pre[0], ext[0], flag, want_next),
                *epi(ys[1], su[:, 0], post[1], pre[1], ext[1], flag, want_next))

    def fused_sweep(quant, inject, flag, want_next, ext, plain=False):
        m_, qi_, si_, post, pre = sweep_cases[quant][:5]
        return sweep_fns[(inject, plain)](quant, m_, qu, su, qi_, si_, post, pre, ext, flag,
                                          want_next)

    errs["sweep"] = 0.0
    for quant in ("int8", "int4"):
        for inject, flag, want_next in ((False, chainmm.COMBINE_ADD, True),
                                        (False, chainmm.COMBINE_ADD, False),
                                        (True, True, True), (True, True, False)):
            ext0 = sweep_cases[quant][6 if inject else 5]
            exts = [[t_.clone() for t_ in ext0] for _ in range(3)]
            got = fused_sweep(quant, inject, flag, want_next, exts[0])
            sep = separate_sweep(quant, inject, flag, want_next, exts[1])
            ref = fused_sweep(quant, inject, flag, want_next, exts[2], plain=True)
            what = f"{quant} sweep inject={inject} want_next={want_next}"
            for a, b, c in zip(list(got) + exts[0], list(sep) + exts[1], list(ref) + exts[2]):
                if a is None:
                    require(b is None and c is None, f"{what}: an output is missing")
                    continue
                require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                        f"{what} differs from the dual and two K2 launches: max abs err "
                        f"{max_abs(a, b)}")
                require(torch.equal(a, c), f"{what} differs from its plain version: max abs err "
                                           f"{max_abs(a, c)}")
                errs["sweep"] = max(errs["sweep"], max_abs(a, c))
            require(not want_next or bool(got[1].gt(0).all() and got[3].gt(0).all()),
                    f"{what}: an amax is not positive")
    del exts, got, sep, ref
    log("the chain's sweeps (K2's epilogue in the turn-out of K1 and of K5; forward with the "
        "combine and inject, each with and without a next input) equal the dual followed by two "
        "K2 launches and their plain version exactly")

    # ---- the sweeps on the previous sweep's (z, amax): K3's rounding in
    # the turn-in, held to K3 on each z input followed by the sweep on
    # (q, s) (the route the fold replaced; int8 zeros with scale 1 for a
    # zero input) and to the plain version where finite (PyTorch's
    # float-to-int8 cast is not K3's outside int8's range, and the plain
    # amax takes any NaN where the kernels' take a whole block's), bit for
    # bit; the fused call launches no K3
    quant_sweeps = {"forward": chainmm.dual_sweep, "inject": chainmm.dual_sweep_inject,
                    "tanh": chainmm.dual_sweep_tanh,
                    "tanh_inject": chainmm.dual_sweep_tanh_inject}
    errs["quant_sweep"] = 0.0
    n_quant_cases = {"linear": 0, "tanh": 0}

    def quantizing_case(kind, quant, m_, inputs, post, pre, ext0, h0, flag, want_next,
                        sides=(True, True), plain=True):
        sweep = quant_sweeps[kind]
        n_z = sum(x_ is not None for x_, _ in inputs)
        runs = {}
        for route in ("fused", "separate") + (("plain",) if plain else ()):
            ext = [t_.clone() if t_ is not None else None for t_ in ext0]
            hs_ = ([torch.full((DIM, p_.shape[0]), float("nan"), device=dev) for p_ in post]
                   if kind == "tanh" else list(h0))
            fn_ = {"fused": sweep, "separate": sweep.separate, "plain": sweep.plain}[route]
            k3_before = propagate.quantize_rows.launches
            out = list(fn_(quant, m_, *inputs[0], *inputs[1], post, pre, ext, flag, want_next,
                           hs_, sides))
            k3_ran = propagate.quantize_rows.launches - k3_before
            require(k3_ran == (n_z if route == "separate" else 0),
                    f"{kind} {quant} {route}: {k3_ran} K3 launches")
            runs[route] = out + ext + (hs_ if kind == "tanh" else [])
        what = (f"{quant} quantizing {kind} sweep flag={flag} want_next={want_next} "
                f"sides={sides}")
        for k_, a in enumerate(runs["fused"]):
            for route, other in runs.items():
                b = other[k_]
                if a is None or b is None:
                    require(a is None and b is None, f"{what}: an output is missing ({route})")
                    continue
                require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                        f"{what} differs from the {route} route: max abs err {max_abs(a, b)}")
                both = torch.isfinite(a) & torch.isfinite(b)
                if bool(both.any()):
                    errs["quant_sweep"] = max(errs["quant_sweep"], max_abs(a[both], b[both]))
        n_quant_cases["tanh" if kind.startswith("tanh") else "linear"] += 1
        return runs["fused"]

    def non_finite(inputs, case):
        """(zu, au), (zi, ai) with an infinite amax on each side, a NaN
        amax, or NaN z over a whole K2 block of one item feature."""
        (zu_, au_), (zi_, ai_) = ((z_.clone(), a_.clone()) for z_, a_ in inputs)
        if case == "inf_amax":
            au_[9] = float("inf")
            ai_[5] = float("inf")
        elif case == "nan_amax":
            ai_[3] = float("nan")
        else:
            zi_[11, 1024:2048] = float("nan")
        return [(zu_, au_), (zi_, ai_)]

    z_inputs = {"int8": [(zu, au), (zi, ai)], "int4": [(zu, au), (zi4, ai4)]}
    for quant in ("int8", "int4"):
        m_, _, _, l_, r_, c_, g_ = sweep_cases[quant]
        for combine in (chainmm.COMBINE_NONE, chainmm.COMBINE_SET, chainmm.COMBINE_ADD):
            for want_next in (True, False):
                got = quantizing_case("forward", quant, m_, z_inputs[quant], l_, r_, c_,
                                      (None, None), combine, want_next)
                require(not want_next or bool(got[1].gt(0).all() and got[3].gt(0).all()),
                        "a quantizing sweep's amax is not positive")
        for inject in (True, False):
            for want_next in (True, False):
                quantizing_case("inject", quant, m_, z_inputs[quant], r_, l_, g_, (None, None),
                                inject, want_next)
        for zero in (0, 1):
            inputs = list(z_inputs[quant])
            inputs[zero] = (None, None)
            got = quantizing_case("forward", quant, m_, inputs, l_, r_, c_, (None, None),
                                  chainmm.COMBINE_ADD, True)
            require(not bool(got[2 * (1 - zero)].any()), "a zero input gave non-zero sums")
        for case in ("inf_amax", "nan_amax", "nan_z_block"):
            # the plain amax takes any NaN, the kernels' a whole block's
            plain_ok = case == "nan_amax"
            quantizing_case("forward", quant, m_, non_finite(z_inputs[quant], case), l_, r_, c_,
                            (None, None), chainmm.COMBINE_ADD, True, plain=plain_ok)
            got = quantizing_case("inject", quant, m_, non_finite(z_inputs[quant], case), r_, l_,
                                  g_, (None, None), True, True, plain=plain_ok)
            require(case != "inf_amax" or not bool(torch.isfinite(got[1]).all()),
                    "an infinite amax left the inject sweep's amax finite")
    log(f"the linear chain's quantizing sweeps ({n_quant_cases['linear']} cases: int8 and int4, "
        "every combine and inject, with and without a next input, a zero input on either side, "
        "infinite and NaN amax, NaN z over a whole block) equal K3 on each input followed by the "
        "sweep on (q, s) exactly, and their plain version where the rounding stays inside int8; "
        "no K3 launch")

    grads_chain = []
    for graph, fn in ((adj, chainmm.fused_chain_resident),
                      (adj, chainmm.fused_chain_resident_plain),
                      (adj4, chainmm.fused_chain_resident)):
        x = emb0.clone().requires_grad_(True)
        fn(graph, x, LAYERS).backward(cot)
        grads_chain.append(x.grad)
    grad_4 = grads_chain.pop()
    require(bool(torch.isfinite(grads_chain[0]).all()) and bool(grads_chain[0].abs().sum() > 0),
            "backward chain: non-finite or all-zero gradient")
    require(torch.equal(*grads_chain), f"3-layer backward chain differs from the plain backward "
                                       f"chain: max abs err {max_abs(*grads_chain)}")
    log(f"3-layer backward chain equals the plain backward chain "
        f"({int((grads_chain[0] != 0).sum())} non-zero gradients)")
    require(torch.equal(grad_4, grads_chain[0]),
            f"3-layer int4 backward chain differs from the int8 backward chain: max abs err "
            f"{max_abs(grad_4, grads_chain[0])}")
    log("3-layer int4 backward chain equals the int8 backward chain")
    # the int8 and int4 chains forward and backward (K3, the sweeps, K2 for
    # the prologues) issue no synchronisation with the host
    chain_counters = (chainmm.chain_sweep_epilogue, chainmm.chain_sweep_inject,
                      chainmm.dual_sweep, chainmm.dual_sweep_inject)
    for graph, dual in ((adj, fusedmm.fused_adj_matmul_int8_t),
                        (adj4, fusedmm.fused_adj_matmul_int4_t)):
        x = emb0.clone().requires_grad_(True)
        before = [fn.launches for fn in (dual,) + chain_counters]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chainmm.fused_chain_resident(graph, x, LAYERS).backward(cot)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran = [fn.launches - b for fn, b in zip((dual,) + chain_counters, before)]
        require(ran == [2 * LAYERS, 4, 0, LAYERS, LAYERS],
                f"the synchronisation check's {graph.quant} chain ran {ran} launches of "
                "(the dual, K2, K2-inject, the forward sweep, the inject sweep)")
        require(torch.equal(x.grad, grads_chain[0]), "the chain under sync debug mode differs")
    log(f"the int8 and int4 chains forward and backward ({2 * LAYERS} sweeps each, K2 only in "
        "the 2 x 2 prologue calls) ran under sync debug mode 'error' without a synchronisation")
    del grads_chain, grad_4, x

    def step_grads(m=model):
        m.zero_grad(set_to_none=True)
        bpr, reg = m.loss_terms(batch)
        (bpr + reg).backward()
        out = (m.user_emb.grad.clone(), m.item_emb.grad.clone(), bpr.detach(), reg.detach())
        m.zero_grad(set_to_none=True)
        return out

    got_step = step_grads()
    with plain_kernels(chainmm, scatter):
        want_step = step_grads()
    int4_step = step_grads(model4)
    for what, a, b in zip(("d user_emb", "d item_emb", "bpr", "reg"), int4_step, got_step):
        require(torch.equal(a, b), f"one int4 step, {what}: differs from the int8 step, "
                                   f"max abs err {max_abs(a, b)}")
    log("one int4 training step: gradients and loss terms equal the int8 step's")
    del int4_step
    for what, a, b in zip(("d user_emb", "d item_emb", "bpr", "reg"), got_step, want_step):
        require(bool(torch.isfinite(a).all()), f"one step, {what}: not finite")
        require(torch.equal(a, b), f"one step, {what}: kernel path differs from the plain path, "
                                   f"max abs err {max_abs(a, b)}")
    log(f"one training step: gradients and loss terms equal the plain path's "
        f"(bpr {float(got_step[2]):.6f}, reg {float(got_step[3]):.3e})")
    del got_step, want_step

    # ---- the main path: construct the server and answer requests
    # the quantized chain's: K2 in the prologues, its epilogue and inject
    # mode in the sweeps (the dual's turn-out), K3's rounding in their
    # turn-in; K2-inject and K3 run standalone on no chain
    int8_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                     chainmm.dual_sweep, chainmm.dual_sweep_inject, scatter.scatter_add_rows)
    int4_counters = (fusedmm.fused_adj_matmul_int4_t,) + int8_counters[1:]
    n_counters = (fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_int8,
                  fusedmm.fused_adj_matmul_int4)
    tanh_counters = (chainmm.chain_sweep_tanh, chainmm.chain_sweep_tanh_inject,
                     chainmm.dual_sweep_tanh, chainmm.dual_sweep_tanh_inject)
    row_counters = (bitmm.bit_matmul, gathermm.gather_rows_matmul, gathermm.gather_rows_matmul_t)
    counters = (int8_counters + (fusedmm.fused_adj_matmul_int4_t, chainmm.chain_sweep_inject,
                                 propagate.quantize_rows)
                + n_counters + tanh_counters + row_counters)

    # a fused sweep also counts the sides it ran, each one standalone
    # epilogue launch of the route it replaced, and the (z, amax) inputs
    # its turn-in rounded, each one K3 launch of that route
    sweeps = [fn for fn in counters if isinstance(fn, chainmm.DualSweep)]

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        for fn in sweeps:
            fn.sides_run = fn.quantized_in_sweep = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {**{fn.__name__: fn.launches for fn in counters},
                **{f"{fn.__name__}.sides_run": fn.sides_run for fn in sweeps},
                **{f"{fn.__name__}.quantized_in_sweep": fn.quantized_in_sweep for fn in sweeps}}

    def require_no_k3(counts: dict, path: str, rounded: int | None = None):
        """No standalone K3 on ``path``'s chains: the sweeps round their
        inputs in the turn-in (``rounded`` of them, where given)."""
        in_sweep = sum(counts[f"{fn.__name__}.quantized_in_sweep"] for fn in sweeps)
        require(counts["quantize_rows"] == 0, f"{path}: {counts['quantize_rows']} K3 launches")
        require(in_sweep > 0 and rounded in (None, in_sweep),
                f"{path}: the sweeps rounded {in_sweep} inputs, expected {rounded}")

    serving_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                        chainmm.dual_sweep)
    reset_counts()
    t0 = time.perf_counter()
    rec = Recommender(model, data)
    torch.cuda.synchronize()
    first_embed_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(0)
    requests = [rng.choice(data.num_users, size=b, replace=False) for b in REQUEST_SIZES]
    answers = [rec.recommend(users, k=K) for users in requests]
    launches = read_counts()
    log(f"serving path launches: {launches}")
    for fn in serving_counters:
        require(fn.launches > 0, f"{fn.__name__} was never launched on the serving path")
    require((launches["chain_sweep_epilogue"], launches["dual_sweep"],
             launches["fused_adj_matmul_int8_t"]) == (2, LAYERS, LAYERS),
            "serving: expected one chain, K2 in its prologue only")
    require_no_k3(launches, "serving", 2 * LAYERS)

    ref_rec = Recommender(PlainChainModel(model), data)
    for users, (items, scores) in zip(requests, answers):
        check_answers(ref_rec, data, users, items, scores)
    log(f"served {len(requests)} requests ({', '.join(map(str, REQUEST_SIZES))} users, "
        f"k={K}): checked against the plain path")

    # ---- times, per sweep of the chain, beside bounds
    d = DIM

    def bound(nbytes: float, ops: float, peak: float = int8_ops) -> tuple[float, str]:
        tb, to = nbytes / bw * 1e3, ops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # the function's work: 2 directions x 2 operations per non-zero entry
    # and feature (the bytes decide at these shapes)
    nnz = int(torch.count_nonzero(adj.m8))
    k1_bytes = u_pad * i_pad + d * (u_pad + i_pad) + 4 * d * (u_pad + i_pad)
    k1_bound = bound(k1_bytes, 4.0 * nnz * d)
    k1_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi), 20)
    k1_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8_t_plain(adj.m8, qu, qi), 3, 1)

    def int_mm_ms(m, q_u, q_i, want_u, want_i):
        """Time of `torch._int_mm` x2 on the unpacked matrix ``m``, the
        library yardstick of K1 and K5; None where it does not apply."""
        try:
            m_cols = m.t().contiguous().t()  # column-major copy for the second product
            lib_fn = lambda: (torch._int_mm(q_i, m.t()), torch._int_mm(q_u, m_cols))  # noqa: E731
            got = lib_fn()
            if torch.equal(got[0].float(), want_u) and torch.equal(got[1].float(), want_i):
                return cuda_ms(lib_fn, 10)
            log("torch._int_mm disagrees with the kernel: no library time")
        except RuntimeError as e:  # the library call is a yardstick only
            log(f"torch._int_mm does not take these shapes: {str(e).splitlines()[0]}")
        return None

    k1_lib = int_mm_ms(adj.m8, qu, qi, yu, yi)

    # K5: the packed matrix read once, the activations in, the sums out
    k5_bytes = u_pad * i_pad4 // 2 + d * (u_pad + i_pad4) + 4 * d * (u_pad + i_pad4)
    k5_bound = bound(k5_bytes, 4.0 * nnz * d)
    k5_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul_int4_t(adj4.m8, qu, qi4), 20)
    k5_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_int4_t_plain(adj4.m8, qu, qi4), 3, 1)
    k5_lib = int_mm_ms(m_unpacked, qu, qi4, yu4, yi4)
    # K1 again right after K5, for the ratio of the two within one run
    k1_ms_again = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi), 20)
    log(f"K5 {k5_ms:.4f} ms per sweep beside K1 {k1_ms:.4f} / {k1_ms_again:.4f} ms "
        f"(before / after), ratio {k5_ms / k1_ms_again:.3f}; packed matrix "
        f"{adj4.m8.numel() / 1e6:.1f} MB, int8 matrix {adj.m8.numel() / 1e6:.1f} MB")
    del m_unpacked

    def k2_pair(fn):
        fn(yu, si[:, 0], lu, ru, cu, chainmm.COMBINE_ADD, True)
        fn(yi, su[:, 0], li, ri, ci, chainmm.COMBINE_ADD, True)

    n_all = u_pad + i_pad
    k2_bound = bound(16.0 * d * n_all + 8.0 * n_all + 16.0 * d, d * n_all * 5.0)
    k2_ms = cuda_ms(lambda: k2_pair(chainmm.chain_sweep_epilogue), 50)
    k2_plain = cuda_ms(lambda: k2_pair(chainmm.chain_sweep_epilogue_plain), 20)

    def k3_pair(fn):
        fn(zu, au)
        fn(zi, ai)

    k3_bound = bound(5.0 * d * n_all + 16.0 * d, 2.0 * d * n_all)
    k3_ms = cuda_ms(lambda: k3_pair(propagate.quantize_rows), 50)
    k3_plain = cuda_ms(lambda: k3_pair(propagate.quantize_rows_plain), 20)
    k3_lib = None
    try:
        zp = torch.zeros(d, dtype=torch.int64, device=dev)
        k3_lib = cuda_ms(lambda: (
            torch.quantize_per_channel(zu, su[:, 0].double(), zp, 0, torch.qint8),
            torch.quantize_per_channel(zi, si[:, 0].double(), zp, 0, torch.qint8)), 20)
    except RuntimeError as e:
        log(f"torch.quantize_per_channel unavailable here: {str(e).splitlines()[0]}")

    def k2i_pair(fn):
        fn(yu, si[:, 0], ru, lu, gu, True, True)
        fn(yi, su[:, 0], ri, li, gi, True, True)

    # y and g read, the next input written: 12 bytes an element
    k2i_bound = bound(12.0 * d * n_all + 8.0 * n_all + 16.0 * d, d * n_all * 5.0)
    k2i_ms = cuda_ms(lambda: k2i_pair(chainmm.chain_sweep_inject), 50)
    k2i_plain = cuda_ms(lambda: k2i_pair(chainmm.chain_sweep_inject_plain), 20)

    # the chain's sweeps (a middle sweep: the combine added or the cotangent
    # injected, a next input) beside the bare dual and the route they
    # replaced, the dual and two K2 launches, in turns; their bound: the
    # stored matrix and the int8 inputs read once, the scales and vectors,
    # the combine read and written and z written (forward), the cotangent
    # read and the next input written (inject); 4 operations per non-zero
    # entry and feature
    # The sweep on (z, amax) as the chain runs it (K3's rounding in the
    # turn-in) beside K3 twice and the sweep on (q, s), and the bare sweep
    # on (q, s); its bound reads z as float32 where the bare sweep reads q
    sweep_times, quant_times = {}, {}

    def time_quantizing(kind, quant, m_, inputs, post, pre, ext, flag, bare_sweep, nbytes,
                        hs_=(None, None)):
        sw_ = quant_sweeps[kind]
        args = (*inputs[0], *inputs[1], post, pre, ext, flag, True, hs_)
        quantizing = cuda_ms(lambda: sw_(quant, m_, *args), 20)
        k3_then_sweep = cuda_ms(lambda: sw_.separate(quant, m_, *args), 20)
        n_q = inputs[0][0].shape[1] + inputs[1][0].shape[1]
        bnd = bound(nbytes + 3.0 * d * n_q, 4.0 * nnz * d)
        require(bnd[0] <= quantizing, f"{quant} quantizing {kind} sweep: {quantizing} ms below "
                                      f"its bound {bnd[0]} ms")
        quant_times[(quant, kind)] = (quantizing, k3_then_sweep, bare_sweep, bnd)
        log(f"{quant} quantizing {kind} sweep: {quantizing:.4f} ms (bound {bnd[0]:.4f} by "
            f"{bnd[1]}) beside K3 x2 and the sweep on (q, s) {k3_then_sweep:.4f} ms and the bare "
            f"sweep on (q, s) {bare_sweep:.4f} ms")

    for quant in ("int8", "int4"):
        m_, qi_ = sweep_cases[quant][:2]
        n_q = u_pad + qi_.shape[1]
        bare = cuda_ms(lambda: duals[quant](m_, qu, qi_), 20)
        for inject, flag in ((False, chainmm.COMBINE_ADD), (True, True)):
            ext = [t_.clone() for t_ in sweep_cases[quant][6 if inject else 5]]
            fused = cuda_ms(lambda: fused_sweep(quant, inject, flag, True, ext), 20)
            separate = cuda_ms(lambda: separate_sweep(quant, inject, flag, True, ext), 20)
            nbytes = (m_.numel() + d * n_q + 8.0 * d + 8.0 * n_q
                      + (8.0 if inject else 12.0) * d * n_q)
            bnd = bound(nbytes, 4.0 * nnz * d)
            require(bnd[0] <= fused, f"{quant} sweep inject={inject}: {fused} ms below its bound "
                                     f"{bnd[0]} ms")
            sweep_times[(quant, inject)] = (fused, separate, bare, bnd)
            log(f"{quant} {'inject' if inject else 'forward'} sweep: {fused:.4f} ms (bound "
                f"{bnd[0]:.4f} by {bnd[1]}) beside the dual and two K2 launches "
                f"{separate:.4f} ms and the bare dual {bare:.4f} ms")
            time_quantizing("inject" if inject else "forward", quant, m_, z_inputs[quant],
                            *sweep_cases[quant][3:5], ext, flag, fused, nbytes)
    del ext

    def k4_pair(fn):
        for idx, vals, n_rows in k4_cases:
            fn(idx, vals, n_rows)

    def index_add(idx, vals, n_rows):
        return torch.zeros((n_rows, d), device=dev).index_add_(0, idx, vals)

    # idx (int64) and vals read, the table written
    k4_bound = bound(sum(8.0 * idx.numel() + 4.0 * vals.numel() + 4.0 * n_rows * d
                         for idx, vals, n_rows in k4_cases),
                     sum(float(vals.numel()) for _, vals, _ in k4_cases))
    # the step's entry (one call per table, no range check) on the inputs
    # index_add_ takes, the item batch concatenated; beside it the gathers'
    # backward path (the concatenation included) and the public entry (range
    # check, one flag read back), two calls each
    k4_ms = cuda_ms(lambda: k4_pair(scatter.scatter_add_rows_unchecked), 50)
    k4_path_ms = cuda_ms(k4_step, 50)
    k4_checked_ms = cuda_ms(lambda: k4_pair(scatter.scatter_add_rows), 50)
    k4_plain = cuda_ms(lambda: k4_pair(scatter.scatter_add_rows_plain), 10)
    k4_lib = cuda_ms(lambda: k4_pair(index_add), 50)
    for idx, vals, n_rows in k4_cases:
        assert_close(index_add(idx, vals, n_rows), scatter.scatter_add_rows(idx, vals, n_rows),
                     "index_add_ against K4", rtol=1e-5, atol=1e-9)
    log(f"K4 per step: the step's entry {k4_ms:.4f} ms (two calls, no range check; the "
        f"backward's path, pos and neg concatenated in it, {k4_path_ms:.4f} ms), the public "
        f"entry {k4_checked_ms:.4f} ms (two calls, each checking the range), index_add_ x2 "
        f"{k4_lib:.4f} ms, bound {k4_bound[0]:.4f} ms by {k4_bound[1]}")

    embed_ms = host_ms(model.eval_embeddings, 5)
    reset_counts()
    model4.eval_embeddings()
    embed4_launches = read_counts()
    require(embed4_launches["fused_adj_matmul_int4_t"] == LAYERS
            and embed4_launches["fused_adj_matmul_int8_t"] == 0,
            f"int4 eval embeddings launches {embed4_launches}")
    embed4_ms = host_ms(model4.eval_embeddings, 5)
    log(f"eval embeddings int4: {embed4_ms:.3f} ms beside int8 {embed_ms:.3f} ms "
        f"({LAYERS} K5 launches per chain)")
    req_ms = {b: host_ms(lambda u=users: rec.recommend(u, k=K), 5)
              for b, users in zip(REQUEST_SIZES, requests)}
    log(f"eval embeddings: {embed_ms:.3f} ms (first, inside the constructor: "
        f"{first_embed_ms:.3f} ms); per request: "
        + ", ".join(f"{b} users {t:.3f} ms" for b, t in req_ms.items()))
    bwd_chain_ms = host_ms(lambda: chainmm._run_chain_bwd(adj, gu, gi, LAYERS, True,
                                                          chainmm.KERNELS), 5)
    bwd_chain4_ms = host_ms(lambda: chainmm._run_chain_bwd(
        adj4, gu, propagate._pad_cols(gi, i_pad4).contiguous(), LAYERS, True, chainmm.KERNELS), 5)
    log(f"backward chain (3 sweeps of K3 and K1 with K2's inject mode in its turn-out): "
        f"{bwd_chain_ms:.3f} ms; int4 (K5 in K1's place, the item side's pad included): "
        f"{bwd_chain4_ms:.3f} ms")

    # ---- the training path: sample, two epochs, evaluate
    lr = cfg.float("learn_rate")
    runner = EpochRunner(model, lr, BATCH, data.num_train)
    evaluator = Evaluator(model, data, cfg)
    best = BestResults(patience=cfg.int("early_stopping"))
    steps = runner.num_batches
    require(steps == -(-data.num_train // BATCH), f"{steps} steps per epoch")
    row_ptr_d, col_idx_d = neg_sampler.row_ptr, neg_sampler.col_idx
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epoch_ms, sample_ms, term_sums, triples = [], [], [], []
    for epoch in range(EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        triple = neg_sampler.sample_epoch(gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        terms = runner.run_epoch(*triple, generator=gen, epoch=epoch)
        term_sums.append(terms.cpu().numpy())  # the epoch's one transfer; waits for the card
        t2 = time.perf_counter()
        sample_ms.append((t1 - t0) * 1e3)
        epoch_ms.append((t2 - t1) * 1e3)
        triples.append(triple)
    t0 = time.perf_counter()
    result = evaluator.evaluate()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    best.update(result, EPOCHS - 1)
    train_launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training path launches: {train_launches}")
    for fn in int8_counters:
        require(fn.launches > 0, f"{fn.__name__} was never launched on the training path")
    require(train_launches["fused_adj_matmul_int4_t"] == 0, "K5 ran on the int8 training path")
    # a step: the forward chain and the backward chain, K2 in their prologues
    # (2 + 2), a sweep each a layer; the evaluation's chain one more forward
    n_train = EPOCHS * steps
    want_train = {"chain_sweep_epilogue": 4 * n_train + 2, "chain_sweep_inject": 0,
                  "dual_sweep": LAYERS * (n_train + 1), "dual_sweep_inject": LAYERS * n_train,
                  "fused_adj_matmul_int8_t": LAYERS * (2 * n_train + 1), "quantize_rows": 0,
                  "dual_sweep.quantized_in_sweep": 2 * LAYERS * (n_train + 1),
                  "dual_sweep_inject.quantized_in_sweep": 2 * LAYERS * n_train}
    require(all(train_launches[k_] == v for k_, v in want_train.items()),
            f"training path: expected {want_train}")
    require_no_k3(train_launches, "training", 2 * LAYERS * (2 * n_train + 1))

    # one int4 epoch through the same runner code, for the int8-vs-int4 times
    runner4 = EpochRunner(model4, lr, BATCH, data.num_train)
    reset_counts()
    triple = neg_sampler.sample_epoch(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    terms4 = runner4.run_epoch(*triple, generator=gen, epoch=0).cpu().numpy()
    epoch4_ms = (time.perf_counter() - t0) * 1e3
    int4_epoch_launches = read_counts()
    log(f"int4 epoch launches: {int4_epoch_launches}")
    for fn in int4_counters:
        require(fn.launches > 0, f"{fn.__name__} was never launched in the int4 epoch")
    require(int4_epoch_launches["fused_adj_matmul_int4_t"] == 2 * LAYERS * steps
            and int4_epoch_launches["fused_adj_matmul_int8_t"] == 0,
            f"int4 epoch: K5 launches {int4_epoch_launches}")
    require_no_k3(int4_epoch_launches, "int4 epoch", 4 * LAYERS * steps)
    require(bool(np.isfinite(terms4).all()) and terms4[0] < steps * np.log(2.0),
            f"int4 epoch loss terms {terms4}")
    del runner4, triple

    # checked after the counts are read: these launch nothing counted twice
    train_pairs = set(zip(data.train_user.tolist(), data.train_item.tolist()))
    for users_t, pos_t, neg_t in triples:
        require(users_t.shape == pos_t.shape == neg_t.shape == (data.num_train,), "triple shapes")
        # membership by the CSR binary search, independent of the sampler's bitmap
        hit = sampler_lib._membership(row_ptr_d, col_idx_d, users_t, neg_t,
                                      neg_sampler.search_iters)
        require(not bool(hit.any()), f"{int(hit.sum())} sampled negatives are train positives")
        require(bool(((neg_t >= 0) & (neg_t < ni)).all()), "negative out of range")
    u0, p0 = triples[0][0].cpu().numpy(), triples[0][1].cpu().numpy()
    require(set(zip(u0.tolist(), p0.tolist())) == train_pairs and u0.size == len(train_pairs),
            "the epoch is not a permutation of the train pairs")
    for epoch, terms in enumerate(term_sums):
        require(terms.shape == (2,) and bool(np.isfinite(terms).all()),
                f"epoch {epoch}: loss terms {terms}")
        log(f"epoch {epoch}: bpr sum {terms[0]:.4f} (mean {terms[0] / steps:.6f}), "
            f"reg sum {terms[1]:.6f}; {epoch_ms[epoch]:.1f} ms = {epoch_ms[epoch] / steps:.3f} "
            f"ms per step; sampler {sample_ms[epoch]:.2f} ms")
    require(term_sums[0][0] < steps * np.log(2.0), "the first epoch's BPR sum is not below "
                                                   "that of a model that knows nothing")
    require(term_sums[1][0] < term_sums[0][0],
            f"BPR sum did not fall: {term_sums[0][0]} then {term_sums[1][0]}")
    for name_ in ("recall", "precision", "ndcg"):
        v = result[name_]
        require(v.shape == (len(TOP_KS),) and bool(np.isfinite(v).all())
                and bool(((v >= 0) & (v <= 1)).all()), f"{name_} {v}")
    require(best.epoch == EPOCHS and np.array_equal(best.recall, result["recall"]), "BestResults")
    require(bool(torch.isfinite(model.user_emb).all() and torch.isfinite(model.item_emb).all()),
            "non-finite parameters after training")
    step_ms = float(np.mean(epoch_ms)) / steps
    log(f"eval sweep {eval_ms:.2f} ms over {evaluator.plan.num_test_users} test users: "
        + ", ".join(f"{m}@{TOP_KS} {np.round(result[m], 5).tolist()}"
                    for m in ("recall", "precision", "ndcg")))
    log(f"training: {step_ms:.3f} ms per step, {float(np.mean(epoch_ms)):.1f} ms per epoch of "
        f"{steps} steps of {BATCH} triples ({data.num_train / np.mean(epoch_ms) * 1e3:.0f} "
        f"triples/s), sampler {float(np.mean(sample_ms)):.2f} ms per epoch, eval sweep "
        f"{eval_ms:.2f} ms, peak device memory {peak_gb:.2f} GB")
    log(f"int8 vs int4, bare EpochRunner: int8 {step_ms:.3f} ms per step "
        f"({float(np.mean(epoch_ms)):.1f} ms per epoch), int4 {epoch4_ms / steps:.3f} ms per step "
        f"({epoch4_ms:.1f} ms per epoch, {2 * LAYERS} K5 launches per step)")

    # ---- the run harness in int4: train_model with logs and checkpoints,
    # then both Recommender constructors answer the requests
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg_run = cfg4.updated(interval=1, dataset=data.name)
        log_dir, ck_dir = os.path.join(tmp, "log"), os.path.join(tmp, "ck")
        reset_counts()
        t0 = time.perf_counter()
        result4 = loop_lib.train_model("LightGCN", data, config=cfg_run, seed=0, log_dir=log_dir,
                                       echo=False, max_epochs=EPOCHS, checkpoint_dir=ck_dir)
        torch.cuda.synchronize()
        harness_s = time.perf_counter() - t0
        rec_result = Recommender.from_train_result("LightGCN", data, cfg_run, result4)
        rec_ckpt = Recommender.from_checkpoint("LightGCN", data, cfg_run, ck_dir)
        answers_result = [rec_result.recommend(users, k=K) for users in requests]
        answers_ckpt = [rec_ckpt.recommend(users, k=K) for users in requests]
        harness_launches = read_counts()
        log(f"run harness launches: {harness_launches}")
        for fn in int4_counters:
            require(fn.launches > 0, f"{fn.__name__} was never launched on the run-harness path")
        require_no_k3(harness_launches, "run harness")
        # per epoch 6 sweeps a step and one eval chain; one chain per Recommender
        want_k5 = EPOCHS * (2 * LAYERS * steps + LAYERS) + 2 * LAYERS
        require(harness_launches["fused_adj_matmul_int4_t"] == want_k5
                and harness_launches["fused_adj_matmul_int8_t"] == 0,
                f"run harness: expected {want_k5} K5 and no K1 launches")

        require(ckpt_lib.latest_checkpoint(ck_dir) == EPOCHS, "no checkpoint of the last epoch")
        for (it_a, sc_a), (it_b, sc_b) in zip(answers_result, answers_ckpt):
            require(np.array_equal(it_a, it_b) and np.array_equal(sc_a, sc_b),
                    "from_train_result and from_checkpoint serve different answers")
        ref_rec4 = Recommender(PlainChainModel(rec_result.model), data)
        for users, (items, scores) in zip(requests, answers_result):
            check_answers(ref_rec4, data, users, items, scores)
        log_base = os.path.join(log_dir, "LightGCN", data.name)
        require(os.path.getsize(log_base + ".log") > 0 and os.path.getsize(log_base + ".jsonl") > 0,
                "train_model wrote no log files")
        with open(log_base + ".jsonl") as f:
            events = [json.loads(line) for line in f]
        train_events = [e for e in events if e["kind"] == "train_epoch"]
        eval_events = [e for e in events if e["kind"] == "eval"]
        require(len(train_events) == EPOCHS and len(eval_events) == EPOCHS
                and events[-1]["kind"] == "best", f"events {[e['kind'] for e in events]}")
        bpr = [e["loss_terms"][0] for e in train_events]
        require(bool(np.isfinite(bpr).all()) and bpr[1] < bpr[0] < np.log(2.0),
                f"train_model's BPR terms did not fall: {bpr}")
        require(1 <= result4.best.epoch <= EPOCHS and len(result4.history) == EPOCHS
                and bool(np.isfinite(eval_events[-1]["recall"]).all()), "train_model's result")
        with open(log_base + ".log") as f:
            log_text = f.read()
        require("compute_dtype : int4" in log_text and "Best epoch:" in log_text, "log lines")
        harness_epoch_ms = [h["train_time"] * 1e3 for h in result4.history]
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(
            os.path.join(tmp, "ck_timed"), 1, loop_lib.training_state_tree(
                rec_result.model, torch.optim.Adam(rec_result.model.parameters()),
                torch.Generator(), torch.Generator(device=dev)))
        ckpt_s = time.perf_counter() - t0
        log(f"run harness int4: train_model {harness_s:.2f} s for {EPOCHS} epochs with evaluation "
            f"and a checkpoint each; epochs "
            + ", ".join(f"{t:.1f} ms" for t in harness_epoch_ms)
            + f" ({harness_epoch_ms[-1] / steps:.3f} ms per step in the last, bare runner "
            f"{epoch4_ms / steps:.3f}); BPR terms {bpr}; recall@{TOP_KS[-1]} "
            f"{eval_events[-1]['recall'][-1]:.5f}; one checkpoint write {ckpt_s:.3f} s; both "
            f"Recommender constructors served {len(requests)} requests with equal answers, "
            "checked against the plain path")
        del rec_result, rec_ckpt, ref_rec4, result4
        torch.cuda.empty_cache()

        # ---- the command lines on the card, a small dataset from files
        quick = make_synthetic_dataset(*QUICK, seed=0, name="quick")
        write_dataset(os.path.join(tmp, "data", "quick"), quick)
        conf_dir = os.path.join(tmp, "conf")
        os.makedirs(conf_dir)
        with open(os.path.join(default_configure_dir(), "LightGCN.txt")) as f:
            conf_text = f.read()
        with open(os.path.join(conf_dir, "LightGCN.txt"), "w") as f:
            f.write(conf_text + f"\ndataset_path = {os.path.join(tmp, 'data')}\n"
                    "dataset = quick\ntraining_epochs = 2\ninterval = 1\n"
                    f"batch_size = {BATCH}\ncompute_dtype = int4\n")
        cli_ck = os.path.join(tmp, "cli_ck")
        cli_users = [1, 17, 42]
        reset_counts()
        t0 = time.perf_counter()
        out_main, out_serve = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_main):
            code_main = cli_main.main(["--model", "LightGCN", "--configure_dir", conf_dir,
                                       "--log_dir", os.path.join(tmp, "cli_log"),
                                       "--checkpoint_dir", cli_ck, "--seed", "7"])
        with contextlib.redirect_stdout(out_serve):
            code_serve = cli_serve.main(["--model", "LightGCN", "--configure_dir", conf_dir,
                                         "--checkpoint_dir", cli_ck, "--users",
                                         ",".join(map(str, cli_users)), "-k", str(K)])
        cli_s = time.perf_counter() - t0
        cli_launches = read_counts()
        log(f"command-line launches: {cli_launches}")
        require(code_main == 0 and code_serve == 0, f"exit codes {code_main}, {code_serve}")
        for fn in int4_counters:
            require(fn.launches > 0, f"{fn.__name__} was never launched by the command lines")
        require_no_k3(cli_launches, "command lines")
        require("compute_dtype : int4" in out_main.getvalue()
                and "Best epoch:" in out_main.getvalue(), "main's output")
        rows = [json.loads(line) for line in out_serve.getvalue().strip().splitlines()]
        require([r["user"] for r in rows] == cli_users, f"serve answered {len(rows)} users")
        for r in rows:
            seen = quick.col_idx[quick.row_ptr[r["user"]]: quick.row_ptr[r["user"] + 1]]
            require(len(r["items"]) == len(set(r["items"])) == K and len(r["scores"]) == K
                    and bool(np.isfinite(r["scores"]).all())
                    and r["scores"] == sorted(r["scores"], reverse=True)
                    and not np.isin(r["items"], seen).any(), f"serve's answer for {r['user']}")
        log(f"command lines: main trained 2 epochs on {quick.num_users} x {quick.num_items} and "
            f"serve answered {len(rows)} users in {cli_s:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- K7 and K8, the per-application duals in [N, d] layout, on K1's and
    # K5's inputs transposed: equal to their plain versions, to K1 and K5, and
    # to each other
    quN, qiN, qi4N = qu.T.contiguous(), qi.T.contiguous(), qi4.T.contiguous()
    yu7, yi7 = fusedmm.fused_adj_matmul_int8(adj.m8, quN, qiN)
    yu7_p, yi7_p = fusedmm.fused_adj_matmul_int8_plain(adj.m8, quN, qiN)
    errs["K7"] = max(max_abs(yu7, yu7_p), max_abs(yi7, yi7_p))
    require(torch.equal(yu7, yu7_p) and torch.equal(yi7, yi7_p),
            f"K7 differs from its plain version: max abs err {errs['K7']}")
    require(torch.equal(yu7, yu.T) and torch.equal(yi7, yi.T),
            "K7 differs from K1 on the transposed activations")
    yu7b, yi7b = fusedmm.fused_adj_matmul_int8(adj.m8, quN, qiN)
    require(torch.equal(yu7.view(torch.int32), yu7b.view(torch.int32))
            and torch.equal(yi7.view(torch.int32), yi7b.view(torch.int32)),
            f"K7 at d = {DIM}: two launches differ")
    del yu7b, yi7b
    yu8, yi8 = fusedmm.fused_adj_matmul_int4(adj4.m8, quN, qi4N)
    yu8_p, yi8_p = fusedmm.fused_adj_matmul_int4_plain(adj4.m8, quN, qi4N)
    errs["K8"] = max(max_abs(yu8, yu8_p), max_abs(yi8, yi8_p))
    require(torch.equal(yu8, yu8_p) and torch.equal(yi8, yi8_p),
            f"K8 differs from its plain version: max abs err {errs['K8']}")
    require(torch.equal(yu8, yu4.T) and torch.equal(yi8, yi4.T),
            "K8 differs from K5 on the transposed activations")
    require(torch.equal(yu8, yu7) and torch.equal(yi8[:i_pad], yi7)
            and not bool(yi8[i_pad:].any()), "K8 differs from K7 on the unpacked matrix")
    yu8b, yi8b = fusedmm.fused_adj_matmul_int4(adj4.m8, quN, qi4N)
    require(torch.equal(yu8.view(torch.int32), yu8b.view(torch.int32))
            and torch.equal(yi8.view(torch.int32), yi8b.view(torch.int32)),
            f"K8 at d = {DIM}: two launches differ")
    del yu8b, yi8b
    log(f"K7 and K8 equal their plain versions, K1 and K5 transposed, and each other exactly "
        f"({int((yu7 != 0).sum())} + {int((yi7 != 0).sum())} non-zero sums); two launches of "
        "each bit-equal")
    k7_64_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8(adj.m8, quN, qiN), 20)
    k7_64_passes = fusedmm.fused_adj_matmul_int8.passes  # as K7's launcher reports them
    require(k7_64_passes == fusedmm.scan_passes(DIM) == 1,
            f"K7 at d = {DIM}: {k7_64_passes} reads of M launched, {fusedmm.scan_passes(DIM)} "
            "stated")
    # K8 at d = 64 beside its bound, plain version and library call: m4 read
    # once, the activations in, the sums out; 4 operations per non-zero
    # entry and feature
    k8_64_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul_int4(adj4.m8, quN, qi4N), 20)
    k8_64_passes = fusedmm.fused_adj_matmul_int4.passes  # as K8's launcher reports them
    require(k8_64_passes == fusedmm.scan_passes(DIM) == 1,
            f"K8 at d = {DIM}: {k8_64_passes} reads of m4 launched, {fusedmm.scan_passes(DIM)} "
            "stated")
    k8_64_bound = bound(adj4.m8.numel() + 5 * d * (u_pad + i_pad4), 4.0 * nnz * d)
    k8_64_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_int4_plain(adj4.m8, quN, qi4N), 3, 1)
    k8_64_lib = k5_lib  # the same function on the same inputs, transposed
    k1_now = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi), 20)
    k5_now = cuda_ms(lambda: fusedmm.fused_adj_matmul_int4_t(adj4.m8, qu, qi4), 20)
    log(f"at d = {DIM}: K7 {k7_64_ms:.4f} ms ({k7_64_passes} pass over M, as launched) beside K1 "
        f"{k1_now:.4f} ms, K8 {k8_64_ms:.4f} ms ({k8_64_passes} pass over m4, as launched; bound "
        f"{k8_64_bound[0]:.4f} ms by {k8_64_bound[1]}, plain {k8_64_plain:.4f} ms, "
        f"torch._int_mm x2 on the unpacked matrix {k8_64_lib}) beside K5 {k5_now:.4f} ms, per "
        f"application")
    del yu7_p, yi7_p, yu8_p, yi8_p, yu7, yi7, yu8, yi8

    # three `FusedSquareAdj.matmul` calls against the chain's layers
    for graph, mode in ((adj, "int8"), (adj4, "int4")):
        layers = propagate.fused_chain_t(graph, emb0, LAYERS, True, None)
        h = emb0
        for k, want in enumerate(layers[1:], 1):
            h = graph.matmul(h)
            require(torch.equal(h, want), f"{mode}: matmul applied {k} times differs from the "
                                          f"chain's layer {k}: max abs err {max_abs(h, want)}")
        del layers, h
    log(f"{LAYERS} FusedSquareAdj.matmul calls equal the chain's layers exactly, int8 and int4")

    # ---- K6, the bfloat16 dual, on the first application's inputs of the
    # exact model (the same tables as the int8 model's at its start)
    cfg_bf = cfg.updated(compute_dtype="bfloat16", propagation_backend="fused")
    model_bf = get_model("LightGCN")(cfg_bf, data, device=dev,
                                     generator=torch.Generator().manual_seed(0))
    adj_bf = model_bf.graph
    require(isinstance(adj_bf, propagate.FusedSquareAdj) and adj_bf.quant == "none"
            and tuple(adj_bf.m8.shape) == (u_pad, i_pad) and torch.equal(adj_bf.m8, adj.m8),
            "the exact fused adjacency is not the int8 matrix")
    require(torch.equal(concat_user_item(model_bf.user_emb, model_bf.item_emb).detach(), emb0),
            "the exact model's tables differ from the int8 model's initial tables")
    zu6 = (adj_bf.right_u[:, None] * emb0[:nu]).contiguous()
    zi6 = (adj_bf.right_i[:, None] * emb0[nu:]).contiguous()
    y6 = fusedmm.fused_adj_matmul(adj_bf.m8, zu6, zi6)
    y6_again = fusedmm.fused_adj_matmul(adj_bf.m8, zu6, zi6)
    y6_p = fusedmm.fused_adj_matmul_plain(adj_bf.m8, zu6, zi6)
    errs["K6"] = 0.0
    for what, a, b, c in zip(("yu", "yi"), y6, y6_again, y6_p):
        require(tuple(a.shape) == tuple(c.shape) and a.dtype == torch.float32
                and bool(torch.isfinite(a).all()), f"K6 {what}: shape, type or non-finite")
        require(torch.equal(a, b), f"K6 {what}: two launches differ, max abs err {max_abs(a, b)}")
        assert_close(a, c, f"K6 {what}", **TIGHT)
        errs["K6"] = max(errs["K6"], max_abs(a, c))
    k6_passes = fusedmm.fused_adj_matmul.passes  # as K6's launcher reports them
    require(k6_passes == fusedmm.scan_passes(DIM) == 1,
            f"K6 at d = {DIM}: {k6_passes} reads of M launched, {fusedmm.scan_passes(DIM)} stated")
    log(f"K6 matches its plain version (max abs err {errs['K6']:.3e}, largest sum "
        f"{float(max(y6_p[0].abs().max(), y6_p[1].abs().max())):.3e}); two launches bit-equal; "
        f"{k6_passes} read of M, as launched")
    # K6 at d = 128 (one read of M for 128 features): the first application's
    # inputs beside a second copy scaled by 1/2
    zu6w, zi6w = (torch.cat([z_, 0.5 * z_], 1) for z_ in (zu6, zi6))
    y6w = fusedmm.fused_adj_matmul(adj_bf.m8, zu6w, zi6w)
    k6_128_passes = fusedmm.fused_adj_matmul.passes
    require(k6_128_passes == fusedmm.scan_passes(2 * DIM) == 1,
            f"K6 at d = {2 * DIM}: {k6_128_passes} reads of M launched")
    y6w_again = fusedmm.fused_adj_matmul(adj_bf.m8, zu6w, zi6w)
    for what, a, b, c in zip(("yu", "yi"), y6w, y6w_again,
                             fusedmm.fused_adj_matmul_plain(adj_bf.m8, zu6w, zi6w)):
        require(torch.equal(a, b), f"K6 d = {2 * DIM} {what}: two launches differ")
        assert_close(a, c, f"K6 d = {2 * DIM} {what}", **TIGHT)
        errs["K6"] = max(errs["K6"], max_abs(a, c))
    # one K6 call with no synchronisation of the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y6_nosync = fusedmm.fused_adj_matmul(adj_bf.m8, zu6, zi6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(all(torch.equal(a, b) for a, b in zip(y6_nosync, y6)), "K6 under sync debug differs")
    log(f"K6 at d = {2 * DIM}: within TIGHT of its plain version, two launches bit-equal, "
        f"{k6_128_passes} read of M; one K6 call ran under sync debug mode 'error'")
    del y6w, y6w_again, y6_nosync
    # the backward: the swapped product of the batch cotangent, against
    # autograd through the plain version
    g6 = (cot[:nu].contiguous(), cot[nu:].contiguous())
    grads6 = []
    for fn in (fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_plain):
        a, b = zu6.clone().requires_grad_(True), zi6.clone().requires_grad_(True)
        torch.autograd.backward(list(fn(adj_bf.m8, a, b)), list(g6))
        grads6.append((a.grad, b.grad))
    for what, got, ref in zip(("d zu", "d zi"), *grads6):
        top = float(ref.abs().max())
        require(top > 0 and max_abs(got, ref) <= BF16 * top,
                f"K6 backward {what}: max abs err {max_abs(got, ref)} above {BF16} of {top}")
    log(f"K6 backward (swapped cotangents) within {BF16} of autograd through the plain version")
    del grads6, y6_again

    # M read once, the float32 activations in, the float32 sums out; the
    # function's work is 4 operations per non-zero entry and feature
    k6_bytes = u_pad * i_pad + 4 * d * (nu + ni) + 4 * d * (nu + ni)
    k6_bound = bound(k6_bytes, 4.0 * nnz * d, bf16_ops)
    k6_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul(adj_bf.m8, zu6, zi6), 20)
    k6_128_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul(adj_bf.m8, zu6w, zi6w), 20)
    k6_128_bound = bound(u_pad * i_pad + 16 * d * (nu + ni), 8.0 * nnz * d, bf16_ops)
    k6_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(adj_bf.m8, zu6, zi6), 3, 1)
    # library yardstick: two torch.matmul calls on a bfloat16 copy of M
    # (results rounded to bfloat16), the copy's time stated apart
    copy_ms = cuda_ms(lambda: adj_bf.m8.to(torch.bfloat16), 3, 1)
    m_bf = adj_bf.m8.to(torch.bfloat16)
    zu16 = torch.nn.functional.pad(zu6.to(torch.bfloat16), (0, 0, 0, u_pad - nu))
    zi16 = torch.nn.functional.pad(zi6.to(torch.bfloat16), (0, 0, 0, i_pad - ni))
    lib6 = (m_bf @ zi16, m_bf.T @ zu16)
    for what, a, c in zip(("yu", "yi"), lib6, y6_p):
        require(max_abs(a[: c.shape[0]].float(), c) <= BF16 * float(c.abs().max()),
                f"torch.matmul on the bfloat16 copy disagrees with K6's plain version ({what})")
    k6_lib = cuda_ms(lambda: (m_bf @ zi16, m_bf.T @ zu16), 10)
    log(f"K6 {k6_ms:.4f} ms per application (bound {k6_bound[0]:.4f} ms by {k6_bound[1]}, plain "
        f"{k6_plain:.4f} ms, torch.matmul x2 on a bfloat16 copy {k6_lib:.4f} ms, the copy "
        f"{copy_ms:.4f} ms more); at d = {2 * DIM} {k6_128_ms:.4f} ms (bound "
        f"{k6_128_bound[0]:.4f} ms by {k6_128_bound[1]})")
    del m_bf, zu16, zi16, lib6, y6, y6_p

    # ---- the exact path at full width: bfloat16 on the fused backend
    cfg_gather = cfg.updated(compute_dtype="float32", propagation_backend="gather")
    t0 = time.perf_counter()
    model_gather = get_model("LightGCN")(cfg_gather, data, device=dev,
                                         generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    require(isinstance(model_gather.graph, propagate.GatherSquareAdj), "gather adjacency")
    log(f"gather adjacency ({model_gather.graph.graph.rows.numel()} padded edges) on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    ref_gather = Recommender(model_gather, data)

    reset_counts()
    t0 = time.perf_counter()
    rec_bf = Recommender(model_bf, data)
    torch.cuda.synchronize()
    embed_bf_first_ms = (time.perf_counter() - t0) * 1e3
    answers_bf = [rec_bf.recommend(users, k=K) for users in requests]
    runner_bf = EpochRunner(model_bf, lr, BATCH, BF16_STEPS * BATCH)
    require(runner_bf.num_batches == BF16_STEPS, f"{runner_bf.num_batches} steps per run")
    triple = neg_sampler.sample_epoch(gen)
    bf_terms, bf_run_ms = [], []
    for run in range(2):
        part = [t_[run * BF16_STEPS * BATCH: (run + 1) * BF16_STEPS * BATCH] for t_ in triple]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf_terms.append(runner_bf.run_epoch(*part, generator=gen, epoch=run).cpu().numpy())
        bf_run_ms.append((time.perf_counter() - t0) * 1e3)
    evaluator_bf = Evaluator(model_bf, data, cfg_bf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result_bf = evaluator_bf.evaluate()
    torch.cuda.synchronize()
    eval_bf_ms = (time.perf_counter() - t0) * 1e3
    bf_launches = read_counts()
    log(f"exact bfloat16-fused path launches: {bf_launches}")
    # a Recommender's chain, six products a step, the evaluation's chain
    want_k6 = LAYERS + 2 * BF16_STEPS * 2 * LAYERS + LAYERS
    require(bf_launches["fused_adj_matmul"] == want_k6,
            f"bfloat16-fused path: {bf_launches['fused_adj_matmul']} K6 launches, expected "
            f"{want_k6}")
    require(all(n == 0 for name_, n in bf_launches.items() if name_ != "fused_adj_matmul"),
            "another kernel ran on the bfloat16-fused path")
    for users, (items, scores) in zip(requests, answers_bf):
        check_answers_close(ref_gather, data, users, items, scores, BF16_SCORE)
    log(f"bfloat16-fused model served {len(requests)} requests: checked against the float32 "
        f"gather model within {BF16_SCORE}")
    for run, terms in enumerate(bf_terms):
        require(terms.shape == (2,) and bool(np.isfinite(terms).all()), f"run {run}: {terms}")
        log(f"bfloat16-fused run {run}: bpr sum {terms[0]:.4f} (mean {terms[0] / BF16_STEPS:.6f})"
            f", reg sum {terms[1]:.6f}; {bf_run_ms[run]:.1f} ms = "
            f"{bf_run_ms[run] / BF16_STEPS:.3f} ms per step")
    require(bf_terms[0][0] < BF16_STEPS * np.log(2.0) and bf_terms[1][0] < bf_terms[0][0],
            f"bfloat16-fused BPR sum did not fall: {bf_terms[0][0]} then {bf_terms[1][0]}")
    for name_ in ("recall", "precision", "ndcg"):
        v = result_bf[name_]
        require(v.shape == (len(TOP_KS),) and bool(np.isfinite(v).all())
                and bool(((v >= 0) & (v <= 1)).all()), f"bfloat16-fused {name_} {v}")
    require(bool(torch.isfinite(model_bf.user_emb).all() and torch.isfinite(model_bf.item_emb).all()),
            "non-finite parameters after bfloat16-fused training")
    embed_bf_ms = host_ms(model_bf.eval_embeddings, 5)
    bf_step_ms = bf_run_ms[1] / BF16_STEPS
    log(f"bfloat16-fused: eval embeddings {embed_bf_ms:.3f} ms (first {embed_bf_first_ms:.3f}), "
        f"{bf_step_ms:.3f} ms per step, eval sweep {eval_bf_ms:.2f} ms, recall@{TOP_KS[-1]} "
        f"{result_bf['recall'][-1]:.5f}")
    del rec_bf, runner_bf, ref_gather, evaluator_bf

    # ---- the other exact backends and dense int8: eval embeddings held to
    # each other from the same weights, then a few tens of steps each. The
    # dense backend runs K6 (bfloat16) and K7 (int8) as the fused backend
    # does, one launch an application; dense float32 and gather run none
    def fresh(cfg_):
        return get_model("LightGCN")(cfg_, data, device=dev,
                                     generator=torch.Generator().manual_seed(0))

    embed_fused_bf = torch.cat(fresh(cfg_bf).eval_embeddings())
    exact_models = {
        "dense bfloat16": fresh(cfg.updated(compute_dtype="bfloat16", propagation_backend="dense")),
        "dense int8": fresh(cfg.updated(compute_dtype="int8", propagation_backend="dense")),
        "dense float32": fresh(cfg.updated(compute_dtype="float32", propagation_backend="dense")),
        "gather float32": model_gather,
    }
    for label in ("dense bfloat16", "dense int8", "dense float32"):
        g_ = exact_models[label].graph
        require(isinstance(g_, propagate.DenseSquareAdj)
                and g_.runs_kernel(DIM) == (label != "dense float32")
                and g_.m.shape[1] % propagate.DENSE_COL_PAD == 0, f"{label} adjacency")
    dense_shape = tuple(exact_models["dense bfloat16"].graph.m.shape)
    # every kernel launched on an exact path, by path: the eval embeddings
    # below, the timing's three chains and OTHER_STEPS steps
    dense_launches = {}
    embeds = {}
    for label, m_ in exact_models.items():
        reset_counts()
        embeds[label] = torch.cat(m_.eval_embeddings())
        dense_launches[label] = read_counts()
    embeds["fused bfloat16"] = embed_fused_bf
    top = float(embeds["gather float32"].abs().max())
    err_f32 = max_abs(embeds["dense float32"], embeds["gather float32"])
    require(err_f32 <= F32_SUM * top, f"dense float32 against gather: {err_f32} of {top}")
    # both K6 on the same counts and bfloat16 operands: integer sums, the same
    # scale (a power of two from the largest activation) whatever the padding
    require(torch.equal(embeds["dense bfloat16"], embeds["fused bfloat16"]),
            f"dense bfloat16 eval embeddings differ from fused bfloat16's: max abs err "
            f"{max_abs(embeds['dense bfloat16'], embeds['fused bfloat16'])}")
    err_bf = max_abs(embeds["dense bfloat16"], embeds["gather float32"])
    require(err_bf <= BF16 * top, f"bfloat16 against float32 eval embeddings: {err_bf} of {top}")
    again = torch.cat(model_gather.eval_embeddings())
    require(torch.equal(again, embeds["gather float32"]), "the gather product is not repeatable")
    # dense int8 against its plain route (K7's plain version: exact integer sums)
    m_d8 = exact_models["dense int8"]
    with plain_duals(fusedmm, propagate):
        embed_d8_plain = torch.cat(m_d8.eval_embeddings())
    require(torch.equal(embeds["dense int8"], embed_d8_plain),
            f"dense int8 eval embeddings differ from the plain route's: max abs err "
            f"{max_abs(embeds['dense int8'], embed_d8_plain)}")
    g8 = m_d8.graph
    qu_d8, _ = propagate._quantize_cols(torch.nn.functional.pad(
        g8.right_u[:, None] * m_d8.user_emb.detach(), (0, 0, 0, g8.m.shape[0] - nu)))
    qi_d8, _ = propagate._quantize_cols(torch.nn.functional.pad(
        g8.right_i[:, None] * m_d8.item_emb.detach(), (0, 0, 0, g8.m.shape[1] - ni)))
    raw_d8 = fusedmm.fused_adj_matmul_int8(g8.m, qu_d8, qi_d8)
    raw_d8_plain = fusedmm.fused_adj_matmul_int8_plain(g8.m, qu_d8, qi_d8)
    require(all(torch.equal(a, b) for a, b in zip(raw_d8, raw_d8_plain)),
            "K7 on the dense matrix: raw integer sums differ from its plain version")
    del embed_d8_plain, raw_d8, raw_d8_plain, qu_d8, qi_d8
    log(f"eval embeddings from the same weights: dense float32 within {err_f32:.3e} of gather, "
        f"bfloat16 within {err_bf:.3e} (largest entry {top:.3e}); dense bfloat16 (K6 on M "
        f"{list(dense_shape)}) equal to fused bfloat16 bit for bit; dense int8 (K7) equal to its "
        "plain route, K7's raw sums on the dense matrix equal to its plain version's")
    del embeds, again, embed_fused_bf
    other_ms = {}
    for label, m_ in exact_models.items():
        runner_ = EpochRunner(m_, lr, BATCH, OTHER_STEPS * BATCH)
        part = [t_[: OTHER_STEPS * BATCH] for t_ in triple]
        reset_counts()
        embed_ms_ = host_ms(m_.eval_embeddings, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy()
        step_ms_ = (time.perf_counter() - t0) * 1e3 / OTHER_STEPS
        counts_ = read_counts()
        dense_launches[label] = {k_: n + counts_[k_] for k_, n in dense_launches[label].items()}
        require(bool(np.isfinite(terms).all()) and terms[0] < OTHER_STEPS * np.log(2.0),
                f"{label}: loss terms {terms}")
        other_ms[label] = (step_ms_, embed_ms_)
        log(f"{label}: {step_ms_:.3f} ms per step over {OTHER_STEPS} steps (bpr mean "
            f"{terms[0] / OTHER_STEPS:.6f}), eval embeddings {embed_ms_:.3f} ms")
        del runner_
    # four chains (one held, three timed) and two products a layer a step
    want_dense = 4 * LAYERS + OTHER_STEPS * 2 * LAYERS
    expect = {"dense bfloat16": {"fused_adj_matmul": want_dense},
              "dense int8": {"fused_adj_matmul_int8": want_dense,
                             "scatter_add_rows": 2 * OTHER_STEPS},
              "dense float32": {}, "gather float32": {}}
    for label, want in expect.items():
        got_ = {k_: n for k_, n in dense_launches[label].items() if n}
        require(got_ == want, f"{label}: launches {got_}, expected {want}")
    log("exact paths' launches: dense bfloat16 K6 x "
        f"{dense_launches['dense bfloat16']['fused_adj_matmul']}, dense int8 K7 x "
        f"{dense_launches['dense int8']['fused_adj_matmul_int8']} (K4 x "
        f"{dense_launches['dense int8']['scatter_add_rows']}), dense float32 and gather none")
    del exact_models, model_gather, m_d8, g8
    torch.cuda.empty_cache()

    # ---- LightGCN int8 and int4 at a width the chain's kernels decline:
    # the per-application loop through K7 and K8, forward and backward
    wide = {}
    reset_counts()
    for mode in ("int8", "int4"):
        m_ = fresh(cfg.updated(compute_dtype=mode, embedding_size=WIDE_DIM))
        require(not chainmm.supports_chain_resident(m_.graph, WIDE_DIM, LAYERS, "mean", None),
                f"{mode}: the chain took d = {WIDE_DIM}")
        runner_ = EpochRunner(m_, lr, BATCH, WIDE_STEPS * BATCH)
        part = [t_[: WIDE_STEPS * BATCH] for t_ in triple]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms = runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy()
        wide[mode] = (terms, (time.perf_counter() - t0) * 1e3 / WIDE_STEPS, m_)
        require(bool(np.isfinite(terms).all()) and terms[0] < WIDE_STEPS * np.log(2.0),
                f"{mode} at d = {WIDE_DIM}: loss terms {terms}")
        del runner_
    wide_launches = read_counts()
    log(f"d = {WIDE_DIM} path launches: {wide_launches}")
    want_wide = WIDE_STEPS * 2 * LAYERS
    require(wide_launches["fused_adj_matmul_int8"] == want_wide
            and wide_launches["fused_adj_matmul_int4"] == want_wide
            and wide_launches["fused_adj_matmul_int8_t"] == 0
            and wide_launches["fused_adj_matmul_int4_t"] == 0,
            f"d = {WIDE_DIM}: expected {want_wide} launches each of K7 and K8 and none of K1, K5")
    require(np.array_equal(wide["int8"][0], wide["int4"][0])
            and torch.equal(wide["int8"][2].user_emb, wide["int4"][2].user_emb),
            f"int4 at d = {WIDE_DIM} differs from int8: {wide['int4'][0]} and {wide['int8'][0]}")
    log(f"d = {WIDE_DIM} through the per-application loop: int8 {wide['int8'][1]:.3f} ms per step, "
        f"int4 {wide['int4'][1]:.3f} ms per step over {WIDE_STEPS} steps; equal loss terms and "
        f"weights")

    # K7 and K8 at the shapes this path gives them: the first application's
    # quantized activations of the d = 128 model; each reads its stored
    # matrix once for all 128 features, and K8 equals K7 on the unpacked one
    m128, m128_4 = wide["int8"][2], wide["int4"][2]
    a128, a128_4 = m128.graph, m128_4.graph
    qu128, _ = propagate._quantize_cols(torch.nn.functional.pad(
        a128.right_u[:, None] * m128.user_emb.detach(), (0, 0, 0, u_pad - nu)))
    qi128, _ = propagate._quantize_cols(torch.nn.functional.pad(
        a128.right_i[:, None] * m128.item_emb.detach(), (0, 0, 0, i_pad4 - ni)))
    qi128_8 = qi128[:i_pad].contiguous()
    dw = WIDE_DIM
    wide_kernels, wide_out = {}, {}
    for tag, fn, plain, m_store, qi_, cols in (
            ("K7", fusedmm.fused_adj_matmul_int8, fusedmm.fused_adj_matmul_int8_plain, a128.m8,
             qi128_8, i_pad),
            ("K8", fusedmm.fused_adj_matmul_int4, fusedmm.fused_adj_matmul_int4_plain, a128_4.m8,
             qi128, i_pad4)):
        got = fn(m_store, qu128, qi_)
        launched = fn.passes  # as the launcher reports them
        require(launched == fusedmm.scan_passes(dw) == 1,
                f"{tag} at d = {dw}: {launched} reads of the stored matrix launched, "
                f"{fusedmm.scan_passes(dw)} stated; one expected")
        want = plain(m_store, qu128, qi_)
        err = max(max_abs(got[0], want[0]), max_abs(got[1], want[1]))
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"{tag} at d = {dw} differs from its plain version: max abs err {err}")
        again = fn(m_store, qu128, qi_)
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, again)), f"{tag} at d = {dw}: two launches differ")
        del again
        errs[tag] = max(errs[tag], err)
        wide_out[tag] = got
        m_bytes = m_store.numel()
        # the function's work: the non-zero entries only (2 directions x 2 ops
        # each), the same entries packed or not
        ops = 4.0 * nnz * dw
        bnd = bound(m_bytes + dw * (u_pad + cols) + 4 * dw * (u_pad + cols), ops)
        ms = cuda_ms(lambda: fn(m_store, qu128, qi_), 20)
        plain_ms = cuda_ms(lambda: plain(m_store, qu128, qi_), 3, 1)
        m_dense = fusedmm.unpack_nibbles(m_store) if tag == "K8" else m_store
        lib = int_mm_ms(m_dense, qu128.T.contiguous(), qi_.T.contiguous(),
                        got[0].T.contiguous(), got[1].T.contiguous())
        wide_kernels[tag] = (ms, plain_ms, bnd, lib)
        log(f"{tag} at d = {dw}: {ms:.4f} ms per application, {launched} pass over the stored "
            f"matrix, as launched (bound {bnd[0]:.4f} ms by {bnd[1]}, plain {plain_ms:.4f} ms, "
            f"torch._int_mm x2 on transposed operands {lib})")
        del got, want, m_dense
    (yu7w, yi7w), (yu8w, yi8w) = wide_out["K7"], wide_out["K8"]
    require(torch.equal(yu8w, yu7w) and torch.equal(yi8w[:i_pad], yi7w)
            and not bool(yi8w[i_pad:].any()), f"K8 at d = {dw} differs from K7 on the unpacked "
                                              "matrix")
    log(f"K8 at d = {dw} equals K7 on the unpacked matrix exactly")
    del wide, m128, m128_4, wide_out, yu7w, yi7w, yu8w, yi8w

    # ==== EGCF (parallel mode): the tanh chain with the seed sweep, K9 and K10
    cfg_e = load_model_config("EGCF").updated(
        embedding_size=DIM, GCN_layer=LAYERS, compute_dtype="int8", batch_size=BATCH,
        test_batch_size=2048, dataset=data.name)
    require(cfg_e.float("ssl_lambda") == 0.1 and cfg_e.float("temperature") == 0.1
            and cfg_e.str("mode") == "parallel", "EGCF's config")

    def fresh_egcf(cfg_):
        return get_model("EGCF")(cfg_, data, device=dev,
                                 generator=torch.Generator().manual_seed(0))

    t0 = time.perf_counter()
    egcf = fresh_egcf(cfg_e)
    egcf4 = fresh_egcf(cfg_e.updated(compute_dtype="int4"))
    torch.cuda.synchronize()
    log(f"EGCF int8 and int4 models (item table [{ni}, {DIM}] alone, adjacencies on the card) in "
        f"{time.perf_counter() - t0:.1f} s")
    require(convert.table_names(egcf) == ("item_emb",)
            and torch.equal(egcf.item_emb, egcf4.item_emb)
            and torch.equal(egcf.graph.m8, adj.m8), "EGCF tables or adjacency")
    require(chainmm.supports_chain_resident(egcf.graph, DIM, LAYERS, "sum", torch.tanh, False,
                                            True), "the resident chain declines EGCF")

    # ---- (a) K9 and K10 against their plain versions, on the seed chain's
    # first sweeps (the item side quantized once, a zero user input)
    xi_e = propagate._pad_cols(egcf.item_emb.detach().T, i_pad).contiguous()
    zi_e, ai_e = chainmm.chain_sweep_epilogue(xi_e, ones_d, torch.ones(i_pad, device=dev), ri,
                                              torch.empty_like(xi_e), chainmm.COMBINE_NONE, True)
    qi_e, si_e = propagate.quantize_rows(zi_e, ai_e)
    qu_0 = torch.zeros((DIM, u_pad), dtype=torch.int8, device=dev)
    yu_seed, _ = fusedmm.fused_adj_matmul_int8_t(adj.m8, qu_0, qi_e)
    hs_u = torch.empty((2, DIM, u_pad), device=dev)
    hs_i = torch.empty((2, DIM, i_pad), device=dev)

    def both_tanh(y, s_, post, pre, c, h_slot, combine, want):
        c_k, c_p, h_p = c.clone(), c.clone(), torch.empty_like(h_slot)
        zk, ak = chainmm.chain_sweep_tanh(y, s_, post, pre, c_k, h_slot, combine, want)
        zp, ap = chainmm.chain_sweep_tanh_plain(y, s_, post, pre, c_p, h_p, combine, want)
        same = (torch.equal(h_slot, h_p) and torch.equal(c_k, c_p)
                and (not want or (torch.equal(zk, zp) and torch.equal(ak, ap))))
        err = max(max_abs(h_slot, h_p), max_abs(c_k, c_p),
                  max_abs(zk, zp) if want else 0.0, max_abs(ak, ap) if want else 0.0)
        require(same, f"K9 combine={combine} want_next={want} differs from its plain version: "
                      f"max abs err {err}")
        errs["K9"] = max(errs.get("K9", 0.0), err)
        return zk, ak, c_k

    cu_e = torch.zeros((DIM, u_pad), device=dev)
    ci_e = torch.zeros((DIM, i_pad), device=dev)
    zu_e, au_e, _ = both_tanh(yu_seed, si_e[:, 0], lu, ru, cu_e, hs_u[0],
                              chainmm.COMBINE_NONE, True)
    qu_e, su_e = propagate.quantize_rows(zu_e, au_e)
    yu_e, yi_e = fusedmm.fused_adj_matmul_int8_t(adj.m8, qu_e, qi_e)
    _, _, cu_e = both_tanh(yu_e, si_e[:, 0], lu, ru, cu_e, hs_u[1], chainmm.COMBINE_SET, True)
    _, _, ci_e = both_tanh(yi_e, su_e[:, 0], li, ri, ci_e, hs_i[1], chainmm.COMBINE_SET, True)
    both_tanh(yu_e, si_e[:, 0], lu, ru, cu_e, hs_u[1], chainmm.COMBINE_ADD, False)
    both_tanh(yi_e, su_e[:, 0], li, ri, ci_e, hs_i[1], chainmm.COMBINE_ADD, True)
    require(torch.equal(hs_u[0], torch.tanh(lu[None, :] * (yu_seed * si_e))),
            "K9's tanh is not torch.tanh on the card")
    log(f"K9 equals its plain version exactly (torch.tanh on the card, "
        f"{int((hs_u[0] != 0).sum())} + {int((hs_u[1] != 0).sum())} non-zero user outputs)")
    for inject, want_next in ((True, True), (False, True), (True, False), (False, False)):
        for y, s_, post, pre, g_, h_ in ((yu_e, si_e[:, 0], ru, lu, gu, hs_u[1]),
                                         (yi_e, su_e[:, 0], ri, li, gi, hs_i[1])):
            h_arg = h_ if want_next else None
            ok, ak = chainmm.chain_sweep_tanh_inject(y, s_, post, pre, g_, h_arg, inject, want_next)
            op, ap = chainmm.chain_sweep_tanh_inject_plain(y, s_, post, pre, g_, h_arg, inject,
                                                           want_next)
            same = torch.equal(ok, op) and (not want_next or torch.equal(ak, ap))
            require(same, f"K10 inject={inject} want_next={want_next} differs from its plain "
                          f"version: max abs err {max_abs(ok, op)}")
            errs["K10"] = max(errs.get("K10", 0.0), max_abs(ok, op))
    log("K10 equals its plain version exactly")

    # ---- the tanh chain's sweeps: K1 or K5 with K9's or K10's epilogue in
    # the turn-out, on the chain's middle sweep inputs, against the dual
    # followed by K9 or K10 on each side that runs (the route they
    # replaced) and their plain version, bit for bit; the seed sweeps' per-
    # side cases; infinite and NaN scales, NaN cotangents and h over a
    # whole block of 1,024 nodes
    qi_e4 = propagate._pad_cols(qi_e, i_pad4).contiguous()
    tanh_cases = {"int8": (adj.m8, qi_e, (lu, li), (ru, ri), (cu_e, ci_e), (gu, gi),
                           (hs_u[1], hs_i[1])),
                  "int4": (adj4.m8, qi_e4, (lu, li4), (ru, ri4),
                           (cu_e, propagate._pad_cols(ci_e, i_pad4).contiguous()), (gu, gi4),
                           (hs_u[1], propagate._pad_cols(hs_i[1], i_pad4).contiguous()))}
    tanh_fns = {("fused", False): chainmm.dual_sweep_tanh,
                ("fused", True): chainmm.dual_sweep_tanh_inject,
                ("plain", False): chainmm.dual_sweep_tanh.plain,
                ("plain", True): chainmm.dual_sweep_tanh_inject.plain}

    def tanh_route(route, quant, inject, flag, want_next, ext, hs_, sides=(True, True),
                   scales=(su_e, si_e)):
        """One tanh sweep: "fused" (the dual with K9's or K10's epilogue in
        its turn-out), "plain" (its plain version) or "separate" (the dual
        kernel, then K9 or K10 on each side that runs)."""
        m_, qi_, l_, r_ = tanh_cases[quant][:4]
        post, pre = (r_, l_) if inject else (l_, r_)
        su_, si_ = scales
        if route != "separate":
            return list(tanh_fns[(route, inject)](quant, m_, qu_e, su_, qi_, si_, post, pre, ext,
                                                  flag, want_next, hs_, sides))
        ys = duals[quant](m_, qu_e, qi_)
        wants = want_next if isinstance(want_next, tuple) else (want_next,) * 2
        epi = chainmm.chain_sweep_tanh_inject if inject else chainmm.chain_sweep_tanh
        out = []
        for k, (y, s_) in enumerate(((ys[0], si_), (ys[1], su_))):
            out += (epi(y, s_[:, 0], post[k], pre[k], ext[k], hs_[k], flag, wants[k])
                    if sides[k] else [None, None])
        return out

    def tanh_case(quant, inject, flag, want_next, sides=(True, True), h_=None, scales=None,
                  nan_in=None, plain=True):
        """The fused tanh sweep against the separate route (and its plain
        version), bit for bit: every output, the combine, the h slices."""
        ext0 = [t_.clone() for t_ in tanh_cases[quant][5 if inject else 4]]
        h_in = list(h_ if h_ is not None else tanh_cases[quant][6])
        if nan_in is not None:  # NaN over node block [1024, 2048) of one feature a side
            ext0[0][7, 1024:2048] = float("nan")
            h_in[1] = h_in[1].clone()
            h_in[1][11, 1024:2048] = float("nan")
        runs = {}
        for route in ("fused", "separate") + (("plain",) if plain else ()):
            ext = [t_.clone() for t_ in ext0]
            hs_ = h_in if inject else [torch.full_like(t_, float("nan")) for t_ in ext0]
            out = tanh_route(route, quant, inject, flag, want_next, ext, hs_, sides,
                             scales or (su_e, si_e))
            runs[route] = out + ext + ([] if inject else hs_)
        what = (f"{quant} tanh sweep inject={inject} flag={flag} want_next={want_next} "
                f"sides={sides}")
        for k, a in enumerate(runs["fused"]):
            for route, other in runs.items():
                b = other[k]
                if a is None or b is None:
                    require(a is None and b is None, f"{what}: an output is missing ({route})")
                    continue
                require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                        f"{what} differs from the {route} route: max abs err {max_abs(a, b)}")
                errs["tanh_sweep"] = max(errs["tanh_sweep"], max_abs(a, b))
        return runs["fused"]

    errs["tanh_sweep"] = 0.0
    n_tanh_cases = 0
    for quant in ("int8", "int4"):
        for combine in (chainmm.COMBINE_NONE, chainmm.COMBINE_SET, chainmm.COMBINE_ADD):
            for want_next in (True, False):
                got = tanh_case(quant, False, combine, want_next)
                n_tanh_cases += 1
                if quant == "int8" and combine == chainmm.COMBINE_ADD and want_next:
                    require(torch.equal(got[6], torch.tanh(lu[None, :] * (yu_e * si_e))),
                            "the fused sweep's h is not torch.tanh on the card")
                    require(bool(got[1].gt(0).all() and got[3].gt(0).all()),
                            "a fused tanh sweep's amax is not positive")
        for inject in (True, False):
            for want_next in (True, False):
                tanh_case(quant, True, inject, want_next)
                n_tanh_cases += 1
        # the seed sweeps: the forward's runs the users alone; the backward's
        # sweep K - 1 wants the users' next input alone, its sweep K runs the
        # items alone
        got = tanh_case(quant, False, chainmm.COMBINE_NONE, True, (True, False))
        require(got[2] is None and bool(got[7].isnan().all()), "the seed sweep wrote items")
        h_seed = (tanh_cases[quant][6][0], None)
        got = tanh_case(quant, True, False, (True, False), h_=h_seed)
        require(got[1] is not None and got[3] is None, "sweep K - 1: the amax of a side")
        got = tanh_case(quant, True, True, False, (False, True), h_=(None, None))
        require(got[0] is None and got[2] is not None, "sweep K: the user side ran")
        n_tanh_cases += 3
        # non-finite scales and inputs, against the separate route (the plain
        # version's amax takes any NaN where the kernels' take a whole block's)
        su_inf, si_inf, si_nan = su_e.clone(), si_e.clone(), si_e.clone()
        su_inf[9] = float("inf")
        si_inf[5] = float("inf")
        si_nan[3] = float("nan")
        for inject in (False, True):
            flag = True if inject else chainmm.COMBINE_ADD
            got = tanh_case(quant, inject, flag, True, scales=(su_inf, si_inf), plain=False)
            require(not inject or not bool(torch.isfinite(got[1]).all()),
                    "an infinite scale left the inject sweep's amax finite")
            got = tanh_case(quant, inject, flag, True, scales=(su_e, si_nan), plain=False)
            require(bool(got[1][3].isnan()), "a NaN scale left the amax a number")
            got = tanh_case(quant, inject, flag, True, nan_in=True, plain=False)
            require(not inject or bool(got[1][7].isnan() and got[3][11].isnan()),
                    "NaN over a whole block left the inject sweep's amax a number")
            n_tanh_cases += 3
    log(f"the tanh chain's sweeps ({n_tanh_cases} cases: K9's and K10's epilogues in the turn-out "
        "of K1 and of K5; every combine and inject, with and without a next input; the seed "
        "sweeps' per-side cases; infinite and NaN scales, NaN over a whole block) equal the dual "
        "followed by K9 or K10 on each side that runs exactly, and their plain version where "
        "finite; the fused h is torch.tanh")

    # the tanh sweeps on (z, amax), against K3 and the sweep on (q, s): the
    # users' input is the seed sweep's output, the items' the prologue's;
    # the seed sweeps' zero inputs and sides
    tanh_z = {"int8": [(zu_e, au_e), (zi_e, ai_e)],
              "int4": [(zu_e, au_e), (propagate._pad_cols(zi_e, i_pad4).contiguous(), ai_e)]}
    for quant in ("int8", "int4"):
        m_, _, l_, r_, c_, g_, h_ = tanh_cases[quant]
        for combine in (chainmm.COMBINE_NONE, chainmm.COMBINE_SET, chainmm.COMBINE_ADD):
            for want_next in (True, False):
                quantizing_case("tanh", quant, m_, tanh_z[quant], l_, r_, c_, (None, None),
                                combine, want_next)
        for inject in (True, False):
            for want_next in (True, False):
                quantizing_case("tanh_inject", quant, m_, tanh_z[quant], r_, l_, g_,
                                h_ if want_next else (None, None), inject, want_next)
        # the forward's seed sweep: a zero user input, the users alone
        got = quantizing_case("tanh", quant, m_, [(None, None), tanh_z[quant][1]], l_, r_, c_,
                              (None, None), chainmm.COMBINE_NONE, True, (True, False))
        require(got[2] is None and bool(got[7].isnan().all()), "the seed sweep wrote items")
        # the backward's sweep K - 1 (the users' next input alone) and sweep
        # K (a zero item input, the items alone)
        got = quantizing_case("tanh_inject", quant, m_, tanh_z[quant], r_, l_, g_, (h_[0], None),
                              False, (True, False))
        require(got[1] is not None and got[3] is None, "sweep K - 1: the amax of a side")
        got = quantizing_case("tanh_inject", quant, m_, [tanh_z[quant][0], (None, None)], r_, l_,
                              (None, g_[1]), (None, None), True, False, (False, True))
        require(got[0] is None and got[2] is not None, "sweep K: the user side ran")
        for case in ("inf_amax", "nan_amax", "nan_z_block"):
            plain_ok = case == "nan_amax"
            quantizing_case("tanh", quant, m_, non_finite(tanh_z[quant], case), l_, r_, c_,
                            (None, None), chainmm.COMBINE_ADD, True, plain=plain_ok)
            quantizing_case("tanh_inject", quant, m_, non_finite(tanh_z[quant], case), r_, l_,
                            g_, h_, True, True, plain=plain_ok)
    log(f"the tanh chain's quantizing sweeps ({n_quant_cases['tanh']} cases: int8 and int4, "
        "every combine and inject, with and without a next input, the seed sweeps' zero inputs "
        "and sides, infinite and NaN amax, NaN z over a whole block) equal K3 on each input "
        "followed by the sweep on (q, s) exactly, and their plain version where finite; no K3 "
        "launch")

    # one forward sweep (both sides, combine ADD, next input) and one backward sweep
    # (inject, next input), as the chain runs them in the middle of the chain
    def k9_pair(fn):
        fn(yu_e, si_e[:, 0], lu, ru, cu_e, hs_u[1], chainmm.COMBINE_ADD, True)
        fn(yi_e, su_e[:, 0], li, ri, ci_e, hs_i[1], chainmm.COMBINE_ADD, True)

    def k10_pair(fn):
        fn(yu_e, si_e[:, 0], ru, lu, gu, hs_u[1], True, True)
        fn(yi_e, su_e[:, 0], ri, li, gi, hs_i[1], True, True)

    # K9: y read, h and z written, the combine read and written: 20 bytes an
    # element; K10: y, g and h read, the next input written: 16
    k9_bound = bound(20.0 * d * n_all + 8.0 * n_all + 8.0 * d, 7.0 * d * n_all, F32_OPS)
    k10_bound = bound(16.0 * d * n_all + 8.0 * n_all + 8.0 * d, 8.0 * d * n_all, F32_OPS)
    k9_ms = cuda_ms(lambda: k9_pair(chainmm.chain_sweep_tanh), 50)
    k9_plain = cuda_ms(lambda: k9_pair(chainmm.chain_sweep_tanh_plain), 20)
    k10_ms = cuda_ms(lambda: k10_pair(chainmm.chain_sweep_tanh_inject), 50)
    k10_plain = cuda_ms(lambda: k10_pair(chainmm.chain_sweep_tanh_inject_plain), 20)
    log(f"K9 {k9_ms:.4f} ms per sweep (2 launches; bound {k9_bound[0]:.4f} by {k9_bound[1]}, plain "
        f"{k9_plain:.4f}); K10 {k10_ms:.4f} ms (bound {k10_bound[0]:.4f}, plain {k10_plain:.4f})")
    # the tanh chain's sweeps (a middle sweep: the combine added or the
    # cotangent injected, a next input) beside the bare dual and the route
    # they replaced, the dual and two K9 or K10 launches; their bound: the
    # stored matrix and the int8 inputs read once, the scales and vectors,
    # the combine read and written, h and z written (forward: 16 bytes an
    # element), the cotangent and h read and the next input written
    # (inject: 12); 4 operations per non-zero entry and feature
    tanh_times = {}
    for quant in ("int8", "int4"):
        m_, qi_ = tanh_cases[quant][:2]
        n_q = u_pad + qi_.shape[1]
        bare = cuda_ms(lambda: duals[quant](m_, qu_e, qi_), 20)
        for inject, flag in ((False, chainmm.COMBINE_ADD), (True, True)):
            ext = [t_.clone() for t_ in tanh_cases[quant][5 if inject else 4]]
            hs_t = tanh_cases[quant][6] if inject else [torch.empty_like(t_) for t_ in ext]
            fused = cuda_ms(lambda: tanh_route("fused", quant, inject, flag, True, ext, hs_t), 20)
            separate = cuda_ms(lambda: tanh_route("separate", quant, inject, flag, True, ext,
                                                  hs_t), 20)
            nbytes = (m_.numel() + d * n_q + 8.0 * d + 8.0 * n_q
                      + (12.0 if inject else 16.0) * d * n_q)
            bnd = bound(nbytes, 4.0 * nnz * d)
            require(bnd[0] <= fused, f"{quant} tanh sweep inject={inject}: {fused} ms below its "
                                     f"bound {bnd[0]} ms")
            tanh_times[(quant, inject)] = (fused, separate, bare, bnd)
            log(f"{quant} tanh {'inject' if inject else 'forward'} sweep: {fused:.4f} ms (bound "
                f"{bnd[0]:.4f} by {bnd[1]}) beside the dual and two "
                f"{'K10' if inject else 'K9'} launches {separate:.4f} ms and the bare dual "
                f"{bare:.4f} ms")
            l_, r_ = tanh_cases[quant][2:4]
            time_quantizing("tanh_inject" if inject else "tanh", quant, m_, tanh_z[quant],
                            *((r_, l_) if inject else (l_, r_)), ext, flag, fused, nbytes, hs_t)
    del ext, hs_t

    # one int8 and one int4 tanh + seed chain forward and backward issue no
    # synchronisation with the host; no K9 runs, K10 only in the backward's
    # two prologue calls
    x0_s = torch.cat([torch.zeros((nu, DIM), device=dev), egcf.item_emb.detach()])
    for graph in (adj, adj4):
        chainmm.fused_chain_resident(graph, x0_s.clone().requires_grad_(True), LAYERS, False,
                                     "sum", torch.tanh, True).backward(cot)
        x = x0_s.clone().requires_grad_(True)
        before = [fn.launches for fn in tanh_counters]
        sides_before = [fn.sides_run for fn in tanh_counters[2:]]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = chainmm.fused_chain_resident(graph, x, LAYERS, False, "sum", torch.tanh, True)
            fwd_ran = [fn.launches - b for fn, b in zip(tanh_counters, before)]
            out.backward(cot)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran = [fn.launches - b for fn, b in zip(tanh_counters, before)]
        require(fwd_ran == [0, 0, LAYERS + 1, 0] and ran == [0, 2, LAYERS + 1, LAYERS + 1],
                f"the synchronisation check's {graph.quant} tanh chain ran {fwd_ran} forward, "
                f"{ran} in all, launches of (K9, K10, the tanh sweep, the tanh inject sweep)")
        sides = [fn.sides_run - b for fn, b in zip(tanh_counters[2:], sides_before)]
        require(sides == [2 * LAYERS + 1] * 2,
                f"the {graph.quant} tanh chain's sweeps ran {sides} sides, forward and backward "
                "(the separate route's K9 and K10 launches: the seed sweeps run one side)")
        require(bool(torch.isfinite(x.grad).all()), "the tanh chain under sync debug mode")
    log(f"the int8 and int4 tanh + seed chains forward and backward ({LAYERS + 1} fused sweeps "
        "each way, no K9, K10 only in the 2 prologue calls) ran under sync debug mode 'error' "
        "without a synchronisation")
    del yu_seed, hs_u, hs_i, cu_e, ci_e, zu_e, xi_e, zi_e, tanh_cases, tanh_z, x0_s, x, out

    # ---- (b) the 3-layer tanh + seed chain, forward and backward: the kernels
    # against the plain chain, int4 against int8, and the per-sweep route
    x0_e = torch.cat([torch.zeros((nu, DIM), device=dev), egcf.item_emb.detach()])
    chain_runs = []
    for graph, fn in ((adj, chainmm.fused_chain_resident),
                      (adj, chainmm.fused_chain_resident_plain),
                      (adj4, chainmm.fused_chain_resident),
                      (adj, propagate.fused_chain_t)):
        x = x0_e.clone().requires_grad_(True)
        out = fn(graph, x, LAYERS, False, "sum", torch.tanh, True)
        out.backward(cot)
        chain_runs.append((out.detach(), x.grad))
    (ck, gk), (cp, gp), (c4, g4), (ct, gt) = chain_runs
    require(tuple(ck.shape) == (nu + ni, DIM) and bool(torch.isfinite(ck).all())
            and bool(torch.isfinite(gk).all()) and bool(gk[nu:].abs().sum() > 0),
            "tanh chain: shape, non-finite or all-zero gradient")
    require(torch.equal(ck, cp), f"tanh + seed chain differs from the plain chain: max abs err "
                                 f"{max_abs(ck, cp)}")
    require(torch.equal(gk, gp), f"tanh + seed backward chain differs from the plain backward: "
                                 f"max abs err {max_abs(gk, gp)}")
    require(not bool(gk[:nu].any()), "the seed chain gave the zero user input a gradient")
    require(torch.equal(c4, ck) and torch.equal(g4, gk), "the int4 tanh chain differs from int8's")
    fused_t_fwd_equal = torch.equal(ct, ck)
    fused_t_grad_err = max_abs(gt, gk)
    require(fused_t_fwd_equal, f"fused_chain_t's forward differs from the kernel chain: max abs err "
                               f"{max_abs(ct, ck)}")
    log(f"3-layer tanh + seed chain: forward and backward equal the plain chain, int4 equals int8; "
        f"fused_chain_t's forward equal, its autograd gradient within {fused_t_grad_err:.3e} "
        f"(largest {float(gk.abs().max()):.3e}; autograd's tanh backward rounds 1 - h^2 once)")
    del chain_runs, ck, gk, cp, gp, c4, g4, ct, gt

    # ---- (c) serving EGCF int8: eval embeddings and four requests
    reset_counts()
    t0 = time.perf_counter()
    rec_e = Recommender(egcf, data)
    torch.cuda.synchronize()
    egcf_first_embed_ms = (time.perf_counter() - t0) * 1e3
    answers_e = [rec_e.recommend(users, k=K) for users in requests]
    egcf_serve_launches = read_counts()
    log(f"EGCF serving path launches: {egcf_serve_launches}")
    # the forward chain: K2 in the item prologue, K9's epilogue in every
    # sweep's turn-out (the seed sweep's included), no K9 or K10 launch
    egcf_chain_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                           chainmm.dual_sweep_tanh)
    for fn in egcf_chain_counters:
        require(fn.launches > 0, f"{fn.__name__} was never launched on EGCF's serving path")
    require(egcf_serve_launches["dual_sweep_tanh"] == LAYERS + 1
            and egcf_serve_launches["fused_adj_matmul_int8_t"] == LAYERS + 1
            and egcf_serve_launches["chain_sweep_tanh"] == 0
            and egcf_serve_launches["chain_sweep_tanh_inject"] == 0,
            "EGCF serving: expected one chain of 4 fused sweeps and no K9 or K10 launch")
    # the seed sweep rounds the items alone, sweep 1 both (the seed's item
    # input again), every later sweep both
    require_no_k3(egcf_serve_launches, "EGCF serving", 2 * LAYERS + 1)
    ref_rec_e = Recommender(PlainChainModel(egcf), data)
    for users, (items, scores) in zip(requests, answers_e):
        check_answers(ref_rec_e, data, users, items, scores)
    egcf_embed_ms = host_ms(egcf.eval_embeddings, 5)
    egcf4_embed_ms = host_ms(egcf4.eval_embeddings, 5)
    egcf_req_ms = {b: host_ms(lambda u=users: rec_e.recommend(u, k=K), 5)
                   for b, users in zip(REQUEST_SIZES, requests)}
    log(f"EGCF served {len(requests)} requests, checked against the plain path; eval embeddings "
        f"{egcf_embed_ms:.3f} ms (first {egcf_first_embed_ms:.3f}; int4 {egcf4_embed_ms:.3f}); per "
        "request: " + ", ".join(f"{b} users {t:.3f} ms" for b, t in egcf_req_ms.items()))
    del rec_e, ref_rec_e

    # ---- (d) one step against the plain path, two epochs, an evaluation
    def egcf_step(m):
        m.zero_grad(set_to_none=True)
        terms = m.loss_terms(batch)
        sum(terms).backward()
        out = (m.item_emb.grad.clone(), *(t_.detach() for t_ in terms))
        m.zero_grad(set_to_none=True)
        return out

    got_e = egcf_step(egcf)
    with plain_kernels(chainmm, scatter):
        want_e = egcf_step(egcf)
    for what, a, b in zip(("d item_emb", "bpr", "reg", "ssl"), got_e, want_e):
        require(bool(torch.isfinite(a).all()), f"EGCF step, {what}: not finite")
        require(torch.equal(a, b), f"EGCF step, {what}: kernel path differs from the plain path, "
                                   f"max abs err {max_abs(a, b)}")
    log(f"one EGCF step: item gradient and loss terms equal the plain path's (bpr "
        f"{float(got_e[1]):.6f}, reg {float(got_e[2]):.3e}, ssl {float(got_e[3]):.6f})")
    del got_e, want_e

    lr_e = cfg_e.float("learn_rate")
    runner_e = EpochRunner(egcf, lr_e, BATCH, data.num_train)
    evaluator_e = Evaluator(egcf, data, cfg_e)
    reset_counts()
    e_epoch_ms, e_terms = [], []
    for epoch in range(EPOCHS):
        triple_e = neg_sampler.sample_epoch(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_terms.append(runner_e.run_epoch(*triple_e, generator=gen, epoch=epoch).cpu().numpy())
        e_epoch_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    result_e = evaluator_e.evaluate()
    torch.cuda.synchronize()
    e_eval_ms = (time.perf_counter() - t0) * 1e3
    egcf_train_launches = read_counts()
    log(f"EGCF training path launches: {egcf_train_launches}")
    for fn in egcf_chain_counters + (chainmm.chain_sweep_tanh_inject,
                                     chainmm.dual_sweep_tanh_inject, scatter.scatter_add_rows):
        require(fn.launches > 0, f"{fn.__name__} was never launched on EGCF's training path")
    # per step: forward 4 sweeps, backward 4 (the seed's included), all
    # fused, K10 standalone in the backward's prologue (2); the eval chain 4
    n_e = EPOCHS * steps
    want_dual = n_e * 2 * (LAYERS + 1) + LAYERS + 1
    want_e = {"fused_adj_matmul_int8_t": want_dual, "chain_sweep_inject": 0,
              "fused_adj_matmul_int4_t": 0, "chain_sweep_tanh": 0,
              "chain_sweep_tanh_inject": 2 * n_e, "dual_sweep_tanh": (n_e + 1) * (LAYERS + 1),
              "dual_sweep_tanh_inject": n_e * (LAYERS + 1)}
    require(all(egcf_train_launches[k_] == v for k_, v in want_e.items()),
            f"EGCF training: expected {want_e}")
    # the backward's seed sweep rounds the users alone
    require_no_k3(egcf_train_launches, "EGCF training", (2 * n_e + 1) * (2 * LAYERS + 1))
    for epoch, terms in enumerate(e_terms):
        require(terms.shape == (3,) and bool(np.isfinite(terms).all()),
                f"EGCF epoch {epoch}: loss terms {terms}")
        log(f"EGCF epoch {epoch}: bpr sum {terms[0]:.4f}, reg sum {terms[1]:.6f}, ssl sum "
            f"{terms[2]:.4f}; {e_epoch_ms[epoch]:.1f} ms = {e_epoch_ms[epoch] / steps:.3f} ms per "
            "step")
    require(e_terms[0][0] < steps * np.log(2.0) and e_terms[1][0] < e_terms[0][0],
            f"EGCF's BPR sum did not fall: {e_terms[0][0]} then {e_terms[1][0]}")
    for name_ in ("recall", "precision", "ndcg"):
        v = result_e[name_]
        require(v.shape == (2,) and bool(np.isfinite(v).all())
                and bool(((v >= 0) & (v <= 1)).all()), f"EGCF {name_} {v}")
    require(bool(torch.isfinite(egcf.item_emb).all()), "non-finite EGCF parameters")
    egcf_step_ms = float(np.mean(e_epoch_ms)) / steps
    log(f"EGCF training: {egcf_step_ms:.3f} ms per step, {float(np.mean(e_epoch_ms)):.1f} ms per "
        f"epoch; eval sweep {e_eval_ms:.2f} ms, recall@{cfg_e.int_list('top_K')} "
        f"{np.round(result_e['recall'], 5).tolist()}")
    del runner_e, evaluator_e, triple_e

    # ---- (e) int4 against int8: 24 steps from the same weights, equal terms and weights
    egcf8 = fresh_egcf(cfg_e)
    part = [t_[: OTHER_STEPS * BATCH] for t_ in triple]
    e_runs = {}
    reset_counts()
    for mode, m_ in (("int8", egcf8), ("int4", egcf4)):
        runner_ = EpochRunner(m_, lr_e, BATCH, OTHER_STEPS * BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_runs[mode] = (runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy(),
                        (time.perf_counter() - t0) * 1e3 / OTHER_STEPS)
    egcf_int4_launches = read_counts()
    require(np.array_equal(e_runs["int8"][0], e_runs["int4"][0])
            and torch.equal(egcf8.item_emb, egcf4.item_emb),
            f"EGCF int4 differs from int8 over {OTHER_STEPS} steps: {e_runs}")
    require(egcf_int4_launches["fused_adj_matmul_int4_t"] == OTHER_STEPS * 2 * (LAYERS + 1),
            f"EGCF int4 steps: K5 launches {egcf_int4_launches}")
    log(f"EGCF int4 over {OTHER_STEPS} steps: loss terms and weights equal int8's; "
        f"{e_runs['int4'][1]:.3f} ms per step beside int8 {e_runs['int8'][1]:.3f}")
    del egcf8, egcf4

    # ---- (f) bfloat16 on the fused backend: K6 per application with tanh
    cfg_e_bf = cfg_e.updated(compute_dtype="bfloat16", propagation_backend="fused")
    egcf_bf = fresh_egcf(cfg_e_bf)
    egcf_gather = fresh_egcf(cfg_e.updated(compute_dtype="float32", propagation_backend="gather"))
    ref_gather_e = Recommender(egcf_gather, data)
    reset_counts()
    rec_e_bf = Recommender(egcf_bf, data)
    answers_e_bf = [rec_e_bf.recommend(users, k=K) for users in requests]
    runner_ = EpochRunner(egcf_bf, lr_e, BATCH, OTHER_STEPS * BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf_e_terms = runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy()
    egcf_bf_step_ms = (time.perf_counter() - t0) * 1e3 / OTHER_STEPS
    egcf_bf_launches = read_counts()
    want_k6_e = (LAYERS + 1) * (1 + 2 * OTHER_STEPS)
    require(egcf_bf_launches["fused_adj_matmul"] == want_k6_e
            and all(n == 0 for name_, n in egcf_bf_launches.items() if name_ != "fused_adj_matmul"),
            f"EGCF bfloat16-fused: expected {want_k6_e} K6 launches and nothing else: "
            f"{egcf_bf_launches}")
    # LightGCN's rule for BF16_SCORE: 2**-7 of the largest logit, times the
    # sigmoid's slope at 0 (1/4); EGCF sums three tanh layers, so its logits
    # are larger and the bar follows them
    ref_u, ref_i = ref_gather_e._repr
    top_logit = max(float((ref_u[torch.from_numpy(u_).to(dev)] @ ref_i.T).abs().max())
                    for u_ in requests)
    egcf_bf_tol = BF16 * top_logit / 4.0
    for users, (items, scores) in zip(requests, answers_e_bf):
        check_answers_close(ref_gather_e, data, users, items, scores, egcf_bf_tol)
    require(bool(np.isfinite(bf_e_terms).all()) and bf_e_terms[0] < OTHER_STEPS * np.log(2.0),
            f"EGCF bfloat16-fused loss terms {bf_e_terms}")
    egcf_bf_embed_ms = host_ms(egcf_bf.eval_embeddings, 3)
    log(f"EGCF bfloat16-fused: served {len(requests)} requests, checked against the float32 gather "
        f"EGCF within {egcf_bf_tol:.3e} (largest logit {top_logit:.4f}); {egcf_bf_step_ms:.3f} ms "
        f"per step over {OTHER_STEPS} steps, "
        f"eval embeddings {egcf_bf_embed_ms:.3f} ms")
    del egcf_bf, egcf_gather, ref_gather_e, rec_e_bf, runner_
    torch.cuda.empty_cache()

    # ---- (g) the run harness and the command line for EGCF
    tmp = tempfile.mkdtemp(prefix="chip_smoke_egcf_")
    try:
        ck_e = os.path.join(tmp, "ck")
        reset_counts()
        t0 = time.perf_counter()
        res_e = loop_lib.train_model("EGCF", data, config=cfg_e, seed=0,
                                     log_dir=os.path.join(tmp, "log"), echo=False, max_epochs=1,
                                     checkpoint_dir=ck_e)
        rec_ck_e = Recommender.from_checkpoint("EGCF", data, cfg_e, ck_e)
        items_ck, scores_ck = rec_ck_e.recommend(requests[1], k=K)
        rec_res_e = Recommender.from_train_result("EGCF", data, cfg_e, res_e)
        items_res, scores_res = rec_res_e.recommend(requests[1], k=K)
        egcf_harness_s = time.perf_counter() - t0
        egcf_harness_launches = read_counts()
        log(f"EGCF run-harness launches: {egcf_harness_launches}")
        for fn in egcf_chain_counters + (chainmm.chain_sweep_tanh_inject,
                                         chainmm.dual_sweep_tanh_inject):
            require(fn.launches > 0, f"{fn.__name__} was never launched by EGCF's train_model")
        require_no_k3(egcf_harness_launches, "EGCF run harness")
        require(ckpt_lib.latest_checkpoint(ck_e) == 1
                and np.array_equal(items_ck, items_res) and np.array_equal(scores_ck, scores_res),
                "EGCF: no checkpoint, or from_checkpoint and from_train_result disagree")
        require(set(res_e.params) == {"item_emb"} and len(res_e.history) == 1
                and bool(np.isfinite(res_e.last_result["recall"]).all()), "EGCF's train_model")
        del rec_ck_e, rec_res_e, res_e

        quick_e = make_synthetic_dataset(*QUICK, seed=0, name="quick")
        write_dataset(os.path.join(tmp, "data", "quick"), quick_e)
        conf_e = os.path.join(tmp, "conf")
        os.makedirs(conf_e)
        with open(os.path.join(default_configure_dir(), "EGCF.txt")) as f:
            text_e = f.read()
        with open(os.path.join(conf_e, "EGCF.txt"), "w") as f:
            f.write(text_e + f"\ndataset_path = {os.path.join(tmp, 'data')}\n"
                    "dataset = quick\ntraining_epochs = 1\n")
        out_e = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_e):
            code_e = cli_main.main(["--model=EGCF", "--configure_dir", conf_e, "--log_dir",
                                    os.path.join(tmp, "cli_log"), "--checkpoint_dir",
                                    os.path.join(tmp, "cli_ck")])
        egcf_cli_s = time.perf_counter() - t0
        egcf_cli_launches = read_counts()
        require(code_e == 0 and "Best epoch:" in out_e.getvalue()
                and "compute_dtype : int8" in out_e.getvalue(), "EGCF's command line")
        for fn in egcf_chain_counters + (chainmm.chain_sweep_tanh_inject,
                                         chainmm.dual_sweep_tanh_inject):
            require(fn.launches > 0, f"{fn.__name__} was never launched by EGCF's command line")
        require_no_k3(egcf_cli_launches, "EGCF command line")
        log(f"EGCF run harness: train_model one epoch with evaluation and a checkpoint, both "
            f"Recommender constructors, {egcf_harness_s:.2f} s; main.main(['--model=EGCF', ...]) "
            f"on {quick_e.num_users} x {quick_e.num_items} in {egcf_cli_s:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del egcf
    torch.cuda.empty_cache()

    # ==== the bitpack backend (K11) and the batch-row partial product (K12, K13)
    t0 = time.perf_counter()
    model_bp = fresh(cfg.updated(compute_dtype="bfloat16", propagation_backend="bitpack"))
    torch.cuda.synchronize()
    adj_bp = model_bp.graph
    bp_bytes = adj_bp.packed.numel() + adj_bp.packed_t.numel()
    log(f"bitpack adjacency packed {list(adj_bp.packed.shape)} + {list(adj_bp.packed_t.shape)} = "
        f"{bp_bytes / 1e9:.3f} GB on the card in {time.perf_counter() - t0:.1f} s")
    require(isinstance(adj_bp, propagate.BitSquareAdj)
            and torch.equal(bitmm.unpack_rows(adj_bp.packed), adj.m8.view(torch.uint8))
            and torch.equal(bitmm.unpack_rows(adj_bp.packed_t)[:i_pad, :u_pad],
                            adj.m8.T.view(torch.uint8)),
            "the packed bits are not the int8 matrix")
    nnz_bp = int(torch.count_nonzero(adj.m8))

    # ---- K11 on the first application's inputs: against its plain version,
    # against itself, against K6 on the same binary matrix, its backward
    zu11 = (adj_bp.right_u[:, None] * emb0[:nu]).contiguous()
    zi11 = (adj_bp.right_i[:, None] * emb0[nu:]).contiguous()
    # each direction with the plan its adjacency keeps (K11's split of the
    # packed bits among its warps)
    require(adj_bp.plans is not None, "the bitpack adjacency on the card has no K11 plans")
    k11_dirs = ((adj_bp.packed, zi11, nu, adj_bp.plans[0]),
                (adj_bp.packed_t, zu11, ni, adj_bp.plans[1]))
    y11 = [bitmm.bit_matmul(*a_) for a_ in k11_dirs]
    y11_again = [bitmm.bit_matmul(*a_) for a_ in k11_dirs]
    y11_p = [bitmm.bit_matmul_plain(*a_[:3]) for a_ in k11_dirs]
    y6 = fusedmm.fused_adj_matmul(adj_bf.m8, zu11, zi11)
    errs["K11"] = 0.0
    for what, a, b, c, k6 in zip(("yu", "yi"), y11, y11_again, y11_p, y6):
        require(a.dtype == torch.float32 and tuple(a.shape) == tuple(c.shape)
                and bool(torch.isfinite(a).all()), f"K11 {what}: shape, type or non-finite")
        require(torch.equal(a, b), f"K11 {what}: two launches differ, max abs err {max_abs(a, b)}")
        assert_close(a, c, f"K11 {what}", **TIGHT)
        assert_close(a, k6, f"K11 against K6 {what}", **TIGHT)
        errs["K11"] = max(errs["K11"], max_abs(a, c))
    log(f"K11 matches its plain version (max abs err {errs['K11']:.3e}) and K6 (max abs err "
        f"{max(max_abs(a, b) for a, b in zip(y11, y6)):.3e}); two launches bit-equal")
    grads11 = []
    for fn in (lambda a, b: bitmm.bit_adj_matmul(adj_bp.packed, adj_bp.packed_t, a, b,
                                                 adj_bp.plans),
               lambda a, b: (bitmm.bit_matmul_plain(adj_bp.packed, b, nu),
                             bitmm.bit_matmul_plain(adj_bp.packed_t, a, ni))):
        a, b = zu11.clone().requires_grad_(True), zi11.clone().requires_grad_(True)
        torch.autograd.backward(list(fn(a, b)), [cot[:nu].contiguous(), cot[nu:].contiguous()])
        grads11.append((a.grad, b.grad))
    for what, got, ref in zip(("d xu", "d xi"), *grads11):
        top = float(ref.abs().max())
        require(top > 0 and max_abs(got, ref) <= BF16 * top,
                f"K11 backward {what}: max abs err {max_abs(got, ref)} above {BF16} of {top}")
    log(f"K11 backward (swapped cotangents) within {BF16} of autograd through the plain version")
    # one K11 call with no synchronisation of the host
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y11_nosync = bitmm.bit_matmul(*k11_dirs[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(torch.equal(y11_nosync, y11[0]), "K11 under sync debug differs")
    log("one K11 call ran under sync debug mode 'error'")
    del grads11, y11_again, y6, y11_nosync

    k11_ms = [cuda_ms(lambda a_=a_: bitmm.bit_matmul(*a_), 20) for a_ in k11_dirs]
    k11_plain = sum(cuda_ms(lambda a_=a_: bitmm.bit_matmul_plain(*a_[:3]), 3, 1)
                    for a_ in k11_dirs)
    # the function needs one add per set bit and feature in each direction
    # (the bits are 0/1); its bytes: both packings, the float32 activations
    # in, the float32 rows out
    k11_ops = 2 * 2.0 * nnz_bp * d
    k11_bytes = bp_bytes + sum(4.0 * a_[1].shape[0] * d + 4.0 * a_[2] * d for a_ in k11_dirs)
    k11_bound = bound(k11_bytes, k11_ops, bf16_ops)
    # library yardstick: torch.matmul x2 on bfloat16 unpacked copies (results
    # rounded to bfloat16), the copies not counted
    lib_ops = []
    for p_, x_, n_, _ in k11_dirs:
        m_bf16 = bitmm.unpack_rows(p_).to(torch.bfloat16)
        lib_ops.append((m_bf16, torch.nn.functional.pad(x_.to(torch.bfloat16),
                                                        (0, 0, 0, p_.shape[1] - x_.shape[0]))))
    for (m_bf16, x_bf16), c in zip(lib_ops, y11_p):
        got = (m_bf16 @ x_bf16)[: c.shape[0]].float()
        require(max_abs(got, c) <= BF16 * float(c.abs().max()),
                "torch.matmul on the unpacked copy disagrees with K11's plain version")
    k11_lib = cuda_ms(lambda: [m_bf16 @ x_bf16 for m_bf16, x_bf16 in lib_ops], 10)
    del lib_ops, y11, y11_p
    torch.cuda.empty_cache()
    log(f"K11 {k11_ms[0]:.4f} ms (users, [{8 * adj_bp.packed.shape[0]}, "
        f"{adj_bp.packed.shape[1]}]) + {k11_ms[1]:.4f} ms (items) = {sum(k11_ms):.4f} ms per "
        f"application (bound {k11_bound[0]:.4f} ms by {k11_bound[1]} for {nnz_bp} set bits a "
        f"direction; plain {k11_plain:.4f} ms, torch.matmul x2 on bfloat16 unpacked copies "
        f"{k11_lib:.4f} ms)")

    # ---- the bitpack path, LightGCN bfloat16 and float32: eval embeddings
    # against bfloat16-fused, serving against the float32 gather model, two
    # runs of BIT_STEPS steps, one evaluation
    ref_gather = Recommender(fresh(cfg_gather), data)
    embed_fused_bf = torch.cat(fresh(cfg_bf).eval_embeddings())
    bit_runs = {}
    triple_b = neg_sampler.sample_epoch(gen)
    for dt in ("bfloat16", "float32"):
        cfg_b = cfg.updated(compute_dtype=dt, propagation_backend="bitpack")
        m_b = model_bp if dt == "bfloat16" else fresh(cfg_b)
        emb_b = torch.cat(m_b.eval_embeddings())
        assert_close(emb_b, embed_fused_bf, f"bitpack {dt} against bfloat16-fused eval embeddings",
                     **TIGHT)
        reset_counts()
        t0 = time.perf_counter()
        rec_b = Recommender(m_b, data)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        answers_b = [rec_b.recommend(users, k=K) for users in requests]
        runner_b = EpochRunner(m_b, lr, BATCH, BIT_STEPS * BATCH)
        terms_b, run_ms = [], []
        for run in range(2):
            part = [t_[run * BIT_STEPS * BATCH: (run + 1) * BIT_STEPS * BATCH] for t_ in triple_b]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            terms_b.append(runner_b.run_epoch(*part, generator=gen, epoch=run).cpu().numpy())
            run_ms.append((time.perf_counter() - t0) * 1e3)
        evaluator_b = Evaluator(m_b, data, cfg_b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result_b = evaluator_b.evaluate()
        torch.cuda.synchronize()
        eval_b_ms = (time.perf_counter() - t0) * 1e3
        launches_b = read_counts()
        log(f"bitpack {dt} path launches: {launches_b}")
        # a Recommender's chain, 12 a step (3 layers x 2 directions, forward
        # and backward), the evaluation's chain
        want_k11 = 2 * LAYERS + 2 * BIT_STEPS * 4 * LAYERS + 2 * LAYERS
        require(launches_b["bit_matmul"] == want_k11
                and all(n == 0 for name_, n in launches_b.items() if name_ != "bit_matmul"),
                f"bitpack {dt}: expected {want_k11} K11 launches and nothing else")
        for users, (items, scores) in zip(requests, answers_b):
            check_answers_close(ref_gather, data, users, items, scores, BF16_SCORE)
        require(all(t_.shape == (2,) and bool(np.isfinite(t_).all()) for t_ in terms_b)
                and terms_b[0][0] < BIT_STEPS * np.log(2.0) and terms_b[1][0] < terms_b[0][0],
                f"bitpack {dt}: BPR sums did not fall: {terms_b}")
        for name_ in ("recall", "precision", "ndcg"):
            v = result_b[name_]
            require(v.shape == (len(TOP_KS),) and bool(np.isfinite(v).all())
                    and bool(((v >= 0) & (v <= 1)).all()), f"bitpack {dt} {name_} {v}")
        embed_b_ms = host_ms(m_b.eval_embeddings, 5)
        bit_runs[dt] = (launches_b, run_ms[1] / BIT_STEPS, embed_b_ms, eval_b_ms)
        log(f"bitpack {dt}: eval embeddings within TIGHT of bfloat16-fused, {len(requests)} "
            f"requests within {BF16_SCORE} of the float32 gather model; {embed_b_ms:.3f} ms eval "
            f"embeddings (first {first_ms:.3f}), BPR sums {terms_b[0][0]:.4f} then "
            f"{terms_b[1][0]:.4f}, {run_ms[0] / BIT_STEPS:.3f} / {run_ms[1] / BIT_STEPS:.3f} ms per "
            f"step, eval sweep {eval_b_ms:.2f} ms, recall@{TOP_KS[-1]} "
            f"{result_b['recall'][-1]:.5f}")
        del rec_b, runner_b, m_b, evaluator_b
    del model_bp, adj_bp, ref_gather, embed_fused_bf
    torch.cuda.empty_cache()

    # ---- the bitpack path, EGCF parallel bfloat16: serving against the
    # float32 gather EGCF, OTHER_STEPS steps
    egcf_bp = fresh_egcf(cfg_e.updated(compute_dtype="bfloat16", propagation_backend="bitpack"))
    ref_gather_e = Recommender(fresh_egcf(cfg_e.updated(compute_dtype="float32",
                                                        propagation_backend="gather")), data)
    reset_counts()
    rec_e_bp = Recommender(egcf_bp, data)
    answers_e_bp = [rec_e_bp.recommend(users, k=K) for users in requests]
    runner_ = EpochRunner(egcf_bp, lr_e, BATCH, OTHER_STEPS * BATCH)
    part = [t_[: OTHER_STEPS * BATCH] for t_ in triple]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp_e_terms = runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy()
    egcf_bp_step_ms = (time.perf_counter() - t0) * 1e3 / OTHER_STEPS
    egcf_bp_launches = read_counts()
    want_k11_e = 2 * (LAYERS + 1) * (1 + 2 * OTHER_STEPS)
    require(egcf_bp_launches["bit_matmul"] == want_k11_e
            and all(n == 0 for name_, n in egcf_bp_launches.items() if name_ != "bit_matmul"),
            f"EGCF bitpack: expected {want_k11_e} K11 launches and nothing else: "
            f"{egcf_bp_launches}")
    ref_u, ref_i = ref_gather_e._repr
    top_logit_bp = max(float((ref_u[torch.from_numpy(u_).to(dev)] @ ref_i.T).abs().max())
                       for u_ in requests)
    egcf_bp_tol = BF16 * top_logit_bp / 4.0
    for users, (items, scores) in zip(requests, answers_e_bp):
        check_answers_close(ref_gather_e, data, users, items, scores, egcf_bp_tol)
    require(bool(np.isfinite(bp_e_terms).all()) and bp_e_terms[0] < OTHER_STEPS * np.log(2.0),
            f"EGCF bitpack loss terms {bp_e_terms}")
    log(f"EGCF bitpack bfloat16: served {len(requests)} requests within {egcf_bp_tol:.3e} of the "
        f"float32 gather EGCF; {egcf_bp_step_ms:.3f} ms per step over {OTHER_STEPS} steps")
    del egcf_bp, ref_gather_e, rec_e_bp, runner_
    torch.cuda.empty_cache()

    # ---- the batch-row partial product: LightGCN bfloat16 on dense with
    # batch_rows_propagation = 1, against the same model without it
    cfg_full = cfg.updated(compute_dtype="bfloat16", propagation_backend="dense")
    model_rows = fresh(cfg_full.updated(batch_rows_propagation=1))
    model_full = fresh(cfg_full)
    adj_rows = model_rows.graph
    require(adj_rows.supports_rows and not model_full.graph.supports_rows
            and torch.equal(adj_rows.m_t, adj_rows.m.T), "the dense adjacency's row copies")
    log(f"dense adjacency with the transpose: M {list(adj_rows.m.shape)} and Mᵀ "
        f"{list(adj_rows.m_t.shape)}, {2 * adj_rows.m.numel() / 1e9:.3f} GB")
    got_r, want_r = step_grads(model_rows), step_grads(model_full)
    for what, a, b in zip(("bpr", "reg"), got_r[2:], want_r[2:]):
        assert_close(a, b, f"batch rows, one step's {what}", **TIGHT)
    for what, a, b in zip(("d user_emb", "d item_emb"), got_r[:2], want_r[:2]):
        top = float(b.abs().max())
        require(bool(torch.isfinite(a).all()) and max_abs(a, b) <= BF16 * top,
                f"batch rows, one step's {what}: max abs err {max_abs(a, b)} above {BF16} of {top}")
    log(f"batch rows: one step's loss terms within TIGHT and gradients within {BF16} of the full "
        f"propagation's (max abs err {max(max_abs(a, b) for a, b in zip(got_r, want_r)):.3e})")
    del got_r, want_r

    # K12 and K13 at the step's shapes: the batch's rows (with repeats), the
    # first application's activations and the batch cotangents
    rows_sets = ((adj_rows.m, idx_u), (adj_rows.m_t, idx_i))
    zs = (adj_rows.right_i[:, None] * emb0[nu:], adj_rows.right_u[:, None] * emb0[:nu])
    gs = (vals_u, vals_i)
    k12 = {}
    for dt in (torch.bfloat16, torch.float32):
        for tag, fn, plain, vs in (("K12", gathermm.gather_rows_matmul,
                                    gathermm.gather_rows_matmul_plain, zs),
                                   ("K13", gathermm.gather_rows_matmul_t,
                                    gathermm.gather_rows_matmul_t_plain, gs)):
            cases = [(m_, r_, v_.to(dt).contiguous()) for (m_, r_), v_ in zip(rows_sets, vs)]
            for m_, r_, v_ in cases:
                got = fn(m_, r_, v_)
                require(torch.equal(got, fn(m_, r_, v_)), f"{tag} {dt}: two launches differ")
                # atol scales with the largest entry: K13's cotangents are
                # those of a mean over the batch, far below unit scale
                want = plain(m_, r_, v_)
                assert_close(got, want, f"{tag} {dt}", rtol=TIGHT["rtol"],
                             atol=TIGHT["atol"] * float(want.abs().max()))
                errs[tag] = max(errs.get(tag, 0.0), max_abs(got, want))
            ms = cuda_ms(lambda: [fn(*c_) for c_ in cases], 20)
            plain_ms = cuda_ms(lambda: [plain(*c_) for c_ in cases], 3, 1)
            if tag == "K12":
                lib_fn = lambda: [m_[r_, : v_.shape[0]].to(dt) @ v_  # noqa: E731
                                  for m_, r_, v_ in cases]
                out_bytes = sum(4.0 * r_.numel() * d for _, r_, _ in cases)
            else:
                lib_fn = lambda: [m_[r_].to(dt).T @ v_ for m_, r_, v_ in cases]  # noqa: E731
                out_bytes = sum(4.0 * m_.shape[1] * d for m_, _, _ in cases)
            lib_ms = cuda_ms(lib_fn, 10)
            # each distinct row read once, z (or g) read once, the output written once
            distinct = [int(torch.unique(r_).numel()) for _, r_, _ in cases]
            nbytes = (sum(n_ * m_.shape[1] for n_, (m_, _, _) in zip(distinct, cases))
                      + sum(v_.numel() * v_.element_size() for _, _, v_ in cases) + out_bytes)
            ops = sum(2.0 * n_ * m_.shape[1] * d for n_, (m_, _, _) in zip(distinct, cases))
            bnd = bound(nbytes, ops, bf16_ops if dt == torch.bfloat16 else F32_OPS)
            k12[(tag, dt)] = (ms, plain_ms, bnd, lib_ms)
            log(f"{tag} {str(dt)[6:]}: {ms:.4f} ms per step (2 launches: {idx_u.numel()} user "
                f"rows, {idx_i.numel()} item rows; bound {bnd[0]:.4f} ms by {bnd[1]}, plain "
                f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms)")
    # one call of each on the step's rows issues no synchronisation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (m_, r_), z_, g_ in zip(rows_sets, zs, gs):
            gathermm.gather_rows_matmul(m_, r_, z_.to(torch.bfloat16))
            gathermm.gather_rows_matmul_t(m_, r_, g_.to(torch.bfloat16))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"K12 and K13 match their plain versions within TIGHT (max abs err {errs['K12']:.3e}, "
        f"{errs['K13']:.3e}); two launches bit-equal; no synchronisation under sync debug mode "
        "\"error\"")

    # 2 x 12 steps each, rows and full in turns on the same batches
    half = OTHER_STEPS // 2
    rows_terms, rows_ms, full_ms = [], [], []
    reset_counts()
    for run in range(2):
        part = [t_[run * half * BATCH: (run + 1) * half * BATCH] for t_ in triple_b]
        for m_, out_ms, out_terms in ((model_rows, rows_ms, rows_terms),
                                      (model_full, full_ms, [])):
            runner_ = EpochRunner(m_, lr, BATCH, half * BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_terms.append(runner_.run_epoch(*part, generator=gen, epoch=run).cpu().numpy())
            out_ms.append((time.perf_counter() - t0) * 1e3 / half)
    rows_launches = read_counts()
    log(f"batch-rows path launches: {rows_launches}")
    # K12 and K13 once each a step and table; K6 for the K - 1 full layers
    # of the batch-rows model and the LAYERS of the full model, forward and
    # backward
    want_rows = {"gather_rows_matmul": 2 * OTHER_STEPS, "gather_rows_matmul_t": 2 * OTHER_STEPS,
                 "fused_adj_matmul": OTHER_STEPS * 2 * ((LAYERS - 1) + LAYERS)}
    require({k_: n for k_, n in rows_launches.items() if n} == want_rows,
            f"batch rows: expected {want_rows} and nothing else")
    require(all(bool(np.isfinite(t_).all()) for t_ in rows_terms)
            and rows_terms[1][0] < rows_terms[0][0], f"batch rows: BPR sums {rows_terms}")
    log(f"batch rows: BPR sums {rows_terms[0][0]:.4f} then {rows_terms[1][0]:.4f}; "
        f"{float(np.mean(rows_ms)):.3f} ms per step ({', '.join(f'{t:.3f}' for t in rows_ms)}) "
        f"beside {float(np.mean(full_ms)):.3f} ms ({', '.join(f'{t:.3f}' for t in full_ms)}) "
        f"without batch rows, dense bfloat16, in turns over {half} steps each")
    del model_rows, model_full, adj_rows, runner_, triple_b
    torch.cuda.empty_cache()


    # ==== the rectangular adjacency R̃ = Du^-1/2 · R · Di^-1/2 at yelp2018
    # scale, one direction a call (EGCF's alternating mode): every backend
    # against dense float32 on the first application's tables; the int8
    # product's raw int32 sums against its plain version exactly; K11's
    # single direction, forward and backward, bit-equal to the K11 wrapper
    # on each packing and within TIGHT of its plain version; each op once
    # under sync debug mode "error"; each direction timed beside its bound
    xu_r, xi_r = emb0[:nu].contiguous(), emb0[nu:].contiguous()
    t0 = time.perf_counter()
    rect_adjs = {label: propagate.build_rect_adjacency(data, backend_, dtype_, device=dev)
                 for label, backend_, dtype_ in (("dense float32", "dense", "float32"),
                                                 ("dense bfloat16", "dense", "bfloat16"),
                                                 ("dense int8", "dense", "int8"),
                                                 ("gather float32", "gather", "float32"),
                                                 ("bitpack bfloat16", "bitpack", "bfloat16"))}
    torch.cuda.synchronize()
    log(f"rectangular adjacencies (dense float32, bfloat16, int8 with Mᵀ; gather; bitpack) on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    r8 = rect_adjs["dense int8"]
    r4 = propagate.build_rect_adjacency(data, "auto", "int4", device=dev)
    require(isinstance(r4, propagate.DenseRectAdj) and r4.quant == "int8"
            and torch.equal(r4.m, r8.m) and torch.equal(r8.m_t, r8.m.T)
            and torch.equal(r8.m, adj.m8[: r8.m.shape[0], : r8.m.shape[1]])
            and isinstance(rect_adjs["bitpack bfloat16"], propagate.BitRectAdj)
            and rect_adjs["bitpack bfloat16"].plans is not None,
            "rectangular builders: int4 and auto do not build the int8 dense adjacency, or the "
            "stored matrices differ")
    del r4
    rect_out = {label: (a_.matmul(xi_r), a_.t_matmul(xu_r)) for label, a_ in rect_adjs.items()}
    ref_r = rect_out["dense float32"]
    for label, pair in rect_out.items():
        for what, got, want in zip(("R̃ x_i", "R̃ᵀ x_u"), pair, ref_r):
            require(got.dtype == torch.float32 and got.shape == want.shape
                    and bool(torch.isfinite(got).all()), f"{label} {what}: type, shape, finite")
            top = float(want.abs().max())
            if label == "gather float32":
                require(max_abs(got, want) <= F32_SUM * top, f"{label} {what}: max abs err "
                                                             f"{max_abs(got, want)}")
            elif label in ("dense bfloat16", "bitpack bfloat16"):
                require(max_abs(got, want) <= BF16 * top, f"{label} {what}: max abs err "
                                                          f"{max_abs(got, want)}")
    for what, got, want in zip(("R̃ x_i", "R̃ᵀ x_u"), rect_out["bitpack bfloat16"],
                               rect_out["dense bfloat16"]):
        assert_close(got, want, f"bitpack against dense bfloat16, {what}", **TIGHT)
    # int8: the raw sums exact, the products equal their plain route's
    zs_r = (r8.right[:, None] * xi_r, r8.left[:, None] * xu_r)
    q_r = [propagate._quantize_cols(propagate._pad_rows(z_, n_))
           for z_, n_ in zip(zs_r, (r8.m.shape[1], r8.m.shape[0]))]
    raw_r = [propagate.int8_matmul(r8.m, r8.m_t, q_, t_) for (q_, _), t_ in zip(q_r, (False, True))]
    for (q_, _), t_, got in zip(q_r, (False, True), raw_r):
        require(got.dtype == torch.int32 and torch.equal(got, propagate.int8_matmul_plain(
            r8.m, q_, t_)), f"int8 rectangular product (transpose={t_}): raw sums differ from "
                            "the plain version")
    with plain_rect(propagate, bitmm, chainmm, scatter):
        plain8 = (r8.matmul(xi_r), r8.t_matmul(xu_r))
    require(all(torch.equal(a_, b_) for a_, b_ in zip(rect_out["dense int8"], plain8)),
            "int8 rectangular products differ from their plain route")
    int8_gap = max(max_abs(a_, b_) / float(b_.abs().max())
                   for a_, b_ in zip(rect_out["dense int8"], ref_r))
    # K11 one direction a call, forward and backward
    rb = rect_adjs["bitpack bfloat16"]
    k11_rect = ((rb.packed, rb.packed_t, rb.right[:, None] * xi_r, nu, rb.plans),
                (rb.packed_t, rb.packed, rb.left[:, None] * xu_r, ni, rb.plans[::-1]))
    for (p_, pt_, z_, n_, plans_), g_ in zip(k11_rect, (cot[:nu], cot[nu:])):
        x_ = z_.clone().requires_grad_(True)
        y_ = bitmm.bit_rect_matmul(p_, pt_, x_, n_, plans_)
        y_.backward(g_.contiguous())
        require(torch.equal(y_, bitmm.bit_matmul(p_, z_, n_, plans_[0]))
                and torch.equal(y_, bitmm.bit_rect_matmul(p_, pt_, z_, n_, plans_)),
                "K11 single direction: differs from the wrapper or across two launches")
        require(torch.equal(x_.grad, bitmm.bit_matmul(pt_, g_.contiguous(), z_.shape[0],
                                                      plans_[1])),
                "K11 single direction's backward differs from K11 on the other packing")
        assert_close(y_.detach(), bitmm.bit_matmul_plain(p_, z_, n_), "K11 single direction",
                     **TIGHT)
        assert_close(x_.grad, bitmm.bit_matmul_plain(pt_, g_.contiguous(), z_.shape[0]),
                     "K11 single direction's backward", **TIGHT)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a_ in rect_adjs.values():
            a_.matmul(xi_r)
            a_.t_matmul(xu_r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"rectangular products: gather within {F32_SUM}, dense bfloat16 within {BF16} of the "
        f"largest entry of dense float32's, bitpack within TIGHT of dense bfloat16's; int8 raw "
        f"sums equal the plain version's, its products its plain route's (relative gap to "
        f"float32 {int8_gap:.3e}); K11's single direction and its backward bit-equal to K11 on "
        f"each packing and within TIGHT of the plain version; every op once under sync debug "
        f"mode \"error\"")
    # ---- the rectangular route on K6 (bfloat16 on dense): each direction
    # one K6 launch with the other side left out, `matmul_both` one launch
    # for both. At d = DIM and 2 DIM (LightGCL's and CVGA's widths): each
    # one-sided launch within TIGHT of its plain version (K6's bar),
    # bit-equal to the same side of the two-sided launch and across two
    # launches; a one-sided call's backward bit-equal to the one-sided
    # launch on the cotangent; the adjacency's two-direction call bit-equal
    # to its two one-direction calls; one of each under sync debug mode
    # "error"; timed (CUDA events) beside the bound, the plain version (the
    # route it replaced, M converted to float32 in row blocks) and
    # torch.matmul on a bfloat16 copy of M, one direction (the copy not
    # counted)
    rb16 = rect_adjs["dense bfloat16"]
    m_r = rb16.m
    nnz_r = data.nnz
    require(m_r.shape[1] % propagate.DENSE_COL_PAD == 0 and rb16.runs_kernel(DIM)
            and rb16.runs_kernel(2 * DIM) and not rect_adjs["dense float32"].runs_kernel(DIM)
            and not r8.runs_kernel(DIM),
            "the rectangular dense route: K6 in bfloat16 only, M's columns padded to "
            "DENSE_COL_PAD")
    gen_r = torch.Generator(device=dev).manual_seed(3)
    rect_k6 = {}
    for d_r in (DIM, 2 * DIM):
        zi_r = torch.randn((ni, d_r), generator=gen_r, device=dev) * rb16.right[:, None]
        zu_r = torch.randn((nu, d_r), generator=gen_r, device=dev) * rb16.left[:, None]
        one_u = fusedmm.fused_adj_matmul(m_r, None, zi_r)
        one_i = fusedmm.fused_adj_matmul(m_r, zu_r, None)
        passes_r = fusedmm.fused_adj_matmul.passes
        require(one_u[1] is None and one_i[0] is None
                and tuple(one_u[0].shape) == (m_r.shape[0], d_r)
                and tuple(one_i[1].shape) == (m_r.shape[1], d_r),
                f"K6 one-sided at d = {d_r}: the absent side's result or the shapes")
        dual_r = fusedmm.fused_adj_matmul(m_r, zu_r, zi_r)
        require(torch.equal(dual_r[0], one_u[0][:nu]) and torch.equal(dual_r[1], one_i[1][:ni]),
                f"K6 at d = {d_r}: a one-sided launch differs from the same side of the "
                "two-sided launch")
        require(torch.equal(fusedmm.fused_adj_matmul(m_r, None, zi_r)[0], one_u[0])
                and torch.equal(fusedmm.fused_adj_matmul(m_r, zu_r, None)[1], one_i[1]),
                f"K6 one-sided at d = {d_r}: two launches differ")
        plain_r = (fusedmm.fused_adj_matmul_plain(m_r, None, zi_r)[0],
                   fusedmm.fused_adj_matmul_plain(m_r, zu_r, None)[1])
        for what, got, want in zip(("M @ zi", "Mᵀ @ zu"), (one_u[0], one_i[1]), plain_r):
            assert_close(got, want, f"K6 one-sided at d = {d_r}, {what}", **TIGHT)
        err_r = max(max_abs(one_u[0], plain_r[0]), max_abs(one_i[1], plain_r[1]))
        x_ = zi_r.clone().requires_grad_(True)
        y_ = fusedmm.fused_adj_matmul(m_r, None, x_)[0]
        g_ = torch.randn(tuple(y_.shape), generator=gen_r, device=dev)
        y_.backward(g_)
        require(x_.grad is not None and tuple(x_.grad.shape) == (ni, d_r)
                and torch.equal(x_.grad, fusedmm.fused_adj_matmul(m_r, g_, None)[1][:ni]),
                f"K6 one-sided at d = {d_r}: the backward differs from the one-sided launch on "
                "the cotangent")
        xi_d = torch.randn((ni, d_r), generator=gen_r, device=dev)
        xu_d = torch.randn((nu, d_r), generator=gen_r, device=dev)
        both_r = rb16.matmul_both(xi_d, xu_d)
        require(torch.equal(both_r[0], rb16.matmul(xi_d))
                and torch.equal(both_r[1], rb16.t_matmul(xu_d)),
                f"DenseRectAdj.matmul_both at d = {d_r} differs from matmul and t_matmul")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rb16.matmul(xi_d)
            rb16.t_matmul(xu_d)
            rb16.matmul_both(xi_d, xu_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        del x_, y_, g_, both_r, plain_r, dual_r, one_u, one_i
        times_r = {
            "users": cuda_ms(lambda: fusedmm.fused_adj_matmul(m_r, None, zi_r), 20),
            "items": cuda_ms(lambda: fusedmm.fused_adj_matmul(m_r, zu_r, None), 20),
            "dual": cuda_ms(lambda: fusedmm.fused_adj_matmul(m_r, zu_r, zi_r), 20),
            "plain_users": cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(m_r, None, zi_r), 3, 1),
            "plain_items": cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(m_r, zu_r, None), 3, 1),
        }
        m_copy = m_r.to(torch.bfloat16)
        z_copy = torch.nn.functional.pad(zi_r, (0, 0, 0, m_r.shape[1] - ni)).to(torch.bfloat16)
        ref_lib = fusedmm.fused_adj_matmul(m_r, None, zi_r)[0][:nu]
        require(max_abs((m_copy @ z_copy)[:nu].float(), ref_lib)
                <= BF16 * float(ref_lib.abs().max()),
                "torch.matmul on the bfloat16 copy of M disagrees with K6")
        del ref_lib
        times_r["library"] = cuda_ms(lambda: m_copy @ z_copy, 10)
        del m_copy, z_copy
        # one direction: M once, its input rows in and its output rows out
        # (float32), 2 operations a non-zero entry and feature; the dual both
        bnd_u = bound(m_r.numel() + 4.0 * d_r * (ni + nu), 2.0 * nnz_r * d_r, bf16_ops)
        bnd_dual = bound(m_r.numel() + 8.0 * d_r * (ni + nu), 4.0 * nnz_r * d_r, bf16_ops)
        rect_k6[d_r] = dict(times=times_r, bound=bnd_u, bound_dual=bnd_dual, err=err_r,
                            passes=passes_r)
        log(f"rectangular K6 at d = {d_r} on M {list(m_r.shape)} ({passes_r} read(s) of M a "
            f"launch): R̃ x_i {times_r['users']:.4f} ms, R̃ᵀ x_u {times_r['items']:.4f} ms a "
            f"direction (bound {bnd_u[0]:.4f} by {bnd_u[1]}; plain {times_r['plain_users']:.4f} "
            f"and {times_r['plain_items']:.4f}; torch.matmul on a bfloat16 copy "
            f"{times_r['library']:.4f}), both in one launch {times_r['dual']:.4f} ms (bound "
            f"{bnd_dual[0]:.4f}); one-sided launches within TIGHT of the plain version (max abs "
            f"err {err_r:.3e}), bit-equal to the two-sided launch's sides and across two "
            f"launches, the backward and matmul_both bit-equal, no sync")
        del zi_r, zu_r, xi_d, xu_d
    torch.cuda.empty_cache()

    # times, each direction beside its bound: the stored matrix read once,
    # the float32 activations in and the float32 rows out, or 2 operations
    # per non-zero entry and feature at the type's peak; library: one call
    # on a copy where none computes the same thing from the stored matrix
    rect_times = {}
    for label, a_ in rect_adjs.items():
        # the matrix one direction reads: M (or the int8 mode's Mᵀ), one
        # packing, or one ordering of the gather graph's arrays
        if isinstance(a_, propagate.DenseRectAdj):
            stored = a_.m.numel()
        elif isinstance(a_, propagate.BitRectAdj):
            stored = a_.packed.numel()
        else:
            stored = sum(t_.numel() * t_.element_size() for t_ in (
                a_.graph.rows, a_.graph.cols, a_.graph.vals, a_.graph.row_counts))
        peak = (F32_OPS if label in ("dense float32", "gather float32")
                else int8_ops if label == "dense int8" else bf16_ops)
        bnd_r = bound(stored + 4.0 * (nu + ni) * d, 2.0 * nnz_r * d, peak)
        fwd = cuda_ms(lambda a_=a_: a_.matmul(xi_r), 10)
        trn = cuda_ms(lambda a_=a_: a_.t_matmul(xu_r), 10)
        rect_times[label] = (fwd, trn, bnd_r, stored)
    # library yardsticks, one direction each
    q_cols = [q_.T.contiguous().T for q_, _ in q_r]
    lib_r = {"dense int8": cuda_ms(lambda: (torch._int_mm(r8.m, q_cols[0]),
                                            torch._int_mm(r8.m_t, q_cols[1])), 10) / 2}
    csr = torch.sparse_csr_tensor(*(t_.to(dev) for t_ in (
        torch.from_numpy(data.row_ptr.astype(np.int64)),
        torch.from_numpy(data.col_idx.astype(np.int64)))),
        rect_adjs["gather float32"].graph.vals[: nnz_r].contiguous(), size=(nu, ni))
    require(max_abs(torch.sparse.mm(csr, xi_r), ref_r[0]) <= F32_SUM * float(ref_r[0].abs().max()),
            "torch.sparse.mm on R̃ disagrees with dense float32")
    lib_r["gather float32"] = cuda_ms(lambda: torch.sparse.mm(csr, xi_r), 10)
    del csr
    zf = torch.nn.functional.pad(zs_r[0], (0, 0, 0, r8.m.shape[1] - ni))
    for label, dt_ in (("dense float32", torch.float32), ("dense bfloat16", torch.bfloat16)):
        m_copy, z_copy = r8.m.to(dt_), zf.to(dt_)
        lib_r[label] = cuda_ms(lambda: m_copy @ z_copy, 10)
        del m_copy, z_copy
    m_copy = bitmm.unpack_rows(rb.packed).to(torch.bfloat16)
    z_copy = torch.nn.functional.pad(zs_r[0], (0, 0, 0, rb.packed.shape[1] - ni)).to(torch.bfloat16)
    lib_r["bitpack bfloat16"] = cuda_ms(lambda: m_copy @ z_copy, 10)
    del m_copy, z_copy, zf, q_cols
    for label, (fwd, trn, bnd_r, stored) in rect_times.items():
        log(f"rectangular {label}: R̃ x_i {fwd:.4f} ms, R̃ᵀ x_u {trn:.4f} ms (bound "
            f"{bnd_r[0]:.4f} ms a direction by {bnd_r[1]}, {stored / 1e6:.1f} MB of stored "
            f"matrix; library {lib_r[label]:.4f} ms a direction)")
    del rect_adjs, rect_out, ref_r, plain8, raw_r, q_r, zs_r, r8, rb, k11_rect
    torch.cuda.empty_cache()

    # ==== EGCF, mode = alternating: int8 on dense (the int8 products and K4 in
    # the backward) and bfloat16 on bitpack (K11 one direction a call)
    cfg_alt = cfg_e.updated(mode="alternating")
    alt8 = fresh_egcf(cfg_alt)
    require(not hasattr(alt8, "graph") and isinstance(alt8.user_graph, propagate.DenseRectAdj)
            and alt8.user_graph.quant == "int8" and alt8.user_graph.m_t is not None,
            "EGCF alternating int8: the rectangular int8 dense adjacency")
    reset_counts()
    rec_alt = Recommender(alt8, data)
    answers_alt = [rec_alt.recommend(users, k=K) for users in requests]
    alt_serve_launches = read_counts()
    require(all(n == 0 for n in alt_serve_launches.values()),
            f"EGCF alternating int8 serving runs no kernel of the port: {alt_serve_launches}")
    with plain_rect(propagate, bitmm, chainmm, scatter):
        ref_rec_alt = Recommender(alt8, data)
    for users, (items, scores) in zip(requests, answers_alt):
        check_answers(ref_rec_alt, data, users, items, scores)
    alt_embed_ms = host_ms(alt8.eval_embeddings, 5)
    del ref_rec_alt

    def step_against_plain(m, label):
        """One step against the plain route at tests/test_torch_egcf.py's
        bars: loss terms within rtol 1e-5, the gradient within NOISE of its
        largest entry and a relative L2 error below 1e-2."""
        got_s = egcf_step(m)
        with plain_rect(propagate, bitmm, chainmm, scatter):
            want_s = egcf_step(m)
        for what, a, b in zip(("bpr", "reg", "ssl"), got_s[1:], want_s[1:]):
            assert_close(a, b, f"{label} step, {what}", rtol=1e-5, atol=0.0)
        top = float(want_s[0].abs().max())
        assert_close(got_s[0] / top, want_s[0] / top, f"{label} step, d item_emb", rtol=2e-2,
                     atol=1e-2)
        rel = float((got_s[0] - want_s[0]).norm() / want_s[0].norm())
        require(rel < 1e-2, f"{label} step, d item_emb: relative L2 error {rel}")
        return all(torch.equal(a, b) for a, b in zip(got_s, want_s)), got_s

    same_a, got_a = step_against_plain(alt8, "EGCF alternating int8")
    log(f"EGCF alternating int8: {len(requests)} requests checked against the plain path; one "
        f"step's loss terms and item gradient against the plain route (bit-equal: {same_a}; bpr "
        f"{float(got_a[1]):.6f}, ssl {float(got_a[3]):.6f}); eval embeddings {alt_embed_ms:.3f} "
        "ms")
    runner_a = EpochRunner(alt8, lr_e, BATCH, data.num_train)
    reset_counts()
    a_epoch_ms, a_terms = [], []
    for epoch in range(EPOCHS):
        triple_a = neg_sampler.sample_epoch(gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a_terms.append(runner_a.run_epoch(*triple_a, generator=gen, epoch=epoch).cpu().numpy())
        a_epoch_ms.append((time.perf_counter() - t0) * 1e3)
    result_a = Evaluator(alt8, data, cfg_alt).evaluate()
    alt_train_launches = read_counts()
    log(f"EGCF alternating int8 training path launches: {alt_train_launches}")
    require(alt_train_launches["scatter_add_rows"] == 2 * n_e
            and all(n == 0 for name_, n in alt_train_launches.items()
                    if name_ != "scatter_add_rows"),
            f"EGCF alternating int8: expected {2 * n_e} K4 launches and nothing else")
    # at EGCF's published learn_rate and SSL weights, on this data the BPR
    # sum of the alternating mode rises over the first epochs while the
    # summed loss falls, in the JAX package as in the port
    # (tests/test_torch_rect.py::test_alternating_bpr_rises_while_the_loss_
    # falls_in_both_packages): the objective is held to falling
    require(all(t_.shape == (3,) and bool(np.isfinite(t_).all()) for t_ in a_terms)
            and a_terms[0][0] < steps * np.log(2.0) and a_terms[1].sum() < a_terms[0].sum(),
            f"EGCF alternating int8: the summed loss did not fall: {a_terms}")
    require(bool(np.isfinite(result_a["recall"]).all()), f"EGCF alternating recall {result_a}")
    alt_step_ms = float(np.mean(a_epoch_ms)) / steps
    log(f"EGCF alternating int8: loss sums {a_terms[0].sum():.4f} then {a_terms[1].sum():.4f} "
        f"(BPR {a_terms[0][0]:.4f} then {a_terms[1][0]:.4f}, ssl {a_terms[0][2]:.4f} then "
        f"{a_terms[1][2]:.4f}); "
        f"{alt_step_ms:.3f} ms per step beside the parallel mode's {egcf_step_ms:.3f} (this run); "
        f"recall@{cfg_e.int_list('top_K')} {np.round(result_a['recall'], 5).tolist()}")
    del rec_alt, runner_a, triple_a, alt8
    torch.cuda.empty_cache()

    cfg_alt_bp = cfg_alt.updated(compute_dtype="bfloat16", propagation_backend="bitpack")
    alt_bp = fresh_egcf(cfg_alt_bp)
    require(isinstance(alt_bp.user_graph, propagate.BitRectAdj), "EGCF alternating bitpack")
    ref_gather_a = Recommender(fresh_egcf(cfg_alt.updated(compute_dtype="float32",
                                                          propagation_backend="gather")), data)
    reset_counts()
    rec_a_bp = Recommender(alt_bp, data)
    answers_a_bp = [rec_a_bp.recommend(users, k=K) for users in requests]
    runner_ = EpochRunner(alt_bp, lr_e, BATCH, OTHER_STEPS * BATCH)
    part = [t_[: OTHER_STEPS * BATCH] for t_ in triple]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp_a_terms = runner_.run_epoch(*part, generator=gen, epoch=0).cpu().numpy()
    alt_bp_step_ms = (time.perf_counter() - t0) * 1e3 / OTHER_STEPS
    alt_bp_launches = read_counts()
    # the serving chain 2 a layer, a step 4 a layer (each direction's
    # backward one launch on the other packing)
    want_k11_a = 2 * LAYERS * (1 + 2 * OTHER_STEPS)
    require(alt_bp_launches["bit_matmul"] == want_k11_a
            and all(n == 0 for name_, n in alt_bp_launches.items() if name_ != "bit_matmul"),
            f"EGCF alternating bitpack: expected {want_k11_a} K11 launches and nothing else: "
            f"{alt_bp_launches}")
    ref_u, ref_i = ref_gather_a._repr
    top_logit_a = max(float((ref_u[torch.from_numpy(u_).to(dev)] @ ref_i.T).abs().max())
                      for u_ in requests)
    alt_bp_tol = BF16 * top_logit_a / 4.0
    for users, (items, scores) in zip(requests, answers_a_bp):
        check_answers_close(ref_gather_a, data, users, items, scores, alt_bp_tol)
    require(bool(np.isfinite(bp_a_terms).all()) and bp_a_terms[0] < OTHER_STEPS * np.log(2.0),
            f"EGCF alternating bitpack loss terms {bp_a_terms}")
    same_bp, _ = step_against_plain(alt_bp, "EGCF alternating bitpack")
    log(f"EGCF alternating bitpack bfloat16: served {len(requests)} requests within "
        f"{alt_bp_tol:.3e} of the float32 gather EGCF; one step against the plain route "
        f"(bit-equal: {same_bp}); {alt_bp_step_ms:.3f} ms per step over {OTHER_STEPS} steps")
    del alt_bp, ref_gather_a, rec_a_bp, runner_
    torch.cuda.empty_cache()

    # EGCF alternating in bfloat16 on dense: each direction of each layer one
    # K6 launch with the other side left out, forward and backward; one step
    # against the same step on K6's plain version (the route it replaced) at
    # K6's rules, one step under sync debug mode "error"
    alt_bf = fresh_egcf(cfg_alt.updated(compute_dtype="bfloat16", propagation_backend="dense"))
    require(isinstance(alt_bf.user_graph, propagate.DenseRectAdj)
            and alt_bf.user_graph.runs_kernel(DIM), "EGCF alternating bfloat16: dense on K6")
    reset_counts()
    got_ab = egcf_step(alt_bf)
    alt_bf_launches = read_counts()
    want_k6_ab = 4 * LAYERS  # a layer's two directions, forward and backward
    require(alt_bf_launches["fused_adj_matmul"] == want_k6_ab
            and all(n == 0 for name_, n in alt_bf_launches.items() if name_ != "fused_adj_matmul"),
            f"EGCF alternating bfloat16: expected {want_k6_ab} K6 launches and nothing else: "
            f"{alt_bf_launches}")
    with plain_duals(fusedmm, propagate):
        want_ab = egcf_step(alt_bf)
    for what, a, b in zip(("bpr", "reg", "ssl"), got_ab[1:], want_ab[1:]):
        require(bool(torch.isfinite(a)), f"EGCF alternating bfloat16 step, {what}: not finite")
        assert_close(a, b, f"EGCF alternating bfloat16 step, {what}", **TIGHT)
    top = float(want_ab[0].abs().max())
    require(bool(torch.isfinite(got_ab[0]).all()) and max_abs(got_ab[0], want_ab[0]) <= BF16 * top,
            f"EGCF alternating bfloat16 step, d item_emb: max abs err "
            f"{max_abs(got_ab[0], want_ab[0])} above {BF16} of {top}")
    ab_err = max_abs(got_ab[0], want_ab[0]) / top
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        egcf_step(alt_bf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    alt_bf_step_ms = host_ms(lambda: egcf_step(alt_bf), 5)
    log(f"EGCF alternating bfloat16 on dense: {want_k6_ab} K6 launches a step (one a direction, "
        f"forward and backward); one step against the plain route (loss terms within TIGHT, "
        f"item gradient within {ab_err:.3e} of its largest entry), one under sync debug mode "
        f"\"error\"; {alt_bf_step_ms:.3f} ms a step (host clock, the gradient's copy included)")
    del alt_bf, got_ab, want_ab
    torch.cuda.empty_cache()

    # ==== the zoo: MFBPR, the encoder-switch family, NOISE_ZOO and
    # CONTRAST_ZOO at their published configs on the datasets they name
    # (LightCCF, LightCSCF and MixRec on an amazon-book-scale set); under the
    # LightGCN encoder and in NOISE_ZOO and CONTRAST_ZOO every product is K6
    # on the dense matrix, one launch a layer each way (LightGCN_pp's on the
    # `gen` scaling, SimGCL's in training and IMPGCN's groups at d = 192;
    # IMPGCN's Â·E, which feeds only its gates, forward alone). Each model:
    # one step held to the same step on K6's plain version with the same
    # noise (loss terms within TIGHT, gradients within BF16 of the largest
    # entry: K6's rules), one step under sync debug mode "error", a server
    # answering ZOO_REQUEST users held to the plain route's (the same eval
    # generator: seeded 0), ZOO_STEPS steps. NCL runs past its warm-up: its
    # k-means (KMEANS_ITERS iterations a table, the sums on K4) under sync
    # debug mode "error", held to the same clustering with K4's plain version
    # bit for bit and timed, then its steps at epoch = warmup_epochs with the
    # prototype term; the 24 steps' path runs the epoch's clustering first,
    # as the training loop does.
    t0 = time.perf_counter()
    amazon = make_synthetic_dataset(*AMAZON, seed=0, name="amazon-book-scale")
    log(f"amazon-book-scale dataset {amazon.num_users} users x {amazon.num_items} items, "
        f"{amazon.num_train} train, {amazon.num_test} test, built in "
        f"{time.perf_counter() - t0:.1f} s")
    zoo_sets = {"yelp2018": (data, neg_sampler),
                "amazon-book": (amazon, sampler_lib.NegativeSampler(amazon, device=dev))}
    zoo_rng = np.random.default_rng(5)
    zoo_res, zoo_launches, zoo_calls, zoo_models = {}, {}, {}, {}
    for name_z in ZOO:
        cfg_z = load_model_config(name_z)
        data_z, sampler_z = zoo_sets[cfg_z.str("dataset")]
        cfg_z = cfg_z.updated(dataset=data_z.name)
        lgcn = (cfg_z.str("encoder", "MF") == "LightGCN"
                or (name_z in PROPAGATING and cfg_z.str("train_strategy", "") != "MF"))
        dim_z = ZOO_DIMS.get(name_z, DIM)
        if name_z == "LightGODE":
            layers_z = 1  # one Euler step: one application
        elif name_z in WEIGHTED_ZOO + STATE_ZOO:
            layers_z = cfg_z.int("GCN_layer")
        else:
            layers_z = ZOO_LAYERS.get(name_z, LAYERS)
        published_z = (cfg_z.int("embedding_size") == dim_z
                       and cfg_z.str("compute_dtype") == "bfloat16"
                       and cfg_z.str("propagation_backend") == "auto")
        if name_z == "LightGODE":
            published_z = published_z and cfg_z.str("train_strategy") == "MF_init"
        elif lgcn:
            published_z = published_z and cfg_z.int("GCN_layer") == layers_z
        if name_z in WEIGHTED_ZOO:
            published_z = (published_z and not cfg_z.bool("node_dropout", False)
                           and cfg_z.int_list("layer_size")[:layers_z] == [dim_z] * layers_z)
        require(published_z, f"{name_z}: not the published config the phase expects")
        step_k6_z, repr_k6_z = zoo_k6_launches(name_z, lgcn, layers_z)
        no_grad_z = NO_GRAD.get(name_z, ())
        # NCL past its warm-up: the epoch its steps take
        epoch_z = cfg_z.int("warmup_epochs") if name_z == "NCL" else 0
        bs, lr_z = cfg_z.int("batch_size"), cfg_z.float("learn_rate")
        t0 = time.perf_counter()
        m_z = get_model(name_z)(cfg_z, data_z, device=dev,
                                generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        start_z = {k_: getattr(m_z, k_).detach().clone() for k_ in no_grad_z}
        k6_bound_z = None
        if lgcn:
            g_z = m_z.graph
            # a step's applications: SimGCL's three chains and IMPGCN's three
            # groups run at 3d
            d_step = 3 * dim_z if name_z in ("SimGCL", "IMPGCN") else dim_z
            require(isinstance(g_z, propagate.DenseSquareAdj) and g_z.quant == "none"
                    and g_z.compute_dtype_name == "bfloat16" and g_z.runs_kernel(dim_z)
                    and g_z.runs_kernel(d_step),
                    f"{name_z}: the model's adjacency is not dense bfloat16 on K6")
            nnz_z = int(data_z.nnz)  # M's non-zero entries: the distinct train pairs
            nu_z, ni_z = data_z.num_users, data_z.num_items
            # M read once, the float32 activations in and the sums out once
            k6_bound_z = bound(g_z.m.numel() + 8 * dim_z * (nu_z + ni_z), 4.0 * nnz_z * dim_z,
                               bf16_ops)
            k6_step_bound_z = bound(g_z.m.numel() + 8 * d_step * (nu_z + ni_z),
                                    4.0 * nnz_z * d_step, bf16_ops)
        if name_z == "LightGCN_pp":
            # a node with no train edge is a zero row after layer 1, where the
            # JAX package's norm has a NaN gradient: the port's must be finite
            no_edge_z = data_z.num_items - len(np.unique(data_z.col_idx))
            require(no_edge_z > 0, "LightGCN_pp: the set has no item without a train edge")
        triple_z = sampler_z.sample_epoch(gen)
        batch_z = dict(zip(("user", "pos", "neg"), (t_[:bs] for t_ in triple_z)))
        kmeans_ms_z = None
        if name_z == "NCL":
            # the epoch's clustering past the warm-up, on K4, under sync debug
            # mode "error"; then the same from the same seed on K4's plain
            # version, bit for bit; then timed
            k4_before = scatter.scatter_add_rows.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                m_z.epoch_context(epoch_z, np.random.default_rng(ZOO_NOISE_SEED))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            clusters_z = (m_z.user_centroids, m_z.user_2cluster, m_z.item_centroids,
                          m_z.item_2cluster)
            require(scatter.scatter_add_rows.launches - k4_before == 2 * KMEANS_ITERS,
                    f"NCL's k-means: {scatter.scatter_add_rows.launches - k4_before} K4 "
                    f"launches, {2 * KMEANS_ITERS} expected")
            with plain_kernels(chainmm, scatter):
                m_z.epoch_context(epoch_z, np.random.default_rng(ZOO_NOISE_SEED))
            plain_clusters_z = (m_z.user_centroids, m_z.user_2cluster, m_z.item_centroids,
                                m_z.item_2cluster)
            for what, a, b in zip(("user centroids", "user assignment", "item centroids",
                                   "item assignment"), clusters_z, plain_clusters_z):
                require(torch.equal(a, b), f"NCL's k-means on K4, {what}: differs from K4's "
                                           "plain version")
            used_z = [int(torch.unique(a_).numel()) for a_ in clusters_z[1::2]]
            require(min(used_z) > m_z.k // 2, f"NCL's k-means: clusters used {used_z}")
            kmeans_ms_z = host_ms(
                lambda: m_z.epoch_context(epoch_z, np.random.default_rng(ZOO_NOISE_SEED)), 3)

        # RecDCL's histories: each route's step starts from the same ones
        state0_z = {k_: v_.clone() for k_, v_ in m_z.model_state().items()}

        def zoo_step(m_, b_=batch_z):
            # a fresh generator a call: the kernel step and the plain one draw
            # the same noise
            gen_ = torch.Generator(device=dev).manual_seed(ZOO_NOISE_SEED)
            m_.load_model_state(state0_z)
            m_.zero_grad(set_to_none=True)
            terms_ = m_.loss_terms(b_, gen_, epoch_z)
            total_ = terms_[0]
            for t_ in terms_[1:]:
                total_ = total_ + t_
            total_.backward()
            grads_ = [None if getattr(m_, k_).grad is None else getattr(m_, k_).grad.clone()
                      for k_ in convert.table_names(m_)]
            m_.zero_grad(set_to_none=True)
            return [t_.detach() for t_ in terms_], grads_

        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got_z = zoo_step(m_z)
        torch.cuda.synchronize()
        step_mem = torch.cuda.max_memory_allocated() - mem0
        hist_z = [v_.clone() for v_ in m_z.model_state().values()]
        with plain_duals(fusedmm, propagate):
            want_z = zoo_step(m_z)
        for what, a, b in zip(m_z.loss_names, got_z[0], want_z[0]):
            require(bool(torch.isfinite(a)), f"{name_z} step, {what}: not finite")
            assert_close(a, b, f"{name_z} step, {what}", **TIGHT)
        for what, a, b in zip(m_z.state_names, hist_z, m_z.model_state().values()):
            # the batch's final embeddings written into the histories
            require(bool(torch.isfinite(a).all()), f"{name_z} step, {what}: not finite")
            assert_close(a, b, f"{name_z} step, {what}", **TIGHT)
        require(m_z.state_names == () or not all(torch.equal(a, b) for a, b in zip(
            hist_z, state0_z.values())), f"{name_z}: the step left its state as it was")
        del hist_z, state0_z
        for what, a, b in zip(convert.table_names(m_z), got_z[1], want_z[1]):
            if what in no_grad_z:
                require(a is None and b is None, f"{name_z} step, d {what}: a gradient")
                continue
            top = float(b.abs().max())
            require(bool(torch.isfinite(a).all()) and max_abs(a, b) <= BF16 * top,
                    f"{name_z} step, d {what}: max abs err {max_abs(a, b)} above {BF16} of {top}")
        if name_z == "NCL":
            require(float(got_z[0][3]) > 0, f"NCL step past the warm-up: proto {got_z[0][3]}")
        same_z = all(a is b or torch.equal(a, b) for a, b in zip(got_z[0] + got_z[1],
                                                                 want_z[0] + want_z[1]))
        require(lgcn or same_z, f"{name_z} under MF: the plain route is the same route")
        mem_bar_z, wide_z, narrow_mem_z = None, {}, None
        if lgcn:
            # no float32 (or bfloat16) copy of M: the step's extra memory stays
            # below M's own int8 bytes, plus, for the contrasts against a full
            # table, the score matrices the step keeps for its backward, and at
            # RecDCL's width the K6 launch's scratch and output and the float32
            # [N, d] tensors the step keeps
            kept_z = kept_score_bytes(name_z, bs, data_z.num_users, data_z.num_items)
            if name_z == "RecDCL":
                wide_z = wide_step_bytes(g_z, layers_z, dim_z)
            mem_bar_z = g_z.m.numel() + kept_z + sum(wide_z.values())
            require(step_mem < mem_bar_z,
                    f"{name_z}: a step took {step_mem} bytes beyond the model's, above M's "
                    f"{g_z.m.numel()}, the {kept_z} bytes of kept score matrices and the "
                    f"wide step's {wide_z}")
        if wide_z and mem_bar_z >= 2 * g_z.m.numel():
            # the wide bar cannot rule out a bfloat16 copy of M (2 bytes an
            # entry): one step of the same model at d = DIM under M's bytes
            narrow = get_model(name_z)(cfg_z.updated(embedding_size=DIM), data_z, device=dev,
                                       generator=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            terms_n = narrow.loss_terms(batch_z, None, epoch_z)
            sum(terms_n).backward()
            torch.cuda.synchronize()
            narrow_mem_z = torch.cuda.max_memory_allocated() - mem0
            require(all(bool(torch.isfinite(t_.detach())) for t_ in terms_n)
                    and narrow_mem_z < narrow.graph.m.numel(),
                    f"{name_z} at d = {DIM}: a step took {narrow_mem_z} bytes beyond the "
                    f"model's, above M's {narrow.graph.m.numel()} (terms {terms_n})")
            del narrow, terms_n
        del got_z, want_z
        # one step under sync debug mode "error" (the optimizer's state is made
        # by the step before it)
        runner_z = EpochRunner(m_z, lr_z, bs, ZOO_STEPS * bs)
        one_z = EpochRunner(m_z, lr_z, bs, bs, optimizer=runner_z.opt)
        part_one = [t_[bs: 2 * bs] for t_ in triple_z]
        gen_one = torch.Generator(device=dev).manual_seed(ZOO_NOISE_SEED)
        one_z.run_epoch(*part_one, generator=gen_one, epoch=epoch_z)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            nosync_z = one_z.run_epoch(*part_one, generator=gen_one, epoch=epoch_z)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(bool(torch.isfinite(nosync_z).all()), f"{name_z}: the sync-debug step {nosync_z}")
        # the server, one request, ZOO_STEPS steps
        users_z = zoo_rng.choice(data_z.num_users, size=ZOO_REQUEST, replace=False)
        reset_counts()
        t0 = time.perf_counter()
        rec_z = Recommender(m_z, data_z)
        torch.cuda.synchronize()
        embed_first_ms = (time.perf_counter() - t0) * 1e3
        items_z, scores_z = rec_z.recommend(users_z, k=K)
        with plain_duals(fusedmm, propagate):
            ref_z = Recommender(m_z, data_z)
        if lgcn:
            check_answers_close(ref_z, data_z, users_z, items_z, scores_z, TIE)
        else:
            check_answers(ref_z, data_z, users_z, items_z, scores_z)
        del rec_z, ref_z
        part_z = [t_[2 * bs: (2 + ZOO_STEPS) * bs] for t_ in triple_z]
        if name_z == "NCL":
            # the epoch's clustering before its steps, as the training loop runs it
            m_z.epoch_context(epoch_z, np.random.default_rng(ZOO_NOISE_SEED + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms_z = runner_z.run_epoch(*part_z, generator=gen, epoch=epoch_z).cpu().numpy()
        step_ms_z = (time.perf_counter() - t0) * 1e3 / ZOO_STEPS
        zoo_launches[name_z] = read_counts()
        want_l = ({"fused_adj_matmul": repr_k6_z + ZOO_STEPS * step_k6_z} if lgcn else {})
        if name_z == "NCL":
            want_l["scatter_add_rows"] = 2 * KMEANS_ITERS
        got_l = {k_: n for k_, n in zoo_launches[name_z].items() if n}
        require(got_l == want_l, f"{name_z}: launches {got_l}, expected {want_l}")
        require(terms_z.shape == (len(m_z.loss_names),) and bool(np.isfinite(terms_z).all()),
                f"{name_z}: loss terms {terms_z}")
        require(name_z != "NCL" or terms_z[-1] > 0, f"{name_z}'s 24 steps: proto sum "
                                                     f"{terms_z[-1]}")
        # the last step's gradients (the runner sets them to None before a step)
        # and the tables it left; the tables that take no gradient never moved
        require(all(bool(torch.isfinite(p_.grad).all()) and bool(torch.isfinite(p_).all())
                    for p_ in m_z.parameters() if p_.grad is not None)
                and all((p_.grad is None) == (k_ in no_grad_z)
                        for k_, p_ in m_z.named_parameters()),
                f"{name_z}: a gradient or a table of the last step is not finite, or a "
                "gradient is missing or present where it should not be")
        require(all(torch.equal(getattr(m_z, k_), v_) for k_, v_ in start_z.items()),
                f"{name_z}: a table without a gradient moved")
        gen_eval = torch.Generator(device=dev).manual_seed(0)
        embed_ms_z = host_ms(lambda: m_z.eval_embeddings(gen_eval), 5)
        zoo_calls[name_z] = lambda r_=one_z, p_=part_one, g_=gen_one, e_=epoch_z: r_.run_epoch(
            *p_, generator=g_, epoch=e_)
        zoo_models[name_z] = m_z
        zoo_res[name_z] = dict(step_ms=step_ms_z, embed_ms=embed_ms_z, k6_bound=k6_bound_z,
                               step_mem_mb=step_mem / 1e6,
                               mem_bar_mb=None if mem_bar_z is None else mem_bar_z / 1e6,
                               kmeans_ms=kmeans_ms_z,
                               narrow_mem_mb=None if narrow_mem_z is None else narrow_mem_z / 1e6)
        enc_z = (f"{cfg_z.str('encoder', 'MF')} encoder" if name_z not in PROPAGATING
                 else f"dense K6 propagation at d = {dim_z}, {layers_z} "
                      f"application{'s' if layers_z > 1 else ''} a pass")
        log(f"{name_z} ({enc_z}, batch {bs}, on {data_z.name}): one "
            f"step against the plain route (bit-equal: {same_z}), one under sync debug mode "
            f"'error', {ZOO_REQUEST} users served against the plain route; {step_ms_z:.3f} ms "
            f"per step over {ZOO_STEPS} steps, eval embeddings {embed_ms_z:.3f} ms (first "
            f"{embed_first_ms:.3f}), K6 launches {got_l.get('fused_adj_matmul', 0)}"
            + (f", K6's bound {k6_bound_z[0]:.4f} ms an application by {k6_bound_z[1]} "
               f"({step_k6_z} a step, {repr_k6_z} a representation"
               + (f", at d = {d_step}: {k6_step_bound_z[0]:.4f} ms" if d_step != dim_z else "")
               + ")" if lgcn else ", no propagation")
            + (f"; {no_edge_z} item(s) without a train edge, the gradients finite"
               if name_z == "LightGCN_pp" else "")
            + (f"; k-means past the warm-up (k = {m_z.k}, {KMEANS_ITERS} iterations a table, "
               f"K4 x {2 * KMEANS_ITERS}, equal to K4's plain version, no sync) "
               f"{kmeans_ms_z:.3f} ms an epoch; steps at epoch {epoch_z}"
               if name_z == "NCL" else "")
            + (f"; {', '.join(no_grad_z)} without a gradient, unmoved" if no_grad_z else "")
            + f"; a step's memory beyond the model's {step_mem / 1e6:.1f} MB"
            + (f" (bar {mem_bar_z / 1e6:.1f} MB: M's bytes"
               + (" and the kept score matrices" if kept_z else "")
               + "".join(f", {k_} {v_ / 1e6:.1f} MB" for k_, v_ in wide_z.items()) + ")"
               if mem_bar_z is not None else "")
            + (f"; at d = {DIM} a step's memory {narrow_mem_z / 1e6:.1f} MB, below M's bytes"
               if narrow_mem_z is not None else "")
            + "; loss sums "
            f"{dict(zip(m_z.loss_names, np.round(terms_z, 5).tolist()))}; built in {build_s:.1f} s")
        del runner_z, triple_z, batch_z
        torch.cuda.empty_cache()
    # ==== the rectangular models at their published configs on the
    # yelp2018-scale set: LightGCL (2 layers, its SVD branch taken on the
    # host when the model is built; both directions of a layer one K6
    # launch, `DenseRectAdj.matmul_both`) and CVGA (user-row batches, its
    # encoder R̃ @ q_w one K6 launch at 2 DIM with the user side left out).
    # Each: one step against the same step on K6's plain version with the
    # same noise (K6's rules), one step under sync debug mode "error", the
    # step's memory under a bar built from the shapes (no float copy of M),
    # its own K6 launches a step and a representation, ZOO_STEPS steps, eval
    # embeddings timed, a request of ZOO_REQUEST users held to the plain
    # route's server (CVGA's representation the dict of z and its decoder);
    # then CVGA trains one epoch through `train_model` (the user-row path,
    # a permutation of the users from the run's generator) and serves from
    # its result
    rect_paths = {}
    for name_z in RECT_ZOO:
        cfg_z = load_model_config(name_z).updated(dataset=data.name)
        dim_z = cfg_z.int("embedding_size")
        require(dim_z == DIM and cfg_z.str("compute_dtype") == "bfloat16"
                and cfg_z.str("propagation_backend") == "auto"
                and (name_z != "LightGCL" or cfg_z.int("GCN_layer") == RECT_LAYERS),
                f"{name_z}: not the published config the phase expects")
        bs, lr_z = cfg_z.int("batch_size"), cfg_z.float("learn_rate")
        t0 = time.perf_counter()
        m_z = get_model(name_z)(cfg_z, data, device=dev, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        g_z = m_z.graph
        d_k6 = 2 * dim_z if name_z == "CVGA" else dim_z  # CVGA's encoder: [μ, log σ²]
        require(isinstance(g_z, propagate.DenseRectAdj) and g_z.quant == "none"
                and g_z.compute_dtype_name == "bfloat16" and g_z.runs_kernel(d_k6)
                and g_z.m.shape[1] % propagate.DENSE_COL_PAD == 0,
                f"{name_z}: the model's adjacency is not the rectangular dense route on K6")
        # a step: LightGCL one launch a layer each way, CVGA its encoder each
        # way; a representation: the forward alone
        step_k6_z, repr_k6_z = (2 * RECT_LAYERS, RECT_LAYERS) if name_z == "LightGCL" else (2, 1)
        if name_z == "CVGA":
            perm_z = noise.permutation(nu, gen)
            triple_z = (perm_z, perm_z, perm_z)
        else:
            triple_z = neg_sampler.sample_epoch(gen)
        batch_z = dict(zip(("user", "pos", "neg"), (t_[:bs] for t_ in triple_z)))

        def rect_step(m_, b_=batch_z):
            gen_ = torch.Generator(device=dev).manual_seed(ZOO_NOISE_SEED)
            m_.zero_grad(set_to_none=True)
            terms_ = m_.loss_terms(b_, gen_, 0)
            sum(terms_).backward()
            grads_ = [getattr(m_, k_).grad.clone() for k_ in convert.table_names(m_)]
            m_.zero_grad(set_to_none=True)
            return [t_.detach() for t_ in terms_], grads_

        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        got_z = rect_step(m_z)
        one_step_launches = read_counts()
        step_mem = torch.cuda.max_memory_allocated() - mem0
        require(one_step_launches["fused_adj_matmul"] == step_k6_z,
                f"{name_z}: {one_step_launches['fused_adj_matmul']} K6 launches a step, "
                f"{step_k6_z} expected")
        with plain_duals(fusedmm, propagate):
            want_z = rect_step(m_z)
        for what, a, b in zip(m_z.loss_names, got_z[0], want_z[0]):
            require(bool(torch.isfinite(a)), f"{name_z} step, {what}: not finite")
            assert_close(a, b, f"{name_z} step, {what}", **TIGHT)
        grad_err_z = 0.0
        for what, a, b in zip(convert.table_names(m_z), got_z[1], want_z[1]):
            top = float(b.abs().max())
            require(bool(torch.isfinite(a).all()) and max_abs(a, b) <= BF16 * top,
                    f"{name_z} step, d {what}: max abs err {max_abs(a, b)} above {BF16} of {top}")
            grad_err_z = max(grad_err_z, max_abs(a, b) / top)
        del got_z, want_z
        # no float copy of M: M's own bytes, plus what the step keeps from its
        # shapes: LightGCL the float32 [B, U] and [B, I] scores of its
        # contrast against the full tables, CVGA six float32 [B, I] rows
        # (the decoder's output, its log-softmax, the targets, their
        # product and two gradients)
        kept_z = (4 * bs * (nu + ni) if name_z == "LightGCL" else 6 * 4 * bs * ni)
        mem_bar_z = g_z.m.numel() + kept_z
        require(step_mem < mem_bar_z and mem_bar_z < 2 * g_z.m.numel(),
                f"{name_z}: a step took {step_mem} bytes beyond the model's, above the bar "
                f"{mem_bar_z} (M's {g_z.m.numel()} and {kept_z} kept), or the bar does not rule "
                "out a bfloat16 copy of M")
        runner_z = EpochRunner(m_z, lr_z, bs, ZOO_STEPS * bs)
        one_z = EpochRunner(m_z, lr_z, bs, bs, optimizer=runner_z.opt)
        part_one = [t_[bs: 2 * bs] for t_ in triple_z]
        gen_one = torch.Generator(device=dev).manual_seed(ZOO_NOISE_SEED)
        one_z.run_epoch(*part_one, generator=gen_one)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            nosync_z = one_z.run_epoch(*part_one, generator=gen_one)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(bool(torch.isfinite(nosync_z).all()), f"{name_z}: the sync-debug step {nosync_z}")
        users_z = zoo_rng.choice(nu, size=ZOO_REQUEST, replace=False)
        reset_counts()
        t0 = time.perf_counter()
        rec_z = Recommender(m_z, data)
        torch.cuda.synchronize()
        embed_first_ms = (time.perf_counter() - t0) * 1e3
        items_z, scores_z = rec_z.recommend(users_z, k=K)
        with plain_duals(fusedmm, propagate):
            ref_z = Recommender(m_z, data)
        check_answers_close(ref_z, data, users_z, items_z, scores_z, TIE)
        require(isinstance(rec_z._repr, dict) == (name_z == "CVGA"),
                f"{name_z}: the representation's form")
        del rec_z, ref_z
        part_z = [t_[2 * bs: (2 + ZOO_STEPS) * bs] for t_ in triple_z]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        terms_z = runner_z.run_epoch(*part_z, generator=gen).cpu().numpy()
        step_ms_z = (time.perf_counter() - t0) * 1e3 / ZOO_STEPS
        zoo_launches[name_z] = read_counts()
        want_l = {"fused_adj_matmul": repr_k6_z + ZOO_STEPS * step_k6_z}
        got_l = {k_: n for k_, n in zoo_launches[name_z].items() if n}
        require(got_l == want_l, f"{name_z}: launches {got_l}, expected {want_l}")
        require(terms_z.shape == (len(m_z.loss_names),) and bool(np.isfinite(terms_z).all())
                and all(bool(torch.isfinite(p_.grad).all()) and bool(torch.isfinite(p_).all())
                        for p_ in m_z.parameters()),
                f"{name_z}: loss terms {terms_z}, or a gradient or table not finite")
        gen_eval = torch.Generator(device=dev).manual_seed(0)
        embed_ms_z = host_ms(lambda: m_z.eval_embeddings(gen_eval), 5)
        zoo_calls[name_z] = lambda r_=one_z, p_=part_one, g_=gen_one: r_.run_epoch(
            *p_, generator=g_)
        k6_bound_z = bound(g_z.m.numel() + 4.0 * d_k6 * (nu + ni), 2.0 * nnz * d_k6, bf16_ops)
        extra_z = ""
        if name_z == "LightGCL":
            extra_z = f"; SVD (q = {m_z.svd_q}) {m_z.svd_seconds:.2f} s on the host"
        else:
            # the user-row path end to end: train_model one epoch (ceil(U / B)
            # steps from a permutation of the users), its evaluation, a server
            # from its result
            reset_counts()
            t0 = time.perf_counter()
            res_c = loop_lib.train_model("CVGA", data, config=cfg_z, seed=0, log_dir=None,
                                         echo=False, max_epochs=1, device=dev)
            cvga_epoch_s = time.perf_counter() - t0
            rec_c = Recommender.from_train_result("CVGA", data, cfg_z, res_c, device=dev)
            items_c, scores_c = rec_c.recommend(users_z, k=K)
            cvga_train_launches = rect_paths["zoo_cvga_train_model"] = read_counts()
            steps_c = -(-nu // bs)
            want_c = 2 * steps_c + 2  # the epoch's steps, its evaluation, the server
            require(cvga_train_launches["fused_adj_matmul"] == want_c
                    and bool(np.isfinite(res_c.last_result["recall"]).all())
                    and np.isfinite(scores_c).all(),
                    f"CVGA through train_model: K6 launches "
                    f"{cvga_train_launches['fused_adj_matmul']}, {want_c} expected, recall "
                    f"{res_c.last_result['recall']}")
            extra_z = (f"; train_model one epoch of user rows ({steps_c} steps, an evaluation) "
                       f"in {cvga_epoch_s:.1f} s, recall@{cfg_z.int_list('top_K')} "
                       f"{np.round(res_c.last_result['recall'], 5).tolist()}, served from its "
                       "result")
            del res_c, rec_c
        zoo_res[name_z] = dict(step_ms=step_ms_z, embed_ms=embed_ms_z, k6_bound=k6_bound_z,
                               step_mem_mb=step_mem / 1e6, mem_bar_mb=mem_bar_z / 1e6,
                               kmeans_ms=None, narrow_mem_mb=None)
        log(f"{name_z} (rectangular K6 at d = {d_k6}, batch {bs}): one step against the plain "
            f"route (loss terms within TIGHT, gradients within {grad_err_z:.3e} of their largest "
            f"entries), one under sync debug mode 'error', {ZOO_REQUEST} users served against "
            f"the plain route; {step_ms_z:.3f} ms per step over {ZOO_STEPS} steps, eval "
            f"embeddings {embed_ms_z:.3f} ms (first {embed_first_ms:.3f}), K6 launches "
            f"{got_l['fused_adj_matmul']} ({step_k6_z} a step, {repr_k6_z} a representation), "
            f"K6's bound {k6_bound_z[0]:.4f} ms a direction; a step's memory beyond the "
            f"model's {step_mem / 1e6:.1f} MB (bar {mem_bar_z / 1e6:.1f} MB: M's bytes and "
            f"{kept_z / 1e6:.1f} MB kept); loss sums "
            f"{dict(zip(m_z.loss_names, np.round(terms_z, 5).tolist()))}; built in "
            f"{build_s:.1f} s" + extra_z)
        zoo_models[name_z] = m_z
        del runner_z, triple_z, batch_z
        torch.cuda.empty_cache()

    # K6 on amazon-book's matrix, the largest it has run, beside its bound,
    # its plain version and two torch.matmul calls on a bfloat16 copy
    g_a = zoo_models["LightCCF"].graph
    nu_a, ni_a = amazon.num_users, amazon.num_items
    emb_a = concat_user_item(zoo_models["LightCCF"].user_emb,
                             zoo_models["LightCCF"].item_emb).detach()
    zu_a = g_a.right_u[:, None] * emb_a[:nu_a]
    zi_a = g_a.right_i[:, None] * emb_a[nu_a:]
    y_a = fusedmm.fused_adj_matmul(g_a.m, zu_a, zi_a)
    y_a_again = fusedmm.fused_adj_matmul(g_a.m, zu_a, zi_a)
    y_a_plain = fusedmm.fused_adj_matmul_plain(g_a.m, zu_a, zi_a)
    for what, a, b, c in zip(("yu", "yi"), y_a, y_a_again, y_a_plain):
        require(torch.equal(a, b), f"K6 on amazon-book's M, {what}: two launches differ")
        assert_close(a, c, f"K6 on amazon-book's M, {what}", **TIGHT)
        errs["K6"] = max(errs["K6"], max_abs(a, c))
    nnz_a = int(amazon.nnz)
    k6a_bound = bound(g_a.m.numel() + 8 * DIM * (nu_a + ni_a), 4.0 * nnz_a * DIM, bf16_ops)
    k6a_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul(g_a.m, zu_a, zi_a), 20)
    k6a_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(g_a.m, zu_a, zi_a), 2, 1)
    m_bf_a = g_a.m.to(torch.bfloat16)
    zu16_a = torch.nn.functional.pad(zu_a.to(torch.bfloat16), (0, 0, 0, g_a.m.shape[0] - nu_a))
    zi16_a = torch.nn.functional.pad(zi_a.to(torch.bfloat16), (0, 0, 0, g_a.m.shape[1] - ni_a))
    k6a_lib = cuda_ms(lambda: (m_bf_a @ zi16_a, m_bf_a.T @ zu16_a), 5)
    del m_bf_a, zu16_a, zi16_a, y_a, y_a_again, y_a_plain, emb_a, zu_a, zi_a
    torch.cuda.empty_cache()
    log(f"K6 on amazon-book's M {list(g_a.m.shape)} ({g_a.m.numel() / 1e9:.3f} GB, {nnz_a} "
        f"entries): {k6a_ms:.4f} ms an application (bound {k6a_bound[0]:.4f} ms by "
        f"{k6a_bound[1]}, plain {k6a_plain:.4f} ms, torch.matmul x2 on a bfloat16 copy "
        f"{k6a_lib:.4f} ms); two launches bit-equal, within TIGHT of its plain version")
    # K6 at d = 192, SimGCL's three chains side by side, on its yelp2018-scale
    # dense M: three reads of M a launch (64 features a read), held to its
    # plain version, timed beside three d = 64 applications and its bound
    g_s = zoo_models["SimGCL"].graph
    nu_s, ni_s = data.num_users, data.num_items
    emb_s = concat_user_item(zoo_models["SimGCL"].user_emb,
                             zoo_models["SimGCL"].item_emb).detach()
    emb_s3 = torch.cat([emb_s, 0.5 * emb_s, -0.25 * emb_s], dim=1)
    zu_s = (g_s.right_u[:, None] * emb_s3[:nu_s]).contiguous()
    zi_s = (g_s.right_i[:, None] * emb_s3[nu_s:]).contiguous()
    y_s = fusedmm.fused_adj_matmul(g_s.m, zu_s, zi_s)
    k6s_passes = fusedmm.fused_adj_matmul.passes  # as K6's launcher reports them
    require(k6s_passes == fusedmm.scan_passes(3 * DIM) == 3,
            f"K6 at d = {3 * DIM}: {k6s_passes} reads of M launched, 3 expected")
    y_s_again = fusedmm.fused_adj_matmul(g_s.m, zu_s, zi_s)
    for what, a, b, c in zip(("yu", "yi"), y_s, y_s_again,
                             fusedmm.fused_adj_matmul_plain(g_s.m, zu_s, zi_s)):
        require(torch.equal(a, b), f"K6 d = {3 * DIM} {what}: two launches differ")
        assert_close(a, c, f"K6 d = {3 * DIM} {what}", **TIGHT)
        errs["K6"] = max(errs["K6"], max_abs(a, c))
    nnz_s = int(data.nnz)
    k6s_bound = bound(g_s.m.numel() + 8 * 3 * DIM * (nu_s + ni_s), 4.0 * nnz_s * 3 * DIM,
                      bf16_ops)
    k6s_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul(g_s.m, zu_s, zi_s), 20)
    thirds = [(zu_s[:, j * DIM:(j + 1) * DIM].contiguous(),
               zi_s[:, j * DIM:(j + 1) * DIM].contiguous()) for j in range(3)]
    k6s_3x64_ms = cuda_ms(lambda: [fusedmm.fused_adj_matmul(g_s.m, *z_) for z_ in thirds], 20)
    k6s_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(g_s.m, zu_s, zi_s), 2, 1)
    m_bf_s = g_s.m.to(torch.bfloat16)
    zu16_s = torch.nn.functional.pad(zu_s.to(torch.bfloat16), (0, 0, 0, g_s.m.shape[0] - nu_s))
    zi16_s = torch.nn.functional.pad(zi_s.to(torch.bfloat16), (0, 0, 0, g_s.m.shape[1] - ni_s))
    k6s_lib = cuda_ms(lambda: (m_bf_s @ zi16_s, m_bf_s.T @ zu16_s), 10)
    del m_bf_s, zu16_s, zi16_s, y_s, y_s_again, emb_s, emb_s3, zu_s, zi_s, thirds
    torch.cuda.empty_cache()
    log(f"K6 at d = {3 * DIM} on SimGCL's M {list(g_s.m.shape)}: {k6s_passes} reads of M, as "
        f"launched; {k6s_ms:.4f} ms an application against {k6s_3x64_ms:.4f} ms for three "
        f"d = {DIM} applications (bound {k6s_bound[0]:.4f} ms by {k6s_bound[1]}, plain "
        f"{k6s_plain:.4f} ms, torch.matmul x2 on a bfloat16 copy {k6s_lib:.4f} ms); two "
        f"launches bit-equal, within TIGHT of its plain version")

    # K6 at d = 2,048, RecDCL's width, on its yelp2018-scale dense M: sixteen
    # reads of M a launch (128 features a read), held to its plain version,
    # timed beside its bound and two torch.matmul calls on a bfloat16 copy of
    # M (the copy not counted)
    g_w = zoo_models["RecDCL"].graph
    dim_w = ZOO_DIMS["RecDCL"]
    nu_w, ni_w = data.num_users, data.num_items
    with torch.no_grad():
        emb_w = concat_user_item(zoo_models["RecDCL"].user_emb, zoo_models["RecDCL"].item_emb)
        zu_w = (g_w.right_u[:, None] * emb_w[:nu_w]).contiguous()
        zi_w = (g_w.right_i[:, None] * emb_w[nu_w:]).contiguous()
    del emb_w
    y_w = fusedmm.fused_adj_matmul(g_w.m, zu_w, zi_w)
    k6w_passes = fusedmm.fused_adj_matmul.passes
    require(k6w_passes == fusedmm.scan_passes(dim_w) == 16,
            f"K6 at d = {dim_w}: {k6w_passes} reads of M launched, 16 expected")
    y_w_again = fusedmm.fused_adj_matmul(g_w.m, zu_w, zi_w)
    for what, a, b, c in zip(("yu", "yi"), y_w, y_w_again,
                             fusedmm.fused_adj_matmul_plain(g_w.m, zu_w, zi_w)):
        require(torch.equal(a, b), f"K6 d = {dim_w} {what}: two launches differ")
        assert_close(a, c, f"K6 d = {dim_w} {what}", **TIGHT)
        errs["K6"] = max(errs["K6"], max_abs(a, c))
    del y_w, y_w_again
    k6w_bound = bound(g_w.m.numel() + 8 * dim_w * (nu_w + ni_w), 4.0 * int(data.nnz) * dim_w,
                      bf16_ops)
    k6w_ms = cuda_ms(lambda: fusedmm.fused_adj_matmul(g_w.m, zu_w, zi_w), 10)
    k6w_plain = cuda_ms(lambda: fusedmm.fused_adj_matmul_plain(g_w.m, zu_w, zi_w), 2, 1)
    m_bf_w = g_w.m.to(torch.bfloat16)
    zu16_w = torch.nn.functional.pad(zu_w.to(torch.bfloat16), (0, 0, 0, g_w.m.shape[0] - nu_w))
    zi16_w = torch.nn.functional.pad(zi_w.to(torch.bfloat16), (0, 0, 0, g_w.m.shape[1] - ni_w))
    k6w_lib = cuda_ms(lambda: (m_bf_w @ zi16_w, m_bf_w.T @ zu16_w), 5)
    del m_bf_w, zu16_w, zi16_w, zu_w, zi_w
    torch.cuda.empty_cache()
    log(f"K6 at d = {dim_w} on RecDCL's M {list(g_w.m.shape)}: {k6w_passes} reads of M, as "
        f"launched; {k6w_ms:.4f} ms an application (bound {k6w_bound[0]:.4f} ms by "
        f"{k6w_bound[1]}, plain {k6w_plain:.4f} ms, torch.matmul x2 on a bfloat16 copy "
        f"{k6w_lib:.4f} ms); two launches bit-equal, within TIGHT of its plain version")
    # NGCF with node dropout (off in its published config), which forces the
    # gather backend: the edge mask, the dropped values and their transpose
    # through the graph's permutation, the sparse products; one step under
    # sync debug mode "error" after one that makes Adam's state
    cfg_nd = load_model_config("NGCF").updated(dataset=data.name, node_dropout=True)
    t0 = time.perf_counter()
    m_nd = get_model("NGCF")(cfg_nd, data, device=dev, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    nd_build_s = time.perf_counter() - t0
    require(isinstance(m_nd.graph, propagate.GatherSquareAdj)
            and m_nd.graph.t_perm is not None, "NGCF node dropout: not on the gather backend")
    bs_nd = cfg_nd.int("batch_size")
    triple_nd = [t_[:2 * bs_nd] for t_ in neg_sampler.sample_epoch(gen)]
    runner_nd = EpochRunner(m_nd, cfg_nd.float("learn_rate"), bs_nd, bs_nd)
    gen_nd = torch.Generator(device=dev).manual_seed(ZOO_NOISE_SEED)
    runner_nd.run_epoch(*[t_[:bs_nd] for t_ in triple_nd], generator=gen_nd)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        terms_nd = runner_nd.run_epoch(*[t_[bs_nd:] for t_ in triple_nd], generator=gen_nd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    nd_step_ms = (time.perf_counter() - t0) * 1e3
    require(not any(read_counts().values()), "NGCF node dropout: a kernel launched on gather")
    terms_nd = terms_nd.cpu().numpy()
    require(bool(np.isfinite(terms_nd).all())
            and all(bool(torch.isfinite(p_.grad).all()) for p_ in m_nd.parameters()),
            f"NGCF node dropout: loss terms {terms_nd} or a gradient not finite")
    log(f"NGCF with node dropout on gather (built in {nd_build_s:.1f} s, the transpose "
        f"permutation included): one step under sync debug mode 'error', {nd_step_ms:.1f} ms, "
        f"loss terms {terms_nd.tolist()}, gradients finite")
    del m_nd, runner_nd, triple_nd
    torch.cuda.empty_cache()

    # MAWU through its command line, from files
    tmp_z = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        quick_z = make_synthetic_dataset(*QUICK, seed=0, name="quick")
        write_dataset(os.path.join(tmp_z, "data", "quick"), quick_z)
        conf_z = os.path.join(tmp_z, "conf")
        os.makedirs(conf_z)
        with open(os.path.join(default_configure_dir(), "MAWU.txt")) as f:
            text_z = f.read()
        with open(os.path.join(conf_z, "MAWU.txt"), "w") as f:
            f.write(text_z + f"\ndataset_path = {os.path.join(tmp_z, 'data')}\n"
                    "dataset = quick\ntraining_epochs = 1\n")
        out_z = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_z):
            code_z = cli_main.main(["--model=MAWU", "--configure_dir", conf_z, "--log_dir",
                                    os.path.join(tmp_z, "log"), "--checkpoint_dir",
                                    os.path.join(tmp_z, "ck")])
        mawu_cli_s = time.perf_counter() - t0
        mawu_cli_launches = read_counts()
        leaves_z, _ = ckpt_lib.read_checkpoint(os.path.join(tmp_z, "ck"), 1)
        require(code_z == 0 and "Best epoch:" in out_z.getvalue()
                and "encoder : LightGCN" in out_z.getvalue(), "MAWU's command line")
        # count, mu, nu and params of four tables, the two generators' states
        require(len(leaves_z) == 3 * 4 + 3, f"MAWU's checkpoint has {len(leaves_z)} leaves")
        got_l = {k_: n for k_, n in mawu_cli_launches.items() if n}
        require(set(got_l) == {"fused_adj_matmul"}, f"MAWU's command line launched {got_l}")
        log(f"main.main(['--model=MAWU', ...]) on {quick_z.num_users} x {quick_z.num_items}: one "
            f"epoch, an evaluation, a checkpoint of four tables, K6 x "
            f"{got_l['fused_adj_matmul']}, {mawu_cli_s:.2f} s")
    finally:
        shutil.rmtree(tmp_z, ignore_errors=True)

    # ==== learnability: LightGCN int8 and int4 on learnable data, recall@20
    # after the last epoch at least LEARN_FACTOR times after the first (the
    # popularity level), int4's metrics and loss sums equal int8's
    t0 = time.perf_counter()
    latent = make_latent_synthetic_dataset(*(int(n_ * LEARN_SCALE) for n_ in YELP), seed=0,
                                           name="latent-yelp-scale")
    log(f"latent dataset {latent.num_users} users x {latent.num_items} items, "
        f"{latent.num_train} train, {latent.num_test} test, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg_l = load_model_config("LightGCN").updated(
        dataset=latent.name, embedding_size=DIM, GCN_layer=LAYERS, batch_size=BATCH,
        test_batch_size=2048, top_K=[20], learn_rate=0.005, reg_lambda=0.0001,
        training_epochs=LEARN_EPOCHS, interval=LEARN_EPOCHS - 1, early_stopping=100,
        propagation_backend="fused")
    learn = {}
    reset_counts()
    for mode in ("int8", "int4"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_learn_") as tmp_l:
            t0 = time.perf_counter()
            res_l = loop_lib.train_model("LightGCN", latent, config=cfg_l.updated(
                compute_dtype=mode), seed=2024, log_dir=tmp_l, echo=False)
            wall_l = time.perf_counter() - t0
            with open(os.path.join(tmp_l, "LightGCN", f"{latent.name}.jsonl")) as f:
                events = [json.loads(line) for line in f]
        evals = [(ev["epoch"], ev["recall"][0], ev["ndcg"][0]) for ev in events
                 if ev["kind"] == "eval"]
        losses_l = [ev["loss_terms"] for ev in events if ev["kind"] == "train_epoch"]
        learn[mode] = (evals, losses_l, wall_l)
        log(f"learnability {mode}: recall@20 {[round(e_[1], 5) for e_ in evals]} at epochs "
            f"{[e_[0] for e_ in evals]}, {wall_l:.1f} s")
    learn_launches = read_counts()
    evals8 = learn["int8"][0]
    require(len(evals8) == 2 and evals8[0][0] == 1 and evals8[-1][0] == LEARN_EPOCHS,
            f"learnability: evaluations at {evals8}")
    require(evals8[-1][1] >= LEARN_FACTOR * evals8[0][1],
            f"learnability: recall@20 {evals8[-1][1]} after epoch {LEARN_EPOCHS} is below "
            f"{LEARN_FACTOR} x {evals8[0][1]} after the first")
    require(learn["int4"][:2] == learn["int8"][:2],
            "learnability: int4's metrics or loss sums differ from int8's")
    for fn in (fusedmm.fused_adj_matmul_int8_t, fusedmm.fused_adj_matmul_int4_t,
               chainmm.dual_sweep, chainmm.dual_sweep_inject, scatter.scatter_add_rows):
        require(fn.launches > 0, f"{fn.__name__} was never launched on the learnability path")
    log(f"learnability: recall@20 {evals8[0][1]:.5f} after epoch 1, {evals8[-1][1]:.5f} after "
        f"epoch {LEARN_EPOCHS} ({evals8[-1][1] / evals8[0][1]:.2f} x, at least {LEARN_FACTOR}); "
        f"int4's metrics and loss sums equal int8's; {learn['int8'][2]:.1f} s int8, "
        f"{learn['int4'][2]:.1f} s int4")
    # DirectAU (encoder LightGCN, dense bfloat16 on K6) at its published
    # config on the same latent set, the same epochs and the same bar
    cfg_dl = load_model_config("DirectAU").updated(
        dataset=latent.name, top_K=[20], test_batch_size=2048, training_epochs=LEARN_EPOCHS,
        interval=LEARN_EPOCHS - 1, early_stopping=100)
    require(cfg_dl.str("encoder") == "LightGCN" and cfg_dl.str("compute_dtype") == "bfloat16"
            and cfg_dl.str("propagation_backend") == "auto", "DirectAU's learnability config")
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_learn_") as tmp_l:
        t0 = time.perf_counter()
        loop_lib.train_model("DirectAU", latent, config=cfg_dl, seed=2024, log_dir=tmp_l,
                             echo=False)
        wall_dl = time.perf_counter() - t0
        with open(os.path.join(tmp_l, "DirectAU", f"{latent.name}.jsonl")) as f:
            events = [json.loads(line) for line in f]
    learn_dl_launches = read_counts()
    evals_dl = [(ev["epoch"], ev["recall"][0], ev["ndcg"][0]) for ev in events
                if ev["kind"] == "eval"]
    losses_dl = [ev["loss_terms"] for ev in events if ev["kind"] == "train_epoch"]
    log(f"learnability DirectAU: recall@20 {[round(e_[1], 5) for e_ in evals_dl]} at epochs "
        f"{[e_[0] for e_ in evals_dl]}; loss terms (align, uniform, reg) after epoch 1 "
        f"{np.round(losses_dl[0], 5).tolist()}, after epoch {len(losses_dl)} "
        f"{np.round(losses_dl[-1], 5).tolist()}; {wall_dl:.1f} s")
    steps_dl = -(-latent.num_train // cfg_dl.int("batch_size"))
    want_dl = {"fused_adj_matmul": LEARN_EPOCHS * steps_dl * 2 * LAYERS + 2 * LAYERS}
    got_dl = {k_: n for k_, n in learn_dl_launches.items() if n}
    require(got_dl == want_dl, f"DirectAU learnability: launches {got_dl}, expected {want_dl}")
    require(len(evals_dl) == 2 and evals_dl[0][0] == 1 and evals_dl[-1][0] == LEARN_EPOCHS
            and all(np.isfinite(losses_dl).ravel()), f"DirectAU learnability: evaluations at "
                                                      f"{evals_dl}")
    # LightGCN's bar, written before DirectAU's first run: its last recall@20
    # at least LEARN_FACTOR x its first. Missed on the card (ROADMAP §C):
    # DirectAU's first evaluation is already far above the popularity level,
    # where LightGCN's sits. Reported here, not required; what is required is
    # that DirectAU learns beyond popularity, LEARN_FACTOR x LightGCN int8's
    # first evaluation on the same set, and that its recall does not fall
    held_dl = evals_dl[-1][1] >= LEARN_FACTOR * evals_dl[0][1]
    popularity = evals8[0][1]
    require(evals_dl[-1][1] >= LEARN_FACTOR * popularity and evals_dl[-1][1] >= evals_dl[0][1],
            f"DirectAU learnability: recall@20 {evals_dl[-1][1]} after epoch {LEARN_EPOCHS}, "
            f"{evals_dl[0][1]} after the first; the popularity level {popularity}")
    log(f"learnability DirectAU: recall@20 {evals_dl[0][1]:.5f} after epoch 1, "
        f"{evals_dl[-1][1]:.5f} after epoch {LEARN_EPOCHS}: {evals_dl[-1][1] / popularity:.2f} x "
        f"the popularity level (LightGCN's first evaluation, {popularity:.5f}; at least "
        f"{LEARN_FACTOR}); LightGCN's bar, {LEARN_FACTOR} x its own first evaluation: "
        f"{'held' if held_dl else 'missed'} ({evals_dl[-1][1] / evals_dl[0][1]:.2f} x); K6 x "
        f"{got_dl['fused_adj_matmul']}")
    del latent

    n_steps = EPOCHS * steps

    by_path = {"serving": launches, "training": train_launches,
               "int4_epoch": int4_epoch_launches, "run_harness": harness_launches,
               "command_lines": cli_launches, "bf16_fused": bf_launches,
               "dense_bf16": dense_launches["dense bfloat16"],
               "dense_int8": dense_launches["dense int8"],
               "dense_f32": dense_launches["dense float32"],
               "gather_f32": dense_launches["gather float32"], "wide_d128": wide_launches,
               "egcf_serving": egcf_serve_launches, "egcf_training": egcf_train_launches,
               "egcf_int4": egcf_int4_launches, "egcf_bf16_fused": egcf_bf_launches,
               "egcf_run_harness": egcf_harness_launches,
               "egcf_command_line": egcf_cli_launches,
               "bitpack_bf16": bit_runs["bfloat16"][0], "bitpack_f32": bit_runs["float32"][0],
               "egcf_bitpack": egcf_bp_launches, "batch_rows": rows_launches,
               "egcf_alternating_serving": alt_serve_launches,
               "egcf_alternating_training": alt_train_launches,
               "egcf_alternating_bitpack": alt_bp_launches, "learnability": learn_launches,
               **{f"zoo_{name_z}": c for name_z, c in zoo_launches.items()},
               "zoo_mawu_command_line": mawu_cli_launches,
               "learnability_directau": learn_dl_launches,
               "dense_egcf_alternating_bf16": alt_bf_launches, **rect_paths}
    egcf_tanh = (chainmm.chain_sweep_tanh, chainmm.chain_sweep_tanh_inject)

    def entry(name_, source, replaces, fn, err, ms, plain, bnd, lib, unit, also=(),
              per="sides_run"):
        # ``also``: the sweeps that run this kernel's code inside the dual's
        # launch (K2's, K9's and K10's epilogues in the turn-out, counted by
        # the sides they ran; K3's rounding in the turn-in, by the inputs it
        # rounded): one side is what one standalone launch does
        counts = {path: c[fn.__name__] + sum(c[f"{f_.__name__}.{per}"] for f_ in also)
                  for path, c in by_path.items()}
        # per training step of the path the kernel serves (the int8 count
        # with the eval sweep's chain; K6's without the chains of the
        # Recommender and of the evaluation; K9's and K10's on EGCF's)
        if fn is fusedmm.fused_adj_matmul_int4_t:
            per_step = counts["int4_epoch"] / steps
        elif fn is fusedmm.fused_adj_matmul:
            per_step = (counts["bf16_fused"] - 2 * LAYERS) / (2 * BF16_STEPS)
        elif fn in (fusedmm.fused_adj_matmul_int8, fusedmm.fused_adj_matmul_int4):
            per_step = counts["wide_d128"] / WIDE_STEPS
        elif fn in egcf_tanh:
            per_step = counts["egcf_training"] / n_steps
        elif fn is bitmm.bit_matmul:
            per_step = (counts["bitpack_bf16"] - 4 * LAYERS) / (2 * BIT_STEPS)
        elif fn in row_counters:
            per_step = counts["batch_rows"] / OTHER_STEPS
        else:
            per_step = counts["training"] / n_steps
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(counts.values()), "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib, "unit": unit,
                **{f"launches_{path}": n for path, n in counts.items()},
                "launches_per_step": per_step}

    k2_src = "idgrec_torch/csrc/chain_sweep_epilogue.cu"
    side_unit = ("; launches counts one side's epilogue: a standalone launch, or one "
                 "side of a fused sweep")
    kernels = [
        entry("dual_int8_t", "idgrec_torch/csrc/dual_int8_t.cu", "idgrec_tpu/ops/fusedmm.py:674",
              fusedmm.fused_adj_matmul_int8_t, errs["K1"], k1_ms, k1_plain, k1_bound, k1_lib,
              "one sweep: 1 launch (3 kernels: the turn to [N, d] with the sums zeroed, the "
              "scan of M, the turn back)"),
        entry("dual_int4_t", "idgrec_torch/csrc/dual_int4_t.cu", "idgrec_tpu/ops/fusedmm.py:708",
              fusedmm.fused_adj_matmul_int4_t, errs["K5"], k5_ms, k5_plain, k5_bound, k5_lib,
              "one sweep on the nibble-packed matrix: 1 launch (3 kernels: K1's turn to [N, d] "
              "with the sums zeroed, K8's scan of the packed bytes, K1's turn back)"),
        entry("chain_sweep_epilogue", k2_src, "idgrec_tpu/ops/chainmm.py:322",
              chainmm.chain_sweep_epilogue, errs["K2"], k2_ms, k2_plain, k2_bound, None,
              "one sweep standalone: 2 launches (users, items); in the chain it runs in the "
              "prologue standalone and in every sweep inside the turn-out of K1 or K5 "
              "(csrc/dual_turns.cuh, chainmm.dual_sweep)" + side_unit,
              also=(chainmm.dual_sweep,)),
        entry("chain_sweep_inject", k2_src, "idgrec_tpu/ops/chainmm.py:341",
              chainmm.chain_sweep_inject, errs["K2i"], k2i_ms, k2i_plain, k2i_bound, None,
              "one backward sweep standalone: 2 launches (users, items); in the chain it runs "
              "only inside the turn-out of K1 or K5 (csrc/dual_turns.cuh, "
              "chainmm.dual_sweep_inject)" + side_unit,
              also=(chainmm.dual_sweep_inject,)),
        entry("quantize_rows", "idgrec_torch/csrc/quantize_rows.cu",
              "idgrec_tpu/ops/chainmm.py:236", propagate.quantize_rows, errs["K3"], k3_ms,
              k3_plain, k3_bound, k3_lib,
              "one sweep's inputs standalone: 2 launches (users, items); in the chain it runs "
              "only inside the turn-in of K1 or K5 (csrc/dual_turns.cuh, every chainmm.DualSweep "
              "on (z, amax)); launches counts one side quantized: a standalone launch, or one "
              "(z, amax) input rounded in a sweep's turn-in",
              also=tuple(quant_sweeps.values()), per="quantized_in_sweep"),
        entry("scatter_add_rows", "idgrec_torch/csrc/scatter_add_rows.cu",
              "idgrec_tpu/ops/scatter.py:40", scatter.scatter_add_rows, errs["K4"], k4_ms,
              k4_plain, k4_bound, k4_lib,
              "one step on the step's entry: 2 calls (2,048 rows into the user table, "
              "4,096 into the item table, pos and neg concatenated; two kernels each); "
              "library: index_add_ x2 into zeroed tables"),
        entry("dual_bf16", "idgrec_torch/csrc/dual_bf16.cu", "idgrec_tpu/ops/fusedmm.py:98",
              fusedmm.fused_adj_matmul, errs["K6"], k6_ms, k6_plain, k6_bound, k6_lib,
              "one application at d = 64: 1 launch (3 kernels: the bfloat16 copy with its "
              "maxima and the sums zeroed, the scan of M, the conversion); library: "
              "torch.matmul x2 on a bfloat16 copy of M, the copy not counted"),
        entry("dual_int8_n", "idgrec_torch/csrc/dual_int8_n.cu", "idgrec_tpu/ops/fusedmm.py:211",
              fusedmm.fused_adj_matmul_int8, errs["K7"], *wide_kernels["K7"],
              f"one application at d = {WIDE_DIM}: 1 launch, one 128-feature group (one read of "
              "M)"),
        entry("dual_int4_n", "idgrec_torch/csrc/dual_int4_n.cu", "idgrec_tpu/ops/fusedmm.py:442",
              fusedmm.fused_adj_matmul_int4, errs["K8"], *wide_kernels["K8"],
              f"one application at d = {WIDE_DIM} on the nibble-packed matrix: 1 launch, one "
              "128-feature group (one read of m4)"),
        entry("chain_sweep_tanh", "idgrec_torch/csrc/chain_sweep_tanh.cu",
              "idgrec_tpu/ops/chainmm.py:366", chainmm.chain_sweep_tanh, errs["K9"], k9_ms,
              k9_plain, k9_bound, None,
              "one forward sweep of the tanh chain standalone: 2 launches (users, items); in "
              "the chain it runs only inside the turn-out of K1 or K5 (csrc/dual_turns.cuh, "
              "chainmm.dual_sweep_tanh; the seed sweep the user side alone)" + side_unit,
              also=(chainmm.dual_sweep_tanh,)),
        entry("chain_sweep_tanh_inject", "idgrec_torch/csrc/chain_sweep_tanh.cu",
              "idgrec_tpu/ops/chainmm.py:391", chainmm.chain_sweep_tanh_inject, errs["K10"],
              k10_ms, k10_plain, k10_bound, None,
              "one backward sweep of the tanh chain standalone: 2 launches; in the chain it "
              "runs standalone in the backward's prologue and in every sweep inside the "
              "turn-out of K1 or K5 (chainmm.dual_sweep_tanh_inject)" + side_unit,
              also=(chainmm.dual_sweep_tanh_inject,)),
        entry("bit_matmul", "idgrec_torch/csrc/bit_matmul.cu", "idgrec_tpu/ops/bitmm.py:94",
              bitmm.bit_matmul, errs["K11"], sum(k11_ms), k11_plain, k11_bound, k11_lib,
              "one application at d = 64: 2 calls (users, items), each 2 kernels (the scan "
              "by the adjacency's plan, the shared row groups' sums), the bfloat16 rounding "
              "inside; library: torch.matmul x2 on bfloat16 unpacked copies, the copies not "
              "counted"),
        entry("gather_rows_matmul", "idgrec_torch/csrc/gather_rows_matmul.cu",
              "idgrec_tpu/ops/gathermm.py:113", gathermm.gather_rows_matmul, errs["K12"],
              *k12[("K12", torch.bfloat16)],
              f"one step, bfloat16 z: 2 calls ({BATCH} user rows, {2 * BATCH} item rows), each the "
              "kernel and the column shares' sum; library: M[rows].to(bfloat16) @ z x2"),
        entry("gather_rows_matmul_t", "idgrec_torch/csrc/gather_rows_matmul.cu",
              "idgrec_tpu/ops/gathermm.py:148", gathermm.gather_rows_matmul_t, errs["K13"],
              *k12[("K13", torch.bfloat16)],
              f"one step, bfloat16 g: 2 launches ({BATCH} user rows, {2 * BATCH} item rows); "
              "library: M[rows].to(bfloat16).T @ g x2"),
    ]
    for k in kernels:
        if k["name"] == "scatter_add_rows":
            k["public_entry_ms"] = k4_checked_ms  # two calls, each checking the range
            k["backward_path_ms"] = k4_path_ms  # the step's entry, the concatenation included
        elif k["name"] == "dual_int8_n":
            k.update(ms_d64=k7_64_ms, launches_dense=by_path["dense_int8"]["fused_adj_matmul_int8"])
        elif k["name"] == "dual_bf16":
            k.update(ms_d128=k6_128_ms, bound_ms_d128=k6_128_bound[0], passes_d64=k6_passes,
                     passes_d128=k6_128_passes, ms_d192=k6s_ms, bound_ms_d192=k6s_bound[0],
                     plain_ms_d192=k6s_plain, library_ms_d192=k6s_lib, passes_d192=k6s_passes,
                     ms_three_d64=k6s_3x64_ms, ms_amazon=k6a_ms, bound_ms_amazon=k6a_bound[0],
                     plain_ms_amazon=k6a_plain, library_ms_amazon=k6a_lib,
                     ms_d2048=k6w_ms, bound_ms_d2048=k6w_bound[0], plain_ms_d2048=k6w_plain,
                     library_ms_d2048=k6w_lib, passes_d2048=k6w_passes,
                     **{f"rect_{key}_d{d_r}": val for d_r, r_ in rect_k6.items()
                        for key, val in (("ms_users", r_["times"]["users"]),
                                         ("ms_items", r_["times"]["items"]),
                                         ("ms_both", r_["times"]["dual"]),
                                         ("bound_ms", r_["bound"][0]),
                                         ("bound_ms_both", r_["bound_dual"][0]),
                                         ("plain_ms_users", r_["times"]["plain_users"]),
                                         ("plain_ms_items", r_["times"]["plain_items"]),
                                         ("library_ms", r_["times"]["library"]),
                                         ("max_abs_err", r_["err"]), ("passes", r_["passes"]))},
                     launches_rect=sum(c["fused_adj_matmul"] for path, c in by_path.items()
                                       if path in ("zoo_LightGCL", "zoo_CVGA",
                                                   "zoo_cvga_train_model",
                                                   "dense_egcf_alternating_bf16")),
                     launches_dense=sum(c["fused_adj_matmul"] for path, c in by_path.items()
                                        if path.startswith(("dense", "zoo", "batch_rows",
                                                            "learnability_directau"))))
        elif k["name"] == "bit_matmul":
            k["ms_per_direction"] = k11_ms
            # the rectangular adjacency's directions (BitRectAdj.matmul,
            # .t_matmul: one K11 call each, the scaling included)
            fwd, trn, bnd_r, _ = rect_times["bitpack bfloat16"]
            k.update(rect_ms_per_direction=[fwd, trn], rect_bound_ms_per_direction=bnd_r[0])
        elif k["name"] == "dual_int4_n":
            k.update(ms_d64=k8_64_ms, plain_ms_d64=k8_64_plain, bound_ms_d64=k8_64_bound[0],
                     library_ms_d64=k8_64_lib)
        elif k["name"] in ("chain_sweep_epilogue", "chain_sweep_inject"):
            inject = k["name"] == "chain_sweep_inject"
            sweep_fn = chainmm.dual_sweep_inject if inject else chainmm.dual_sweep
            k["runs_in"] = "idgrec_torch/csrc/dual_turns.cuh"
            k["launches_standalone"] = sum(c[k["name"]] for c in by_path.values())
            k["launches_in_sweep"] = sum(c[f"{sweep_fn.__name__}.sides_run"]
                                         for c in by_path.values())
            for quant in ("int8", "int4"):
                fused, separate, bare, bnd = sweep_times[(quant, inject)]
                k.update({f"sweep_ms_{quant}": fused, f"dual_and_k2_ms_{quant}": separate,
                          f"bare_dual_ms_{quant}": bare, f"sweep_bound_ms_{quant}": bnd[0]})
        elif k["name"] == "quantize_rows":
            k["runs_in"] = "idgrec_torch/csrc/dual_turns.cuh"
            k["launches_standalone"] = sum(c["quantize_rows"] for c in by_path.values())
            k["launches_in_sweep"] = sum(c[f"{fn_.__name__}.quantized_in_sweep"]
                                         for c in by_path.values()
                                         for fn_ in quant_sweeps.values())
            k["quantizing_sweep_err"] = errs["quant_sweep"]
            for (quant, kind), (zq, sep, bare_, bnd) in quant_times.items():
                k.update({f"quantizing_sweep_ms_{kind}_{quant}": zq,
                          f"k3_and_sweep_ms_{kind}_{quant}": sep,
                          f"bare_sweep_ms_{kind}_{quant}": bare_,
                          f"quantizing_sweep_bound_ms_{kind}_{quant}": bnd[0]})
        elif k["name"] in ("chain_sweep_tanh", "chain_sweep_tanh_inject"):
            inject = k["name"] == "chain_sweep_tanh_inject"
            sweep_fn = chainmm.dual_sweep_tanh_inject if inject else chainmm.dual_sweep_tanh
            k["runs_in"] = "idgrec_torch/csrc/dual_turns.cuh"
            k["launches_standalone"] = sum(c[k["name"]] for c in by_path.values())
            k["launches_in_sweep"] = sum(c[f"{sweep_fn.__name__}.sides_run"]
                                         for c in by_path.values())
            for quant in ("int8", "int4"):
                fused, separate, bare, bnd = tanh_times[(quant, inject)]
                k.update({f"sweep_ms_{quant}": fused, f"dual_and_pair_ms_{quant}": separate,
                          f"bare_dual_ms_{quant}": bare, f"sweep_bound_ms_{quant}": bnd[0]})
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms by {k['bound_by']}, "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']}), "
            f"launches: {k['launches_serving']} serving, {k['launches_training']} training, "
            f"{k['launches_int4_epoch']} int4 epoch, {k['launches_run_harness']} run harness, "
            f"{k['launches_command_lines']} command lines, {k['launches_bf16_fused']} "
            f"bfloat16-fused, {k['launches_wide_d128']} d = {WIDE_DIM}; EGCF "
            f"{k['launches_egcf_serving']} serving, {k['launches_egcf_training']} training, "
            f"{k['launches_egcf_int4']} int4, {k['launches_egcf_bf16_fused']} bfloat16-fused, "
            f"{k['launches_egcf_run_harness']} run harness, {k['launches_egcf_command_line']} "
            f"command line; bitpack {k['launches_bitpack_bf16']} bfloat16, "
            f"{k['launches_bitpack_f32']} float32, {k['launches_egcf_bitpack']} EGCF; "
            f"{k['launches_batch_rows']} batch rows; EGCF alternating "
            f"{k['launches_egcf_alternating_serving']} serving, "
            f"{k['launches_egcf_alternating_training']} int8 training, "
            f"{k['launches_egcf_alternating_bitpack']} bitpack; {k['launches_learnability']} "
            f"learnability; dense {k['launches_dense_bf16']} bfloat16, "
            f"{k['launches_dense_int8']} int8; zoo "
            + ", ".join(f"{k[f'launches_zoo_{n_}']} {n_}" for n_ in ZOO + RECT_ZOO)
            + f", {k['launches_zoo_cvga_train_model']} CVGA train_model, "
            f"{k['launches_dense_egcf_alternating_bf16']} EGCF alternating bfloat16 dense"
            + f", {k['launches_zoo_mawu_command_line']} MAWU command line, "
            f"{k['launches_learnability_directau']} DirectAU learnability "
            f"({k['launches_per_step']:.2f} per step)")
    log(f"EGCF: eval embeddings {egcf_embed_ms:.3f} ms (int4 {egcf4_embed_ms:.3f}, bfloat16-fused "
        f"{egcf_bf_embed_ms:.3f}), {egcf_step_ms:.3f} ms per step, {float(np.mean(e_epoch_ms)):.1f} "
        f"ms per epoch (int8); int4 {e_runs['int4'][1]:.3f} and int8 {e_runs['int8'][1]:.3f} ms per "
        f"step over {OTHER_STEPS} steps; bfloat16-fused {egcf_bf_step_ms:.3f}; beside LightGCN "
        f"int8 {step_ms:.3f}")
    log("zoo, published configs: " + "; ".join(
        f"{n_} {r_['step_ms']:.3f} ms per step, eval embeddings {r_['embed_ms']:.3f} ms"
        + (f", K6 bound {r_['k6_bound'][0]:.4f} ms an application" if r_["k6_bound"] else "")
        + f", a step's memory {r_['step_mem_mb']:.1f} MB"
        + (f" (bar {r_['mem_bar_mb']:.1f})" if r_["mem_bar_mb"] else "")
        + (f", k-means {r_['kmeans_ms']:.3f} ms an epoch" if r_["kmeans_ms"] else "")
        for n_, r_ in zoo_res.items()))
    log(f"exact modes, ms per training step: fused bfloat16 {bf_step_ms:.3f}, "
        + ", ".join(f"{label} {v[0]:.3f}" for label, v in other_ms.items())
        + f"; bitpack bfloat16 {bit_runs['bfloat16'][1]:.3f}, float32 "
        f"{bit_runs['float32'][1]:.3f}; dense bfloat16 with batch rows "
        f"{float(np.mean(rows_ms)):.3f} beside {float(np.mean(full_ms)):.3f} without; beside int8 "
        f"{step_ms:.3f} and int4 {epoch4_ms / steps:.3f} in this run")
    # the device launches of one call of each scan kernel, counted last: once
    # used, the profiler slows the host's later launches
    per_call = {"dual_int8_t": lambda: fusedmm.fused_adj_matmul_int8_t(adj.m8, qu, qi),
                "dual_int4_t": lambda: fusedmm.fused_adj_matmul_int4_t(adj4.m8, qu, qi4),
                "dual_int8_n": lambda: fusedmm.fused_adj_matmul_int8(adj.m8, quN, qiN),
                "dual_int4_n": lambda: fusedmm.fused_adj_matmul_int4(adj4.m8, quN, qi4N),
                "dual_bf16": lambda: fusedmm.fused_adj_matmul(adj.m8, zu6, zi6),
                "bit_matmul": lambda: bitmm.bit_matmul(*k11_dirs[0])}
    for k in kernels:
        if k["name"] in per_call:
            k["device_launches_per_call"] = device_launches(per_call[k["name"]])
    sweep_calls = {}
    for quant in ("int8", "int4"):
        for inject, flag, name_ in ((False, chainmm.COMBINE_ADD, "chain_sweep_epilogue"),
                                    (True, True, "chain_sweep_inject")):
            ext = [t_.clone() for t_ in sweep_cases[quant][6 if inject else 5]]
            n_ = device_launches(lambda: fused_sweep(quant, inject, flag, True, ext))
            sweep_calls[f"{quant} {'inject' if inject else 'forward'}"] = n_
            next(k for k in kernels if k["name"] == name_)[
                f"device_launches_per_sweep_{quant}"] = n_
        # the tanh sweeps on the same inputs (a sweep's launches do not
        # depend on its values), h slices of the sweep's shapes
        m_, qi_, si_, l_, r_ = sweep_cases[quant][:5]
        for inject, name_ in ((False, "chain_sweep_tanh"), (True, "chain_sweep_tanh_inject")):
            ext = [t_.clone() for t_ in sweep_cases[quant][6 if inject else 5]]
            h_ = [torch.zeros_like(t_) for t_ in ext]
            post, pre = (r_, l_) if inject else (l_, r_)
            fn_ = chainmm.dual_sweep_tanh_inject if inject else chainmm.dual_sweep_tanh
            flag = True if inject else chainmm.COMBINE_ADD
            n_ = device_launches(lambda: fn_(quant, m_, qu, su, qi_, si_, post, pre, ext, flag,
                                             True, h_))
            sweep_calls[f"{quant} tanh {'inject' if inject else 'forward'}"] = n_
            next(k for k in kernels if k["name"] == name_)[
                f"device_launches_per_sweep_{quant}"] = n_
        # a sweep on (z, amax), as the chain runs it
        ext = [t_.clone() for t_ in sweep_cases[quant][5]]
        n_ = device_launches(lambda: chainmm.dual_sweep(
            quant, m_, *z_inputs[quant][0], *z_inputs[quant][1], l_, r_, ext,
            chainmm.COMBINE_ADD, True))
        sweep_calls[f"{quant} forward on (z, amax)"] = n_
        next(k for k in kernels if k["name"] == "quantize_rows")[
            f"device_launches_per_quantizing_sweep_{quant}"] = n_
    zoo_device = {n_: device_launches(fn_) for n_, fn_ in zoo_calls.items()}
    log("device launches a zoo step (torch.profiler, forward, backward and Adam): "
        + ", ".join(f"{n_} {c_}" for n_, c_ in zoo_device.items()))
    log("device launches a call (torch.profiler, kernels and memsets, the wrapper's fills "
        "included): " + ", ".join(f"{k['name']} {k['device_launches_per_call']}"
                                  for k in kernels if k["name"] in per_call)
        + "; a chain sweep (both sides) " + ", ".join(f"{w} {n_}" for w, n_ in sweep_calls.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
