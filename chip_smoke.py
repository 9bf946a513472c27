#!/usr/bin/env python3
"""Smoke run of the idgrec_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1-K5 from idgrec_torch/csrc and holds
each against its plain PyTorch version at the shapes of the main paths:
LightGCN (d=64, 3 layers, int8 and int4 chains) over the yelp2018-scale
synthetic dataset, random weights from a seed. K5 (the dual product on
the nibble-packed matrix) is also held to K1 on the unpacked matrix, and
the int4 chain, backward chain and one step's gradients to int8's, all
exactly. Then it drives the paths, each with the launch counts set to 0
just before and read just after:

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
  written to a temporary directory.

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
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s
PEAKS = {"H100": (3.35e12, 1979e12)}
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
TIGHT = dict(rtol=3e-5, atol=3e-6)
TIE = 1e-5


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple[float, float, str]:
    for key, (bw, ops) in PEAKS.items():
        if key in name:
            note = "H100 SXM data sheet" + ("" if ("HBM3" in name or "SXM" in name)
                                           else " (assumed for this H100 variant)")
            return bw, ops, note
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
    def eval_embeddings(self):
        from idgrec_torch.models.base import concat_user_item, split_user_item
        from idgrec_torch.ops import chainmm

        m = self.model
        emb0 = concat_user_item(m.user_emb, m.item_emb)
        final = chainmm.fused_chain_resident_plain(m.graph, emb0, m.num_layers)
        return split_user_item(final, m.num_users)

    def score_batch(self, repr_, users):
        return self.model.score_batch(repr_, users)


@contextlib.contextmanager
def plain_kernels(chainmm, scatter):
    """Route the chain and the batch scatter through the kernels' plain
    versions: the reference a training step is held to."""
    saved = chainmm.KERNELS, scatter.scatter_add_rows
    chainmm.KERNELS, scatter.scatter_add_rows = chainmm.PLAIN, scatter.scatter_add_rows_plain
    try:
        yield
    finally:
        chainmm.KERNELS, scatter.scatter_add_rows = saved


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from idgrec_torch import main as cli_main
        from idgrec_torch import serve as cli_serve
        from idgrec_torch.config import default_configure_dir, load_model_config
        from idgrec_torch.data.dataset import make_synthetic_dataset
        from idgrec_torch.engine import checkpoint as ckpt_lib
        from idgrec_torch.engine import loop as loop_lib
        from idgrec_torch.engine import sampler as sampler_lib
        from idgrec_torch.engine.evaluator import BestResults, Evaluator
        from idgrec_torch.engine.trainer import EpochRunner
        from idgrec_torch.models import get_model
        from idgrec_torch.models.base import concat_user_item
        from idgrec_torch.ops import _build, chainmm, fusedmm, losses, propagate, scatter
        from idgrec_torch.serving import Recommender
    except ImportError as e:
        print(f"chip_smoke: the idgrec_torch package is missing beside this script: {e}",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    bw, int8_ops, peak_note = peaks_for(name)
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
    log(f"K1 equals its plain version exactly ({int((yu != 0).sum())} + "
        f"{int((yi != 0).sum())} non-zero sums)")
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
    log(f"K5 equals its plain version and K1 on the unpacked matrix exactly "
        f"({int((yu4 != 0).sum())} + {int((yi4 != 0).sum())} non-zero sums)")
    del yu4_p, yi4_p, yu4_k1, yi4_k1, xi4, zi4

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
    cot_parts = []
    for idx, vals, n_rows in k4_cases:
        got = scatter.scatter_add_rows(idx, vals, n_rows)
        want = scatter.scatter_add_rows_plain(idx, vals, n_rows)
        require(torch.equal(got, want), f"K4 into [{n_rows}, {DIM}] differs from its plain "
                                        f"version: max abs err {max_abs(got, want)}")
        errs["K4"] = max(errs.get("K4", 0.0), max_abs(got, want))
        cot_parts.append(got)
    log(f"K4 equals its plain version exactly ({dup_u} duplicate user rows, {dup_i} duplicate "
        f"item rows in the batch)")
    cot = torch.cat(cot_parts)  # [N, d]: the combine's cotangent of this batch
    del final, rows

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
    del grads_chain, grad_4

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
    int8_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                     chainmm.chain_sweep_inject, propagate.quantize_rows,
                     scatter.scatter_add_rows)
    int4_counters = (fusedmm.fused_adj_matmul_int4_t,) + int8_counters[1:]
    counters = int8_counters + (fusedmm.fused_adj_matmul_int4_t,)

    def reset_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counters}

    serving_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                        propagate.quantize_rows)
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

    ref_rec = Recommender(PlainChainModel(model), data)
    for users, (items, scores) in zip(requests, answers):
        check_answers(ref_rec, data, users, items, scores)
    log(f"served {len(requests)} requests ({', '.join(map(str, REQUEST_SIZES))} users, "
        f"k={K}): checked against the plain path")

    # ---- times, per sweep of the chain, beside bounds
    d = DIM

    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        tb, to = nbytes / bw * 1e3, ops / int8_ops * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    k1_bytes = u_pad * i_pad + d * (u_pad + i_pad) + 4 * d * (u_pad + i_pad)
    k1_bound = bound(k1_bytes, 4.0 * u_pad * i_pad * d)
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
    k5_bound = bound(k5_bytes, 4.0 * u_pad * i_pad4 * d)
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

    def k4_pair(fn):
        for idx, vals, n_rows in k4_cases:
            fn(idx, vals, n_rows)

    def index_add(idx, vals, n_rows):
        return torch.zeros((n_rows, d), device=dev).index_add_(0, idx, vals)

    # idx (int64) and vals read, the table written
    k4_bound = bound(sum(8.0 * idx.numel() + 4.0 * vals.numel() + 4.0 * n_rows * d
                         for idx, vals, n_rows in k4_cases),
                     sum(float(vals.numel()) for _, vals, _ in k4_cases))
    k4_ms = cuda_ms(lambda: k4_pair(scatter.scatter_add_rows), 50)
    k4_plain = cuda_ms(lambda: k4_pair(scatter.scatter_add_rows_plain), 10)
    k4_lib = cuda_ms(lambda: k4_pair(index_add), 50)
    for idx, vals, n_rows in k4_cases:
        assert_close(index_add(idx, vals, n_rows), scatter.scatter_add_rows(idx, vals, n_rows),
                     "index_add_ against K4", rtol=1e-5, atol=1e-9)

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
    log(f"backward chain (3 sweeps, K3/K1/K2-inject): {bwd_chain_ms:.3f} ms; int4 "
        f"(K3/K5/K2-inject, the item side's pad included): {bwd_chain4_ms:.3f} ms")

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

    n_steps = EPOCHS * steps

    def entry(name_, source, replaces, fn, err, ms, plain, bnd, lib, unit):
        by_path = {"serving": launches, "training": train_launches,
                   "int4_epoch": int4_epoch_launches, "run_harness": harness_launches,
                   "command_lines": cli_launches}
        counts = {path: c[fn.__name__] for path, c in by_path.items()}
        # per training step of the mode the kernel serves (the eval
        # sweep's chain included in the int8 count)
        per_step = (counts["int4_epoch"] / steps if fn is fusedmm.fused_adj_matmul_int4_t
                    else counts["training"] / n_steps)
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(counts.values()), "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib, "unit": unit,
                **{f"launches_{path}": n for path, n in counts.items()},
                "launches_per_step": per_step}

    k2_src = "idgrec_torch/csrc/chain_sweep_epilogue.cu"
    kernels = [
        entry("dual_int8_t", "idgrec_torch/csrc/dual_int8_t.cu", "idgrec_tpu/ops/fusedmm.py:674",
              fusedmm.fused_adj_matmul_int8_t, errs["K1"], k1_ms, k1_plain, k1_bound, k1_lib,
              "one sweep: 1 launch"),
        entry("dual_int4_t", "idgrec_torch/csrc/dual_int4_t.cu", "idgrec_tpu/ops/fusedmm.py:708",
              fusedmm.fused_adj_matmul_int4_t, errs["K5"], k5_ms, k5_plain, k5_bound, k5_lib,
              "one sweep on the nibble-packed matrix: 1 launch"),
        entry("chain_sweep_epilogue", k2_src, "idgrec_tpu/ops/chainmm.py:322",
              chainmm.chain_sweep_epilogue, errs["K2"], k2_ms, k2_plain, k2_bound, None,
              "one sweep: 2 launches (users, items)"),
        entry("chain_sweep_inject", k2_src, "idgrec_tpu/ops/chainmm.py:341",
              chainmm.chain_sweep_inject, errs["K2i"], k2i_ms, k2i_plain, k2i_bound, None,
              "one backward sweep: 2 launches (users, items)"),
        entry("quantize_rows", "idgrec_torch/csrc/quantize_rows.cu",
              "idgrec_tpu/ops/chainmm.py:236", propagate.quantize_rows, errs["K3"], k3_ms,
              k3_plain, k3_bound, k3_lib, "one sweep: 2 launches (users, items)"),
        entry("scatter_add_rows", "idgrec_torch/csrc/scatter_add_rows.cu",
              "idgrec_tpu/ops/scatter.py:40", scatter.scatter_add_rows, errs["K4"], k4_ms,
              k4_plain, k4_bound, k4_lib,
              "one step: 2 launches (2,048 rows into the user table, 4,096 into the item table)"),
    ]
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms by {k['bound_by']}, "
            f"plain {k['plain_ms']:.4f} ms, library {k['library_ms']}), "
            f"launches: {k['launches_serving']} serving, {k['launches_training']} training, "
            f"{k['launches_int4_epoch']} int4 epoch, {k['launches_run_harness']} run harness, "
            f"{k['launches_command_lines']} command lines ({k['launches_per_step']:.2f} per step)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
