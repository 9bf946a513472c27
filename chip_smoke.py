#!/usr/bin/env python3
"""Smoke run of the idgrec_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels K1-K4 from idgrec_torch/csrc and holds
each against its plain PyTorch version at the shapes of the main paths:
LightGCN (d=64, 3 layers, int8 chain) over the yelp2018-scale synthetic
dataset, random weights from a seed. Then it drives both paths:

* serving: `serving.Recommender` answers four requests, checked against
  the plain path;
* training: `NegativeSampler.sample_epoch`, two full epochs of
  `EpochRunner.run_epoch` (605 steps of 2,048 triples each),
  `Evaluator.evaluate`, `BestResults`; the backward chain and one
  step's gradients are held to the plain path first.

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
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# yelp2018 scale as bench.py builds it (users, items, train, test; seed 0)
YELP = (31_668, 38_048, 1_237_259, 324_147)
DIM, LAYERS, K = 64, 3, 20
DEVICE = "cuda"
REQUEST_SIZES = (1, 17, 256, 2048)
BATCH, EPOCHS, TOP_KS = 2048, 2, (10, 20)
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s
PEAKS = {"H100": (3.35e12, 1979e12)}
# tolerances: K1's raw integer products, K3's scales and integers, the
# 3-layer chain and the served scores are equal to the plain versions'
# (K2 is built with -fmad=false and keeps the plain operation order);
# K2 within TIGHT; served ids equal except among scores tied within TIE.
# K2's inject mode, K4 (no atomics, batch order), the 3-layer backward
# chain and one training step's gradients and loss terms are equal to
# the plain versions'.
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
        from idgrec_torch.config import load_model_config
        from idgrec_torch.data.dataset import make_synthetic_dataset
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

    emb0 = concat_user_item(model.user_emb, model.item_emb).detach()
    chain_k = chainmm.fused_chain_resident(adj, emb0, LAYERS)
    chain_p = chainmm.fused_chain_resident_plain(adj, emb0, LAYERS)
    require(tuple(chain_k.shape) == (nu + ni, DIM), f"chain shape {tuple(chain_k.shape)}")
    require(bool(torch.isfinite(chain_k).all()), "non-finite chain output")
    require(torch.equal(chain_k, chain_p),
            f"3-layer chain differs from the plain chain: max abs err {max_abs(chain_k, chain_p)}")
    log("3-layer chain equals the plain chain")
    del chain_k, chain_p

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
    for fn in (chainmm.fused_chain_resident, chainmm.fused_chain_resident_plain):
        x = emb0.clone().requires_grad_(True)
        fn(adj, x, LAYERS).backward(cot)
        grads_chain.append(x.grad)
    require(bool(torch.isfinite(grads_chain[0]).all()) and bool(grads_chain[0].abs().sum() > 0),
            "backward chain: non-finite or all-zero gradient")
    require(torch.equal(*grads_chain), f"3-layer backward chain differs from the plain backward "
                                       f"chain: max abs err {max_abs(*grads_chain)}")
    log(f"3-layer backward chain equals the plain backward chain "
        f"({int((grads_chain[0] != 0).sum())} non-zero gradients)")
    del grads_chain

    def step_grads():
        model.zero_grad(set_to_none=True)
        bpr, reg = model.loss_terms(batch)
        (bpr + reg).backward()
        out = (model.user_emb.grad.clone(), model.item_emb.grad.clone(), bpr.detach(), reg.detach())
        model.zero_grad(set_to_none=True)
        return out

    got_step = step_grads()
    with plain_kernels(chainmm, scatter):
        want_step = step_grads()
    for what, a, b in zip(("d user_emb", "d item_emb", "bpr", "reg"), got_step, want_step):
        require(bool(torch.isfinite(a).all()), f"one step, {what}: not finite")
        require(torch.equal(a, b), f"one step, {what}: kernel path differs from the plain path, "
                                   f"max abs err {max_abs(a, b)}")
    log(f"one training step: gradients and loss terms equal the plain path's "
        f"(bpr {float(got_step[2]):.6f}, reg {float(got_step[3]):.3e})")
    del got_step, want_step

    # ---- the main path: construct the server and answer requests
    counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                chainmm.chain_sweep_inject, propagate.quantize_rows, scatter.scatter_add_rows)
    serving_counters = (fusedmm.fused_adj_matmul_int8_t, chainmm.chain_sweep_epilogue,
                        propagate.quantize_rows)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = Recommender(model, data)
    torch.cuda.synchronize()
    first_embed_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(0)
    requests = [rng.choice(data.num_users, size=b, replace=False) for b in REQUEST_SIZES]
    answers = [rec.recommend(users, k=K) for users in requests]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
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
    k1_lib = None
    try:
        m_cols = adj.m8.t().contiguous().t()  # column-major copy for the second product
        lib_fn = lambda: (torch._int_mm(qi, adj.m8.t()), torch._int_mm(qu, m_cols))  # noqa: E731
        got = lib_fn()
        if torch.equal(got[0].float(), yu) and torch.equal(got[1].float(), yi):
            k1_lib = cuda_ms(lib_fn, 10)
        else:
            log("torch._int_mm disagrees with K1: no library time")
        del m_cols, got
    except RuntimeError as e:  # the library call is a yardstick only
        log(f"torch._int_mm does not take these shapes: {str(e).splitlines()[0]}")

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
    req_ms = {b: host_ms(lambda u=users: rec.recommend(u, k=K), 5)
              for b, users in zip(REQUEST_SIZES, requests)}
    log(f"eval embeddings: {embed_ms:.3f} ms (first, inside the constructor: "
        f"{first_embed_ms:.3f} ms); per request: "
        + ", ".join(f"{b} users {t:.3f} ms" for b, t in req_ms.items()))
    bwd_chain_ms = host_ms(lambda: chainmm._run_chain_bwd(adj, gu, gi, LAYERS, True,
                                                          chainmm.KERNELS), 5)
    log(f"backward chain (3 sweeps, K3/K1/K2-inject): {bwd_chain_ms:.3f} ms")

    # ---- the training path: sample, two epochs, evaluate
    lr = cfg.float("learn_rate")
    runner = EpochRunner(model, lr, BATCH, data.num_train)
    evaluator = Evaluator(model, data, cfg)
    best = BestResults(patience=cfg.int("early_stopping"))
    steps = runner.num_batches
    require(steps == -(-data.num_train // BATCH), f"{steps} steps per epoch")
    row_ptr_d, col_idx_d = neg_sampler.row_ptr, neg_sampler.col_idx
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
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
    train_launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"training path launches: {train_launches}")
    for fn in counters:
        require(fn.launches > 0, f"{fn.__name__} was never launched on the training path")

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

    n_steps = EPOCHS * steps

    def entry(name_, source, replaces, fn, err, ms, plain, bnd, lib, unit):
        served, trained = launches.get(fn.__name__, 0), train_launches[fn.__name__]
        return {"name": name_, "route": "cuda", "source": source, "replaces": replaces,
                "launches": served + trained, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib, "unit": unit,
                "launches_serving": served, "launches_training": trained,
                "launches_per_step": trained / n_steps}

    k2_src = "idgrec_torch/csrc/chain_sweep_epilogue.cu"
    kernels = [
        entry("dual_int8_t", "idgrec_torch/csrc/dual_int8_t.cu", "idgrec_tpu/ops/fusedmm.py:674",
              fusedmm.fused_adj_matmul_int8_t, errs["K1"], k1_ms, k1_plain, k1_bound, k1_lib,
              "one sweep: 1 launch"),
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
            f"launches: {k['launches_serving']} serving, {k['launches_training']} training "
            f"({k['launches_per_step']:.2f} per step, the eval sweep's included)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
