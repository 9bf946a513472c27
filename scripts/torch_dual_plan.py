#!/usr/bin/env python3
"""K6 and K7 on the plan of M against their scan, by layout, on one card.

    python3 scripts/torch_dual_plan.py [--widths 64,128,192,2048] [--out FILE]

On the yelp2018-scale dense M (bench.py's synthetic 31,668 x 38,048,
1,237,259 pairs, seed 0; columns padded to 256) it builds the plan
(`fusedmm.dual_plan`, timed), then at each width:

* holds K6 on the plan and K6's scan to `fused_adj_matmul_fixed_plain`
  bit for bit (both directions, and each one-sided launch at d = 128),
  and K7 on the plan and K7's scan to `fused_adj_matmul_int8_plain`;
* times (CUDA events, mean of N launches) the scan, the walk with each
  feature layout a lane can hold at that width (`fusedmm.walk_features`
  overridden: the whole width in one slice, or slices) and each chunk of
  entries a warp, `torch.matmul` x2 on a bfloat16 copy of M and
  `torch._int_mm` x2 (the operands as the library takes them, the copies
  not counted), and the one-sided directions at d = 128;
* the host's side of a launch at d = 64, two-sided and one-sided, on
  the plan and on the scan: microseconds a call to enqueue HOST_CALLS
  calls, and to finish them.

Prints one line a measurement, the card's name and power limit, and
writes every number to ``--out`` (JSON). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

YELP = (31_668, 38_048, 1_237_259, 324_147)
CHUNKS = (64, 128, 256)
ITERS = 10
HOST_CALLS = 200


def log(msg: str) -> None:
    print(f"[dual_plan] {msg}", flush=True)


def cuda_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
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


def layouts(d: int) -> list[int]:
    """Features a lane the walk can take at width d."""
    return [f for f in (1, 2, 3, 4, 6, 8) if d % (32 * f) == 0 and d // (32 * f) <= 64]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="64,128,192,2048")
    ap.add_argument("--out", default="dual_plan.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.ops import _build, fusedmm, propagate

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.build_all(("dual_bf16", "dual_int8_n"))
    log(f"build {time.perf_counter() - t0:.1f} s")
    out = {"card": card, "widths": {}}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # a small matrix first: every layout and chunk bit-equal to the plain version
    small = torch.where(torch.rand(640, 768, device=dev, generator=gen) < 0.05,
                        torch.randint(1, 128, (640, 768), device=dev, generator=gen),
                        0).to(torch.int8)
    small[:, 5] = 3  # a hot column
    sp = fusedmm.dual_plan(small)
    for d in (32, 64, 96, 128, 192, 256):
        zu = torch.randn(600, d, device=dev, generator=gen)
        zi = torch.randn(700, d, device=dev, generator=gen)
        want = fusedmm.fused_adj_matmul_fixed_plain(small, zu, zi)
        for fpl in layouts(d):
            for chunk in CHUNKS:
                fusedmm.walk_features, fusedmm.WALK_CHUNK = (lambda _d, f=fpl: f), chunk
                got = fusedmm.fused_adj_matmul(small, zu, zi, sp)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"small M, d = {d}, {fpl} a lane, chunk {chunk}: "
                                         "the walk differs from the plain version")
        fusedmm.walk_features, fusedmm.WALK_CHUNK = WALK_FEATURES, WALK_CHUNK
        got = fusedmm.fused_adj_matmul(small, zu, zi)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"small M, d = {d}: the scan differs from the plain version")
    log("small M: the walk (every layout and chunk) and the scan equal the plain version")

    data = make_synthetic_dataset(*YELP, seed=0)
    adj = propagate.build_adjacency(data, "sym", "dense", compute_dtype="bfloat16", device=dev)
    m = adj.m
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = fusedmm.dual_plan(m)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    out.update(m_shape=list(m.shape), nnz=plan.nnz, m_bytes=m.numel(), plan_bytes=plan.nbytes,
               plan_build_ms=build_ms)
    log(f"M {list(m.shape)} ({m.numel()} bytes), plan of {plan.nnz} entries: {plan.nbytes} "
        f"bytes, built in {build_ms:.1f} ms")
    m_bf = m.to(torch.bfloat16)
    m_t = m.T.contiguous()
    nu, ni = data.num_users, data.num_items
    u_pad, i_pad = m.shape
    for d in (int(w) for w in args.widths.split(",")):
        row = {}
        zu = torch.randn(nu, d, device=dev, generator=gen) * adj.right_u[:, None]
        zi = torch.randn(ni, d, device=dev, generator=gen) * adj.right_i[:, None]
        want = fusedmm.fused_adj_matmul_fixed_plain(m, zu, zi, plan)
        scan = fusedmm.fused_adj_matmul(m, zu, zi)
        walk = fusedmm.fused_adj_matmul(m, zu, zi, plan)
        row["k6_scan_equal"] = all(torch.equal(a, b) for a, b in zip(scan, want))
        row["k6_plan_equal"] = all(torch.equal(a, b) for a, b in zip(walk, want))
        del scan, walk, want
        row["k6_scan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul(m, zu, zi))
        row["k6_scan_reads"] = fusedmm.fused_adj_matmul.passes
        for fpl in layouts(d):
            for chunk in CHUNKS:
                fusedmm.walk_features, fusedmm.WALK_CHUNK = (lambda _d, f=fpl: f), chunk
                row[f"k6_plan_ms_fpl{fpl}_chunk{chunk}"] = cuda_ms(
                    lambda: fusedmm.fused_adj_matmul(m, zu, zi, plan))
        fusedmm.walk_features, fusedmm.WALK_CHUNK = WALK_FEATURES, WALK_CHUNK
        row["k6_plan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul(m, zu, zi, plan))
        zub, zib = zu.to(torch.bfloat16), zi.to(torch.bfloat16)
        zub_p = torch.nn.functional.pad(zub, (0, 0, 0, u_pad - nu))
        zib_p = torch.nn.functional.pad(zib, (0, 0, 0, i_pad - ni))
        row["matmul_x2_ms"] = cuda_ms(lambda: (m_bf @ zib_p, m_bf.T @ zub_p))
        if d <= 192:
            qu = torch.randint(-127, 128, (u_pad, d), device=dev, generator=gen,
                               dtype=torch.int8)
            qi = torch.randint(-127, 128, (i_pad, d), device=dev, generator=gen,
                               dtype=torch.int8)
            want8 = fusedmm.fused_adj_matmul_int8_plain(m, qu, qi)
            scan8 = fusedmm.fused_adj_matmul_int8(m, qu, qi)
            walk8 = fusedmm.fused_adj_matmul_int8(m, qu, qi, plan)
            row["k7_scan_equal"] = all(torch.equal(a, b) for a, b in zip(scan8, want8))
            row["k7_plan_equal"] = all(torch.equal(a, b) for a, b in zip(walk8, want8))
            del want8, scan8, walk8
            row["k7_scan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8(m, qu, qi))
            for fpl in layouts(d):
                fusedmm.walk_features = lambda _d, f=fpl: f
                row[f"k7_plan_ms_fpl{fpl}"] = cuda_ms(
                    lambda: fusedmm.fused_adj_matmul_int8(m, qu, qi, plan))
            fusedmm.walk_features = WALK_FEATURES
            row["k7_plan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul_int8(m, qu, qi, plan))
            qi_c, qu_c = qi.T.contiguous().T, qu.T.contiguous().T
            row["int_mm_x2_ms"] = cuda_ms(lambda: (torch._int_mm(m, qi_c),
                                                   torch._int_mm(m_t, qu_c)))
            del qu, qi, qi_c, qu_c
        if d == 128:
            for name, a, b in (("rect_ri", None, zi), ("rect_rt", zu, None)):
                want1 = fusedmm.fused_adj_matmul_fixed_plain(m, a, b, plan)
                got1 = fusedmm.fused_adj_matmul(m, a, b, plan)
                row[f"{name}_plan_equal"] = all(
                    (x is None and y is None) or torch.equal(x, y) for x, y in zip(got1, want1))
                row[f"{name}_plan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul(m, a, b, plan))
                row[f"{name}_scan_ms"] = cuda_ms(lambda: fusedmm.fused_adj_matmul(m, a, b))
            row["rect_matmul_ms"] = cuda_ms(lambda: m_bf @ zib_p)
            row["rect_t_matmul_ms"] = cuda_ms(lambda: m_bf.T @ zub_p)
        out["widths"][d] = row
        log(f"d = {d}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in row.items()))
        bad = [k for k, v in row.items() if k.endswith("_equal") and not v]
        if bad:
            raise AssertionError(f"d = {d}: not bit-equal to the plain version: {bad}")
        del zu, zi, zub, zib, zub_p, zib_p
    # the host's side of a launch at d = 64 (EGCF alternating's one-sided
    # launches and LightGCN's two-sided ones): seconds to enqueue HOST_CALLS
    # calls without a synchronisation, then to finish them
    host = {}
    d = 64
    zu = torch.randn(nu, d, device=dev, generator=gen)
    zi = torch.randn(ni, d, device=dev, generator=gen)
    for name, a, b in (("two_sided", zu, zi), ("one_sided", None, zi)):
        for path, p_ in (("plan", plan), ("scan", None)):
            for _ in range(5):
                fusedmm.fused_adj_matmul(m, a, b, p_)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fusedmm.fused_adj_matmul(m, a, b, p_)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host[f"{name}_{path}"] = dict(enqueue_us=(t1 - t0) * 1e6 / HOST_CALLS,
                                          total_us=(t2 - t0) * 1e6 / HOST_CALLS)
    out["host_d64"] = host
    log("host, d = 64 (us a call: enqueue, enqueue and finish): " + ", ".join(
        f"{k} {v['enqueue_us']:.1f} / {v['total_us']:.1f}" for k, v in host.items()))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"card: {card}; wrote {args.out}")
    return 0


if __name__ == "__main__":
    from idgrec_torch.ops import fusedmm as _f

    WALK_FEATURES, WALK_CHUNK = _f.walk_features, _f.WALK_CHUNK
    sys.exit(main())
