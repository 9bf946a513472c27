#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: LightGCN training throughput at
yelp2018 scale (the run of the JAX package's bench.py, in idgrec_torch).

    python3 scripts/torch_bench.py [--quick] [--compute_dtype best|int8|int4|bfloat16|float32]
                                   [--backend auto|dense|fused|gather]

Builds the synthetic dataset at exactly yelp2018 scale (31,668 users /
38,048 items / 1,237,259 train interactions, seed 0), trains LightGCN
(3 layers, d = 64, B = 2,048) through `NegativeSampler`, `EpochRunner`
and the hand-written kernels, and evaluates twice. Work per epoch:
sampling and shuffle on the device, 605 steps of full-graph propagation
(3 sweeps forward, 3 backward) and Adam.

``--compute_dtype best`` (the default) trains one warm-up and one trial
epoch in int8 and in int4, keeps the faster and drops the other's
adjacency before the timed epochs. int4 is a bit-identical nibble-unpack
of the int8 arithmetic, so the choice changes the time and nothing else.
``--compute_dtype bfloat16`` or ``float32`` times an exact mode on the
backend ``--backend`` names (``auto`` resolves to dense when the matrix
fits); the exact modes are not candidates of ``best``.

Progress goes to stderr. Stdout carries the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and, as the last line,

    {"metric": "lightgcn_yelp2018scale_train_pairs_per_sec", "value": N, "unit": "pairs/s"}

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions; for smoke runs with ``--quick``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

SCALES = {
    # users, items, train, test
    "quick": (2000, 3000, 60_000, 10_000),
    "yelp2018": (31_668, 38_048, 1_237_259, 324_147),
    "amazon-book": (52_643, 91_599, 2_380_730, 603_378),
}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line(device) -> str:
    if device.type != "cuda":
        return f"device: {device}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="small scale smoke run")
    parser.add_argument("--scale", default="yelp2018", choices=["yelp2018", "amazon-book"],
                        help="synthetic dataset scale (public stats of the named set)")
    parser.add_argument("--epochs", type=int, default=3, help="timed epochs")
    parser.add_argument("--batch_size", "--batch-size", type=int, default=2048)
    parser.add_argument("--layers", type=int, default=3)
    parser.add_argument("--emb", type=int, default=64)
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "dense", "fused", "gather"], help="propagation backend")
    parser.add_argument("--compute_dtype", "--compute-dtype", default="best",
                        choices=["best", "int8", "int4", "bfloat16", "float32"],
                        help="best trains one trial epoch in int8 and in int4 and keeps the "
                             "faster; bfloat16 and float32 are the exact modes")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from idgrec_torch.config import Config
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.device import resolve_device
    from idgrec_torch.engine.evaluator import Evaluator
    from idgrec_torch.engine.profiling import ThroughputMeter
    from idgrec_torch.engine.sampler import NegativeSampler
    from idgrec_torch.engine.trainer import EpochRunner
    from idgrec_torch.models import get_model

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = card_line(device)
    print(card, flush=True)
    log(f"device: {torch.cuda.get_device_name(0) if on_card else 'cpu'}; torch {torch.__version__}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.time()
    data = make_synthetic_dataset(
        *SCALES["quick" if args.quick else args.scale], seed=0,
        name="yelp2018-scale" if args.quick else f"{args.scale}-scale")
    log(f"dataset built in {time.time() - t0:.1f}s: {data.get_statistics()}")

    sampler = NegativeSampler(data, device=device)

    def make_setup(compute_dtype):
        cfg = Config({
            "dataset": data.name,
            "top_K": "[10, 20]",
            "embedding_size": str(args.emb),
            "batch_size": str(args.batch_size),
            "test_batch_size": "2048",
            "learn_rate": "0.001",
            "reg_lambda": "0.0001",
            "GCN_layer": str(args.layers),
            "propagation_backend": args.backend,
            "compute_dtype": compute_dtype,
        })
        model = get_model("LightGCN")(cfg, data, device=device,
                                      generator=torch.Generator().manual_seed(2024))
        runner = EpochRunner(model, cfg.float("learn_rate"), args.batch_size, data.num_train)
        gen = torch.Generator(device=device).manual_seed(2024)

        def one_epoch(epoch):
            users, pos, neg = sampler.sample_epoch(gen)
            terms = runner.run_epoch(users, pos, neg, generator=gen, epoch=epoch)
            return terms.cpu().numpy()  # waits for the device

        return {"cfg": cfg, "model": model, "runner": runner, "one_epoch": one_epoch}

    candidates = ["int8", "int4"] if args.compute_dtype == "best" else [args.compute_dtype]
    trials = {}
    for cand in candidates:
        # the whole candidate is fallible: a mode can fail at setup (counts
        # above a nibble) or when its kernel builds; the others still run
        try:
            su = make_setup(cand)
            t0 = time.time()
            terms = su["one_epoch"](0)
            log(f"mode {cand}: warmup epoch (kernel build included) {time.time() - t0:.1f}s, "
                f"loss terms {[float(t) for t in terms]}")
            trial_s = 0.0
            if len(candidates) > 1:
                t0 = time.time()
                su["one_epoch"](1)
                trial_s = time.time() - t0
                log(f"mode {cand}: trial epoch {trial_s:.3f}s")
            trials[cand] = (trial_s, su)
        except Exception as e:  # noqa: BLE001 - reported, and fatal when no mode is left
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            log(f"mode {cand}: failed ({type(e).__name__}: {msg}), skipped")
        su = terms = None  # `trials` holds the only reference, so the loser can be dropped
    if not trials:
        raise SystemExit("no benchmark mode could be set up")
    chosen = min(trials, key=lambda k: trials[k][0])
    if len(trials) > 1:
        log(f"chosen mode: {chosen} ({ {k: round(v[0], 3) for k, v in trials.items()} })")
    setup = trials[chosen][1]
    # drop the loser's adjacency and tables before the timed epochs
    trials.clear()
    if on_card:
        torch.cuda.empty_cache()
    cfg, model, one_epoch = setup["cfg"], setup["model"], setup["one_epoch"]

    per_epoch = []
    sync()
    t0 = time.time()
    for e in range(args.epochs):
        t1 = time.time()
        one_epoch(e + 1)
        per_epoch.append(time.time() - t1)
        log(f"epoch {e + 1}: {per_epoch[-1]:.3f}s")
    epoch_time = (time.time() - t0) / max(args.epochs, 1)
    if len(per_epoch) > 1:
        log(f"epoch time min/median/max: {min(per_epoch):.3f}/"
            f"{sorted(per_epoch)[len(per_epoch) // 2]:.3f}/{max(per_epoch):.3f}s")

    meter = ThroughputMeter(
        num_train=data.num_train, nnz=data.nnz, emb_size=args.emb, num_layers=args.layers,
        steps_per_epoch=setup["runner"].num_batches)
    rates = meter.rates(epoch_time)
    log(f"propagation: {rates['sparse_gflops']:.1f} sparse-GFLOP/s (algorithmic)")
    pairs_per_sec = data.num_train / epoch_time
    log(f"mode {chosen}: epoch time {epoch_time:.3f}s, {pairs_per_sec:,.0f} pairs/s")

    evaluator = Evaluator(model, data, cfg)
    for label in ("first", "steady"):
        sync()
        t0 = time.time()
        result = evaluator.evaluate()
        sync()
        log(f"eval sweep ({label}) {time.time() - t0:.3f}s recall@20={result['recall'][1]:.4f}")

    scale_tag = ("yelp2018scale" if (args.quick or args.scale == "yelp2018")
                 else args.scale.replace("-", ""))
    print(card, flush=True)
    print(json.dumps({"metric": f"lightgcn_{scale_tag}_train_pairs_per_sec",
                      "value": round(pairs_per_sec, 1), "unit": "pairs/s"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
