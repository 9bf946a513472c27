#!/usr/bin/env python3
"""Convergence check of the PyTorch/CUDA port: exact bfloat16 against the
quantized modes on learnable data (the port's counterpart of
scripts/quant_parity.py).

    python3 scripts/torch_quant_parity.py [--epochs 40] [--interval 5] [--scale 1.0]
        [--modes bfloat16,int8,int4] [--model LightGCN|EGCF] [--backend auto|dense|fused|gather]
        [--device cuda|cpu] [--out PATH]

Builds `make_latent_synthetic_dataset` at yelp2018 scale times ``--scale``
(31,668 users, 38,048 items, 1,237,259 train and 324,147 test pairs at
1.0; seed 0, named "latent-yelp-scale"), whose train and test pairs come
from one low-rank preference model, so recall rises only if the model
learns. Trains ``--model`` through `engine.loop.train_model` in each
compute mode with the JAX script's config (learn_rate 0.005, reg_lambda
0.0001, 3 layers, d = 64, B = 2,048, early_stopping 100, top_K [20],
train seed 2024; EGCF adds ssl_lambda 0.2, temperature 0.2, mode
parallel) on ``--backend``, and reports each mode's best recall@20 and
NDCG@20, its best epoch, its evaluation curve, its loss curve and its
wall time, with each quantized mode's recall relative to bfloat16's.
On the card, pass ``--backend fused``: bfloat16 then runs kernel K6, the
quantized modes the resident chain (K1 or K5); under ``auto`` bfloat16
resolves to ``dense`` and its float32 block products.

Progress goes to stderr. Stdout carries the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``) and, as the last line, the
result JSON, which ``--out`` also writes (with its directory). Runs on
the card unless ``--device cpu`` is given (the kernels' plain versions;
smoke runs at a small ``--scale``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

YELP = (31_668, 38_048, 1_237_259, 324_147)  # users, items, train, test


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line(device) -> str:
    if device.type != "cuda":
        return f"device: {device}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_config(data_name: str, epochs: int, interval: int, compute_dtype: str, backend: str,
               model: str) -> dict:
    cfg = {
        "dataset": data_name, "top_K": "[20]",
        "training_epochs": str(epochs), "interval": str(interval),
        "early_stopping": "100",
        "embedding_size": "64", "batch_size": "2048",
        "test_batch_size": "2048", "learn_rate": "0.005",
        "reg_lambda": "0.0001", "GCN_layer": "3",
        "compute_dtype": compute_dtype, "propagation_backend": backend,
    }
    if model == "EGCF":
        # the reference configure/EGCF.txt's SSL keys, as the JAX script sets them
        cfg.update({"ssl_lambda": "0.2", "temperature": "0.2", "mode": "parallel"})
    return cfg


def read_events(log_dir: str, model: str, data_name: str) -> tuple[list, list]:
    """(evaluation curve, per-epoch loss terms) from the run's JSONL log."""
    curve, losses = [], []
    with open(os.path.join(log_dir, model, f"{data_name}.jsonl"), encoding="utf-8") as f:
        for line in f:
            ev = json.loads(line)
            if ev["kind"] == "eval":
                curve.append({"epoch": ev["epoch"], "recall@20": ev["recall"][0],
                              "ndcg@20": ev["ndcg"][0]})
            elif ev["kind"] == "train_epoch":
                losses.append(ev["loss_terms"])
    return curve, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--interval", type=int, default=5)
    ap.add_argument("--scale", type=float, default=1.0, help="shrink factor for a smoke run")
    ap.add_argument("--modes", default="bfloat16,int8,int4")
    ap.add_argument("--model", default="LightGCN", choices=["LightGCN", "EGCF"])
    ap.add_argument("--backend", default="auto", choices=["auto", "dense", "fused", "gather"],
                    help="propagation backend; fused on the card (see the module docstring)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON to this path")
    args = ap.parse_args(argv)

    import torch

    from idgrec_torch.config import Config
    from idgrec_torch.data.dataset import make_latent_synthetic_dataset
    from idgrec_torch.device import resolve_device
    from idgrec_torch.engine.loop import train_model

    device = resolve_device(args.device)
    card = card_line(device)
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    log(f"device: {kind}; torch {torch.__version__}")

    s = args.scale
    t0 = time.time()
    data = make_latent_synthetic_dataset(*(int(n * s) for n in YELP), seed=0,
                                         name="latent-yelp-scale")
    log(f"dataset built in {time.time() - t0:.1f}s: {data.get_statistics()}")

    results = {}
    for cdt in args.modes.split(","):
        cfg = Config(run_config(data.name, args.epochs, args.interval, cdt, args.backend,
                                args.model))
        with tempfile.TemporaryDirectory() as log_dir:
            t0 = time.time()
            res = train_model(args.model, data, config=cfg, seed=2024, log_dir=log_dir,
                              echo=False, device=device)
            wall = time.time() - t0
            curve, losses = read_events(log_dir, args.model, data.name)
        results[cdt] = {
            "recall@20": float(res.best.recall[0]),
            "ndcg@20": float(res.best.ndcg[0]),
            "best_epoch": res.best.epoch,
            "wall_s": wall,
            "curve": curve,
            "loss_terms": losses,
        }
        log(f"{cdt}: recall@20 {results[cdt]['recall@20']:.4f}, ndcg@20 "
            f"{results[cdt]['ndcg@20']:.4f}, best epoch {results[cdt]['best_epoch']}, "
            f"{wall:.1f}s; curve {[round(c['recall@20'], 4) for c in curve]}")
    out = {"results": results, "platform": "gpu" if device.type == "cuda" else "cpu",
           "device": kind, "card": card, "torch": torch.__version__, "model": args.model,
           "backend": args.backend, "scale": args.scale, "epochs": args.epochs,
           "interval": args.interval, "dataset": data.get_statistics()}
    base = results.get("bfloat16")
    if base:
        for cdt, r in results.items():
            if cdt != "bfloat16":
                out[f"{cdt}_recall_rel_delta"] = r["recall@20"] / base["recall@20"] - 1.0
    if "int8" in results and "int4" in results:
        out["int4_equals_int8"] = all(results["int4"][k] == results["int8"][k]
                                      for k in ("recall@20", "ndcg@20", "curve", "loss_terms"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "results"}
                     | {"results": {c: {k: v for k, v in r.items() if k not in ("curve",
                                                                                 "loss_terms")}
                                    for c, r in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
