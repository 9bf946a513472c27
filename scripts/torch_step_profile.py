#!/usr/bin/env python3
"""Where one training step of the port spends its time, on one NVIDIA
GPU, for a ported model in any compute mode.

    python3 scripts/torch_step_profile.py [--model LightGCN|EGCF|MFBPR|DirectAU|MAWU|SCCF|
        LightCCF|LightCSCF|SimGCL|XSimGCL|LightGCN_pp|BIGCF|MixRec|CGCL|NCL|HCCF|IMPGCN|
        NGCF|GCMC|GCCF|LightGODE|RecDCL|LightGCL|CVGA|SGL]
        [--steps 40] [--compute_dtype int8|int4|bfloat16|float32]
        [--backend auto|dense|fused|gather|bitpack] [--batch_rows]
        [--mode parallel|alternating] [--embedding_size D] [--root DIR]

Builds the model of chip_smoke.py (its config file's loss weights and
width, d = 64, RecDCL 2,048, unless ``--embedding_size`` says otherwise
(LightGCN and EGCF 64; 128 takes int8 and int4 to the per-application
loop); LightGCN and EGCF 3 layers, the zoo its config's: IMPGCN 6, GCMC
1, RecDCL 2, LightGODE one application under its MF_init, LightGCL 2
on the rectangular adjacency, CVGA its one encoder product at 2d) on
the synthetic set at the scale of the dataset its config names: yelp2018
(LightGCN, EGCF, MFBPR, DirectAU, MAWU, SCCF, SimGCL, XSimGCL,
LightGCN_pp, BIGCF, CGCL, NCL, HCCF, IMPGCN, NGCF, GCMC, GCCF,
LightGODE, RecDCL, LightGCL, CVGA, SGL) or amazon-book (LightCCF,
LightCSCF, MixRec). CVGA's batches are user rows (a permutation of the user ids,
as the training loop feeds it) and LightGCL's SVD is taken when the
model is built (its host seconds are printed). LightGCN and EGCF run int8
and batch 2,048 unless told otherwise, the zoo its config's compute
dtype (bfloat16) and batch size. A step's noise comes from a CUDA
generator seeded 0. NCL steps past its warm-up: its k-means runs first
(timed on the host clock, ending in a synchronize) and its steps take
the prototype term. SGL draws its epoch's edge-dropout views first
(`epoch_context`, timed the same way): its steps run the shared chain
at 3d on `dense`, or with ``--compute_dtype int8`` / ``int4`` (`auto`
then resolves to `fused`) the quantized views at 3d. ``--batch_rows`` sets
LightGCN's ``batch_rows_propagation = 1``, ``--mode alternating`` EGCF's
ping-pong over the rectangular adjacency. It warms up, then

* times the step's phases on the host clock, each ending in a
  synchronize (forward to the loss, backward, Adam), and the whole step
  unsynchronized, as the trainer runs it;
* traces the same number of steps with `torch.profiler` and prints the
  device time by kernel name (the JSON holds every kernel's time and
  launches a step), the device launches per step (kernels, memsets and
  copies) and the device's busy share of the traced window and of the
  untraced step (the profiler slows the host). If
  the profiler records no device time on this machine it says so and
  the phases above stand alone.

``--root`` names the tree whose ``idgrec_torch`` is profiled (default:
this one), so an earlier commit's checkout can be profiled by the same
script. Prints progress lines, the card's name and power limit, and one
JSON object last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# users, items, train and test pairs at the scale of each dataset a config
# names (bench.py)
SCALES = {"yelp2018": (31_668, 38_048, 1_237_259, 324_147),
          "amazon-book": (52_643, 91_599, 2_380_730, 603_378)}
MODELS = ("LightGCN", "EGCF", "MFBPR", "DirectAU", "MAWU", "SCCF", "LightCCF", "LightCSCF",
          "SimGCL", "XSimGCL", "LightGCN_pp", "BIGCF", "MixRec", "CGCL", "NCL", "HCCF",
          "IMPGCN", "NGCF", "GCMC", "GCCF", "LightGODE", "RecDCL", "LightGCL", "CVGA", "SGL")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="LightGCN", choices=MODELS)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--compute_dtype", default=None,
                        choices=["int8", "int4", "bfloat16", "float32"])
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "dense", "fused", "gather", "bitpack"])
    parser.add_argument("--batch_rows", action="store_true")
    parser.add_argument("--mode", default="parallel", choices=["parallel", "alternating"],
                        help="EGCF's propagation mode")
    parser.add_argument("--embedding_size", type=int, default=None,
                        help="default: 64 for LightGCN and EGCF, the config's for the zoo")
    parser.add_argument("--root", default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from idgrec_torch.config import load_model_config
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.engine.sampler import NegativeSampler
    from idgrec_torch.engine.trainer import EpochRunner
    from idgrec_torch.models import get_model
    from idgrec_torch.ops import _build

    steps = args.steps
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    cfg = load_model_config(args.model)
    ours = args.model in ("LightGCN", "EGCF")
    dtype = args.compute_dtype or ("int8" if ours else cfg.str("compute_dtype"))
    batch_size = 2048 if ours else cfg.int("batch_size")
    scale = cfg.str("dataset")
    data = make_synthetic_dataset(*SCALES[scale], seed=0, name=f"{scale}-scale")
    if args.embedding_size is None:
        args.embedding_size = 64 if ours else cfg.int("embedding_size")
    cfg = cfg.updated(embedding_size=args.embedding_size,
                      GCN_layer=3 if ours else cfg.int("GCN_layer", 3), compute_dtype=dtype,
                      propagation_backend=args.backend,
                      batch_rows_propagation=int(args.batch_rows), batch_size=batch_size)
    if args.model == "EGCF":
        cfg = cfg.updated(mode=args.mode)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    model = get_model(args.model)(cfg, data, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    # NCL past its warm-up: the epoch's clustering, then steps with the
    # prototype term
    epoch = cfg.int("warmup_epochs") if args.model == "NCL" else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.epoch_context(epoch, np.random.default_rng(0))
    torch.cuda.synchronize()
    context_ms = (time.perf_counter() - t0) * 1e3
    if model.batching == "user_rows":
        from idgrec_torch.ops import noise

        users = pos = neg = noise.permutation(data.num_users, gen)
    else:
        users, pos, neg = NegativeSampler(data).sample_epoch(gen)
    if hasattr(model, "svd_seconds"):
        print(f"LightGCL's SVD: {model.svd_seconds:.2f} s on the host", flush=True)
    n = (2 * steps + 10) * batch_size
    runner = EpochRunner(model, cfg.float("learn_rate"), batch_size, n)
    batches = runner._prepare(users[:n], pos[:n], neg[:n])

    def batch(i):
        return {k: v[i] for k, v in batches.items()}

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def step(i):
        runner.opt.zero_grad(set_to_none=True)
        sum(model.loss_terms(batch(i), gen, epoch)).backward()
        runner.opt.step()

    for i in range(10):
        step(i)
    phases = {"forward": [], "backward": [], "adam": []}
    for i in range(10, 10 + steps):
        runner.opt.zero_grad(set_to_none=True)
        terms, ms = sync_ms(lambda: model.loss_terms(batch(i), gen, epoch))
        phases["forward"].append(ms)
        phases["backward"].append(sync_ms(lambda: sum(terms).backward())[1])
        phases["adam"].append(sync_ms(runner.opt.step)[1])
    phase_ms = {k: float(np.median(v)) for k, v in phases.items()}
    _, whole = sync_ms(lambda: [step(i) for i in range(10 + steps, 10 + 2 * steps)])
    step_ms = whole / steps
    print(f"phases (median of {steps}, each synchronized): {phase_ms}; "
          f"unsynchronized step {step_ms:.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10, 10 + steps):
            step(i)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, calls = {}, {}
    n_device = 0  # the kernels, memsets and copies the steps put on the device
    for ev in prof.events():
        # device-side events; the optimizer's annotation spans its kernels
        # and would count them twice
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if on_device and not ev.name.startswith("Optimizer."):
            n_device += 1
            t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            name = ev.name[:90]
            by_kernel[name] = by_kernel.get(name, 0.0) + t / 1e3
            calls[name] = calls.get(name, 0) + 1
    device_ms = sum(by_kernel.values())
    result = {"card": card, "root": os.path.abspath(args.root), "model": args.model,
              "dataset": data.name, "batch_size": batch_size,
              "compute_dtype": dtype, "backend": args.backend,
              "batch_rows": args.batch_rows, "embedding_size": args.embedding_size,
              "mode": args.mode if args.model == "EGCF" else None,
              "steps": steps, "epoch": epoch, "epoch_context_ms": context_ms,
              "phase_ms": phase_ms, "step_ms": step_ms,
              "profiled_window_ms": window_ms, "device_ms_in_window": device_ms,
              "device_launches_per_step": n_device / steps}
    if device_ms <= 0:
        print("torch.profiler recorded no device time on this machine", flush=True)
        result["device_busy_share_traced"] = None
    else:
        # the profiler slows the host, so the share of the traced window
        # understates the untraced step: give the device time beside both
        result["device_busy_share_traced"] = device_ms / window_ms
        result["device_ms_per_step"] = device_ms / steps
        result["device_share_of_untraced_step"] = device_ms / steps / step_ms
        ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        result["device_ms_per_step_by_kernel"] = {k: v / steps for k, v in ranked}
        result["launches_per_step_by_kernel"] = {k: calls[k] / steps for k, _ in ranked}
        for k, v in ranked[:15]:
            print(f"  {v / steps:8.4f} ms/step  {k}", flush=True)
        print(f"device time {device_ms / steps:.3f} ms per step: {device_ms / window_ms:.3f} of "
              f"the traced window ({window_ms / steps:.3f} ms per step under the profiler), "
              f"{device_ms / steps / step_ms:.3f} of the untraced step; {n_device / steps:.1f} "
              "device launches per step", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
