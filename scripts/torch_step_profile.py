#!/usr/bin/env python3
"""Where one LightGCN training step of the port spends its time, on one
NVIDIA GPU, in any compute mode.

    python3 scripts/torch_step_profile.py [--steps 40]
        [--compute_dtype int8|int4|bfloat16|float32] [--backend auto|dense|fused|gather]

Builds the yelp2018-scale model of chip_smoke.py, warms up, then

* times the step's phases on the host clock, each ending in a
  synchronize (forward to the loss, backward, Adam), and the whole step
  unsynchronized, as the trainer runs it;
* traces the same number of steps with `torch.profiler` and prints the
  device time by kernel name and the device's busy share of the traced
  window and of the untraced step (the profiler slows the host). If
  the profiler records no device time on this machine it says so and
  the phases above stand alone.

Prints progress lines, the card's name and power limit, and one JSON
object last.
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
sys.path.insert(0, ROOT)

from idgrec_torch.config import load_model_config  # noqa: E402
from idgrec_torch.data.dataset import make_synthetic_dataset  # noqa: E402
from idgrec_torch.engine.sampler import NegativeSampler  # noqa: E402
from idgrec_torch.engine.trainer import EpochRunner  # noqa: E402
from idgrec_torch.models import get_model  # noqa: E402
from idgrec_torch.ops import _build  # noqa: E402

YELP = (31_668, 38_048, 1_237_259, 324_147)
BATCH = 2048


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--compute_dtype", default="int8",
                        choices=["int8", "int4", "bfloat16", "float32"])
    parser.add_argument("--backend", default="auto", choices=["auto", "dense", "fused", "gather"])
    args = parser.parse_args()
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
    data = make_synthetic_dataset(*YELP, seed=0, name="yelp2018-scale")
    cfg = load_model_config("LightGCN").updated(embedding_size=64, GCN_layer=3,
                                                compute_dtype=args.compute_dtype,
                                                propagation_backend=args.backend,
                                                batch_size=BATCH)
    model = get_model("LightGCN")(cfg, data, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    users, pos, neg = NegativeSampler(data).sample_epoch(gen)
    n = (2 * steps + 10) * BATCH
    runner = EpochRunner(model, cfg.float("learn_rate"), BATCH, n)
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
        bpr, reg = model.loss_terms(batch(i))
        (bpr + reg).backward()
        runner.opt.step()

    for i in range(10):
        step(i)
    phases = {"forward": [], "backward": [], "adam": []}
    for i in range(10, 10 + steps):
        runner.opt.zero_grad(set_to_none=True)
        terms, ms = sync_ms(lambda: model.loss_terms(batch(i)))
        phases["forward"].append(ms)
        phases["backward"].append(sync_ms(lambda: (terms[0] + terms[1]).backward())[1])
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
    by_kernel = {}
    for ev in prof.events():
        # device-side events; the optimizer's annotation spans its kernels
        # and would count them twice
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if on_device and not ev.name.startswith("Optimizer."):
            t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            name = ev.name[:90]
            by_kernel[name] = by_kernel.get(name, 0.0) + t / 1e3
    device_ms = sum(by_kernel.values())
    result = {"card": card, "compute_dtype": args.compute_dtype, "backend": args.backend, "steps": steps, "phase_ms": phase_ms, "step_ms": step_ms,
              "profiled_window_ms": window_ms, "device_ms_in_window": device_ms}
    if device_ms <= 0:
        print("torch.profiler recorded no device time on this machine", flush=True)
        result["device_busy_share_traced"] = None
    else:
        # the profiler slows the host, so the share of the traced window
        # understates the untraced step: give the device time beside both
        result["device_busy_share_traced"] = device_ms / window_ms
        result["device_ms_per_step"] = device_ms / steps
        result["device_share_of_untraced_step"] = device_ms / steps / step_ms
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
        result["device_ms_per_step_by_kernel"] = {k: v / steps for k, v in top}
        for k, v in top:
            print(f"  {v / steps:8.4f} ms/step  {k}", flush=True)
        print(f"device time {device_ms / steps:.3f} ms per step: {device_ms / window_ms:.3f} of "
              f"the traced window ({window_ms / steps:.3f} ms per step under the profiler), "
              f"{device_ms / steps / step_ms:.3f} of the untraced step", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
