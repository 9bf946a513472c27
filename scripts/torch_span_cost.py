#!/usr/bin/env python3
"""Host cost of one of the program's spans (`engine.profiling.span`),
off and on, in µs a span:

    python3 scripts/torch_span_cost.py [--device cpu]

* off: no profiler records, so a span is the gate and the shared no-op
  object; beside it `torch.profiler.record_function`, also off;
* on: under `torch.profiler.profile` (CPU activity, and CUDA on the
  card), the host record and, on the card, two CUDA events on the
  current stream.

Each figure is the best of five timed loops, less the empty loop's
time. The last line on stdout is one JSON object with the card's name
and power limit beside the figures.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _loop_us(enter, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with enter("cost"):
                pass
        best = min(best, (time.perf_counter() - t) / n * 1e6)
    return best


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from idgrec_torch.engine import profiling

    device = torch.device(args.device)
    card = f"device: {device}"
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.zeros(1, device=device).add_(1)  # the CUDA context, so the spans time on the card
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
        acts.append(ProfilerActivity.CUDA)
    empty = contextlib.nullcontext()
    base = _loop_us(lambda name: empty, 200_000)
    out = {"card": card, "torch": torch.__version__, "empty_loop_us": base,
           "span_off_us": _loop_us(profiling.span, 200_000) - base,
           "record_function_off_us": _loop_us(record_function, 50_000) - base}
    with profile(activities=acts):
        out["span_on_us"] = _loop_us(profiling.span, 2_000) - base
    profiling.clear_spans()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
