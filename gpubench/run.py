"""The benchmark of the PyTorch/CUDA port (``idgrec_torch``) on NVIDIA
GPUs. From the root of a checkout:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and per-layer metrics are data files
under ``gpubench/`` found by name. The run makes its inputs from
``--seed``, warms up (counted in ``setup_s``), measures for
``--seconds``, then checks the timed path's outputs against the plain
reference. With ``--trace 0`` it reports the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a `torch.profiler`
trace of part of the window and from host spans.

The last lines on standard error give each number compared with its
limit; the last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``). Exits non-zero, with no result,
when CUDA or the cards the cell asks for are missing, or when JAX or
the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".gpubench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "idgrec_tpu")

# every compiler cache at a fixed place inside the checkout; the port
# builds its own kernels into idgrec_torch/_build/
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:0] = [BENCH_DIR, ROOT]


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def metrics_of(cell, outcome, trace: bool) -> dict:
    from yardstick import manifest

    if not trace:
        values = {"setup_s": outcome.setup_s, cell.mix["rate"]: outcome.rate}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"]).read(outcome.record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed must be a non-negative whole number")

    import torch

    from yardstick import drivers, manifest, tracing

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    outcome = drivers.run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        log(f"gpubench: the run loaded {found}; the benchmark measures idgrec_torch alone")
        return 3
    card = card_line()
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics_of(cell, outcome, bool(args.trace)),
              "device": device_info, "card": card, "seed": args.seed,
              "window_s": outcome.window_s}
    trace = outcome.record.trace
    if args.trace and trace is not None:
        device_info["busy_s"] = tracing.busy_s(trace)
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": tracing.top(tracing.by_name(trace)),
                               "idle_gaps": tracing.top(tracing.idle_gaps(trace))}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    log(f"card: {card}; setup_s {outcome.setup_s:.3f} ("
        + ", ".join(f"{k} {v:.3f}" for k, v in outcome.setup_phases.items())
        + f"); window_s {outcome.window_s:.3f}; units {outcome.record.units}")
    for name in ("epoch", "sweep"):
        spans = sorted(outcome.record.spans.get(name, []))
        if spans:
            log(f"{name} s: n {len(spans)}, min {spans[0]:.4f}, median "
                f"{spans[len(spans) // 2]:.4f}, max {spans[-1]:.4f}; "
                + " ".join(f"{x:.3f}" for x in outcome.record.spans[name][:12]))
    for k, (v, lim) in outcome.checks.items():
        log(f"check {k}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
