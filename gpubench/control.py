"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, on the seeds given:

* ``sound``: the program as the configuration states it, against the
  reference, the numbers a run compares;
* ``control``: the program's own path one precision below the stated
  one (``compute_dtype = int8`` for the stated bfloat16), against the
  reference: it has to fail one of the numbers;
* the faults, planted in the reference put in the program's place:
  training ``half_batch`` (each checked step on half its rows, the mean
  taken over them); evaluation ``half_users`` (the metrics over half the
  test users) and ``no_mask`` (the train positives left in the ranking).
  A training step that returns its state unchanged reads 1 on
  ``change`` by definition and needs no run.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 [--skip control]

One JSON line a seed on standard output. The benchmark's own runs never
run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yardstick import drivers, manifest  # noqa: E402
from yardstick.reference import evaluate as ref_eval  # noqa: E402

CONTROL = {"compute_dtype": "int8"}


def train_readings(cell, seed, device, skip):
    ins = drivers.make_inputs(cell, seed, device)
    out, ref = {}, None
    for label, overrides in (("sound", None), ("control", CONTROL)):
        if label in skip:
            continue
        st = drivers.train_setup(cell, ins, device, overrides)
        feed, states, readings = st["feed"], st["states"], st["readings"]
        del st
        drivers.free_program(device)
        if ref is None:
            ref = drivers.follow(cell, ins, feed, states, device)
            out["reference"] = ref
        out[label] = drivers.compare_train(readings, ref)
        out[label]["sampler"] = drivers.check_feed(feed, ins["pairs"],
                                                   cell.config["dataset"]["num_items"])
        out[label + "_readings"] = readings
    if "half_batch" not in skip:
        def half(batch):
            return tuple(t[: t.shape[0] // 2] for t in batch)

        out["half_batch"] = drivers.compare_train(
            drivers.follow(cell, ins, feed, states, device, plant=half), ref)
    return out


def eval_readings(cell, seed, device, skip):
    from idgrec_torch.engine.evaluator import Evaluator

    ins = drivers.make_inputs(cell, seed, device)
    ref = drivers.reference_metrics(cell, ins, device)
    out = {}
    for label, overrides in (("sound", None), ("control", CONTROL)):
        if label in skip:
            continue
        cfg, data, model = drivers.build_program(cell, ins, device, overrides)
        answer = Evaluator(model, data, cfg).evaluate()
        del model, data
        drivers.free_program(device)
        out[label] = {"answer": drivers.answer_gap(answer, ref)}
    tu, ti, su, si = ins["pairs"]
    users = np.unique(su)
    keep = np.isin(su, users[: users.size // 2])
    uf, itf = drivers.reference_repr(cell, ins, device)
    ks = cell.keys.int_list("top_K")
    if "half_users" not in skip:
        half = ref_eval.metrics(uf, itf, tu, ti, su[keep], si[keep], ks)
        out["half_users"] = {"answer": drivers.answer_gap(half, ref)}
    if "no_mask" not in skip:
        empty = np.zeros(0, np.int64)
        unmasked = ref_eval.metrics(uf, itf, empty, empty, su, si, ks)
        out["no_mask"] = {"answer": drivers.answer_gap(unmasked, ref)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--skip", default="", help="comma-separated readings to leave out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    cell = manifest.cell(args.workload)
    skip = set(filter(None, args.skip.split(",")))
    read = train_readings if cell.mix["loop"] == "train_epochs" else eval_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = read(cell, seed, device, skip)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0,
                          **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
