"""Each cell run end to end at a tiny size on the CPU (the port's kernels
replaced by their plain versions), port against reference, untraced and
traced; and on the card, each cell as the benchmark runs it."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import CANDIDATES
from yardstick import drivers, manifest

ROOT = manifest.ROOT
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", CELLS + list(CANDIDATES))
def test_cell_runs_and_is_correct_at_a_tiny_size(name, tiny_cell):
    cell = tiny_cell(name)
    out = drivers.run(cell, 2**31 + 12345, 0.3, False, CPU, time.perf_counter())
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0 and out.rate > 0
    assert set(out.checks) == set(cell.limits)
    assert 0 < out.setup_s and out.window_s >= 0.3


@pytest.mark.parametrize("name", CELLS + list(CANDIDATES))
def test_a_traced_run_is_correct_and_keeps_its_host_spans(name, tiny_cell):
    cell = tiny_cell(name)
    out = drivers.run(cell, 7, 0.3, True, CPU, time.perf_counter())
    assert out.correct, out.checks
    span = "sample_epoch" if cell.mix["loop"] == "train_epochs" else "eval_embeddings"
    assert out.record.spans[span] and all(s > 0 for s in out.record.spans[span])
    # the CPU has no device trace: every device metric is absent, never 0
    for m in cell.per_layer:
        if m["source"] == "device_trace":
            assert manifest.metric_reader(m["name"]).read(out.record) is None


def test_same_seed_same_inputs_other_seed_other_inputs(tiny_cell):
    cell = tiny_cell("recdcl-yelp2018.train")
    a, b, c = (drivers.make_inputs(cell, s, CPU) for s in (5, 5, 6))
    for x, y in zip(a["pairs"], b["pairs"]):
        assert (x == y).all()
    assert all(torch.equal(a["tables"][k], b["tables"][k]) for k in a["tables"])
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert not (a["pairs"][0] == c["pairs"][0]).all()
    # every seed has the configuration's sizes
    assert all(p.size == cell.config["dataset"][k] for p, k in
               zip(c["pairs"][::2], ("num_train", "num_test")))


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                           "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    for trace in ("0", "1"):
        proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", name, "--seed",
                               str(2**31 + 99), "--seconds", "2", "--trace", trace], cwd=ROOT,
                              capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-4000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu" and result["metrics"]
        assert list(result)[-1] == "checks"
        if trace == "1":
            assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
