"""Tests of the benchmark's harness. Run from the checkout's root:

    python -m pytest gpubench/tests -q

CPU tests run the cells at a tiny size, the port's kernels replaced by
their plain versions. Tests marked ``cuda`` need a card and skip
without one; on the card run them with ``--noconftest`` absent (this
file registers the marker)."""

from __future__ import annotations

import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

# a cell's data at a size a test can hold; batches shrink with it
TINY = {"num_users": 300, "num_items": 500, "num_train": 6000, "num_test": 1500}
TINY_BATCH = 512


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


# cells kept as files but not in BENCHMARK.json: their steps are paced by
# the host, whose speed varies too much on the check machines to bound
# (PERF.md); their configurations, limits and references stay tested
CANDIDATES = ("lightgcn-amazon-book.train", "simgcl-yelp2018.train")


def any_cell(name: str):
    """Cell ``name``, from BENCHMARK.json or one of ``CANDIDATES``."""
    from yardstick import manifest

    man = manifest.load_manifest()
    if name not in CANDIDATES:
        return manifest.cell(name, man)
    config, traffic = name.rsplit(".", 1)
    cell = manifest.cell_of(name, f"gpubench/configs/{config}.json", traffic, 1, man)
    # report what a train cell of BENCHMARK.json reports
    like = manifest.cell(next(w["name"] for w in man["workloads"] if w["traffic"] == traffic),
                         man)
    cell.end_to_end, cell.per_layer = like.end_to_end, like.per_layer
    return cell


def tiny(name: str, **sizes):
    """Cell ``name`` at the tiny size, or at ``sizes`` (dataset keys)."""
    cell = any_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["dataset"].update({**TINY, **sizes})
    cell.keys["batch_size"] = TINY_BATCH
    cell.keys["test_batch_size"] = TINY_BATCH
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
