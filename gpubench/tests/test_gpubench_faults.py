"""The comparison that decides ``correct`` fails what it must: the
control (the port's own path one precision below the configuration's:
int8 for the stated bfloat16), and each fault a cell can have, planted
under the timed path of a whole run at a tiny size on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import CANDIDATES
from yardstick import drivers, manifest

CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]] + list(CANDIDATES)
TRAIN = [n for n in CELLS if n.endswith(".train")]
EVAL = [n for n in CELLS if n.endswith(".eval")]


def run(cell, overrides=None):
    return drivers.run(cell, 2**31 + 777, 0.2, False, CPU, time.perf_counter(), overrides)


# SimGCL's int8 views depart from the reference's by less on a tiny graph
# than at its published scale (change 0.005 against 0.07): its control runs
# on a graph large enough that int8 shows as it does there
CONTROL_SIZES = {"simgcl-yelp2018.train": {"num_users": 2000, "num_items": 3000,
                                           "num_train": 80_000, "num_test": 20_000}}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name, tiny_cell):
    out = run(tiny_cell(name, **CONTROL_SIZES.get(name, {})), {"compute_dtype": "int8"})
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(name, tiny_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run(tiny_cell(name))
    assert not out.correct and out.checks["change"][0] == pytest.approx(1.0), out.checks


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_is_caught(name, tiny_cell, monkeypatch):
    from idgrec_torch.models import get_model

    cell = tiny_cell(name)
    cls = get_model(cell.config["model"])
    whole = cls.loss_terms

    def half(self, batch, generator=None, epoch=0):
        rows = batch["user"].shape[0] // 2
        return whole(self, {k: v[:rows] for k, v in batch.items()}, generator, epoch)

    monkeypatch.setattr(cls, "loss_terms", half)
    out = run(cell)
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", EVAL)
def test_half_of_the_users_left_out_is_caught(name, tiny_cell, monkeypatch):
    from idgrec_torch.engine import evaluator

    plan = evaluator.build_eval_plan

    def half(data, batch_size, users=None, device=None):
        every = sorted(data.test_dict) if users is None else list(users)
        return plan(data, batch_size, users=every[: len(every) // 2], device=device)

    monkeypatch.setattr(evaluator, "build_eval_plan", half)
    out = run(tiny_cell(name))
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", EVAL)
def test_an_answer_altered_where_it_is_made_is_caught(name, tiny_cell, monkeypatch):
    from idgrec_torch.engine import evaluator

    sums = evaluator.topk_metric_sums

    def shifted(topk_items, truth, ks, valid=None):
        # every ranking one item off: the item after the one ranked
        return sums(topk_items + 1, truth, ks, valid=valid)

    monkeypatch.setattr(evaluator, "topk_metric_sums", shifted)
    out = run(tiny_cell(name))
    assert not out.correct, out.checks
