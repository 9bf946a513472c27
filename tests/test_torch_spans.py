"""The program's spans (`engine.profiling.span`) on the CPU: off, a span
is the shared no-op object and the log stays empty; under
`torch.profiler` a training epoch, an evaluation sweep and K6's plain
version record their spans, nested as the code nests them, on the
profiler's clock around the ops they run (a LightGCN sweep on the fused
score-mask-rank route one span a batch, the chained route three); a schedule records its active
steps only; the log empties with `clear_spans` and when `maybe_trace`
ends."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from idgrec_torch.config import Config
from idgrec_torch.data.dataset import make_synthetic_dataset
from idgrec_torch.engine import profiling
from idgrec_torch.engine.evaluator import Evaluator
from idgrec_torch.engine.sampler import NegativeSampler
from idgrec_torch.engine.trainer import EpochRunner
from idgrec_torch.models import get_model
from idgrec_torch.ops import propagate

torch.set_num_threads(1)

_SHAPE = (200, 300, 3000, 400)
# bfloat16 on the dense backend at d = 32: every product runs K6's wrapper
# (its plain version on the CPU); 3,000 pairs in batches of 1,024 are 3 steps
_CFG = {"dataset": "tiny", "embedding_size": "32", "reg_lambda": "0.0001", "GCN_layer": "2",
        "compute_dtype": "bfloat16", "propagation_backend": "dense", "learn_rate": "0.01",
        "batch_size": "1024", "test_batch_size": "64", "top_K": "[5, 10]"}
LAYERS = 2
TRAIN = ("engine.trainer.forward", "engine.trainer.backward", "engine.trainer.adam")
# a batch's spans on the chained route; the fused route opens the last alone
BATCH = ("engine.evaluator.score", "engine.evaluator.mask", "engine.evaluator.topk")
FUSED = ("engine.evaluator.topk",)
K6 = "ops.fusedmm.k6"


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def program():
    data = make_synthetic_dataset(*_SHAPE, seed=4, name="tiny")
    cfg = Config(_CFG)
    model = get_model("LightGCN")(cfg, data, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    assert isinstance(model.graph, propagate.DenseSquareAdj)
    assert model.graph.runs_kernel(model.embedding_size)
    runner = EpochRunner(model, cfg.float("learn_rate"), cfg.int("batch_size"), data.num_train)
    triples = NegativeSampler(data, device="cpu").sample_epoch(torch.Generator().manual_seed(1))
    return {"cfg": cfg, "data": data, "model": model, "runner": runner, "triples": triples}


def _children(log, parent):
    return [s.name for s in log if s.parent == parent]


def test_off_a_span_is_the_shared_noop_and_records_nothing(program):
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("engine.trainer.step")
    assert first is profiling.span(K6)
    with first:
        torch.ones(3).add_(1)
    program["runner"].run_epoch(*program["triples"])
    Evaluator(program["model"], program["data"], program["cfg"]).evaluate()
    assert profiling.span_log() == []


def test_a_training_epoch_records_its_steps_and_their_parts(program):
    runner = program["runner"]
    with profile(activities=[ProfilerActivity.CPU]):
        runner.run_epoch(*program["triples"])
    log = profiling.span_log()
    steps = [k for k, s in enumerate(log) if s.name == "engine.trainer.step"]
    assert len(steps) == runner.num_batches == 3
    for k in steps:
        assert log[k].parent is None and log[k].whole
        assert _children(log, k) == list(TRAIN)
        parts = {s.name: j for j, s in enumerate(log) if s.parent == k}
        # the forward's propagation and the backward's, K6's plain version
        # on the caller's thread, one application a layer each way
        assert _children(log, parts["engine.trainer.forward"]) == [K6] * LAYERS
        assert _children(log, parts["engine.trainer.backward"]) == [K6] * LAYERS
        assert _children(log, parts["engine.trainer.adam"]) == []
        assert sum(log[j].device_ms for j in parts.values()) <= log[k].device_ms
    assert sum(s.name == K6 for s in log) == 2 * LAYERS * runner.num_batches
    assert all(s.whole and s.device_ms > 0 for s in log)
    assert {s.thread for s in log} == {log[0].thread}


def test_an_evaluation_sweep_records_its_representation_and_batches(program):
    evaluator = Evaluator(program["model"], program["data"], program["cfg"])
    batches = evaluator.plan.users.shape[0]
    assert batches > 1
    with profile(activities=[ProfilerActivity.CPU]):
        evaluator.evaluate()
    log = profiling.span_log()
    assert log[0].name == "engine.evaluator.sweep" and log[0].parent is None
    assert _children(log, 0) == ["models.eval_embeddings"] + list(FUSED) * batches
    assert _children(log, 1) == [K6] * LAYERS
    assert len(log) == 2 + LAYERS + batches
    assert all(s.whole and s.device_ms > 0 for s in log)
    assert evaluator.route_batches == {"fused": batches, "chained": 0}


def test_a_chained_sweep_records_score_mask_and_topk(program, monkeypatch):
    """The chained route (a model that scores otherwise, or items sharded)
    records its three spans a batch."""
    evaluator = Evaluator(program["model"], program["data"], program["cfg"])
    monkeypatch.setattr(evaluator, "fused_factors", lambda rep: None)
    batches = evaluator.plan.users.shape[0]
    with profile(activities=[ProfilerActivity.CPU]):
        evaluator.evaluate()
    log = profiling.span_log()
    assert _children(log, 0) == ["models.eval_embeddings"] + list(BATCH) * batches
    assert len(log) == 2 + LAYERS + 3 * batches
    assert all(s.whole and s.device_ms > 0 for s in log)
    assert evaluator.route_batches == {"fused": 0, "chained": batches}


def test_the_profiler_holds_each_span_around_its_ops_on_its_clock(program, monkeypatch):
    # a sweep on each route: the fused one's span and the chain's three
    fused = Evaluator(program["model"], program["data"], program["cfg"])
    chained = Evaluator(program["model"], program["data"], program["cfg"])
    monkeypatch.setattr(chained, "fused_factors", lambda rep: None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        program["runner"].run_epoch(*program["triples"])
        fused.evaluate()
        chained.evaluate()
    assert fused.route_batches["chained"] == chained.route_batches["fused"] == 0
    events = list(prof.events())
    names = {s.name for s in profiling.span_log()}
    assert names == {"engine.trainer.step", *TRAIN, K6, "engine.evaluator.sweep",
                     "models.eval_embeddings", *FUSED, *BATCH}
    ops = [e for e in events if e.name.startswith("aten::")]
    for name in names:
        spans = [e for e in events if e.name == name]
        assert spans, name
        for e in spans:
            # a record of the program, not a user annotation
            assert not getattr(e, "is_user_annotation", False)
            assert e.device_type == torch.autograd.DeviceType.CPU
            inside = [o for o in ops if o.thread == e.thread
                      and e.time_range.start <= o.time_range.start
                      and o.time_range.end <= e.time_range.end]
            assert inside, name


def test_a_schedule_records_its_active_steps_only():
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(6):
            with profiling.span("outside"):
                x.add_(1)
            prof.step()
    log = profiling.span_log()
    assert [s.name for s in log] == ["outside"] * 2 and all(s.whole for s in log)
    profiling.clear_spans()
    # the schedule's step inside the span, as a profiler stepped from the
    # optimizer does it: the span in which the profiler stops still ends
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(6):
            with profiling.span("inside"):
                x.add_(1)
                prof.step()
    log = profiling.span_log()
    assert [(s.name, s.whole) for s in log] == [("inside", True), ("inside", False)]
    assert not torch.autograd._profiler_enabled()


def test_clear_spans_and_the_end_of_maybe_trace_empty_the_log(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.span("b"):
                torch.ones(4).add_(1)
    log = profiling.span_log()
    assert [(s.name, s.parent) for s in log] == [("a", None), ("b", 0)]
    profiling.clear_spans()
    assert profiling.span_log() == []
    with profiling.maybe_trace(str(tmp_path)):
        with profiling.span("engine.trainer.step"):
            torch.ones(4).add_(1)
        assert [s.name for s in profiling.span_log()] == ["engine.trainer.step"]
    assert profiling.span_log() == []
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "engine.trainer.step" for e in events)
