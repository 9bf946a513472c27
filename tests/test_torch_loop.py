"""The port's run harness (`engine.loop.train_model`, logging, the
throughput meter) against the JAX package's on a tiny dataset, on the
CPU.

The samplers of the two packages draw different triples from the same
seed by design, so runs are compared by behaviour and by the shape of
what they write (log lines and JSONL events, numbers masked), not by
value. Within the port, an int4 run equals an int8 run exactly."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from idgrec_torch.config import Config as TConfig
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine import logging_utils as t_logging
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine import profiling as t_profiling
from idgrec_torch.models import get_model as t_get_model
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.engine import logging_utils as j_logging
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.engine import profiling as j_profiling

# The shapes are tiny and the test workers share the cores: intra-op
# threads would only contend with each other.
torch.set_num_threads(1)

_SHAPE = (200, 300, 3000, 400)
_CFG = {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001", "GCN_layer": "2",
        "compute_dtype": "int8", "learn_rate": "0.01", "batch_size": "256",
        "test_batch_size": "64", "top_K": "[5, 10]", "training_epochs": "4", "interval": "2",
        "early_stopping": "10"}
_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} - ")
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?")


def _tdata():
    return t_make(*_SHAPE, seed=4, name="tiny")


def _train(tmp, cfg=None, **kw):
    kw.setdefault("seed", 1)
    kw.setdefault("echo", False)
    kw.setdefault("log_dir", os.path.join(str(tmp), "log"))
    return t_loop.train_model("LightGCN", _tdata(), TConfig({**_CFG, **(cfg or {})}),
                              device="cpu", **kw)


def _log_lines(log_dir):
    with open(os.path.join(log_dir, "LightGCN", "tiny.log")) as f:
        lines = f.read().splitlines()
    assert lines and all(_STAMP.match(line) for line in lines if not line.startswith("\t"))
    return [_STAMP.sub("", line) for line in lines]


def _events(log_dir):
    with open(os.path.join(log_dir, "LightGCN", "tiny.jsonl")) as f:
        return [json.loads(line) for line in f]


def _shape_of(line):
    return _NUMBER.sub("#", line)


def _totals(result):
    return [float(h["loss"].split(" = ")[0]) for h in result.history]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    tlog, jlog = str(tmp / "tlog"), str(tmp / "jlog")
    tres = _train(tmp, log_dir=tlog)
    jres = j_loop.train_model("LightGCN", j_make(*_SHAPE, seed=4, name="tiny"), JConfig(_CFG),
                              seed=1, log_dir=jlog, echo=False)
    return dict(tres=tres, jres=jres, tlog=tlog, jlog=jlog)


def test_losses_fall_and_result_fields(runs):
    tres = runs["tres"]
    totals = _totals(tres)
    assert len(totals) == 4 and totals[-1] < totals[0] < np.log(2.0) + 1e-3
    assert [h["epoch"] for h in tres.history] == [1, 2, 3, 4]
    assert set(tres.params) == {"user_emb", "item_emb"} and tres.state == {}
    assert tuple(tres.params["user_emb"].shape) == (200, 16)
    assert not tres.params["user_emb"].requires_grad
    assert tres.best.epoch in (1, 3) and tres.best.recall.shape == (2,)
    assert set(tres.last_result) == {"recall", "precision", "ndcg"}
    # the same behaviour in the JAX run: four epochs, losses falling
    jt = _totals(runs["jres"])
    assert len(jt) == 4 and jt[-1] < jt[0]
    # both start from a model that knows nothing: the first epoch's BPR is near ln 2
    assert abs(totals[0] - jt[0]) < 0.05


def test_log_line_formats_match_jax(runs):
    tl, jl = _log_lines(runs["tlog"]), _log_lines(runs["jlog"])
    assert len(tl) == len(jl)
    head = 2 + len(TConfig(_CFG))
    # the run header and the config echo are equal character for character
    assert tl[:head] == jl[:head]
    assert tl[0] == "Run with LightGCN on tiny" and "batch_size : 256" in tl[:head]
    # from there on, the same lines in the same order, numbers aside
    assert [_shape_of(x) for x in tl[head:]] == [_shape_of(x) for x in jl[head:]]
    assert re.fullmatch(r"Epoch:    1 \| Training time: \d+\.\d{3} \| training loss: "
                        r"[\d.e-]+ = [\d.e-]+ \+ [\d.e-]+", tl[head])
    assert re.fullmatch(r"Epoch:    1 \| Test recall: \[[\d. e-]+\] \| Test NDCG: \[[\d. e-]+\]",
                        tl[head + 1])
    assert tl[-2] == "Model training process completed."
    assert re.fullmatch(r"Best epoch:    \d \| Best recall: \[.+\] \| Best NDCG: \[.+\]", tl[-1])


def test_jsonl_events_match_jax(runs):
    te, je = _events(runs["tlog"]), _events(runs["jlog"])
    assert [e["kind"] for e in te] == [e["kind"] for e in je] == [
        "train_epoch", "eval", "train_epoch", "train_epoch", "eval", "train_epoch", "best"]
    for a, b in zip(te, je):
        # the port logs no dense padded rate (``mxu_gflops``): no route of
        # it does the padded dense product that rate counts
        assert set(a) == set(b) - {"mxu_gflops"}, a["kind"]
        assert a["epoch"] == b["epoch"] or a["kind"] == "best"
    first = te[0]
    assert len(first["loss_terms"]) == 2 and first["seconds"] > 0
    assert first["pairs_per_sec"] == pytest.approx(3000 / first["seconds"])
    # the logged loss is the term sum over num_train // batch_size + 1 = 12
    assert sum(first["loss_terms"]) == pytest.approx(_totals(runs["tres"])[0], abs=1e-6)


def test_interval_sets_the_eval_epochs(runs):
    evals = [e["epoch"] for e in _events(runs["tlog"]) if e["kind"] == "eval"]
    assert evals == [1, 3]


def test_early_stopping_with_zero_learn_rate(tmp_path):
    res = _train(tmp_path, {"learn_rate": "0", "interval": "1", "early_stopping": "2",
                            "training_epochs": "10"})
    # the first evaluation is the best; two more without a gain stop the run
    assert len(res.history) == 3 and res.best.stop and res.best.epoch == 1
    lines = _log_lines(os.path.join(str(tmp_path), "log"))
    assert lines[-3] == "Early stop......"


def test_max_epochs_overrides_the_config(tmp_path):
    res = _train(tmp_path, max_epochs=1, log_dir=None)
    assert len(res.history) == 1
    assert not os.path.exists(os.path.join(str(tmp_path), "log"))


def test_sparsity_split_matches_jax_and_levels_are_logged(tmp_path):
    tdata, jdata = _tdata(), j_make(*_SHAPE, seed=4, name="tiny")
    t_groups, t_state = tdata.create_sparsity_split()
    j_groups, j_state = jdata.create_sparsity_split()
    assert t_groups == j_groups and t_state == j_state and len(t_groups) >= 4
    res = _train(tmp_path, {"sparsity_test": "1"}, max_epochs=1)
    lines = _log_lines(os.path.join(str(tmp_path), "log"))
    for state in t_state:
        assert state in lines
    levels = [x for x in lines if x.startswith("\t level_")]
    assert len(levels) == len([g for g in t_groups if g])
    assert re.fullmatch(r"\t level_1: recall: \[.+\] ,ndcg: \[.+\]", levels[0])
    # the best is tracked on level 1, the sparsest users
    np.testing.assert_array_equal(res.best.recall, res.last_result["recall"])
    assert levels[0] == "\t level_1: recall: %s ,ndcg: %s" % (res.last_result["recall"],
                                                               res.last_result["ndcg"])


def test_int4_run_equals_int8_run(runs, tmp_path):
    res4 = _train(tmp_path, {"compute_dtype": "int4"}, log_dir=None)
    res8 = runs["tres"]
    assert [h["loss"] for h in res4.history] == [h["loss"] for h in res8.history]
    for k in ("user_emb", "item_emb"):
        assert torch.equal(res4.params[k], res8.params[k])
    np.testing.assert_array_equal(res4.best.recall, res8.best.recall)
    assert res4.best.epoch == res8.best.epoch


def test_same_seed_same_run_other_seed_other_run(runs, tmp_path):
    again = _train(tmp_path, log_dir=None)
    assert [h["loss"] for h in again.history] == [h["loss"] for h in runs["tres"].history]
    other = _train(tmp_path, log_dir=None, seed=2, max_epochs=1)
    assert other.history[0]["loss"] != runs["tres"].history[0]["loss"]


def test_the_global_generator_is_not_used(tmp_path):
    torch.manual_seed(123)
    before = torch.get_rng_state()
    _train(tmp_path, log_dir=None, max_epochs=1)
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("case", ["mesh", "user_rows"])
def test_unported_options_name_their_roadmap_item(tmp_path, monkeypatch, case):
    if case == "mesh":
        # the mesh is ported: a one-rank mesh (no process group) trains the
        # tables as one process does, bit for bit
        from idgrec_torch.parallel.mesh import Mesh

        res = _train(tmp_path / "mesh", log_dir=None, max_epochs=2, mesh=Mesh(1, 1))
        ref = _train(tmp_path / "one", log_dir=None, max_epochs=2)
        assert [h["loss"] for h in res.history] == [h["loss"] for h in ref.history]
        for k, v in ref.params.items():
            assert torch.equal(res.params[k], v)
        assert res.sharded_params == {} and ref.sharded_params is None  # nothing to shard
    else:
        # user-row batches are ported (CVGA's): the run builds no sampler
        # and names no ROADMAP item; its epochs are user-id permutations
        monkeypatch.setattr(t_get_model("LightGCN"), "batching", "user_rows")
        monkeypatch.setattr(t_loop, "NegativeSampler", None)
        res = _train(tmp_path, log_dir=None, max_epochs=1)
        assert np.isfinite(res.last_result["recall"]).all()


def test_model_harness_attributes_have_the_base_defaults():
    model = t_get_model("LightGCN")(TConfig(_CFG), _tdata(), device="cpu")
    assert model.respects_early_stop is True and model.batching == "bpr_triples"
    assert model.aggregates_per_step == 1
    assert model.epoch_context(0, np.random.default_rng(0)) == ()


def test_profile_dir_gets_a_trace_of_the_second_epoch(tmp_path):
    prof = tmp_path / "prof"
    _train(tmp_path, {"batch_size": "2048"}, log_dir=None, max_epochs=2, profile_dir=str(prof))
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with open(traces[0]) as f:
        assert "traceEvents" in json.load(f)


def test_debug_nans_turns_on_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    try:
        t_profiling.debug_options(TConfig({**_CFG, "debug_nans": "1"}))
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    t_profiling.debug_options(TConfig(_CFG))
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("dense_dims", [None, (1024, 2048)])
def test_throughput_meter_matches_jax(dense_dims):
    """The port's rates are the JAX meter's without ``mxu_gflops``, the
    dense padded work no route of the port does, whatever dense dims the
    JAX meter is given."""
    kw = dict(num_train=3000, nnz=2900, emb_size=16, num_layers=3, steps_per_epoch=12,
              aggregates_per_step=2)
    want = j_profiling.ThroughputMeter(**kw, dense_dims=dense_dims).rates(0.37)
    del want["mxu_gflops"]
    assert t_profiling.ThroughputMeter(**kw).rates(0.37) == want


@pytest.mark.parametrize("sums,n", [([3.0, 0.004], 12), ([1e-7], 3), ([2.5, 1.25, 0.1], 7)])
def test_loss_string_matches_jax(sums, n):
    assert t_logging.loss_string(np.asarray(sums, np.float32), n) == \
        j_logging.loss_string(np.asarray(sums, np.float32), n)


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("gather", "bfloat16"),
                                           ("gather", "float32"), ("fused", "bfloat16"),
                                           ("bitpack", "bfloat16"), ("bitpack", "float32")])
def test_train_model_runs_in_the_exact_modes(tmp_path, backend, dtype):
    from idgrec_torch.ops import propagate as t_prop

    res = _train(tmp_path, {"compute_dtype": dtype, "propagation_backend": backend},
                 checkpoint_dir=str(tmp_path / "ck"))
    totals = _totals(res)
    assert len(totals) == 4 and totals[-1] < totals[0] < np.log(2.0) + 1e-3
    want = {"dense": t_prop.DenseSquareAdj, "gather": t_prop.GatherSquareAdj,
            "fused": t_prop.FusedSquareAdj, "bitpack": t_prop.BitSquareAdj}[backend]
    model = t_get_model("LightGCN")(TConfig({**_CFG, "compute_dtype": dtype,
                                             "propagation_backend": backend}), _tdata(),
                                    device="cpu")
    assert isinstance(model.graph, want)
    # a second call resumes from the last checkpoint (epoch 3) and trains the
    # rest: resume == straight run
    again = _train(tmp_path, {"compute_dtype": dtype, "propagation_backend": backend},
                   checkpoint_dir=str(tmp_path / "ck"))
    assert [h["epoch"] for h in again.history] == [4]
    assert again.history[0]["loss"] == res.history[-1]["loss"]
    for k in ("user_emb", "item_emb"):
        assert torch.equal(again.params[k], res.params[k])


def test_int8_at_width_32_through_the_loop_equals_the_chain(tmp_path, monkeypatch):
    """On the card a width the chain's kernels decline (d != 64) takes
    one `FusedSquareAdj.matmul` per layer; the same route forced on the
    CPU trains to the same weights as the chain, bit for bit."""
    from idgrec_torch.ops import chainmm as t_chainmm

    cfg = {"embedding_size": "32", "training_epochs": "2"}
    chain = _train(tmp_path / "chain", cfg)
    calls = []
    monkeypatch.setattr(t_chainmm, "supports_chain_resident",
                        lambda *args, **kw: calls.append(args[1]) or False)
    loop = _train(tmp_path / "loop", cfg)
    assert calls and set(calls) == {32}
    assert _totals(loop) == _totals(chain)
    for k in ("user_emb", "item_emb"):
        assert torch.equal(loop.params[k], chain.params[k])
    for name in ("recall", "ndcg"):
        np.testing.assert_array_equal(loop.last_result[name], chain.last_result[name])


def test_train_model_with_batch_rows_resumes_like_a_straight_run(tmp_path):
    """batch_rows_propagation = 1 on dense: the rows path trains, logs,
    checkpoints and resumes bit for bit, and its losses stay within
    float32 round-off of the full propagation's."""
    over = {"compute_dtype": "bfloat16", "propagation_backend": "dense"}
    full = _train(tmp_path / "full", over, log_dir=None)
    rows_over = {**over, "batch_rows_propagation": "1"}
    res = _train(tmp_path, rows_over, checkpoint_dir=str(tmp_path / "ck"))
    assert len(res.history) == 4
    np.testing.assert_allclose(_totals(res), _totals(full), rtol=1e-3)
    again = _train(tmp_path, rows_over, checkpoint_dir=str(tmp_path / "ck"))
    assert [h["epoch"] for h in again.history] == [4]
    for k in ("user_emb", "item_emb"):
        assert torch.equal(again.params[k], res.params[k])
