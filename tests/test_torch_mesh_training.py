"""Training, evaluation, serving and checkpoints of the port on a 2x2
mesh (data 2 x model 2) of one gloo group of 4 CPU ranks, against the
JAX package on its own 2x2 mesh (4 of the session's 8 CPU devices) and
against the port on one process. Each data rank computes its half of
every batch's loss and backward (ROADMAP A.12).

The group runs every case once (tests/_torch_mesh_worker.py
``suite_mesh_training``) while the parent computes the references; the
join has a 120 s timeout. The dataset has counts that divide no width
(67 users, 83 items), so the padded storage is exercised.

Bars:
* a few LightGCN steps from carried JAX weights on the same triples,
  against JAX's mesh: the loss terms within rtol 1e-5, the tables after
  each step within tests/test_torch_training.py's bars (0.25 learn_rate
  an entry, 1e-3 learn_rate on average: Adam turns a round-off
  difference of a near-zero gradient into up to one learn_rate); the
  same for DirectAU and EGCF (uniformity and in-batch InfoNCE, whose
  rows the data split couples), their loss terms within rtol 3e-5 /
  atol 3e-6;
* one step of every zoo model against the port on one process: the
  loss terms within rtol 3e-5 / atol 3e-6, the gradients within 2**-7
  of the largest entry (the port's bars on the card, PERF.md §2); every
  loss function a rank calls receives half the batch's rows;
* whole runs against the port on one process: LightGCN's per-epoch loss
  within rtol 2e-3 / atol 1e-4 and its best recall within 1e-6
  (tests/test_parallel.py:76-94); SGL, RecDCL, NCL and CVGA with the
  configs and tolerances of tests/test_parallel.py:97-147; every other
  zoo model's epoch within rtol 2e-3 / atol 1e-4 and its tables within
  2e-3 of their largest entry;
* `sharded_topk`: the values of `torch.topk` on the whole row, the ids
  of a stable descending sort (the lowest index among ties; the CPU's
  `torch.topk` orders ties otherwise);
* evaluation, serving and checkpoints: the metrics within 1e-6, the
  served ids equal.
"""

from __future__ import annotations

import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_worker import Group, step_inputs
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.engine.loop import train_model as t_train
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch import convert
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.parallel import padding as t_padding
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.parallel.mesh import make_mesh as j_make_mesh

SHAPE, SEED, B, LR = (67, 83, 1024, 128), 21, 64, 0.01
BASE = {"dataset": "tiny", "top_K": "[3, 5]", "training_epochs": "3", "early_stopping": "10",
        "interval": "1", "embedding_size": "16", "batch_size": str(B),
        "test_batch_size": "32", "learn_rate": str(LR), "reg_lambda": "0.0001",
        "GCN_layer": "2"}
# the port's mode -> its config, and the JAX backend that computes the
# same function (the port's dense bfloat16 products are K6's: JAX fused)
MODES = {
    "dense_bf16": ({"propagation_backend": "dense", "compute_dtype": "bfloat16"}, "fused"),
    "fused_bf16": ({"propagation_backend": "fused", "compute_dtype": "bfloat16"}, "fused"),
    "int8": ({"propagation_backend": "fused", "compute_dtype": "int8"}, "fused"),
    "int4": ({"propagation_backend": "fused", "compute_dtype": "int4"}, "fused"),
}
# tests/test_parallel.py:97-147: (extra config, parameter tolerance)
HARD = {
    "SGL": ({"ssl_lambda": 0.1, "ssl_ratio": 0.1, "aug_type": "ed", "temperature": 0.2,
             "training_epochs": 2}, 2e-3),
    "RecDCL": ({"a": 1, "polyc": 1e-7, "degree": 4, "all_bt_coeff": 1, "poly_coeff": 5.0,
                "bt_coeff": 0.01, "mom_coeff": 1, "momentum": 0.1, "embedding_size": 32}, 0.25),
    "NCL": ({"ssl_lambda": 1e-6, "proto_lambda": 1e-7, "temperature": 0.05, "cl_layer": 1,
             "alpha": 1.5, "k": 4, "warmup_epochs": 1}, 2e-3),
    "CVGA": ({"dropout": 0.3}, 2e-3),
}
ZOO = [name for name in t_available() if name not in HARD and name != "LightGCN"]
ZOO_OVERRIDES = {k: v for k, v in BASE.items() if k not in ("learn_rate", "reg_lambda",
                                                            "GCN_layer")}
USERS = np.arange(0, SHAPE[0], 3)
K = 10


def _cfg(**extra):
    return {**BASE, **{k: str(v) for k, v in extra.items()}}


def _zoo_cfg(name):
    over = {**ZOO_OVERRIDES, "training_epochs": "1"}
    if name == "GCMC":  # its layer_size names the published width
        over.pop("embedding_size")
    return {**t_load_config(name).as_dict(), **over}


def _sgl_cfg(mode):
    return _cfg(**{**HARD["SGL"][0], **MODES[mode][0], "embedding_size": 32})


def _runs():
    runs = {("LightGCN", mode): ("LightGCN", _cfg(**cfg), 3) for mode, (cfg, _) in MODES.items()}
    runs.update({(name, "hard"): (name, _cfg(**extra), 5) for name, (extra, _) in HARD.items()})
    runs.update({(name, "zoo"): (name, _zoo_cfg(name), 5) for name in ZOO})
    return runs


def _triples(tdata):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        pick = rng.integers(0, tdata.num_train, B)
        out.append((tdata.train_user[pick], tdata.train_item[pick],
                    rng.integers(0, tdata.num_items, B)))
    return out


def _ratings():
    """Scores with many ties (a few distinct values) and no tie pattern
    that one shard alone decides."""
    rng = np.random.default_rng(3)
    return np.round(rng.random((9, SHAPE[1])) * 6).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return t_make(*SHAPE, seed=SEED, name="tiny"), j_make(*SHAPE, seed=SEED, name="tiny")


@pytest.fixture(scope="module")
def start(data):
    jmodel = j_get_model("LightGCN")(JConfig(_cfg()), data[1])
    return jax.device_get(jmodel.init_params(jax.random.PRNGKey(7)))


# models whose loss couples the batch's rows, against JAX's 2x2 mesh
JAX_PARITY = ("DirectAU", "EGCF")
TERMS = dict(rtol=3e-5, atol=3e-6)
GRAD = 2.0 ** -7


def _jax_parity_cfg(name):
    cfg = _zoo_cfg(name)
    cfg["GCN_layer"] = "2"
    return cfg


@pytest.fixture(scope="module")
def parity_start(data):
    """(config, JAX's initial tables) of each `JAX_PARITY` model."""
    out = {}
    for name in JAX_PARITY:
        cfg = _jax_parity_cfg(name)
        jmodel = j_get_model(name)(JConfig({**cfg, "propagation_backend": "fused"}), data[1])
        out[name] = (cfg, jax.device_get(jmodel.init_params(jax.random.PRNGKey(7))))
    return out


def _zoo_step_cfgs():
    """Every model's config for its one-step comparison."""
    cfgs = {name: _zoo_cfg(name) for name in ZOO}
    cfgs["LightGCN"] = _cfg()
    cfgs.update({name: _cfg(**extra) for name, (extra, _) in HARD.items()})
    return cfgs


def _zoo_step_ref(tdata, name, cfg, triple):
    """One step of ``name`` on one process, as the worker's
    ``zoo_steps`` runs it on the mesh."""
    model = t_get_model(name)(TConfig(cfg), tdata, device="cpu")
    runner = TRunner(model, float(cfg["learn_rate"]), int(cfg["batch_size"]),
                     int(cfg["batch_size"]))
    (u, p, n), epoch, gen = step_inputs(name, model, triple)
    terms = runner.run_epoch(u, p, n, generator=gen, epoch=epoch)
    return dict(terms=terms.numpy(), grads={
        k: None if p_.grad is None else p_.grad.numpy().copy()
        for k, p_ in model.named_parameters()})


@pytest.fixture(scope="module")
def run(tmp_path_factory, data, start, parity_start):
    """The group's results (rank by rank) and the parent's references."""
    tdata = data[0]
    tmp = tmp_path_factory.mktemp("mesh_training")
    eval_cfg = _cfg(**MODES["int8"][0])
    ck_single = tmp / "ck_single"
    t_train("LightGCN", tdata, config=TConfig(eval_cfg).updated(training_epochs=2), seed=3,
            log_dir=None, echo=False, device="cpu", checkpoint_dir=str(ck_single))
    shutil.copytree(ck_single, tmp / "ck_single_for_mesh")
    inputs = {"shape": SHAPE, "seed": SEED, "start": start, "triples": _triples(tdata),
              "step_cfgs": {mode: _cfg(**cfg) for mode, (cfg, _) in MODES.items()},
              "sgl_cfgs": {mode: _sgl_cfg(mode) for mode in MODES},
              "runs": _runs(), "ratings": _ratings(), "k": K, "eval_cfg": eval_cfg,
              "users": USERS, "dir": str(tmp), "ck_single": str(tmp / "ck_single_for_mesh"),
              "jax_parity": parity_start, "zoo_steps": _zoo_step_cfgs()}
    group = Group("mesh_training", tmp / "group", 4, inputs)
    refs = {key: _summary(t_train(name, tdata, config=TConfig(cfg), seed=seed, log_dir=None,
                                  echo=False, device="cpu"))
            for key, (name, cfg, seed) in inputs["runs"].items()}
    refs["resume"] = _summary(t_train("LightGCN", tdata, config=TConfig(eval_cfg).updated(
        training_epochs=3), seed=3, log_dir=None, echo=False, device="cpu",
        checkpoint_dir=str(ck_single)))
    refs["zoo_steps"] = {name: _zoo_step_ref(tdata, name, cfg, inputs["triples"][0])
                         for name, cfg in inputs["zoo_steps"].items()}
    return group.join(), refs, inputs


def _summary(res):
    return dict(loss=[h["loss"] for h in res.history],
                recall=None if res.best.recall is None else res.best.recall.copy(),
                params={k: v.detach().numpy().copy() for k, v in res.params.items()})


def _losses(summary):
    return np.array([[float(t) for t in h.replace("=", "+").split("+")]
                     for h in summary["loss"]])


# ---------------------------------------------------------------------------
# steps against JAX's mesh


@pytest.fixture(scope="module")
def jax_steps(data, start, run):
    """Three steps of JAX's LightGCN on its 2x2 mesh from the same weights
    and triples, per mode: (terms, true-shape tables) after each step."""
    jmesh = j_make_mesh(4, data_parallel=2)
    out = {}
    for mode, (cfg, backend) in MODES.items():
        jmodel = j_get_model("LightGCN")(JConfig(_cfg(**{**cfg, "propagation_backend": backend})),
                                         data[1])
        jmodel.device_put()
        jrun = JRunner(jmodel, LR, B, B, mesh=jmesh)
        params = jax.tree.map(np.array, start)
        opt_state = jrun.init_opt_state(params)
        params, opt_state, state = jrun.shard(params, opt_state, {})
        steps = []
        for i, (u, p, n) in enumerate(run[2]["triples"]):
            args = [np.asarray(a, np.int32) for a in (u, p, n)]
            params, opt_state, state, terms = jrun.run_epoch(
                params, opt_state, state, (), *args, jax.random.PRNGKey(1), i)
            steps.append((np.asarray(terms), jax.device_get(jrun.unpad(params, state)[0])))
        out[mode] = steps
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_steps_on_the_mesh_match_jax_mesh(run, jax_steps, mode, step):
    jterms, jparams = jax_steps[mode][step]
    for rank_out in run[0]:
        tterms, tparams = rank_out["steps", mode][step]
        np.testing.assert_allclose(tterms, jterms, rtol=1e-5)
        for k in ("user_emb", "item_emb"):
            diff = np.abs(tparams[k] - np.asarray(jparams[k])) / LR
            assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (k, diff.max(), diff.mean())


@pytest.fixture(scope="module")
def jax_parity_steps(data, parity_start, run):
    """Three steps of each `JAX_PARITY` model on JAX's 2x2 mesh from the
    carried tables and the same triples: (terms, tables) after each."""
    jmesh = j_make_mesh(4, data_parallel=2)
    out = {}
    for name, (cfg, start_) in parity_start.items():
        jmodel = j_get_model(name)(JConfig({**cfg, "propagation_backend": "fused"}), data[1])
        jmodel.device_put()
        jrun = JRunner(jmodel, float(cfg["learn_rate"]), B, B, mesh=jmesh)
        params = jax.tree.map(np.array, start_)
        opt_state = jrun.init_opt_state(params)
        params, opt_state, state = jrun.shard(params, opt_state, {})
        steps = []
        for i, (u, p, n) in enumerate(run[2]["triples"]):
            args = [np.asarray(a, np.int32) for a in (u, p, n)]
            params, opt_state, state, terms = jrun.run_epoch(
                params, opt_state, state, (), *args, jax.random.PRNGKey(1), i)
            steps.append((np.asarray(terms), jax.device_get(jrun.unpad(params, state)[0])))
        out[name] = steps
    return out


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("name", JAX_PARITY)
def test_batch_coupled_steps_on_the_mesh_match_jax_mesh(run, jax_parity_steps, name, step):
    """DirectAU's uniformity and EGCF's in-batch InfoNCE take each data
    rank's rows against the gathered batch: the steps match JAX's, whose
    batch is sharded over its "data" axis."""
    jterms, jparams = jax_parity_steps[name][step]
    lr = float(run[2]["jax_parity"][name][0]["learn_rate"])
    for rank_out in run[0]:
        tterms, tparams = rank_out["jax_parity", name][step]
        np.testing.assert_allclose(tterms, jterms, **TERMS)
        for k, v in jparams.items():
            diff = np.abs(tparams[k] - np.asarray(v)) / lr
            assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (k, diff.max(), diff.mean())


@pytest.mark.parametrize("name", sorted(_zoo_step_cfgs()))
def test_zoo_step_on_the_mesh_matches_one_process(run, name):
    """One step of every model on the 2x2 mesh, each data rank on its half
    of the batch, against one process: the loss terms (the ranks' shares
    summed) and the gradients; every loss function a rank called got B/2
    rows."""
    want = run[1]["zoo_steps"][name]
    for rank_out in run[0]:
        got = rank_out["zoo_step", name]
        np.testing.assert_allclose(got["terms"], want["terms"], **TERMS)
        for k, a in want["grads"].items():
            if a is None:
                assert got["grads"][k] is None, k
                continue
            err = float(np.abs(got["grads"][k] - a).max())
            assert err <= GRAD * float(np.abs(a).max()), (name, k, err)
        rows = got["rows"]
        assert rows and {n for _, n in rows} == {B // 2}, sorted(set(rows))


@pytest.mark.parametrize("mode", list(MODES))
def test_each_rank_holds_its_rows_of_the_tables_and_of_m(run, data, mode):
    tdata = data[0]
    rows = {"user_emb": t_padding.pad_to(tdata.num_users),
            "item_emb": t_padding.pad_to(tdata.num_items)}
    d = int(BASE["embedding_size"])
    single = t_get_model("LightGCN")(TConfig(run[2]["step_cfgs"][mode]), tdata, device="cpu")
    m = single.graph.m8 if hasattr(single.graph, "m8") else single.graph.m
    for rank_out in run[0]:
        storage = rank_out["storage", mode]
        assert storage == {k: ((r // 2, d), (r // 2, d)) for k, r in rows.items()}
        assert rank_out["sharded", mode]
        assert rank_out["m_numel", mode] * 2 == m.numel()


def test_the_ranks_take_the_same_steps(run):
    first = run[0][0]
    for rank_out in run[0][1:]:
        for mode in MODES:
            for (t0, p0), (t1, p1) in zip(first["steps", mode], rank_out["steps", mode]):
                np.testing.assert_array_equal(t0, t1)
                for k in p0:
                    np.testing.assert_array_equal(p0[k], p1[k])


@pytest.fixture(scope="module")
def sgl_refs(data, run):
    """One SGL step on one process per mode, with the JAX package's views
    rule declining the quantized views route, as a model axis does."""
    u, p, n = (torch.from_numpy(np.asarray(a, np.int64)) for a in run[2]["triples"][0])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_prop, "REF_YI_BUDGET_WIDE", 4096)
        for mode, cfg in run[2]["sgl_cfgs"].items():
            model = t_get_model("SGL")(TConfig(cfg), data[0], device="cpu",
                                       generator=torch.Generator().manual_seed(0))
            model.epoch_context(0, np.random.default_rng(5))
            terms = model.loss_terms({"user": u, "pos": p, "neg": n})
            sum(terms).backward()
            m = model.graph.m8 if hasattr(model.graph, "m8") else model.graph.m
            out[mode] = dict(
                terms=[float(t.detach()) for t in terms], views_route=model._views_route,
                grads={k: getattr(model, k).grad.numpy().copy() for k in ("user_emb", "item_emb")},
                m_bytes=m.numel() * m.element_size(), shared_is_own=model._shared is m,
                shared_bytes=model._shared.numel() * model._shared.element_size())
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_sgl_on_the_mesh_holds_its_rows_of_m_and_matches_one_process(run, sgl_refs, mode):
    """SGL's clean chain and views on the model axis: each rank holds half
    of M and half of the views' binary matrix (the model's own where it
    is binary), and one step's loss terms and gradients are one
    process's to float32 round-off."""
    want = sgl_refs[mode]
    assert not want["views_route"]
    for rank_out in run[0]:
        got = rank_out["sgl", mode]
        assert got["m_bytes"] * 2 == want["m_bytes"]
        assert got["shared_bytes"] * 2 == want["shared_bytes"]
        assert got["shared_is_own"] == want["shared_is_own"] == (mode != "int4")
        assert got["views_sharded"]
        np.testing.assert_allclose(got["terms"], want["terms"], rtol=1e-5)
        for k, a in want["grads"].items():
            np.testing.assert_allclose(got["grads"][k], a, rtol=1e-4, atol=1e-5 * np.abs(a).max())


# ---------------------------------------------------------------------------
# whole runs against the port on one process


@pytest.mark.parametrize("mode", list(MODES))
def test_lightgcn_run_matches_one_process(run, mode):
    got, ref = run[0][0]["run", ("LightGCN", mode)], run[1][("LightGCN", mode)]
    np.testing.assert_allclose(_losses(got)[:, 0], _losses(ref)[:, 0], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got["recall"], ref["recall"], atol=1e-6)
    assert {k: v.shape for k, v in got["params"].items()} == \
        {k: v.shape for k, v in ref["params"].items()}


@pytest.mark.parametrize("name", list(HARD))
def test_hard_models_match_one_process(run, name):
    got, ref = run[0][0]["run", (name, "hard")], run[1][(name, "hard")]
    np.testing.assert_allclose(_losses(got)[:, 0], _losses(ref)[:, 0], rtol=5e-3, atol=1e-3)
    tol = HARD[name][1]
    for k, a in ref["params"].items():
        scale = np.abs(a).max() + 1e-9
        assert np.abs(a - got["params"][k]).max() / scale < tol, (name, k)
    np.testing.assert_allclose(got["recall"], ref["recall"], atol=0.02)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_epoch_matches_one_process(run, name):
    """One epoch of every other model: each data rank computes the loss of
    its half of every batch, the batch-coupled terms (in-batch InfoNCE,
    uniformity, batch norm) against the gathered batch, the full-table
    contrasts on its rows; the noise is drawn as on one process."""
    got, ref = run[0][0]["run", (name, "zoo")], run[1][(name, "zoo")]
    np.testing.assert_allclose(_losses(got), _losses(ref), rtol=2e-3, atol=1e-4)
    for k, a in ref["params"].items():
        scale = np.abs(a).max() + 1e-9
        assert np.abs(a - got["params"][k]).max() / scale < 2e-3, (name, k)


# ---------------------------------------------------------------------------
# ranking, evaluation, serving, checkpoints


@pytest.mark.parametrize("width", [2, 4])
def test_sharded_topk_matches_torch_topk(run, width):
    ratings = torch.from_numpy(run[2]["ratings"])
    want_vals = torch.topk(ratings, K, dim=1).values.numpy()
    order = torch.sort(ratings, dim=1, descending=True, stable=True).indices[:, :K].numpy()
    assert (np.diff(np.sort(run[2]["ratings"], axis=1), axis=1) == 0).any()  # ties exist
    for rank_out in run[0]:
        vals, idx = rank_out["topk", width]
        np.testing.assert_array_equal(vals, want_vals)
        np.testing.assert_array_equal(idx, order)


def _single_model(data, run):
    cfg = TConfig(run[2]["eval_cfg"])
    model = t_get_model("LightGCN")(cfg, data[0], device="cpu")
    convert.load_jax_params(model, run[2]["start"])
    return cfg, model


def test_evaluator_and_server_on_the_mesh_match_one_process(run, data):
    cfg, model = _single_model(data, run)
    want = TEvaluator(model, data[0], cfg).evaluate()
    items, scores = TRecommender(model, data[0]).recommend(USERS, k=10)
    for rank_out in run[0]:
        for key in ("recall", "precision", "ndcg"):
            np.testing.assert_allclose(rank_out["eval"][key], want[key], atol=1e-6)
        np.testing.assert_array_equal(rank_out["serve"][0], items)
        np.testing.assert_allclose(rank_out["serve"][1], scores, rtol=1e-5)


def test_mesh_checkpoint_serves_on_one_process(run, data):
    ck = run[2]["dir"] + "/ck_mesh"
    cfg = TConfig(run[2]["eval_cfg"])
    items, _ = TRecommender.from_checkpoint("LightGCN", data[0], cfg, ck,
                                            device="cpu").recommend(USERS, k=10)
    for rank_out in run[0]:
        np.testing.assert_array_equal(rank_out["ck_mesh_serve"][0], items)
    want = run[1][("LightGCN", "int8")]
    got = run[0][0]["ck_mesh"]
    np.testing.assert_allclose(_losses(got)[:, 0], _losses(want)[:2, 0], rtol=2e-3, atol=1e-4)


def test_one_process_checkpoint_resumes_on_the_mesh(run):
    got, want = run[0][0]["ck_resume"], run[1]["resume"]
    assert len(got["loss"]) == len(want["loss"]) == 1  # the third epoch only
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=2e-3, atol=1e-4)
    for k, a in want["params"].items():
        diff = np.abs(a - got["params"][k]) / LR
        assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (k, diff.max())
