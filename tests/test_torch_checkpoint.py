"""The port's checkpoints (`engine.checkpoint`, resume in `train_model`,
`convert.load_jax_checkpoint`, `Recommender.from_checkpoint`) against the
JAX package's, on the CPU.

Bars: the files the two `save_checkpoint`s write from one tree are equal
(names, leaf order, arrays, sidecar); a resumed run equals a straight run
bit for bit (tables, Adam state, generator states, best results, the
logged loss); from a checkpoint the JAX `train_model` wrote, the port's
`Evaluator` agrees with the JAX result to 1e-6 and the port's
`Recommender` serves the JAX `Recommender`'s items, except among scores
tied within 1e-5."""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.engine import checkpoint as j_ckpt
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.serving import Recommender as JRecommender

# The shapes are tiny and the test workers share the cores: intra-op
# threads would only contend with each other.
torch.set_num_threads(1)

_SHAPE = (200, 300, 3000, 400)
_CFG = {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001", "GCN_layer": "2",
        "compute_dtype": "int8", "learn_rate": "0.01", "batch_size": "256",
        "test_batch_size": "64", "top_K": "[5, 10]", "training_epochs": "4", "interval": "2"}


def _tree(rng):
    return {"params": {"user_emb": rng.normal(size=(5, 3)).astype(np.float32),
                       "item_emb": rng.normal(size=(7, 3)).astype(np.float32)},
            "opt_state": {"count": np.asarray(4, np.int32),
                          "mu": {"user_emb": np.zeros((5, 3), np.float32),
                                 "item_emb": np.ones((7, 3), np.float32)}},
            "rng": {"host": np.arange(6, dtype=np.uint8)}}


def _files(directory):
    return sorted(os.listdir(directory))


def test_round_trip_and_leaf_order(tmp_path):
    tree = _tree(np.random.default_rng(0))
    best = {"count": 1, "epoch": 2, "recall": np.array([0.1, 0.2], np.float32), "ndcg": None}
    state = np.random.default_rng(3).bit_generator.state
    path = t_ckpt.save_checkpoint(str(tmp_path), 2, tree, np_rng_state=state, best=best)
    assert path.endswith("ckpt_2.npz") and _files(tmp_path) == ["ckpt_2.json", "ckpt_2.npz"]
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == 2
    assert t_ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    template = _tree(np.random.default_rng(1))
    got, meta = t_ckpt.load_checkpoint(str(tmp_path), 2, template)
    for a, b in zip(t_ckpt.tree_leaves(got), t_ckpt.tree_leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got) == sorted(tree) and meta["epoch"] == 2 and meta["num_leaves"] == 6
    assert meta["np_rng_state"] == state and meta["best"]["recall"] == pytest.approx([0.1, 0.2])
    # sorted keys at every level: opt_state.count, mu.item_emb, mu.user_emb, params..., rng
    leaves, _ = t_ckpt.read_checkpoint(str(tmp_path), 2)
    assert [x.shape for x in leaves] == [(), (7, 3), (5, 3), (7, 3), (5, 3), (6,)]


def test_files_equal_the_jax_packages(tmp_path):
    tree = _tree(np.random.default_rng(2))
    best = {"count": 0, "epoch": 1, "recall": np.array([0.3], np.float32),
            "ndcg": np.array([0.2], np.float32)}
    state = np.random.default_rng(5).bit_generator.state
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    t_ckpt.save_checkpoint(t_dir, 7, tree, np_rng_state=state, best=best)
    j_ckpt.save_checkpoint(j_dir, 7, tree, np_rng_state=state, best=best)
    assert _files(t_dir) == _files(j_dir)
    with np.load(os.path.join(t_dir, "ckpt_7.npz")) as a, np.load(os.path.join(j_dir, "ckpt_7.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(t_dir, "ckpt_7.json")) as a, open(os.path.join(j_dir, "ckpt_7.json")) as b:
        assert json.load(a) == json.load(b)
    # and each package reads the other's files
    got, _ = t_ckpt.load_checkpoint(j_dir, 7, tree)
    back, _ = j_ckpt.load_checkpoint(t_dir, 7, tree)
    for x, y, z in zip(t_ckpt.tree_leaves(got), jax.tree.leaves(back), t_ckpt.tree_leaves(tree)):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)


def test_pruning_keeps_the_newest(tmp_path):
    tree = _tree(np.random.default_rng(0))
    for epoch in (1, 2, 3, 10):
        t_ckpt.save_checkpoint(str(tmp_path), epoch, tree)
    assert _files(tmp_path) == ["ckpt_10.json", "ckpt_10.npz", "ckpt_3.json", "ckpt_3.npz"]
    t_ckpt.save_checkpoint(str(tmp_path), 11, tree, keep=1)
    assert _files(tmp_path) == ["ckpt_11.json", "ckpt_11.npz"]
    assert not [f for f in _files(tmp_path) if "tmp" in f]


@pytest.mark.parametrize("case", ["leaf_count", "shape", "rank"])
def test_load_checkpoint_fits_or_refuses(tmp_path, case):
    tree = _tree(np.random.default_rng(0))
    t_ckpt.save_checkpoint(str(tmp_path), 1, tree)
    template = _tree(np.random.default_rng(1))
    if case == "leaf_count":
        del template["rng"]
        with pytest.raises(ValueError, match="6 leaves, template has 5"):
            t_ckpt.load_checkpoint(str(tmp_path), 1, template)
    elif case == "shape":
        template["params"]["user_emb"] = np.zeros((5, 4), np.float32)
        with pytest.raises(ValueError, match="was the run configuration"):
            t_ckpt.load_checkpoint(str(tmp_path), 1, template)
    else:
        template["opt_state"]["count"] = np.zeros((1,), np.int32)
        got, _ = t_ckpt.load_checkpoint(str(tmp_path), 1, template)
        assert got["opt_state"]["count"].shape == (1,) and int(got["opt_state"]["count"][0]) == 4


def _train(ckpt_dir, **kw):
    kw.setdefault("checkpoint_every", 1)
    return t_loop.train_model("LightGCN", t_make(*_SHAPE, seed=4, name="tiny"), TConfig(_CFG),
                              seed=1, log_dir=None, echo=False, checkpoint_dir=ckpt_dir,
                              device="cpu", **kw)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    a, b = str(tmp / "straight"), str(tmp / "resumed")
    straight = _train(a)
    first = _train(b, max_epochs=3)
    second = _train(b)  # finds ckpt_3, runs epoch 4
    return dict(a=a, b=b, straight=straight, first=first, second=second)


def test_resume_equals_straight_run_bit_for_bit(resumed):
    assert _files(resumed["a"]) == _files(resumed["b"]) == [
        "ckpt_3.json", "ckpt_3.npz", "ckpt_4.json", "ckpt_4.npz"]
    la, ma = t_ckpt.read_checkpoint(resumed["a"], 4)
    lb, mb = t_ckpt.read_checkpoint(resumed["b"], 4)
    assert len(la) == len(lb) == 9 and ma["num_leaves"] == 9
    for x, y in zip(la, lb):  # Adam's step and moments, the tables, both generator states
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert ma == mb  # epoch, best results, the numpy generator's state
    assert int(la[0]) == 4 * 12  # Adam's step: four epochs of 12 steps


def test_resumed_run_continues_where_it_stopped(resumed):
    straight, first, second = (resumed[k] for k in ("straight", "first", "second"))
    assert [h["epoch"] for h in first.history] == [1, 2, 3]
    assert [h["epoch"] for h in second.history] == [4]
    assert [h["loss"] for h in first.history + second.history] == [h["loss"] for h in straight.history]
    for k in ("user_emb", "item_emb"):
        assert torch.equal(second.params[k], straight.params[k])
    assert second.best.epoch == straight.best.epoch and second.best.count == straight.best.count
    np.testing.assert_array_equal(second.best.recall, straight.best.recall)
    np.testing.assert_array_equal(second.best.ndcg, straight.best.ndcg)
    assert second.best.recall.dtype == straight.best.recall.dtype


def test_default_cadence_saves_at_eval_epochs(tmp_path):
    _train(str(tmp_path), checkpoint_every=None)  # interval 2: epochs 1 and 3
    assert _files(tmp_path) == ["ckpt_1.json", "ckpt_1.npz", "ckpt_3.json", "ckpt_3.npz"]


def test_recommender_from_checkpoint_equals_from_train_result(resumed):
    data, cfg = t_make(*_SHAPE, seed=4, name="tiny"), TConfig(_CFG)
    a = TRecommender.from_train_result("LightGCN", data, cfg, resumed["straight"], device="cpu")
    b = TRecommender.from_checkpoint("LightGCN", data, cfg, resumed["a"], device="cpu")
    c = TRecommender.from_checkpoint("LightGCN", data, cfg, resumed["a"], epoch=3, device="cpu")
    users = [0, 5, 17, 199]
    ia, sa = a.recommend(users, k=10)
    ib, sb = b.recommend(users, k=10)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(sa, sb)
    assert not np.array_equal(sa, c.recommend(users, k=10)[1])
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        TRecommender.from_checkpoint("LightGCN", data, cfg, resumed["a"] + "_none", device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("jaxck"))
    jdata = j_make(*_SHAPE, seed=4, name="tiny")
    jcfg = JConfig({**_CFG, "interval": "1"})
    res = j_loop.train_model("LightGCN", jdata, jcfg, seed=1, log_dir=None, echo=False,
                             max_epochs=2, checkpoint_dir=ck)
    return dict(ck=ck, res=res, jdata=jdata, jcfg=jcfg)


def test_load_jax_checkpoint_into_model_and_adam(jax_run):
    tdata, tcfg = t_make(*_SHAPE, seed=4, name="tiny"), TConfig({**_CFG, "interval": "1"})
    model = t_get_model("LightGCN")(tcfg, tdata, device="cpu")
    runner = TRunner(model, 0.01, 256, tdata.num_train)
    meta = convert.load_jax_checkpoint(model, runner.opt, jax_run["ck"])
    assert meta["epoch"] == 2 and meta["num_leaves"] == convert.jax_num_leaves(model) == 8
    jparams = jax.device_get(jax_run["res"].params)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == 2 * 12 and float(np.abs(adam["mu"]["user_emb"]).max()) > 0
    assert (adam["nu"]["item_emb"] >= 0).all()
    # evaluated in the port: the JAX run's last evaluation, of these same tables
    got = TEvaluator(model, tdata, tcfg).evaluate()
    for name in ("recall", "precision", "ndcg"):
        np.testing.assert_allclose(got[name], jax_run["res"].last_result[name], rtol=0, atol=1e-6)
    # the optimizer is optional
    convert.load_jax_checkpoint(t_get_model("LightGCN")(tcfg, tdata, device="cpu"), None,
                                jax_run["ck"], epoch=1)


def test_recommender_serves_a_jax_checkpoint_like_the_jax_recommender(jax_run):
    tdata, tcfg = t_make(*_SHAPE, seed=4, name="tiny"), TConfig({**_CFG, "interval": "1"})
    trec = TRecommender.from_checkpoint("LightGCN", tdata, tcfg, jax_run["ck"], device="cpu")
    jrec = JRecommender.from_checkpoint("LightGCN", jax_run["jdata"], jax_run["jcfg"],
                                        jax_run["ck"])
    users = np.arange(0, 200, 7)
    t_items, t_scores = trec.recommend(users, k=10)
    j_items, j_scores = jrec.recommend(users, k=10)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    tied = np.abs(t_scores - j_scores) <= 1e-5
    assert ((t_items == j_items) | tied).all()
    assert (t_items == j_items).mean() > 0.95


def test_load_jax_checkpoint_refuses_what_it_cannot_read(resumed, tmp_path):
    tdata, tcfg = t_make(*_SHAPE, seed=4, name="tiny"), TConfig(_CFG)
    model = t_get_model("LightGCN")(tcfg, tdata, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        convert.load_jax_checkpoint(model, None, str(tmp_path))
    with pytest.raises(ValueError, match="has 9 leaves"):
        convert.load_jax_checkpoint(model, None, resumed["a"])  # the port's own layout
    other = t_get_model("LightGCN")(TConfig({**_CFG, "embedding_size": "8"}), tdata, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        leaves, _ = t_ckpt.read_checkpoint(resumed["a"], 4)
        convert.load_jax_params(
            other, convert.split_adam_and_params(leaves, convert.table_names(other))[3])
