"""The port's LightGCN serving path against the JAX package's, from the
same JAX-initialized parameters (carried over by idgrec_torch.convert),
int8 quantized chain, 3 layers.

Tolerances: eval embeddings within NOISE (rtol 2e-2, atol 1e-2, the
3-sweep bar of tests/test_chainmm.py); served scores within NOISE; the
served items equal the JAX items except among tied scores, checked as:
each served item's reference score equals the reference's score at
that rank within TIE (1e-5 absolute on sigmoid scores). torch.topk and
jax.lax.top_k order ties differently."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.serving import Recommender as JRecommender

NOISE = dict(rtol=2e-2, atol=1e-2)
TIE = 1e-5
_CFG = {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001",
        "GCN_layer": "3", "compute_dtype": "int8"}
_SHAPE = (60, 90, 1100, 200)


@pytest.fixture(scope="module")
def served():
    jdata = j_make(*_SHAPE, seed=4)
    jmodel = j_get_model("LightGCN")(JConfig(_CFG), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(7))
    jrec = JRecommender(jmodel, params, {}, (), jdata)

    tdata = t_make(*_SHAPE, seed=4)
    tmodel = t_get_model("LightGCN")(TConfig(_CFG), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    trec = TRecommender(tmodel, tdata)
    return jrec, trec, tdata, params, tmodel


def _ref_ratings(jrec, users):
    ue, ie = (np.asarray(a, np.float64) for a in jrec._repr)
    r = 1.0 / (1.0 + np.exp(-(ue[users] @ ie.T)))
    for row, u in enumerate(users):
        r[row, jrec.data.positive_items(u)] = -1e9
    return r


def _assert_same_topk(jrec, users, k, got_items, got_scores):
    ref_items, ref_scores = jrec.recommend(users, k=k)
    np.testing.assert_allclose(got_scores, ref_scores, **NOISE)
    ratings = _ref_ratings(jrec, users)
    chosen = np.take_along_axis(ratings, got_items, axis=1)
    np.testing.assert_allclose(chosen, ref_scores, rtol=0, atol=TIE)
    same = got_items == ref_items
    # wherever the ids differ, the reference scores tie
    assert np.all(same | (np.abs(chosen - ref_scores) <= TIE))


def test_params_carried_over(served):
    _, _, _, params, tmodel = served
    np.testing.assert_array_equal(tmodel.user_emb.detach().numpy(), np.asarray(params["user_emb"]))
    np.testing.assert_array_equal(tmodel.item_emb.detach().numpy(), np.asarray(params["item_emb"]))
    with pytest.raises(ValueError):
        convert.load_jax_params(tmodel, {"user_emb": np.zeros((2, 16)), "item_emb": params["item_emb"]})
    with pytest.raises(KeyError):
        convert.state_dict_from_jax({"user_emb": params["user_emb"]}, ("item_emb", "user_emb"))


def test_eval_embeddings_noise(served):
    jrec, trec, _, _, _ = served
    for got, ref in zip(trec._repr, jrec._repr):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **NOISE)
        assert np.linalg.norm(got.numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref)) < 1e-2


@pytest.mark.parametrize("users", [[0], [5, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]],
                         ids=["b1", "b2", "b17"])
def test_recommend_matches_jax(served, users):
    jrec, trec, tdata, _, _ = served
    items, scores = trec.recommend(users, k=7)
    assert items.shape == scores.shape == (len(users), 7)
    assert items.dtype == np.int64 and scores.dtype == np.float32
    _assert_same_topk(jrec, users, 7, items, scores)
    for row, u in enumerate(users):
        assert not set(items[row].tolist()) & set(tdata.positive_items(u).tolist())
        assert np.all(np.diff(scores[row]) <= 0)


def test_unfiltered_ranks_everything(served):
    _, _, tdata, _, tmodel = served
    rec = TRecommender(tmodel, tdata, filter_seen=False)
    items, _ = rec.recommend([5], k=tdata.num_items)
    assert sorted(items[0].tolist()) == list(range(tdata.num_items))


def test_recommend_validates(served):
    _, trec, tdata, _, tmodel = served
    with pytest.raises(ValueError):
        trec.recommend([tdata.num_users + 5], k=3)
    with pytest.raises(ValueError):
        trec.recommend([-1], k=3)
    with pytest.raises(ValueError):
        trec.recommend([[0, 1]], k=3)
    with pytest.raises(ValueError):
        trec.recommend([0], k=0)
    with pytest.raises(ValueError):
        trec.recommend([0], k=tdata.num_items + 1)
    with pytest.raises(ValueError):
        TRecommender(tmodel, tdata, topk_mode="nearest")
    # `approx` (the JAX package's TPU approx_max_k) ranks exactly in the port
    approx = TRecommender(tmodel, tdata, topk_mode="approx")
    for users in ([0, 5, 9], list(range(tdata.num_users))):
        a_items, a_scores = approx.recommend(users, k=7)
        e_items, e_scores = trec.recommend(users, k=7)
        np.testing.assert_array_equal(a_items, e_items)
        np.testing.assert_array_equal(a_scores, e_scores)


def test_entry_points_need_a_device_without_cuda(served):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tdata, _, _ = served
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_get_model("LightGCN")(TConfig(_CFG), tdata)
