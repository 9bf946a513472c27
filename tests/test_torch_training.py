"""The training slice as a whole against the JAX package: from the same
parameters and the same (user, pos, neg) arrays, `EpochRunner` steps in
both packages, then `Evaluator` metrics from the same parameters.
LightGCN, int8 quantized chain, 3 layers, Pallas kernels interpreted.

Tolerances:
* loss terms per step within rtol 1e-5 (f32 sums in another order; the
  forward chains agree to ulps here);
* parameters after each of three Adam steps within 0.25 learn_rate per
  element and 1e-3 learn_rate on average. Adam's first updates are
  ~learn_rate · g/|g|: a 1-lsb flip of a quantized cotangent between
  the packages moves a few gradients by ~1 %, hence a few parameters by
  a small fraction of learn_rate, while a wrong gradient (a sign, a
  missing term) moves parameters by 1-2 learn_rate and fails;
* Adam moments read back through `convert` after three steps, relative
  to their largest entry, within rtol 2e-2 / atol 1e-3 (they sum the
  same gradients, 1-lsb flips included);
* evaluator metrics within 1e-6 absolute (the same parameters, scores
  in full f32, exact top-k; the seeds give no tie at the cut)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.engine.evaluator import BestResults as TBest
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.evaluator import build_eval_plan as t_build_eval_plan
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.engine.evaluator import BestResults as JBest
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.engine.evaluator import build_eval_plan as j_build_eval_plan
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model

LR, B = 0.001, 256
_CFG = {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001", "GCN_layer": "3",
        "compute_dtype": "int8", "learn_rate": str(LR), "batch_size": str(B),
        "test_batch_size": "64", "top_K": "[5, 10]"}
_SHAPE = (200, 300, 3000, 400)


def _models(seed=7):
    jdata, tdata = j_make(*_SHAPE, seed=4), t_make(*_SHAPE, seed=4)
    jmodel = j_get_model("LightGCN")(JConfig(_CFG), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = t_get_model("LightGCN")(TConfig(_CFG), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    return jdata, tdata, jmodel, tmodel, params


def _batch(tdata, rng, size=B):
    pick = rng.integers(0, tdata.num_train, size)
    return (tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, size))


def _j32(*arrays):
    return tuple(jnp.asarray(a, jnp.int32) for a in arrays)


def _t64(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in arrays)


@pytest.fixture(scope="module")
def trained():
    """Three one-step epochs in both packages; the records of each."""
    jdata, tdata, jmodel, tmodel, params = _models()
    jrun, trun = JRunner(jmodel, LR, B, B), TRunner(tmodel, LR, B, B)
    assert jrun.num_batches == trun.num_batches == 1
    opt_state, state = jrun.init_opt_state(params), {}
    rng = np.random.default_rng(0)
    steps = []
    for step in range(3):
        u, p, n = _batch(tdata, rng)
        params, opt_state, state, jterms = jrun.run_epoch(
            params, opt_state, state, (), *_j32(u, p, n), jax.random.PRNGKey(1), step)
        tterms = trun.run_epoch(*_t64(u, p, n), epoch=step)
        steps.append((np.asarray(jterms), tterms.numpy(),
                      jax.device_get(params), convert.jax_params_from_model(tmodel)))
    return dict(steps=steps, opt_state=opt_state, trun=trun, tmodel=tmodel, jmodel=jmodel,
                params=params, jdata=jdata, tdata=tdata)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_step_loss_terms_match_jax(trained, step):
    jterms, tterms, _, _ = trained["steps"][step]
    assert tterms.shape == (2,) and tterms.dtype == np.float32
    assert np.isfinite(tterms).all()
    np.testing.assert_allclose(tterms, jterms, rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_step_parameters_match_jax(trained, step):
    _, _, jparams, tparams = trained["steps"][step]
    for k in ("user_emb", "item_emb"):
        diff = np.abs(tparams[k] - np.asarray(jparams[k])) / LR
        assert diff.max() <= 0.25, (k, diff.max())
        assert diff.mean() <= 1e-3, (k, diff.mean())


def test_parameters_moved_by_about_learn_rate(trained):
    start = jax.device_get(trained["jmodel"].init_params(jax.random.PRNGKey(7)))
    _, _, _, tparams = trained["steps"][0]
    moved = np.abs(tparams["user_emb"] - np.asarray(start["user_emb"])) / LR
    assert 0.5 < np.median(moved) <= 1.0 + 1e-3  # Adam's first update


def test_adam_state_crosses_both_ways(trained):
    opt_state, trun, tmodel = trained["opt_state"], trained["trun"], trained["tmodel"]
    got = convert.adam_state_to_numpy(trun.opt, tmodel)
    adam = opt_state[0]
    assert got["count"] == int(adam.count) == 3
    for k in ("user_emb", "item_emb"):
        for name, ref in (("mu", adam.mu[k]), ("nu", adam.nu[k])):
            ref = np.asarray(ref)
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got[name][k] / scale, ref / scale, rtol=2e-2, atol=1e-3)


def test_same_step_from_the_same_carried_state(trained):
    """optax state -> torch.optim.Adam, then one more step in both."""
    jdata, tdata, jmodel, tmodel, _ = _models()
    params, adam = trained["params"], trained["opt_state"][0]
    convert.load_jax_params(tmodel, jax.device_get(params))
    trun = TRunner(tmodel, LR, B, B)
    convert.load_adam_state(trun.opt, tmodel, int(adam.count), jax.device_get(adam.mu),
                            jax.device_get(adam.nu))
    jrun = JRunner(jmodel, LR, B, B)
    u, p, n = _batch(tdata, np.random.default_rng(9))
    copy = jax.tree.map(jnp.array, (params, trained["opt_state"]))  # run_epoch donates
    jparams, _, _, jterms = jrun.run_epoch(copy[0], copy[1], {}, (), *_j32(u, p, n),
                                           jax.random.PRNGKey(1), 3)
    tterms = trun.run_epoch(*_t64(u, p, n), epoch=3)
    np.testing.assert_allclose(tterms.numpy(), np.asarray(jterms), rtol=1e-5)
    for k in ("user_emb", "item_emb"):
        diff = np.abs(getattr(tmodel, k).detach().numpy() - np.asarray(jparams[k])) / LR
        assert diff.max() <= 0.25, (k, diff.max())
    with pytest.raises(ValueError):
        convert.load_adam_state(trun.opt, tmodel, 1, {"user_emb": np.zeros((2, 2)),
                                                      "item_emb": np.zeros((2, 2))},
                                jax.device_get(adam.nu))


def test_three_steps_in_one_epoch_and_wrapped_trailing_batch():
    jdata, tdata, jmodel, tmodel, params = _models(seed=8)
    num_train = 2 * B + 40  # the third batch wraps around to the epoch's start
    jrun, trun = JRunner(jmodel, LR, B, num_train), TRunner(tmodel, LR, B, num_train)
    assert jrun.num_batches == trun.num_batches == 3
    u, p, n = _batch(tdata, np.random.default_rng(3), num_train)
    jb = jrun._prepare(*_j32(u, p, n))
    tb = trun._prepare(*_t64(u, p, n))
    for k in ("user", "pos", "neg"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jparams, _, _, jterms = jrun.run_epoch(params, jrun.init_opt_state(params), {}, (),
                                           *_j32(u, p, n), jax.random.PRNGKey(1), 0)
    tterms = trun.run_epoch(*_t64(u, p, n))
    np.testing.assert_allclose(tterms.numpy(), np.asarray(jterms), rtol=1e-5)
    for k in ("user_emb", "item_emb"):
        diff = np.abs(getattr(tmodel, k).detach().numpy() - np.asarray(jparams[k])) / LR
        assert diff.max() <= 0.25, (k, diff.max())


def test_loss_terms_gradients_match_jax():
    jdata, tdata, jmodel, tmodel, params = _models(seed=9)
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names) == ("bpr", "reg")
    u, p, n = _batch(tdata, np.random.default_rng(4))
    batch = dict(zip(("user", "pos", "neg"), _j32(u, p, n)))

    def j_loss(prm):
        (bpr, reg), _ = jmodel.loss_terms(prm, {}, (), batch, jax.random.PRNGKey(0), 0)
        return bpr + reg

    ref = jax.grad(j_loss)(params)
    bpr, reg = tmodel.loss_terms(dict(zip(("user", "pos", "neg"), _t64(u, p, n))))
    (bpr + reg).backward()
    for k in ("user_emb", "item_emb"):
        got, want = getattr(tmodel, k).grad.numpy(), np.asarray(ref[k])
        scale = np.abs(want).max()
        # three sweeps: NOISE on gradients normalized to their largest entry
        np.testing.assert_allclose(got / scale, want / scale, rtol=2e-2, atol=1e-2)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


def test_eval_plan_matches_jax():
    jdata, tdata = j_make(*_SHAPE, seed=4), t_make(*_SHAPE, seed=4)
    for users in (None, [3, 1, 77, 150]):
        jp, tp = (j_build_eval_plan(jdata, 64, users=users),
                  t_build_eval_plan(tdata, 64, users=users, device="cpu"))
        assert tp.num_test_users == jp.num_test_users
        for name in ("users", "valid", "truth", "excl_rows", "excl_cols"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                          err_msg=name)
    with pytest.raises(ValueError, match="at least one test user"):
        t_build_eval_plan(tdata, 64, users=[], device="cpu")
    assert tdata.get_statistics() == jdata.get_statistics()
    assert tdata.test_dict == jdata.test_dict


@pytest.mark.parametrize("which", ["initial", "trained"])
def test_evaluator_metrics_match_jax(trained, which):
    jdata, tdata, jmodel = trained["jdata"], trained["tdata"], trained["jmodel"]
    params = (jmodel.init_params(jax.random.PRNGKey(7)) if which == "initial"
              else trained["params"])
    tmodel = t_get_model("LightGCN")(TConfig(_CFG), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    ref = JEvaluator(jmodel, jdata, JConfig(_CFG)).evaluate(params, {}, (), jax.random.PRNGKey(0))
    tev = TEvaluator(tmodel, tdata, TConfig(_CFG))
    got = tev.evaluate()
    again = tev.evaluate(eval_repr=tev.compute_repr())
    for name in ("recall", "precision", "ndcg"):
        assert got[name].shape == (2,) and np.isfinite(got[name]).all()
        assert ((got[name] >= 0) & (got[name] <= 1)).all()
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[name], again[name])
    assert got["recall"][1] > 0


def test_evaluator_on_a_user_subset_matches_jax(trained):
    jdata, tdata, jmodel, tmodel = (trained[k] for k in ("jdata", "tdata", "jmodel", "tmodel"))
    users = sorted(tdata.test_dict)[::3]
    ref = JEvaluator(jmodel, jdata, JConfig(_CFG), users=users).evaluate(
        trained["params"], {}, (), jax.random.PRNGKey(0))
    got = TEvaluator(tmodel, tdata, TConfig(_CFG), users=users).evaluate()
    for name in ("recall", "precision", "ndcg"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-6)


def test_best_results_matches_jax():
    seq = [0.10, 0.12, 0.11, 0.12, 0.09, 0.13, 0.1, 0.1, 0.1]
    t, j = TBest(patience=3), JBest(patience=3)
    for epoch, r in enumerate(seq):
        res = {"recall": np.array([r, r + 0.1], np.float32),
               "ndcg": np.array([r / 2, r], np.float32)}
        t.update(res, epoch)
        j.update(res, epoch)
        assert (t.count, t.epoch, t.stop) == (j.count, j.epoch, j.stop)
        np.testing.assert_array_equal(t.recall, j.recall)
        np.testing.assert_array_equal(t.ndcg, j.ndcg)
    assert t.stop and t.epoch == 6


def test_unported_options_raise():
    tdata = t_make(*_SHAPE, seed=4)
    tmodel = t_get_model("LightGCN")(TConfig(_CFG), tdata, device="cpu")
    # the mesh is ported: a batch that does not divide its data axis raises
    # as the JAX runner does; a one-rank mesh evaluates as one process
    from idgrec_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="data axis"):
        TRunner(tmodel, LR, B + 1, B, mesh=Mesh(2, 1))
    on_mesh = TEvaluator(tmodel, tdata, TConfig(_CFG), mesh=Mesh(1, 1)).evaluate()
    alone = TEvaluator(tmodel, tdata, TConfig(_CFG)).evaluate()
    for k in ("recall", "precision", "ndcg"):
        np.testing.assert_array_equal(on_mesh[k], alone[k])
    # `approx` (the JAX package's TPU approx_max_k) is taken and ranks
    # exactly: the metrics equal exact's; another mode raises
    with pytest.raises(ValueError, match="eval_topk"):
        TEvaluator(tmodel, tdata, TConfig({**_CFG, "eval_topk": "nearest"}))
    approx = TEvaluator(tmodel, tdata, TConfig({**_CFG, "eval_topk": "approx"})).evaluate()
    exact = TEvaluator(tmodel, tdata, TConfig(_CFG)).evaluate()
    for k in ("recall", "precision", "ndcg"):
        np.testing.assert_array_equal(approx[k], exact[k])
    # batch-row propagation is ported; in int8 `auto` resolves to fused,
    # which has no row product, so the model keeps the full propagation
    # (with the JAX package's warning)
    rows_model = t_get_model("LightGCN")(TConfig({**_CFG, "batch_rows_propagation": "1"}),
                                         tdata, device="cpu")
    assert rows_model.batch_rows and not getattr(rows_model.graph, "supports_rows", False)
    dense_rows = t_get_model("LightGCN")(
        TConfig({**_CFG, "batch_rows_propagation": "1", "propagation_backend": "dense"}),
        tdata, device="cpu")
    assert dense_rows.graph.supports_rows


def test_optimizer_is_the_named_adam():
    tmodel = t_get_model("LightGCN")(TConfig(_CFG), t_make(*_SHAPE, seed=4), device="cpu")
    opt = TRunner(tmodel, LR, B, B).opt
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (LR, (0.9, 0.999), 1e-8)
    assert group["foreach"] is False and group["fused"] is False
