"""EGCF and the tanh chain of the port against the JAX package on the
same inputs (JAX Pallas kernels interpreted on the CPU).

Tolerances, with their reasons:
* one counted layer: the port and the JAX chain quantize the same
  inputs bit for bit, and only tanh separates them: XLA:CPU's tanh
  differs from PyTorch's by up to 5 ulps (measured on these inputs, with
  and without the seed sweep), so TANH_ULPS = 5 ulps of the reference;
* three layers cross int8 round()s of tanh outputs, where an
  ulp-perturbed value on a rounding tie moves one activation by 1 lsb:
  NOISE (rtol 2e-2, atol 1e-2, the bar of tests/test_chainmm.py) plus a
  relative L2 error below 1e-2; gradients at the same bars, normalized
  to their largest entry;
* the `self` diag's one layer at TIGHT: XLA may contract the diag's
  multiply-add into an FMA;
* the port's own routes run the same operations in the same order: the
  resident chain, its plain version and `fused_chain_t` are equal bit
  for bit forward, the resident chain and its plain version backward
  too. `fused_chain_t`'s gradient goes through autograd's tanh
  backward, which rounds 1 − h² once (an FMA), where the chain rounds
  twice as the TPU kernel does: NOISE;
* with the seed, the user rows' gradient is exactly zero (the seed
  consumes a zero user input);
* EGCF from carried JAX weights: loss terms within rtol 1e-5, gradients
  at NOISE, three Adam steps within 0.25 learn_rate per element and
  1e-3 learn_rate on average (tests/test_torch_training.py's bars and
  reasons), metrics within 1e-6, served ids equal except among scores
  within 1e-5 (near 0.5 the sigmoid rounds scores closer than ~6e-8 to
  one float, and `torch.topk` and `lax.top_k` order such exact ties
  differently: the weights trained from seed 8 leave no tie that moves a
  metric, where seed 7's move NDCG@5 by 1e-3); float32 modes at TIGHT; bfloat16 modes within BF16 = 2**-7
  of the largest entry (both packages round tanh outputs to bfloat16,
  and a tanh ulp can move a rounding)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import propagate as j_prop

torch.set_num_threads(1)

TANH_ULPS = 5
TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
BF16 = 2.0 ** -7
D, NU = 16, 200
_SHAPE = (NU, 300, 3000, 400)
LR, B = 0.001, 256
_CFG = {"dataset": "tiny", "embedding_size": str(D), "reg_lambda": "0.0001", "GCN_layer": "3",
        "ssl_lambda": "0.1", "temperature": "0.1", "mode": "parallel", "compute_dtype": "int8",
        "learn_rate": str(LR), "batch_size": str(B), "test_batch_size": "64",
        "top_K": "[5, 10]", "interval": "1"}


def _within_ulps(got, ref, ulps=TANH_ULPS):
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= ulps * np.spacing(np.abs(ref).astype(np.float32))).all(), float(err.max())


def _noise(got, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, **NOISE)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5))


@pytest.fixture(scope="module")
def adjs(datasets):
    tdata, jdata = datasets
    out = {}
    for quant in ("int8", "int4"):
        out[quant] = (t_prop.build_adjacency(tdata, "sym", "fused", compute_dtype=quant,
                                             emb_size=D, device="cpu"),
                      j_prop.build_adjacency(jdata, "sym", "fused", compute_dtype=quant,
                                             emb_size=D))
    return out


def _x(n, seed, zero_users):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    if zero_users:
        x[:NU] = 0.0  # EGCF's x0 = [0; E_i]
    return x, rng.normal(size=(n, D)).astype(np.float32)


def _t_grad(fn, adj, x, w, layers, seed):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(adj, xt, layers, False, "sum", torch.tanh, seed)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("quant,seed,layers", [
    ("int8", False, 1), ("int8", True, 1), ("int8", False, 3), ("int8", True, 3),
    ("int4", True, 3),
])
def test_tanh_chain_matches_jax(adjs, quant, seed, layers):
    t, j = adjs[quant]
    x, w = _x(t.shape[0], seed=layers + 2 * seed, zero_users=seed)
    got, grad = _t_grad(t_chainmm.fused_chain_resident, t, x, w, layers, seed)
    xj = jnp.asarray(x)
    for ref in (j_prop.fused_chain_t(j, xj, layers, False, "sum", jnp.tanh, seed),
                j_chainmm.fused_chain_resident(j, xj, layers, False, "sum", jnp.tanh, seed)):
        ref = np.asarray(ref)
        if layers == 1:
            _within_ulps(got, ref)
        else:
            _noise(got, ref)
    ref_grad = np.asarray(jax.grad(lambda e: jnp.sum(
        j_chainmm.fused_chain_resident(j, e, layers, False, "sum", jnp.tanh, seed) * w))(xj))
    _noise(grad, ref_grad)
    if seed:
        assert not grad[:NU].any() and not ref_grad[:NU].any()
        assert grad[NU:].any()


@pytest.mark.parametrize("seed", [False, True])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_port_routes_agree_bit_for_bit(adjs, seed, reduce):
    t, _ = adjs["int8"]
    x, w = _x(t.shape[0], seed=7, zero_users=seed)
    outs, grads = [], []
    for fn in (t_chainmm.fused_chain_resident, t_chainmm.fused_chain_resident_plain,
               t_prop.fused_chain_t):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = fn(t, xt, 3, False, reduce, torch.tanh, seed)
        (out * torch.from_numpy(w)).sum().backward()
        outs.append(out.detach())
        grads.append(xt.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert torch.equal(grads[0], grads[1])
    _noise(grads[2].numpy(), grads[0].numpy())


def test_int4_chain_equals_int8(adjs):
    x, w = _x(adjs["int8"][0].shape[0], seed=8, zero_users=True)
    (a, ga), (b, gb) = (_t_grad(t_chainmm.fused_chain_resident, adjs[q][0], x, w, 3, True)
                        for q in ("int8", "int4"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("layers", [1, 3])
def test_self_diag_tanh_chain_t_matches_jax(datasets, layers):
    tdata, jdata = datasets
    t = t_prop.build_adjacency(tdata, "self", "fused", compute_dtype="int8", emb_size=D,
                               device="cpu")
    j = j_prop.build_adjacency(jdata, "self", "fused", compute_dtype="int8", emb_size=D)
    assert t.has_diag and not t_chainmm.supports_chain_resident(t, D, layers, "sum", torch.tanh,
                                                                False)
    x, _ = _x(t.shape[0], seed=9, zero_users=False)
    got = t_prop.fused_chain_t(t, torch.from_numpy(x), layers, False, "sum", torch.tanh).numpy()
    ref = np.asarray(j_prop.fused_chain_t(j, jnp.asarray(x), layers, False, "sum", jnp.tanh))
    if layers == 1:
        np.testing.assert_allclose(got, ref, **TIGHT)
    else:
        _noise(got, ref)
    with pytest.raises(ValueError, match="no self-loop diag"):
        t_prop.fused_chain_t(t, torch.from_numpy(x), 1, False, "sum", torch.tanh, True)


def test_supports_chain_resident_follows_the_jax_rules(adjs):
    t, j = adjs["int8"]
    for act_t, act_j, layer0, seed in ((torch.tanh, jnp.tanh, False, True),
                                       (torch.tanh, jnp.tanh, False, False),
                                       (torch.tanh, jnp.tanh, True, False),
                                       (None, None, False, True),
                                       (None, None, True, False)):
        assert (t_chainmm.supports_chain_resident(t, D, 3, "sum", act_t, layer0, seed)
                == j_chainmm.supports_chain_resident(j, D, 3, "sum", act_j, layer0, seed)), \
            (act_t, layer0, seed)
    assert not t_chainmm.supports_chain_resident(t, D, 3, "sum", torch.relu, False)
    with pytest.raises(ValueError, match="torch.tanh"):
        t_chainmm.fused_chain_resident(t, torch.zeros(t.shape[0], D), 2, False, "sum", torch.relu)


@pytest.mark.parametrize("combine", [t_chainmm.COMBINE_NONE, t_chainmm.COMBINE_SET,
                                     t_chainmm.COMBINE_ADD])
@pytest.mark.parametrize("want_next", [True, False])
def test_tanh_epilogue_plain(combine, want_next):
    rng = np.random.default_rng(13)
    y, c = (torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32)) for _ in range(2))
    s = torch.from_numpy(rng.random(4).astype(np.float32))
    post, pre = (torch.from_numpy(rng.random(12).astype(np.float32)) for _ in range(2))
    c0, h_out = c.clone(), torch.full((4, 12), np.nan)
    z, amax = t_chainmm.chain_sweep_tanh(y, s, post, pre, c, h_out, combine, want_next)
    h = torch.tanh(post[None, :] * (y * s[:, None]))
    assert torch.equal(h_out, h)
    want_c = {t_chainmm.COMBINE_NONE: c0, t_chainmm.COMBINE_SET: h,
              t_chainmm.COMBINE_ADD: c0 + h}[combine]
    assert torch.equal(c, want_c)
    if want_next:
        assert torch.equal(z, pre[None, :] * h) and torch.equal(amax, z.abs().amax(dim=1))
    else:
        assert z is None and amax is None


@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("want_next", [True, False])
def test_tanh_inject_epilogue_plain(inject, want_next):
    rng = np.random.default_rng(14)
    y, g = (torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32)) for _ in range(2))
    h = torch.tanh(torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32)))
    s = torch.from_numpy(rng.random(4).astype(np.float32))
    post, pre = (torch.from_numpy(rng.random(12).astype(np.float32)) for _ in range(2))
    g0 = g.clone()
    out, amax = t_chainmm.chain_sweep_tanh_inject(y, s, post, pre, g, h if want_next else None,
                                                  inject, want_next)
    store = post[None, :] * (y * s[:, None])
    if inject:
        store = g0 + store
    if want_next:
        want = pre[None, :] * ((1.0 - h * h) * store)
        assert torch.equal(out, want) and torch.equal(amax, want.abs().amax(dim=1))
    else:
        assert torch.equal(out, store) and amax is None
    assert torch.equal(g, g0)


# ---------------------------------------------------------------------------
# the model


def _models(datasets, cfg=None, seed=7):
    tdata, jdata = datasets
    cfg = {**_CFG, **(cfg or {})}
    jmodel = j_get_model("EGCF")(JConfig(cfg), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = t_get_model("EGCF")(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    return jmodel, tmodel, params


def _batch(tdata, rng, size=B):
    pick = rng.integers(0, tdata.num_train, size)
    return (tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, size))


def _j32(*arrays):
    return tuple(jnp.asarray(a, jnp.int32) for a in arrays)


def _t64(*arrays):
    return tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in arrays)


def test_egcf_has_one_item_table(datasets):
    jmodel, tmodel, params = _models(datasets)
    assert set(params) == {"item_emb"} and convert.table_names(tmodel) == ("item_emb",)
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names) == ("bpr", "reg", "ssl")
    assert not hasattr(tmodel, "user_emb")
    assert t_chainmm.supports_chain_resident(tmodel.graph, D, 3, "sum", torch.tanh, False, True)
    # the draw from a generator: the item table alone, Xavier-uniform
    a = t_get_model("EGCF")(TConfig(_CFG), datasets[0], device="cpu",
                            generator=torch.Generator().manual_seed(3))
    limit = float(np.sqrt(6.0 / (D + datasets[0].num_items)))
    assert float(a.item_emb.detach().abs().max()) <= limit


def test_loss_terms_and_gradients_match_jax(datasets):
    jmodel, tmodel, params = _models(datasets, seed=9)
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    batch = dict(zip(("user", "pos", "neg"), _j32(u, p, n)))

    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, (), batch, jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    (_, jterms), ref = jax.value_and_grad(j_loss, has_aux=True)(params)
    terms = tmodel.loss_terms(dict(zip(("user", "pos", "neg"), _t64(u, p, n))))
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], np.asarray(jterms), rtol=1e-5)
    sum(terms).backward()
    _noise(tmodel.item_emb.grad.numpy(), np.asarray(ref["item_emb"]))


@pytest.fixture(scope="module")
def trained(datasets):
    """Three one-step epochs in both packages, int8 on the resident chain."""
    jmodel, tmodel, params = _models(datasets, seed=8)
    jrun, trun = JRunner(jmodel, LR, B, B), TRunner(tmodel, LR, B, B)
    opt_state, rng, steps = jrun.init_opt_state(params), np.random.default_rng(0), []
    batches = [_batch(datasets[0], rng) for _ in range(3)]
    for step, (u, p, n) in enumerate(batches):
        params, opt_state, _, jterms = jrun.run_epoch(params, opt_state, {}, (), *_j32(u, p, n),
                                                      jax.random.PRNGKey(1), step)
        tterms = trun.run_epoch(*_t64(u, p, n), epoch=step)
        steps.append((np.asarray(jterms), tterms.numpy(), jax.device_get(params)["item_emb"],
                      tmodel.item_emb.detach().numpy().copy()))
    return dict(steps=steps, params=params, tmodel=tmodel, jmodel=jmodel, batches=batches)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_three_adam_steps_match_jax(trained, step):
    jterms, tterms, jparams, tparams = trained["steps"][step]
    assert tterms.shape == (3,) and np.isfinite(tterms).all()
    np.testing.assert_allclose(tterms, jterms, rtol=1e-5)
    diff = np.abs(tparams - jparams) / LR
    assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


def test_int4_steps_equal_int8(datasets, trained):
    _, tmodel, _ = _models(datasets, cfg={"compute_dtype": "int4"}, seed=8)
    assert tmodel.graph.quant == "int4"
    trun = TRunner(tmodel, LR, B, B)
    for step, (u, p, n) in enumerate(trained["batches"]):
        tterms = trun.run_epoch(*_t64(u, p, n), epoch=step)
        _, want_terms, _, want = trained["steps"][step]
        np.testing.assert_array_equal(tterms.numpy(), want_terms)
        np.testing.assert_array_equal(tmodel.item_emb.detach().numpy(), want)


@pytest.mark.parametrize("which", ["evaluator", "recommender"])
def test_trained_model_evaluates_and_serves_like_jax(datasets, trained, which):
    tdata, jdata = datasets
    jmodel, tmodel, params = trained["jmodel"], trained["tmodel"], trained["params"]
    convert.load_jax_params(tmodel, jax.device_get(params))
    if which == "evaluator":
        ref = JEvaluator(jmodel, jdata, JConfig(_CFG)).evaluate(params, {}, (),
                                                               jax.random.PRNGKey(0))
        got = TEvaluator(tmodel, tdata, TConfig(_CFG)).evaluate()
        for name in ("recall", "precision", "ndcg"):
            np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-6)
        assert got["recall"][1] > 0
        return
    from idgrec_tpu.serving import Recommender as JRecommender

    users = np.arange(0, NU, 7)
    t_items, t_scores = TRecommender(tmodel, tdata).recommend(users, k=10)
    j_items, j_scores = JRecommender(jmodel, params, {}, (), jdata).recommend(users, k=10)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    assert ((t_items == j_items) | (np.abs(t_scores - j_scores) <= 1e-5)).all()


@pytest.mark.parametrize("backend,dtype", [
    ("fused", "bfloat16"), ("fused", "float32"), ("dense", "bfloat16"), ("dense", "float32"),
    ("gather", "float32"), ("bitpack", "bfloat16"), ("bitpack", "float32"),
])
def test_exact_modes_match_jax(datasets, backend, dtype):
    """The per-application loop, tanh(graph.matmul(·)) per layer. bitpack
    rounds the activations to bfloat16 in float32 mode too."""
    jmodel, tmodel, params = _models(datasets, cfg={"compute_dtype": dtype,
                                                    "propagation_backend": backend})
    assert not t_chainmm.supports_chain_resident(tmodel.graph, D, 3, "sum", torch.tanh, False,
                                                 True)
    ju, ji = jmodel.eval_embeddings(params, {}, (), jax.random.PRNGKey(0))
    tu, ti = tmodel.eval_embeddings()
    got, ref = torch.cat([tu, ti]).numpy(), np.concatenate([np.asarray(ju), np.asarray(ji)])
    if dtype == "float32" and backend != "bitpack":
        np.testing.assert_allclose(got, ref, **TIGHT)
    else:
        assert np.abs(got - ref).max() <= BF16 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# checkpoints: a JAX EGCF checkpoint in the port, resume in the port


@pytest.fixture(scope="module")
def jax_egcf_run(datasets, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("jax_egcf"))
    cfg = JConfig({**_CFG, "compute_dtype": "float32", "propagation_backend": "dense"})
    res = j_loop.train_model("EGCF", datasets[1], cfg, seed=1, log_dir=None, echo=False,
                             max_epochs=1, checkpoint_dir=ck)
    return ck, res


def test_jax_egcf_checkpoint_loads_into_the_port(datasets, jax_egcf_run):
    ck, res = jax_egcf_run
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model("EGCF")(TConfig(_CFG), datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 5
    runner = TRunner(model, LR, B, datasets[0].num_train)
    meta = convert.load_jax_checkpoint(model, runner.opt, ck)
    assert meta["epoch"] == 1
    np.testing.assert_array_equal(model.item_emb.detach().numpy(),
                                  np.asarray(jax.device_get(res.params)["item_emb"]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == -(-datasets[0].num_train // B) and set(adam["mu"]) == {"item_emb"}
    rec = TRecommender.from_checkpoint("EGCF", datasets[0], TConfig(_CFG), ck, device="cpu")
    assert torch.equal(rec.model.item_emb, model.item_emb)
    # a LightGCN model refuses the 5-leaf file: its layout has 8
    lgcn = t_get_model("LightGCN")(TConfig(_CFG), datasets[0], device="cpu")
    with pytest.raises(ValueError, match="has 5 leaves.*has 8"):
        convert.load_jax_checkpoint(lgcn, None, ck)


def test_port_egcf_resume_equals_straight_run(datasets, tmp_path):
    tdata = datasets[0]
    cfg = TConfig({**_CFG, "training_epochs": "2"})
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("EGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    t_loop.train_model("EGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=1, **kw)
    resumed = t_loop.train_model("EGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert set(straight.params) == {"item_emb"}
    assert torch.equal(straight.params["item_emb"], resumed.params["item_emb"])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    np.testing.assert_array_equal(straight.best.recall, resumed.best.recall)
    leaves, meta = t_ckpt.read_checkpoint(str(tmp_path / "a"), 2)
    # count, mu, nu, params, then the two generators' states
    assert meta["num_leaves"] == len(leaves) == 6
    rec = TRecommender.from_train_result("EGCF", tdata, cfg, straight, device="cpu")
    items, _ = rec.recommend([1, 17], k=5)
    assert items.shape == (2, 5)
