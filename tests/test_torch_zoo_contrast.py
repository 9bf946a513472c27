"""CGCL, NCL, HCCF and IMPGCN in the port against the JAX package: the
same tables carried across (`convert`), the same batches, the same
draws. Each model runs its published config at the test's sizes (d = 32,
2 layers; IMPGCN 3 layers, so that its three groups' batched product
runs at 96 wide) over the default route (bfloat16 on ``auto``: dense,
whose products run kernel K6's plain version on the CPU). K6 computes
the JAX fused backend's function, so the JAX side runs
``propagation_backend = fused``.

The same draws: HCCF runs with ``keeprate = 0.5`` so that its masks are
drawn, and IMPGCN draws its two dropout masks in training; both record
``jax.random.bernoulli`` and replay it in the port
(tests/test_torch_zoo_noise.py's Tape and Replay). NCL's k-means is
jitted in the JAX package, so its initial rows are derived eagerly from
the same key (the np_rng seed, ``PRNGKey``, ``split``, ``choice``) and
replayed as the port's ``noise.choice``; NCL is compared past a warm-up
of one epoch, where its prototype term is non-zero.

Bars (tests/test_torch_zoo.py's, with their reasons there): loss terms
within rtol LOSS_RTOL = 1e-5; gradients within GRAD_BF16 = 2**-8 of the
largest entry; three Adam steps within 0.25 learn_rate per element and
1e-3 learn_rate on average; eval embeddings within TIGHT; served ids
equal except among scores within 1e-5.

IMPGCN's gates are compared first. Its top-1 grouping compares floats
for equality, so a user whose two best group scores lie within a few
ulps could fall into another group on the other route; such a user would
be named with its score gap, and any gate that differs fails the test.
Its four grouping tables get a gradient of None in the port and exactly
zero in JAX, and neither package moves them in three Adam steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch import main as t_main
from idgrec_torch import serve as t_serve
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import base as t_base
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import losses as t_losses
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.models.base import concat_user_item as j_concat
from idgrec_tpu.ops import losses as j_losses
from idgrec_tpu.serving import Recommender as JRecommender
from test_torch_zoo_noise import (  # noqa: F401  (fixtures)
    B,
    D,
    LOSS_RTOL,
    LR,
    ROOT,
    TIGHT,
    GRAD_BF16,
    Replay,
    Tape,
    _batch,
    _close_in_lr,
    _grad_close,
    _jbatch,
    _tbatch,
    _write_files,
    datasets,
    tape_and_replay,
)
from test_torch_zoo_noise import _cfg as _noise_cfg

CONTRAST = ("CGCL", "NCL", "HCCF", "IMPGCN")
GROUPING = ("fc_b", "fc_group_b", "fc_group_w", "fc_w")
# NCL past its warm-up at the test's sizes: one warm-up epoch, 16 clusters
NCL_EPOCH, NCL_K, NP_SEED = 1, 16, 21
_EXTRA = {"NCL": {"warmup_epochs": str(NCL_EPOCH), "k": str(NCL_K)},
          "HCCF": {"keeprate": "0.5"}, "IMPGCN": {"GCN_layer": "3"}}


def _cfg(name, **extra):
    return _noise_cfg(name, **{**_EXTRA.get(name, {}), **extra})


def _models(datasets, name, seed=7, jax_backend="fused", **extra):
    tdata, jdata = datasets
    cfg = _cfg(name, **extra)
    # the port's dense route runs K6's function: JAX's fused backend
    jmodel = j_get_model(name)(JConfig({**cfg, "propagation_backend": jax_backend}), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    tmodel = t_get_model(name)(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    return jmodel, tmodel, params, cfg


def _epoch(name):
    return NCL_EPOCH if name == "NCL" else 0


def jax_kmeans_rows(seed: int, sizes: tuple[int, ...], k: int) -> list[np.ndarray]:
    """The initial rows of JAX's k-means, derived eagerly: one key a
    clustering, split from ``PRNGKey(seed)``, ``choice`` without
    replacement (the jitted k-means draws the same from the same key)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(sizes))
    return [np.asarray(jax.random.choice(key, n, (k,), replace=False))
            for key, n in zip(keys, sizes)]


def _contexts(jmodel, tmodel, params, replay, epoch):
    """JAX's epoch context and the port's, from np_rng's of one seed, the
    port's initial rows replayed from JAX's key; the two streams' next
    draws equal."""
    j_rng, t_rng = np.random.default_rng(NP_SEED), np.random.default_rng(NP_SEED)
    ctx = jmodel.epoch_context(params, {}, epoch, j_rng)
    if epoch >= getattr(tmodel, "warmup_epochs", 0) and tmodel.model_name == "NCL":
        seed = int(np.random.default_rng(NP_SEED).integers(0, 2**31 - 1))
        rows = jax_kmeans_rows(seed, (tmodel.num_users, tmodel.num_items), tmodel.k)
        replay.load([("choice", r) for r in rows])
    tmodel.epoch_context(epoch, t_rng)
    replay.done()
    assert j_rng.integers(0, 2**31 - 1) == t_rng.integers(0, 2**31 - 1)
    return ctx


def _j_step(jmodel, params, ctx, batch, key, epoch):
    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, ctx, batch, key, epoch)
        return sum(terms), terms

    (_, terms), grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    return np.asarray(terms), {k: np.asarray(v) for k, v in grads.items()}


def _expected_draws(name, cfg, training=True):
    if not training:
        return []
    layers = int(cfg["GCN_layer"])
    return {"CGCL": [], "NCL": [], "HCCF": ["bernoulli"] * 2 * layers,
            "IMPGCN": ["bernoulli"] * 2}[name]


# ---------------------------------------------------------------------------
# registry, configs, tables


def test_contrast_models_are_registered():
    assert set(CONTRAST) <= set(t_available())
    for name in CONTRAST:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", CONTRAST)
def test_config_copy_is_the_jax_file_byte_for_byte(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    assert t_load_config(name).str("compute_dtype") == "bfloat16"
    assert t_load_config(name).str("propagation_backend") == "auto"
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()


@pytest.mark.parametrize("name,leaves", [("CGCL", 8), ("NCL", 8), ("HCCF", 14), ("IMPGCN", 20)])
def test_tables_loss_names_and_route_match_jax(datasets, name, leaves):
    jmodel, tmodel, params, cfg = _models(datasets, name)
    assert convert.table_names(tmodel) == tuple(sorted(params))
    assert convert.jax_num_leaves(tmodel) == leaves
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names)
    for k, v in jax.device_get(params).items():
        np.testing.assert_array_equal(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    g = tmodel.graph
    assert isinstance(g, t_prop.DenseSquareAdj) and g.quant == "none"
    assert g.runs_kernel(D) and g.runs_kernel(3 * D)  # IMPGCN's groups at 3d


def test_hccf_and_impgcn_draw_their_tables(datasets):
    h = t_get_model("HCCF")(TConfig(_cfg("HCCF")), datasets[0], device="cpu",
                            generator=torch.Generator().manual_seed(3))
    size = int(_cfg("HCCF")["hyper_size"])
    assert tuple(h.user_hyper.shape) == tuple(h.item_hyper.shape) == (D, size)
    limit = float(np.sqrt(6.0 / (D + size)))
    assert 0.9 * limit < float(h.user_hyper.detach().abs().max()) <= limit
    m = t_get_model("IMPGCN")(TConfig(_cfg("IMPGCN")), datasets[0], device="cpu",
                              generator=torch.Generator().manual_seed(3))
    groups = int(_cfg("IMPGCN")["group"])
    assert tuple(m.fc_w.shape) == (D, D) and tuple(m.fc_b.shape) == (D,)
    assert tuple(m.fc_group_w.shape) == (D, groups) and tuple(m.fc_group_b.shape) == (groups,)
    bound = 1.0 / np.sqrt(D)
    for t in (m.fc_w, m.fc_b, m.fc_group_w, m.fc_group_b):
        assert float(t.detach().abs().max()) <= bound


# ---------------------------------------------------------------------------
# the full-pool InfoNCE


@pytest.mark.parametrize("pool,t", [(300, 0.1), (200, 0.05), (7, 1.0)])
def test_infonce_loss_sum_matches_jax_and_the_mean(pool, t):
    rng = np.random.default_rng(pool)
    a, b = (rng.normal(size=(64, D)).astype(np.float32) for _ in range(2))
    c = rng.normal(size=(pool, D)).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = t_losses.infonce_loss_sum(ta, tb, tc, t)
    want = j_losses.infonce_loss_sum(*(jnp.asarray(x) for x in (a, b, c)), t)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    mean = t_losses.infonce_loss_all(ta, tb, tc, t)
    np.testing.assert_allclose(float(got), 64 * float(mean), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# IMPGCN's gates


def _impgcn_gates(jmodel, tmodel, params, replay, tape, key):
    """(JAX's gates [N, G], the port's, the port's scores [N, G]) for the
    training step of ``key``, JAX's two masks replayed."""
    ego = j_concat(params)
    _, _, k_gate = jax.random.split(key, 3)
    jgates = np.asarray(jmodel._group_gates(params, ego, jmodel.graph.matmul(ego), k_gate,
                                            True)).T
    draws = tape.take()
    assert [k for k, _ in draws] == ["bernoulli", "bernoulli"]
    replay.load(draws)
    t_ego = t_base.concat_user_item(tmodel.user_emb, tmodel.item_emb).detach()
    scores = tmodel.group_scores(t_ego, tmodel.graph.matmul(t_ego), torch.Generator(), True)
    replay.done()
    return jgates, tmodel.group_gates(scores).numpy(), scores.numpy()


def _check_gates(jgates, tgates, scores):
    differ = np.flatnonzero((jgates != tgates).any(axis=1))
    top2 = np.sort(scores, axis=1)[:, -2:]
    gaps = {int(u): float(top2[u, 1] - top2[u, 0]) for u in differ}
    assert not len(differ), f"users whose gates differ, with their score gaps: {gaps}"


def test_impgcn_gates_match_jax(datasets, tape_and_replay):
    tape, replay = tape_and_replay
    jmodel, tmodel, params, _ = _models(datasets, "IMPGCN", seed=9)
    tape.take()  # the initial tables' draws
    jgates, tgates, scores = _impgcn_gates(jmodel, tmodel, params, replay, tape,
                                           jax.random.PRNGKey(0))
    _check_gates(jgates, tgates, scores)
    nu = datasets[0].num_users
    assert (tgates[nu:] == 1).all() and (tgates[:nu].sum(axis=1) >= 1).all()
    # the dropout's zeros tie exactly: some users sit in several groups
    assert (tgates[:nu].sum(axis=1) > 1).any()
    assert set(np.unique(tgates[:nu].argmax(axis=1))) == {0, 1, 2}


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving, with JAX's draws


@pytest.mark.parametrize("name", CONTRAST)
def test_loss_terms_and_gradients_match_jax(datasets, tape_and_replay, name):
    tape, replay = tape_and_replay
    jmodel, tmodel, params, cfg = _models(datasets, name, seed=9)
    epoch = _epoch(name)
    ctx = _contexts(jmodel, tmodel, params, replay, epoch)
    tape.take()  # the initial tables' draws and the derivation of k-means's rows
    key = jax.random.PRNGKey(0)
    if name == "IMPGCN":
        _check_gates(*_impgcn_gates(jmodel, tmodel, params, replay, tape, key))
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    jterms, jgrads = _j_step(jmodel, params, ctx, _jbatch(u, p, n), key, epoch)
    draws = tape.take()
    assert [k for k, _ in draws] == _expected_draws(name, cfg)
    replay.load(draws)
    terms = tmodel.loss_terms(_tbatch(u, p, n), torch.Generator(), epoch)
    assert len(terms) == len(tmodel.loss_names)
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], jterms, rtol=LOSS_RTOL)
    if name == "NCL":
        assert float(terms[3].detach()) > 0  # past the warm-up: the prototype term
    sum(terms).backward()
    replay.done()
    if name == "CGCL":
        # JAX fused's gradients are NaN here: held to JAX on gather
        jgather, _, gparams, _ = _models(datasets, name, seed=9, jax_backend="gather")
        _, jgrads = _j_step(jgather, gparams, ctx, _jbatch(u, p, n), key, epoch)
    for k in convert.table_names(tmodel):
        if name == "IMPGCN" and k in GROUPING:
            assert getattr(tmodel, k).grad is None and not jgrads[k].any()
            continue
        _grad_close(getattr(tmodel, k).grad.numpy(), jgrads[k], GRAD_BF16)


@pytest.mark.parametrize("name", CONTRAST)
def test_three_adam_steps_evaluate_and_serve_like_jax(datasets, tape_and_replay, name):
    """Three steps in both packages with JAX's draws (NCL past its
    warm-up, its clusters made once), then the eval embeddings and the
    served ids from the JAX weights carried across. CGCL steps on gather
    in both packages (JAX fused's steps are NaN), then evaluates and
    serves on the default route beside JAX fused."""
    tape, replay = tape_and_replay
    extra = dict(jax_backend="gather", propagation_backend="gather") if name == "CGCL" else {}
    jmodel, tmodel, params, _ = _models(datasets, name, seed=8, **extra)
    epoch = _epoch(name)
    ctx = _contexts(jmodel, tmodel, params, replay, epoch)
    tape.take()
    start = jax.device_get(params)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng = opt.init(params), np.random.default_rng(0)
    trun = TRunner(tmodel, LR, B, B)
    for step in range(3):
        u, p, n = _batch(datasets[0], rng)
        jterms, grads = _j_step(jmodel, params, ctx, _jbatch(u, p, n),
                                jax.random.PRNGKey(10 + step), epoch)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        replay.load(tape.take())
        tterms = trun.run_epoch(*_tbatch(u, p, n).values(), generator=torch.Generator(),
                                epoch=epoch).numpy()
        replay.done()
        assert tterms.shape == (len(tmodel.loss_names),) and np.isfinite(tterms).all()
        np.testing.assert_allclose(tterms, jterms, rtol=LOSS_RTOL * 10 ** step)
        for k, v in jax.device_get(params).items():
            _close_in_lr(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    if name == "IMPGCN":
        for k in GROUPING:  # no gradient in the port, zero in JAX: neither moves
            np.testing.assert_array_equal(np.asarray(jax.device_get(params)[k]), start[k])
            np.testing.assert_array_equal(getattr(tmodel, k).detach().numpy(), start[k])
    if name == "CGCL":
        jmodel, tmodel = _models(datasets, name)[:2]
        tape.take()
    assert isinstance(tmodel.graph, t_prop.DenseSquareAdj)
    convert.load_jax_params(tmodel, jax.device_get(params))
    key = jax.random.PRNGKey(5)
    ju, ji = jmodel.eval_embeddings(params, {}, ctx, key)
    assert tape.take() == []
    tu, ti = tmodel.eval_embeddings(torch.Generator())
    got, ref = torch.cat([tu, ti]).numpy(), np.concatenate([np.asarray(ju), np.asarray(ji)])
    np.testing.assert_allclose(got, ref, **TIGHT)
    users = np.arange(0, datasets[0].num_users, 7)
    j_items, j_scores = JRecommender(jmodel, params, {}, ctx, datasets[1],
                                     rng=key).recommend(users, k=10)
    t_items, t_scores = TRecommender(tmodel, datasets[0]).recommend(users, k=10)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    assert ((t_items == j_items) | (np.abs(t_scores - j_scores) <= 1e-5)).all()


def test_cgcl_jax_fused_gradient_is_nan(datasets):
    """CGCL's struct head contrasts against the full item table of layer
    1, where an item with no train edge (187 and 280 on this set) is a
    zero row: the JAX package's norm has a NaN gradient there, which its
    fused products carry into every user row. PyTorch's norm has gradient
    0 there, so the port's step stays finite."""
    tdata = datasets[0]
    assert np.setdiff1d(np.arange(tdata.num_items), tdata.train_item).tolist() == [187, 280]
    jmodel, tmodel, params, _ = _models(datasets, "CGCL", seed=9)
    u, p, n = _batch(tdata, np.random.default_rng(4))
    jterms, jgrads = _j_step(jmodel, params, (), _jbatch(u, p, n), jax.random.PRNGKey(0), 0)
    assert np.isfinite(jterms).all() and np.isnan(jgrads["user_emb"]).all()
    sum(tmodel.loss_terms(_tbatch(u, p, n))).backward()
    assert all(bool(torch.isfinite(t_.grad).all()) for t_ in tmodel.parameters())


# ---------------------------------------------------------------------------
# NCL's warm-up; the generator where a step draws


def test_ncl_epoch_context_matches_jax(datasets, tape_and_replay):
    """Past the warm-up, from one np_rng seed: JAX's clusters and the
    port's (K4's plain version for the sums on the CPU), the assignments
    equal and the centroids within 1e-5 (tests/test_torch_kmeans.py)."""
    tape, replay = tape_and_replay
    jmodel, tmodel, params, _ = _models(datasets, "NCL", seed=9)
    ctx = _contexts(jmodel, tmodel, params, replay, NCL_EPOCH)
    for side in ("user", "item"):
        np.testing.assert_array_equal(getattr(tmodel, f"{side}_2cluster").numpy(),
                                      np.asarray(ctx[f"{side}_2cluster"]))
        np.testing.assert_allclose(getattr(tmodel, f"{side}_centroids").numpy(),
                                   np.asarray(ctx[f"{side}_centroids"]), rtol=0, atol=1e-5)
        assert len(np.unique(np.asarray(ctx[f"{side}_2cluster"]))) > NCL_K // 2


def test_ncl_before_the_warmup_has_zero_clusters_and_proto(datasets, tape_and_replay):
    tape, replay = tape_and_replay
    jmodel, tmodel, params, _ = _models(datasets, "NCL", seed=9, warmup_epochs="3")
    ctx = _contexts(jmodel, tmodel, params, replay, 2)
    for k in ("user_centroids", "item_centroids", "user_2cluster", "item_2cluster"):
        assert not np.asarray(ctx[k]).any() and not getattr(tmodel, k).any()
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    jterms, _ = _j_step(jmodel, params, ctx, _jbatch(u, p, n), jax.random.PRNGKey(0), 2)
    terms = tmodel.loss_terms(_tbatch(u, p, n), None, 2)
    assert float(terms[3]) == 0.0 == float(jterms[3])
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], jterms, rtol=LOSS_RTOL)


def test_ncl_clusters_stay_out_of_the_state_dict(datasets):
    _, tmodel, _, _ = _models(datasets, "NCL")
    tmodel.epoch_context(NCL_EPOCH, np.random.default_rng(0))
    assert set(tmodel.state_dict()) == {"user_emb", "item_emb"}
    assert tuple(tmodel.user_centroids.shape) == (NCL_K, D)
    assert tmodel.item_2cluster.dtype == torch.int64
    assert tuple(tmodel.item_2cluster.shape) == (datasets[0].num_items,)


@pytest.mark.parametrize("name", ["HCCF", "IMPGCN"])
def test_a_drawing_step_without_a_generator_raises(datasets, name):
    _, tmodel, _, _ = _models(datasets, name)
    batch = _tbatch(*_batch(datasets[0], np.random.default_rng(1)))
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        tmodel.loss_terms(batch)
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        TRunner(tmodel, LR, B, B).run_epoch(*batch.values())


@pytest.mark.parametrize("name", CONTRAST)
def test_steps_that_draw_nothing_need_no_generator(datasets, name):
    """CGCL and NCL never draw, HCCF at its published keeprate of 1.0
    neither; evaluation draws in none of the four, so the generator is
    left untouched."""
    extra = {"keeprate": "1.0"} if name == "HCCF" else {}
    _, tmodel, _, _ = _models(datasets, name, **extra)
    batch = _tbatch(*_batch(datasets[0], np.random.default_rng(1)))
    if name != "IMPGCN":
        terms = tmodel.loss_terms(batch)
        assert all(bool(torch.isfinite(t_)) for t_ in terms)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    for a, b in zip(tmodel.eval_embeddings(gen), tmodel.eval_embeddings()):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------------
# checkpoints, resume, the command lines


@pytest.mark.parametrize("name", ["HCCF", "IMPGCN"])
def test_jax_checkpoint_loads_into_the_port(datasets, tmp_path, name):
    ck = str(tmp_path / f"jax_{name}")
    res = j_loop.train_model(name, datasets[1], JConfig(_cfg(name)), seed=1, log_dir=None,
                             echo=False, max_epochs=1, checkpoint_dir=ck)
    cfg = TConfig(_cfg(name))
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model(name)(cfg, datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == {"HCCF": 14, "IMPGCN": 20}[name]
    runner = TRunner(model, LR, B, datasets[0].num_train)
    assert convert.load_jax_checkpoint(model, runner.opt, ck)["epoch"] == 1
    jparams = jax.device_get(res.params)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == -(-datasets[0].num_train // B)
    assert set(adam["mu"]) == set(jparams)
    if name == "IMPGCN":
        for k in GROUPING:
            assert not adam["mu"][k].any() and not adam["nu"][k].any()
    rec = TRecommender.from_checkpoint(name, datasets[0], cfg, ck, device="cpu")
    assert torch.equal(rec.model.item_emb, model.item_emb)


def test_ncl_resume_equals_straight_run(datasets, tmp_path):
    """Warm-up 1, three epochs: the clusters of epochs 1 and 2 come from
    np_rng, which the checkpoint of epoch 2 carries, so a run resumed
    there equals a straight one."""
    tdata = datasets[0]
    cfg = TConfig(_cfg("NCL", training_epochs="3"))
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("NCL", tdata, cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    t_loop.train_model("NCL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=2,
                       **kw)
    assert t_ckpt.latest_checkpoint(str(tmp_path / "b")) == 2
    resumed = t_loop.train_model("NCL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    np.testing.assert_array_equal(straight.best.recall, resumed.best.recall)


def test_impgcn_checkpoint_counts_the_steps_its_grouping_tables_skip(datasets, tmp_path):
    """The grouping tables take no Adam step in the port (their gradient
    is None), yet a checkpoint's Adam count is the run's, as in optax,
    and their moments stay zero."""
    ck = str(tmp_path / "ck")
    t_loop.train_model("IMPGCN", datasets[0], TConfig(_cfg("IMPGCN")), seed=2, log_dir=None,
                       echo=False, max_epochs=1, checkpoint_dir=ck, device="cpu")
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    names = tuple(sorted(("user_emb", "item_emb") + GROUPING))
    count, mu, nu, _ = convert.split_adam_and_params(leaves, names)
    assert count == -(-datasets[0].num_train // B)
    for k in GROUPING:
        assert not mu[k].any() and not nu[k].any()
    assert mu["user_emb"].any()


@pytest.mark.parametrize("name", ["NCL", "IMPGCN"])
def test_command_lines_train_and_serve(datasets, tmp_path, capsys, name):
    conf = _write_files(datasets, tmp_path, name)
    text = (conf / f"{name}.txt").read_text()
    # NCL for two epochs: the second clusters, past its warm-up of one
    extra = "".join(f"{k} = {v}\n" for k, v in _EXTRA[name].items())
    extra += "training_epochs = 2\n" if name == "NCL" else ""
    (conf / f"{name}.txt").write_text(text + extra)
    ck = tmp_path / "ck"
    code = t_main.main(["--model", name, "--configure_dir", str(conf), "--device", "cpu",
                        "--log_dir", str(tmp_path / "log"), "--checkpoint_dir", str(ck)])
    assert code == 0
    lines = (tmp_path / "log" / name / "tiny.log").read_text()
    assert f"Run with {name} on tiny" in lines and "Test recall" in lines
    capsys.readouterr()
    code = t_serve.main(["--model", name, "--configure_dir", str(conf), "--checkpoint_dir",
                         str(ck), "--users", "1,17,42", "-k", "5", "--device", "cpu"])
    assert code == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 3 and all('"items"' in r for r in rows)
