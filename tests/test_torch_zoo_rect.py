"""LightGCL and CVGA, the models on the rectangular adjacency R̃, in the
port against the JAX package: the same tables carried across
(`convert`), the same batches, the same draws. Each runs its published
config at the test's sizes (d = 32; LightGCL its 2 layers, CVGA its
encoder at 2d = 64) over the default route (bfloat16 on ``auto``: dense,
whose products run kernel K6's plain version on the CPU, one side left
out a direction; LightGCL's two directions of a layer in one call). The
JAX side runs its rectangular ``dense`` backend, whose forward is K6's
function.

LightGCL's SVD factors are JAX's, carried across (`LightGCL.load_factors`):
scipy's ARPACK starts from a random vector, so two builds of the JAX model
need not agree. `lowrank_svd` itself is held to JAX's by its singular
values and its rank-q product U·S·Vᵀ, not by the vectors (defined up to
sign).

CVGA's draws (its dropout mask and its reparameterisation's normal
noise, in training; the noise alone in evaluation) are JAX's, replayed
(tests/test_torch_zoo_noise.py's Replay): the step's from one jitted JAX
trace a model that returns them beside the gradients, the evaluation's
from an eager call on the key the JAX server and evaluator pass through.

Bars:
* loss terms within rtol LOSS_RTOL = 1e-5 (tests/test_torch_zoo.py's);
* gradients within GRAD_RECT = 2**-7 of the largest entry: the port
  rounds each product's cotangent to bfloat16 going in, where XLA rounds
  the transposed product's result to bfloat16 coming out (2**-9
  relative each), in four products a step (test_torch_rect.py's BF16
  bar for one product);
* three Adam steps at tests/test_torch_rect.py's bar for the bfloat16
  dense rectangular route, whose gradients' roundings are these: at most
  0.5 % of the entries above 0.25 learn_rate, 1e-2 learn_rate on average,
  and 2 learn_rate per step taken on any entry (an entry whose gradient
  changes sign moves by up to 2 learn_rate an update); the later steps'
  loss terms start from tables that far apart: rtol 1e-4 after the first
  step;
* eval embeddings within TIGHT: the forward rounds the same operands and
  sums the same exact float32 products in another order;
* metrics within 1e-6, served ids equal except among scores within 1e-5;
* `lowrank_svd`: singular values within rtol 1e-5, U·S·Vᵀ within 1e-5
  of its largest entry (float32 factors of a float64 decomposition);
* `elbo_loss` against JAX's within rtol 1e-6 (the same float32
  operations).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data import graph as t_graph
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import losses as t_losses
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.ops import svd as t_svd
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.data import graph as j_graph
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import losses as j_losses
from idgrec_tpu.ops import svd as j_svd
from idgrec_tpu.serving import Recommender as JRecommender
from test_torch_zoo_noise import (  # noqa: F401  (fixtures)
    LOSS_RTOL,
    LR,
    ROOT,
    TIGHT,
    _grad_close,
    _jbatch,
    _tbatch,
    datasets,
    tape_and_replay,
)
from test_torch_zoo_noise import _cfg as _noise_cfg

RECT = ("LightGCL", "CVGA")
GRAD_RECT = 2.0 ** -7
SEED, USERS_EVERY = 9, 7
# a step's batch: LightGCL's triples, CVGA's users
_BATCH = {"LightGCL": 256, "CVGA": 64}
# the leaves of a JAX checkpoint (3 n + 2 for n tables)
_LEAVES = {"LightGCL": 8, "CVGA": 14}


def _cfg(name, **extra):
    cfg = _noise_cfg(name, batch_size=str(_BATCH[name]), **extra)
    if name == "LightGCL":
        cfg["GCN_layer"] = t_load_config(name)["GCN_layer"]
    return cfg


def _batch(name, tdata, rng):
    b = _BATCH[name]
    if name == "CVGA":
        users = rng.permutation(tdata.num_users)[:b]
        return users, users, users
    pick = rng.integers(0, tdata.num_train, b)
    return tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, b)


@contextlib.contextmanager
def _recording():
    """``jax.random.bernoulli`` and ``normal`` recording their outputs
    (tracers under jit) as (kind, array) into the list it yields, in draw
    order."""
    originals = {k: getattr(jax.random, k) for k in ("bernoulli", "normal")}
    draws = []

    def recorder(kind):
        def draw(*args, **kwargs):
            out = originals[kind](*args, **kwargs)
            draws.append((kind, out))
            return out
        return draw

    for kind in originals:
        setattr(jax.random, kind, recorder(kind))
    try:
        yield draws
    finally:
        for kind, fn in originals.items():
            setattr(jax.random, kind, fn)


def _jit_step(jmodel):
    """jit(value_and_grad) of JAX's loss terms; the aux output holds the
    terms and the draws, in draw order."""
    def loss(params, batch, key):
        with _recording() as draws:
            terms, _ = jmodel.loss_terms(params, {}, (), batch, key, 0)
        return sum(terms), (terms, [d for _, d in draws], [k for k, _ in draws])

    kinds = []

    def traced(params, batch, key):
        total, (terms, arrays, names) = loss(params, batch, key)
        kinds[:] = names
        return total, (terms, arrays)

    step = jax.jit(jax.value_and_grad(traced, has_aux=True))

    def run(params, batch, key):
        (_, (terms, arrays)), grads = step(params, batch, key)
        return (np.asarray(terms), {k: np.asarray(v) for k, v in grads.items()},
                list(zip(kinds, (np.asarray(a) for a in arrays))))

    return run


def _jmodel(datasets, name, **extra):
    jmodel = j_get_model(name)(JConfig({**_cfg(name, **extra), "propagation_backend": "dense"}),
                               datasets[1])
    jmodel.device_put()
    return jmodel


def _eval_draws(jmodel, params, key):
    """JAX's evaluation representation and its draws, eagerly."""
    with _recording() as draws:
        rep = jmodel.eval_embeddings(params, {}, (), key)
    return rep, [(k, np.asarray(v)) for k, v in draws]


def _reference(datasets, name):
    """One JAX run of ``name`` on dense from PRNGKey(SEED)'s tables: three
    steps of three batches under Adam (each step's terms, gradients and
    draws), then from the stepped tables the eval representation and its
    draws, the evaluator's metrics and the served ids of every
    USERS_EVERY-th user (the same key everywhere: the draws repeat)."""
    jmodel = _jmodel(datasets, name)
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    start = jax.device_get(params)
    step = _jit_step(jmodel)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng, steps = opt.init(params), np.random.default_rng(0), []
    for s in range(3):
        u, p, n = _batch(name, datasets[0], rng)
        terms, grads, draws = step(params, _jbatch(u, p, n), jax.random.PRNGKey(10 + s))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(batch=(u, p, n), terms=terms, grads=grads, draws=draws,
                          params=jax.device_get(params)))
    key = jax.random.PRNGKey(5)
    rep, eval_draws = _eval_draws(jmodel, params, key)
    users = np.arange(0, datasets[0].num_users, USERS_EVERY)
    jrec = JRecommender(jmodel, params, {}, (), datasets[1], rng=key)
    items, scores = jrec.recommend(users, k=10)
    metrics = JEvaluator(jmodel, datasets[1], JConfig(_cfg(name))).evaluate(params, {}, (), key)
    factors = None
    if name == "LightGCL":
        factors = tuple(np.asarray(getattr(jmodel, k))
                        for k in ("u_mul_s", "v_mul_s", "u_t", "v_t"))
    return dict(start=start, steps=steps, rep=jax.device_get(rep), eval_draws=eval_draws,
                users=users, items=items, scores=scores, metrics=metrics, factors=factors)


@pytest.fixture(scope="module")
def reference(datasets):
    """`_reference` of a model, run once a module."""
    return functools.lru_cache(maxsize=None)(lambda name: _reference(datasets, name))


def _tmodel(datasets, name, ref, params=None, **extra):
    tmodel = t_get_model(name)(TConfig(_cfg(name, **extra)), datasets[0], device="cpu")
    convert.load_jax_params(tmodel, ref["start"] if params is None else params)
    if ref["factors"] is not None:
        tmodel.load_factors(*ref["factors"])
    return tmodel


def _repr_arrays(rep):
    if isinstance(rep, dict):
        return [np.asarray(rep[k]) for k in ("z", "p_w", "p_b")]
    return [np.concatenate([np.asarray(rep[0]), np.asarray(rep[1])])]


# ---------------------------------------------------------------------------
# registry, configs, tables, the route


def test_rect_models_are_registered():
    assert set(RECT) <= set(t_available())
    assert len(t_available()) == 24
    for name in RECT:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", RECT)
def test_config_copy_is_the_jax_file_byte_for_byte(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    assert t_load_config(name).str("compute_dtype", "bfloat16") == "bfloat16"
    assert t_load_config(name).str("propagation_backend", "auto") == "auto"
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()


@pytest.mark.parametrize("name", RECT)
def test_tables_leaves_and_route_match_jax(datasets, name):
    """Table names and shapes as JAX's, the leaves of a JAX checkpoint,
    and the route: the rectangular dense adjacency on K6 at the model's
    width (CVGA's encoder at 2d)."""
    jparams = jax.device_get(_jmodel(datasets, name).init_params(jax.random.PRNGKey(0)))
    tmodel = t_get_model(name)(TConfig(_cfg(name)), datasets[0], device="cpu")
    assert convert.table_names(tmodel) == tuple(sorted(jparams))
    for k, v in jparams.items():
        assert tuple(getattr(tmodel, k).shape) == np.shape(v), k
    assert convert.jax_num_leaves(tmodel) == _LEAVES[name]
    assert tmodel.batching == ("user_rows" if name == "CVGA" else "bpr_triples")
    assert tuple(tmodel.loss_names) == tuple(j_get_model(name).loss_names)
    g = tmodel.graph
    width = 2 * tmodel.embedding_size if name == "CVGA" else tmodel.embedding_size
    assert isinstance(g, t_prop.DenseRectAdj) and g.quant == "none" and g.runs_kernel(width)


def test_cvga_tables_are_torch_linear_draws_in_jax_order(datasets):
    """q_w [I, 2d] and q_b, then p_w [d, I] and p_b, each U(-k, k) with
    k = 1/sqrt(fan_in), drawn from the generator in that order."""
    tmodel = t_get_model("CVGA")(TConfig(_cfg("CVGA")), datasets[0], device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    ni, d = datasets[0].num_items, tmodel.embedding_size
    gen = torch.Generator().manual_seed(4)
    for name, shape, fan_in in (("q_w", (ni, 2 * d), ni), ("q_b", (2 * d,), ni),
                                ("p_w", (d, ni), d), ("p_b", (ni,), d)):
        k = 1.0 / np.sqrt(fan_in)
        want = torch.empty(shape).uniform_(-k, k, generator=gen)
        assert torch.equal(getattr(tmodel, name).detach(), want), name


def test_cvga_dense_rows_equal_jax(datasets):
    """The padded positives built with numpy equal JAX's per-user loop,
    and the batch's dense target rows equal JAX's scatter."""
    tmodel = t_get_model("CVGA")(TConfig(_cfg("CVGA")), datasets[0], device="cpu")
    jmodel = _jmodel(datasets, "CVGA")
    np.testing.assert_array_equal(tmodel._padded_pos.numpy(), np.asarray(jmodel._padded_pos))
    np.testing.assert_array_equal(tmodel._padded_vals.numpy(), np.asarray(jmodel._padded_vals))
    users = np.random.default_rng(2).permutation(datasets[0].num_users)[:64]
    got = tmodel._dense_rows(torch.from_numpy(users))
    want = np.asarray(jmodel._dense_rows(jnp.asarray(users, jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the pieces: the SVD, the scipy matrix, the ELBO


def test_to_scipy_equals_jax(datasets):
    got = t_graph.normalized_rectangular(datasets[0]).to_scipy()
    want = j_graph.normalized_rectangular(datasets[1], cache=False).to_scipy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert (got != want).nnz == 0


@pytest.mark.parametrize("q", [1, 5])
def test_lowrank_svd_matches_jax(datasets, q):
    """Singular values and the rank-q product U·S·Vᵀ as JAX's; the seeded
    start repeats bit for bit; the randomized fallback is JAX's, draw for
    draw."""
    r = t_graph.normalized_rectangular(datasets[0]).to_scipy()
    u, s, v = t_svd.lowrank_svd(r, q, seed=3)
    ju, js, jv = j_svd.lowrank_svd(r, q, seed=3)
    assert u.shape == (r.shape[0], q) and v.shape == (r.shape[1], q) and s.dtype == np.float32
    assert (np.diff(s) <= 0).all()
    np.testing.assert_allclose(s, js, rtol=1e-5)
    prod, jprod = (u * s[None, :]) @ v.T, (ju * js[None, :]) @ jv.T
    assert np.abs(prod - jprod).max() <= 1e-5 * np.abs(jprod).max()
    again = t_svd.lowrank_svd(r, q, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip((u, s, v), again))
    for a, b in zip(t_svd._randomized_svd(r, q, 3), j_svd._randomized_svd(r, q, 3)):
        np.testing.assert_array_equal(a, b)


def test_elbo_loss_matches_jax():
    rng = np.random.default_rng(8)
    recon = rng.normal(size=(16, 40)).astype(np.float32)
    x = (rng.random((16, 40)) < 0.1).astype(np.float32)
    mu, logvar = (rng.normal(size=(16, 8)).astype(np.float32) for _ in range(2))
    got = t_losses.elbo_loss(*(torch.from_numpy(a) for a in (recon, x, mu, logvar)), 0.5)
    want = j_losses.elbo_loss(*(jnp.asarray(a) for a in (recon, x, mu, logvar)), 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving, with JAX's factors and
# draws


@pytest.mark.parametrize("name", RECT)
def test_loss_terms_and_gradients_match_jax(datasets, reference, tape_and_replay, name):
    _, replay = tape_and_replay
    ref = reference(name)
    first = ref["steps"][0]
    d = int(_cfg(name)["embedding_size"])
    nu = datasets[0].num_users
    want_kinds = {"LightGCL": [], "CVGA": [("bernoulli", (nu, 2 * d)), ("normal", (nu, d))]}
    assert [(k, a.shape) for k, a in first["draws"]] == want_kinds[name]
    tmodel = _tmodel(datasets, name, ref)
    replay.load(first["draws"])
    terms = tmodel.loss_terms(_tbatch(*first["batch"]), torch.Generator())
    replay.done()
    np.testing.assert_allclose([float(t.detach()) for t in terms], first["terms"], rtol=LOSS_RTOL)
    sum(terms).backward()
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), first["grads"][k], GRAD_RECT)


@pytest.mark.parametrize("name", RECT)
def test_three_adam_steps_match_jax(datasets, reference, tape_and_replay, name):
    _, replay = tape_and_replay
    ref = reference(name)
    tmodel = _tmodel(datasets, name, ref)
    trun = TRunner(tmodel, LR, _BATCH[name], _BATCH[name])
    for s, step in enumerate(ref["steps"]):
        replay.load(step["draws"])
        tterms = trun.run_epoch(*_tbatch(*step["batch"]).values(),
                                generator=torch.Generator()).numpy()
        replay.done()
        np.testing.assert_allclose(tterms, step["terms"], rtol=1e-4 if s else LOSS_RTOL)
        for k, v in step["params"].items():
            diff = np.abs(getattr(tmodel, k).detach().numpy() - np.asarray(v)) / LR
            assert (diff.max() <= 2.0 * (s + 1) and (diff > 0.25).mean() <= 5e-3
                    and diff.mean() <= 1e-2), (k, diff.max(), (diff > 0.25).mean(), diff.mean())


@pytest.mark.parametrize("name", RECT)
def test_eval_embeddings_evaluator_and_server_match_jax(datasets, reference, tape_and_replay,
                                                        name):
    """From JAX's stepped tables: the eval representation (CVGA's dict of
    z and its decoder, its noise replayed), the evaluator's metrics and
    the served ids."""
    _, replay = tape_and_replay
    ref = reference(name)
    tmodel = _tmodel(datasets, name, ref, params=ref["steps"][-1]["params"])
    kinds = [k for k, _ in ref["eval_draws"]]
    assert kinds == (["normal"] if name == "CVGA" else [])
    replay.load(ref["eval_draws"])
    rep = tmodel.eval_embeddings(torch.Generator())
    replay.done()
    assert isinstance(rep, dict) == (name == "CVGA")
    tarrays = ([rep[k].numpy() for k in ("z", "p_w", "p_b")] if name == "CVGA"
               else [torch.cat(rep).numpy()])
    for got, want in zip(tarrays, _repr_arrays(ref["rep"])):
        np.testing.assert_allclose(got, want, **TIGHT)
    replay.load(ref["eval_draws"])
    metrics = TEvaluator(tmodel, datasets[0], TConfig(_cfg(name))).evaluate(
        generator=torch.Generator())
    replay.done()
    for k in ("recall", "precision", "ndcg"):
        np.testing.assert_allclose(metrics[k], np.asarray(ref["metrics"][k]), rtol=0, atol=1e-6)
    replay.load(ref["eval_draws"])
    t_items, t_scores = TRecommender(tmodel, datasets[0], generator=torch.Generator()) \
        .recommend(ref["users"], k=10)
    replay.done()
    np.testing.assert_allclose(t_scores, ref["scores"], rtol=0, atol=1e-5)
    assert ((t_items == ref["items"]) | (np.abs(t_scores - ref["scores"]) <= 1e-5)).all()


@pytest.mark.parametrize("name", RECT)
def test_other_backends_take_two_calls_and_match_jax(datasets, reference, tape_and_replay,
                                                     name):
    """On gather (float32) the adjacency has no two-direction call:
    LightGCL takes `matmul` and `t_matmul`; both models' eval
    representations match JAX's gather within TIGHT (CVGA's noise
    replayed)."""
    _, replay = tape_and_replay
    ref = reference(name)
    extra = {"propagation_backend": "gather", "compute_dtype": "float32"}
    jmodel = j_get_model(name)(JConfig(_cfg(name, **extra)), datasets[1])
    jmodel.device_put()
    tmodel = _tmodel(datasets, name, ref, **extra)
    assert isinstance(tmodel.graph, t_prop.GatherRectAdj)
    assert not hasattr(tmodel.graph, "matmul_both")
    jrep, draws = _eval_draws(jmodel, ref["start"], jax.random.PRNGKey(2))
    replay.load(draws)
    rep = tmodel.eval_embeddings(torch.Generator())
    replay.done()
    tarrays = ([rep[k].numpy() for k in ("z", "p_w", "p_b")] if name == "CVGA"
               else [torch.cat(rep).numpy()])
    for got, want in zip(tarrays, _repr_arrays(jrep)):
        np.testing.assert_allclose(got, want, **TIGHT)


# ---------------------------------------------------------------------------
# generators, the run harness's user rows, checkpoints


def test_cvga_draws_need_a_generator_and_lightgcl_draws_nothing(datasets):
    cvga = t_get_model("CVGA")(TConfig(_cfg("CVGA")), datasets[0], device="cpu")
    users = torch.arange(64)
    batch = {"user": users, "pos": users, "neg": users}
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        cvga.loss_terms(batch)
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        cvga.eval_embeddings()
    light = t_get_model("LightGCL")(TConfig(_cfg("LightGCL")), datasets[0], device="cpu")
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    tb = _tbatch(*_batch("LightGCL", datasets[0], np.random.default_rng(1)))
    assert all(bool(torch.isfinite(t)) for t in light.loss_terms(tb, gen))
    for a, b in zip(light.eval_embeddings(gen), light.eval_embeddings()):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), state)


def test_a_user_rows_epoch_feeds_every_user_once(datasets, monkeypatch):
    """`train_model` on CVGA: no sampler; each epoch a permutation of the
    user ids from the run's generator as user, pos and neg, the last
    batch wrapped from the epoch's start; the epoch's steps are
    ceil(U / B)."""
    tdata = datasets[0]
    cvga_cls = t_get_model("CVGA")
    seen = []
    real = cvga_cls.loss_terms

    def spy(self, batch, generator=None, epoch=0):
        assert torch.equal(batch["user"], batch["pos"]) and torch.equal(batch["user"],
                                                                          batch["neg"])
        seen.append((epoch, batch["user"].clone()))
        return real(self, batch, generator, epoch)

    monkeypatch.setattr(cvga_cls, "loss_terms", spy)
    monkeypatch.setattr(t_loop, "NegativeSampler", None)  # a user-row run builds none
    res = t_loop.train_model("CVGA", tdata, TConfig(_cfg("CVGA")), seed=3, log_dir=None,
                             echo=False, max_epochs=2, device="cpu")
    b = _BATCH["CVGA"]
    steps = -(-tdata.num_users // b)
    assert [e for e, _ in seen] == [0] * steps + [1] * steps
    for epoch in (0, 1):
        users = torch.cat([u for e, u in seen if e == epoch])
        assert sorted(users[: tdata.num_users].tolist()) == list(range(tdata.num_users))
        assert torch.equal(users[tdata.num_users:], users[: steps * b - tdata.num_users])
    first = torch.cat([u for e, u in seen if e == 0])
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(first[: tdata.num_users], torch.randperm(tdata.num_users, generator=gen))
    assert np.isfinite(res.last_result["recall"]).all()


def test_cvga_resume_equals_straight_run(datasets, tmp_path):
    """The permutation and the draws come from the run's device generator,
    saved in every checkpoint: a resumed run equals a straight one."""
    tdata = datasets[0]
    cfg = TConfig(_cfg("CVGA"))
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("CVGA", tdata, cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    t_loop.train_model("CVGA", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=1, **kw)
    resumed = t_loop.train_model("CVGA", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert set(straight.params) == {"p_b", "p_w", "q_b", "q_w"}
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    np.testing.assert_array_equal(straight.best.recall, resumed.best.recall)


def test_jax_cvga_checkpoint_loads_into_the_port(datasets, tmp_path):
    """A checkpoint the JAX `train_model` wrote for CVGA (user-row epochs):
    its 14 leaves into the port's tables and Adam, and a server from it."""
    ck = str(tmp_path / "jax_cvga")
    cfg = _cfg("CVGA")
    res = j_loop.train_model("CVGA", datasets[1], JConfig(cfg), seed=1, log_dir=None,
                             echo=False, max_epochs=1, checkpoint_dir=ck)
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model("CVGA")(TConfig(cfg), datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 14
    runner = TRunner(model, LR, _BATCH["CVGA"], datasets[0].num_users)
    assert convert.load_jax_checkpoint(model, runner.opt, ck)["epoch"] == 1
    jparams = jax.device_get(res.params)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == -(-datasets[0].num_users // _BATCH["CVGA"])
    rec = TRecommender.from_checkpoint("CVGA", datasets[0], TConfig(cfg), ck, device="cpu")
    assert torch.equal(rec.model.q_w, model.q_w) and isinstance(rec._repr, dict)
    items, scores = rec.recommend([1, 17], k=5)
    assert items.shape == (2, 5) and np.isfinite(scores).all()
