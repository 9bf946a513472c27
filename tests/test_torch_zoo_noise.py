"""SimGCL, XSimGCL, LightGCN_pp, BIGCF and MixRec in the port against the
JAX package: the same tables carried across (`convert`), the same
batches, and the same noise. Each model runs its published config at the
test's sizes over the default route (bfloat16 on ``auto``: dense, whose
products run kernel K6's plain version on the CPU; SimGCL's chains at
3d = 96). K6 computes the JAX fused backend's function, so the JAX side
runs ``propagation_backend = fused``.

The same noise in both packages: record and replay. The JAX side runs
eagerly with ``jax.random.uniform``, ``normal``, ``beta``, ``dirichlet``
and ``permutation`` wrapped (pytest's ``monkeypatch``): each wrapper
calls the original and records its output. The port's side swaps the
functions of ``idgrec_torch.ops.noise`` for a replay of those arrays in
call order, which fails if the port draws another kind, another shape or
in another order, or leaves a draw unused.

Tolerances (tests/test_torch_zoo.py's bars, with their reasons there):
loss terms within rtol LOSS_RTOL = 1e-5; gradients within GRAD_BF16 =
2**-8 of the largest entry; three Adam steps within 0.25 learn_rate per
element and 1e-3 learn_rate on average; eval embeddings within TIGHT;
served ids equal except among scores within 1e-5.

LightGCN_pp's gradients are held to JAX on ``gather``: the JAX package's
fused (and dense) gradients are NaN on this set, whose items 187 and 280
have no train edge (`test_lightgcn_pp_jax_fused_gradient_is_nan`).
``gather`` sums float32 products without bfloat16 operands, while the
port's dense route rounds each product's operands to bfloat16 (2**-9
relative each), in each of the chain's four products (two layers,
forward and backward). So the gradients' bar is GRAD_PP = 2**-7 of the
largest entry (measured 2.1e-3; the port's own gather route is within
2.7e-7 of JAX's). Its three Adam steps run on gather in both packages:
the dense route's rounding flips the sign of near-zero gradient entries,
which Adam's first updates (learn_rate · g/|g|) turn into 2 learn_rate
(measured 1.99), and JAX fused's steps are NaN.
"""

from __future__ import annotations

import pathlib

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
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.models import simgcl as t_simgcl
from idgrec_torch.ops import losses as t_losses
from idgrec_torch.ops import noise as t_noise
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.models import simgcl as j_simgcl
from idgrec_tpu.ops import losses as j_losses
from idgrec_tpu.ops import propagate as j_prop
from idgrec_tpu.serving import Recommender as JRecommender

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

LOSS_RTOL = 1e-5
GRAD_BF16 = 2.0 ** -8
GRAD_PP = 2.0 ** -7
TIGHT = dict(rtol=3e-5, atol=3e-6)
D, LR, B = 32, 0.001, 256
_SHAPE = (200, 300, 3000, 400)
NOISY = ("SimGCL", "XSimGCL", "LightGCN_pp", "BIGCF", "MixRec")
DRAWING = ("SimGCL", "XSimGCL", "BIGCF", "MixRec")
EARLIER = ("LightGCN", "EGCF", "MFBPR", "DirectAU", "MAWU", "SCCF", "LightCCF", "LightCSCF")
_DRAWS = ("uniform", "normal", "beta", "dirichlet", "permutation", "bernoulli")
_OVERRIDES = {"dataset": "tiny", "embedding_size": str(D), "GCN_layer": "2",
              "learn_rate": str(LR), "batch_size": str(B), "test_batch_size": "64",
              "top_K": "[5, 10]", "interval": "1", "training_epochs": "2"}


def _cfg(name, **extra):
    """The model's published config (the port's copy) at the test's
    sizes, as a plain dict both packages read."""
    cfg = {**t_load_config(name).as_dict(), **_OVERRIDES, **extra}
    if name == "XSimGCL":
        cfg["cl_layer"] = "1"
    return cfg


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5, name="tiny"),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5, name="tiny"))


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


def _batch(tdata, rng, size=B):
    pick = rng.integers(0, tdata.num_train, size)
    return (tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, size))


def _jbatch(u, p, n):
    return dict(zip(("user", "pos", "neg"), (jnp.asarray(a, jnp.int32) for a in (u, p, n))))


def _tbatch(u, p, n):
    return dict(zip(("user", "pos", "neg"),
                    (torch.from_numpy(np.asarray(a, np.int64)) for a in (u, p, n))))


# ---------------------------------------------------------------------------
# record (JAX) and replay (the port)


class Tape:
    """The JAX draws of one call, in order: (kind, numpy array)."""

    def __init__(self, monkeypatch):
        self.draws: list[tuple[str, np.ndarray]] = []
        for kind in _DRAWS:
            monkeypatch.setattr(jax.random, kind, self._recorder(kind, getattr(jax.random, kind)))

    def _recorder(self, kind, original):
        def draw(*args, **kwargs):
            out = original(*args, **kwargs)
            # a draw under jit is a tracer: its kind is recorded, not its value
            self.draws.append((kind, None if isinstance(out, jax.core.Tracer)
                               else np.asarray(out)))
            return out
        return draw

    def take(self) -> list[tuple[str, np.ndarray]]:
        out, self.draws = self.draws, []
        return out


class Replay:
    """Swaps ops/noise.py's draws for a tape's arrays, in call order.
    ``choice`` (k-means's initial rows) is replayed too: JAX draws it
    under jit, so a test derives its values and loads them itself."""

    def __init__(self, monkeypatch):
        self.queue: list[tuple[str, np.ndarray]] = []
        for kind in _DRAWS + ("choice",):
            monkeypatch.setattr(t_noise, kind, self._player(kind))

    def load(self, draws):
        assert not self.queue, f"{len(self.queue)} draws left unused"
        self.queue = list(draws)

    def done(self):
        assert not self.queue, f"the port left {len(self.queue)} of JAX's draws unused"

    def _player(self, kind):
        def draw(*args, **kwargs):
            assert self.queue, f"the port drew {kind} where JAX drew nothing more"
            want, arr = self.queue.pop(0)
            assert want == kind, f"the port drew {kind} where JAX drew {want}"
            if kind in ("uniform", "normal"):
                assert tuple(args[0]) == arr.shape, (kind, tuple(args[0]), arr.shape)
                return torch.from_numpy(arr.copy()).to(kwargs.get("dtype", torch.float32))
            if kind == "dirichlet":
                assert tuple(args[0].shape) == arr.shape
            if kind == "permutation":
                assert arr.shape == (args[0],)
                return torch.from_numpy(arr.astype(np.int64))
            if kind == "bernoulli":
                assert tuple(args[1]) == arr.shape, (kind, tuple(args[1]), arr.shape)
                return torch.from_numpy(arr.astype(bool))
            if kind == "choice":
                assert arr.shape == (args[1],) and 0 <= arr.min() and arr.max() < args[0]
                return torch.from_numpy(arr.astype(np.int64))
            return torch.from_numpy(np.array(arr, np.float32))
        return draw


@pytest.fixture
def tape_and_replay(monkeypatch):
    return Tape(monkeypatch), Replay(monkeypatch)


def _expected_draws(name, cfg):
    """The kinds a step draws in JAX's order."""
    layers = int(cfg["GCN_layer"])
    return {"SimGCL": ["uniform"] * 2 * layers, "XSimGCL": ["uniform"] * layers,
            "LightGCN_pp": [], "BIGCF": ["normal"],
            "MixRec": ["beta", "beta", "dirichlet", "permutation", "permutation"]}[name]


def _j_step(jmodel, params, batch, key):
    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, (), batch, key, 0)
        return sum(terms), terms

    (_, terms), grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    return np.asarray(terms), {k: np.asarray(v) for k, v in grads.items()}


def _grad_close(got, ref, bar):
    top = float(np.abs(ref).max())
    assert top > 0 and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= bar * top, (float(np.abs(got - ref).max()), top)


def _close_in_lr(got, ref):
    diff = np.abs(got - ref) / LR
    assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


# ---------------------------------------------------------------------------
# registry, configs, tables


def test_noise_models_are_registered():
    assert set(NOISY) <= set(t_available())
    for name in NOISY:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", NOISY)
def test_config_copy_is_the_jax_file_byte_for_byte(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    assert t_load_config(name).str("compute_dtype") == "bfloat16"
    assert t_load_config(name).str("propagation_backend") == "auto"
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()


@pytest.mark.parametrize("name", NOISY)
def test_tables_loss_names_and_route_match_jax(datasets, name):
    jmodel, tmodel, params, _ = _models(datasets, name)
    assert convert.table_names(tmodel) == tuple(sorted(params))
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names)
    assert tmodel.aggregates_per_step == getattr(jmodel, "aggregates_per_step", 1)
    for k, v in jax.device_get(params).items():
        np.testing.assert_array_equal(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    g = tmodel.graph
    assert isinstance(g, t_prop.DenseSquareAdj) and g.quant == "none"
    # SimGCL's batched chains run the kernel at 3d
    assert g.runs_kernel(D) and g.runs_kernel(3 * D)
    if name == "LightGCN_pp":
        # gen: the left scale D^-0.6, the right D^+0.1, zero at no edge
        du = np.diff(datasets[0].row_ptr).astype(np.float64)
        np.testing.assert_allclose(g.right_u.numpy(), np.where(du > 0, du ** 0.1, 0), rtol=1e-6)
        np.testing.assert_allclose(g.left_u.numpy(), np.where(du > 0, du ** -0.6, 0), rtol=1e-6)


def test_bigcf_draws_four_tables(datasets):
    m = t_get_model("BIGCF")(TConfig(_cfg("BIGCF")), datasets[0], device="cpu",
                             generator=torch.Generator().manual_seed(3))
    assert convert.table_names(m) == ("item_emb", "item_intent", "user_emb", "user_intent")
    assert convert.jax_num_leaves(m) == 14
    k = int(_cfg("BIGCF")["intent_size"])
    assert tuple(m.user_intent.shape) == tuple(m.item_intent.shape) == (D, k)
    limit = float(np.sqrt(6.0 / (D + k)))
    assert 0.9 * limit < float(m.user_intent.detach().abs().max()) <= limit


# ---------------------------------------------------------------------------
# the SimGCL helpers and the pooled InfoNCE


@pytest.mark.parametrize("ids", [[3, 3, 3], [5, 1, 5, 2, 1], list(range(17)), [0],
                                 [9, 9, 4, 9, 4, 0, 7, 7]])
def test_first_occurrence_mask_matches_jax(ids):
    got = t_simgcl.first_occurrence_mask(torch.tensor(ids, dtype=torch.int64))
    want = np.asarray(j_simgcl.first_occurrence_mask(jnp.asarray(ids, jnp.int32)))
    assert got.dtype == torch.bool and got.shape == (len(ids),)
    np.testing.assert_array_equal(got.numpy(), want)
    seen = set()
    np.testing.assert_array_equal(got.numpy(), [i not in seen and not seen.add(i) for i in ids])


def test_masked_infonce_matches_jax_and_the_unique_rows():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 40, 96)
    assert len(np.unique(ids)) < len(ids)
    a, b = (rng.normal(size=(96, D)).astype(np.float32) for _ in range(2))
    # the same id has the same rows, as gathered from a table
    first = {int(i): j for j, i in reversed(list(enumerate(ids)))}
    rows = np.asarray([first[int(i)] for i in ids])
    a, b = a[rows], b[rows]
    mask = t_simgcl.first_occurrence_mask(torch.from_numpy(ids))
    got = t_simgcl.masked_infonce_loss(torch.from_numpy(a), torch.from_numpy(b), mask, 0.2)
    want = j_simgcl.masked_infonce_loss(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(mask.numpy()), 0.2)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    keep = mask.numpy()
    unique = t_losses.infonce_loss(torch.from_numpy(a[keep]), torch.from_numpy(b[keep]), 0.2)
    np.testing.assert_allclose(float(got), float(unique), rtol=LOSS_RTOL)


@pytest.mark.parametrize("pool,t", [(65, 0.2), (96, 1.0), (3, 0.15)])
def test_infonce_loss_all_matches_jax(pool, t):
    rng = np.random.default_rng(pool)
    a, b = (rng.normal(size=(64, D)).astype(np.float32) for _ in range(2))
    c = rng.normal(size=(pool, D)).astype(np.float32)
    got = t_losses.infonce_loss_all(*(torch.from_numpy(x) for x in (a, b, c)), t)
    want = j_losses.infonce_loss_all(*(jnp.asarray(x) for x in (a, b, c)), t)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert t_losses._INFONCE_ALL_EPS == j_losses._INFONCE_ALL_EPS


def test_perturbed_propagate_matches_jax(datasets, tape_and_replay):
    tape, replay = tape_and_replay
    tdata, jdata = datasets
    x = np.random.default_rng(3).normal(size=(tdata.num_users + tdata.num_items, D))
    x = x.astype(np.float32)
    jg = j_prop.build_adjacency(jdata, "sym", "fused", compute_dtype="bfloat16", emb_size=D)
    tg = t_prop.build_adjacency(tdata, "sym", "dense", compute_dtype="bfloat16", device="cpu")
    want = j_simgcl.perturbed_propagate(jg, jnp.asarray(x), 2, 0.1, jax.random.PRNGKey(4))
    draws = tape.take()
    assert [k for k, _ in draws] == ["uniform", "uniform"]
    replay.load(draws)
    got = t_simgcl.perturbed_propagate(tg, torch.from_numpy(x), 2, 0.1, torch.Generator())
    replay.done()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving, with JAX's noise


@pytest.mark.parametrize("name", NOISY)
def test_loss_terms_and_gradients_match_jax(datasets, tape_and_replay, name):
    tape, replay = tape_and_replay
    jmodel, tmodel, params, cfg = _models(datasets, name, seed=9)
    tape.take()  # the initial tables' draws
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    assert len(np.unique(u)) < B and len(np.unique(p)) < B  # the masks see repeats
    jterms, jgrads = _j_step(jmodel, params, _jbatch(u, p, n), jax.random.PRNGKey(0))
    draws = tape.take()
    assert [k for k, _ in draws] == _expected_draws(name, cfg)
    replay.load(draws)
    terms = tmodel.loss_terms(_tbatch(u, p, n), torch.Generator())
    assert len(terms) == len(tmodel.loss_names)
    np.testing.assert_allclose([float(t_.detach()) for t_ in terms], jterms, rtol=LOSS_RTOL)
    sum(terms).backward()
    replay.done()
    if name == "LightGCN_pp":
        # JAX fused's gradients are NaN here: held to JAX on gather
        jgather, _, gparams, _ = _models(datasets, name, seed=9, jax_backend="gather")
        _, jgrads = _j_step(jgather, gparams, _jbatch(u, p, n), jax.random.PRNGKey(0))
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), jgrads[k],
                    GRAD_PP if name == "LightGCN_pp" else GRAD_BF16)


def _three_steps(datasets, replay, tape, name, backend="fused"):
    """Three steps from the same tables; the JAX side on ``backend``, the
    port's on dense (K6's function) or, beside JAX's gather, on gather."""
    extra = {"propagation_backend": "gather"} if backend == "gather" else {}
    jmodel, tmodel, params, cfg = _models(datasets, name, seed=8, jax_backend=backend, **extra)
    tape.take()  # the initial tables' draws
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng = opt.init(params), np.random.default_rng(0)
    trun = TRunner(tmodel, LR, B, B)
    for step in range(3):
        u, p, n = _batch(datasets[0], rng)
        jterms, grads = _j_step(jmodel, params, _jbatch(u, p, n), jax.random.PRNGKey(10 + step))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        replay.load(tape.take())
        tterms = trun.run_epoch(*_tbatch(u, p, n).values(), generator=torch.Generator(),
                                epoch=step).numpy()
        replay.done()
        assert tterms.shape == (len(tmodel.loss_names),) and np.isfinite(tterms).all()
        np.testing.assert_allclose(tterms, jterms, rtol=LOSS_RTOL * 10 ** step)
        for k, v in jax.device_get(params).items():
            _close_in_lr(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    return jmodel, tmodel, params


@pytest.mark.parametrize("name", NOISY)
def test_three_adam_steps_evaluate_and_serve_like_jax(datasets, tape_and_replay, name):
    """Three steps in both packages with JAX's noise, then the eval
    embeddings (BIGCF's eval noise replayed too) and the served ids from
    the JAX weights carried across. LightGCN_pp steps on gather in both
    packages (JAX fused's steps are NaN), then evaluates and serves on the
    default route beside JAX fused."""
    tape, replay = tape_and_replay
    backend = "gather" if name == "LightGCN_pp" else "fused"
    jmodel, tmodel, params = _three_steps(datasets, replay, tape, name, backend)
    if name == "LightGCN_pp":
        jmodel, tmodel = _models(datasets, name)[:2]
        tape.take()
    assert isinstance(tmodel.graph, t_prop.DenseSquareAdj)
    convert.load_jax_params(tmodel, jax.device_get(params))
    key = jax.random.PRNGKey(5)
    ju, ji = jmodel.eval_embeddings(params, {}, (), key)
    eval_draws = tape.take()
    assert [k for k, _ in eval_draws] == (["normal"] if name == "BIGCF" else [])
    replay.load(eval_draws)
    tu, ti = tmodel.eval_embeddings(torch.Generator())
    replay.done()
    got, ref = torch.cat([tu, ti]).numpy(), np.concatenate([np.asarray(ju), np.asarray(ji)])
    np.testing.assert_allclose(got, ref, **TIGHT)
    users = np.arange(0, datasets[0].num_users, 7)
    jrec = JRecommender(jmodel, params, {}, (), datasets[1], rng=key)
    j_items, j_scores = jrec.recommend(users, k=10)
    # the JAX server's representation is jitted, its draw a tracer: the
    # same key draws what the eager evaluation drew
    assert [k for k, _ in tape.take()] == [k for k, _ in eval_draws]
    replay.load(eval_draws)
    t_items, t_scores = TRecommender(tmodel, datasets[0], generator=torch.Generator()) \
        .recommend(users, k=10)
    replay.done()
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    assert ((t_items == j_items) | (np.abs(t_scores - j_scores) <= 1e-5)).all()


def test_a_draw_out_of_order_fails_the_replay(datasets, tape_and_replay):
    tape, replay = tape_and_replay
    jmodel, tmodel, params, _ = _models(datasets, "MixRec")
    tape.take()  # the initial tables' draws
    u, p, n = _batch(datasets[0], np.random.default_rng(1))
    _j_step(jmodel, params, _jbatch(u, p, n), jax.random.PRNGKey(0))
    draws = tape.take()
    draws[2], draws[3] = draws[3], draws[2]  # the permutation before the Dirichlet weights
    replay.load(draws)
    with pytest.raises(AssertionError, match="drew dirichlet where JAX drew permutation"):
        tmodel.loss_terms(_tbatch(u, p, n), torch.Generator())


# ---------------------------------------------------------------------------
# LightGCN_pp at a node with no train edge


def test_lightgcn_pp_jax_fused_gradient_is_nan(datasets):
    """The JAX package's norm has a NaN gradient at a zero row (an item
    with no train edge is zero after layer 1), which its fused products
    carry into every row; PyTorch's norm has gradient 0 there, so the
    port's step stays finite, and equals its own gather route within
    GRAD_PP."""
    tdata = datasets[0]
    isolated = np.setdiff1d(np.arange(tdata.num_items), tdata.train_item)
    assert isolated.tolist() == [187, 280]
    u, p, n = _batch(tdata, np.random.default_rng(4))
    jmodel, tmodel, params, cfg = _models(datasets, "LightGCN_pp", seed=9)
    jterms, jgrads = _j_step(jmodel, params, _jbatch(u, p, n), jax.random.PRNGKey(0))
    assert np.isfinite(jterms).all() and np.isnan(jgrads["user_emb"]).all()
    terms = tmodel.loss_terms(_tbatch(u, p, n))
    sum(terms).backward()
    gather = t_get_model("LightGCN_pp")(TConfig({**cfg, "propagation_backend": "gather"}),
                                        tdata, device="cpu")
    convert.load_jax_params(gather, jax.device_get(params))
    sum(gather.loss_terms(_tbatch(u, p, n))).backward()
    for k in ("user_emb", "item_emb"):
        _grad_close(getattr(tmodel, k).grad.numpy(), getattr(gather, k).grad.numpy(), GRAD_PP)


# ---------------------------------------------------------------------------
# the generator: required where the model draws, ignored where it does not


@pytest.mark.parametrize("name", DRAWING)
def test_a_drawing_step_without_a_generator_raises(datasets, name):
    _, tmodel, _, _ = _models(datasets, name)
    batch = _tbatch(*_batch(datasets[0], np.random.default_rng(1)))
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        tmodel.loss_terms(batch)
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        TRunner(tmodel, LR, B, B).run_epoch(*batch.values())


def test_bigcf_eval_without_a_generator_raises_and_the_server_seeds_zero(datasets):
    _, tmodel, _, cfg = _models(datasets, "BIGCF")
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        tmodel.eval_embeddings()
    users = np.arange(0, datasets[0].num_users, 5)
    default = TRecommender(tmodel, datasets[0]).recommend(users, k=5)
    seeded = TRecommender(tmodel, datasets[0],
                          generator=torch.Generator().manual_seed(0)).recommend(users, k=5)
    other = TRecommender(tmodel, datasets[0],
                         generator=torch.Generator().manual_seed(1)).recommend(users, k=5)
    for a, b in zip(default, seeded):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(default[1], other[1])
    ev = TEvaluator(tmodel, datasets[0], TConfig(cfg))
    res = [ev.evaluate(generator=torch.Generator().manual_seed(s)) for s in (2, 2)]
    np.testing.assert_array_equal(res[0]["recall"], res[1]["recall"])


@pytest.mark.parametrize("name", EARLIER + ("LightGCN_pp", "SimGCL", "XSimGCL", "MixRec"))
def test_models_without_eval_noise_ignore_the_generator(datasets, name):
    """The eval embeddings with a generator equal them without one bit
    for bit, and the generator draws nothing; so the earlier models'
    evaluation and serving are unchanged by the new signature."""
    tdata = datasets[0]
    cfg = {**_cfg(name)}
    if name not in ("LightGCN", "EGCF", "MFBPR") + NOISY:
        cfg["encoder"] = "LightGCN"
    model = t_get_model(name)(TConfig(cfg), tdata, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    with_gen = model.eval_embeddings(gen)
    without = model.eval_embeddings()
    assert torch.equal(gen.get_state(), state)
    for a, b in zip(with_gen, without):
        assert torch.equal(a, b)
    ev = TEvaluator(model, tdata, TConfig(cfg))
    for a, b in zip(ev.compute_repr(gen), without):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------------
# checkpoints, resume, the command lines


def test_jax_bigcf_checkpoint_loads_into_the_port(datasets, tmp_path):
    ck = str(tmp_path / "jax_bigcf")
    res = j_loop.train_model("BIGCF", datasets[1], JConfig(_cfg("BIGCF")), seed=1,
                             log_dir=None, echo=False, max_epochs=1, checkpoint_dir=ck)
    cfg = TConfig(_cfg("BIGCF"))
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model("BIGCF")(cfg, datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 14
    runner = TRunner(model, LR, B, datasets[0].num_train)
    assert convert.load_jax_checkpoint(model, runner.opt, ck)["epoch"] == 1
    jparams = jax.device_get(res.params)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    adam = convert.adam_state_to_numpy(runner.opt, model)
    assert adam["count"] == -(-datasets[0].num_train // B)
    assert set(adam["mu"]) == {"item_emb", "item_intent", "user_emb", "user_intent"}
    rec = TRecommender.from_checkpoint("BIGCF", datasets[0], cfg, ck, device="cpu")
    assert torch.equal(rec.model.user_intent, model.user_intent)


def test_bigcf_resume_equals_straight_run(datasets, tmp_path):
    """The device generator draws the steps' and the evaluations' noise
    and is saved after the evaluation, so a resumed run equals a
    straight one."""
    tdata = datasets[0]
    cfg = TConfig(_cfg("BIGCF"))
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("BIGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    t_loop.train_model("BIGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=1,
                       **kw)
    resumed = t_loop.train_model("BIGCF", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert set(straight.params) == {"item_emb", "item_intent", "user_emb", "user_intent"}
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    np.testing.assert_array_equal(straight.best.recall, resumed.best.recall)


def _write_files(datasets, tmp_path, name):
    directory = tmp_path / "data" / "tiny"
    directory.mkdir(parents=True, exist_ok=True)
    data = datasets[0]
    for fname, users, items in (("train.txt", data.train_user, data.train_item),
                                ("test.txt", data.test_user, data.test_item)):
        with open(directory / fname, "w") as f:
            for u in np.unique(users):
                f.write(f"{u} " + " ".join(map(str, items[users == u])) + "\n")
    conf = tmp_path / "conf"
    conf.mkdir(exist_ok=True)
    cfg = {**_cfg(name), "dataset_path": str(tmp_path / "data"), "training_epochs": "1"}
    (conf / f"{name}.txt").write_text("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    return conf


@pytest.mark.parametrize("name", ["SimGCL", "BIGCF"])
def test_command_lines_train_and_serve_a_noise_model(datasets, tmp_path, capsys, name):
    conf = _write_files(datasets, tmp_path, name)
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
