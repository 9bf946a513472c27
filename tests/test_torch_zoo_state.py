"""LightGODE, RecDCL and the model-state contract in the port against the
JAX package: `ops.ode.odeint_euler`, `base.batch_norm`, the state a
model carries from step to step (RecDCL's target histories: drawn after
the tables, outside the parameters, rewritten by each step, in every
checkpoint, restored on resume, loaded from a JAX checkpoint).

Each model runs its published config at the test's sizes (d = 32;
RecDCL 2 layers, LightGODE's one Euler step) over the default route
(bfloat16 on ``auto``: dense, K6's plain version on the CPU); the JAX
side runs ``propagation_backend = fused``, whose function K6 computes.
One JAX trace a model and strategy: the step (`jax.value_and_grad` of
the loss terms, the new state beside them) is jitted once and serves the
first step, three Adam steps, the eval embeddings and the served ids
(`_reference`). Neither model draws in its step.

Bars (tests/test_torch_zoo.py's, with their reasons there): loss terms
within rtol LOSS_RTOL = 1e-5; gradients within GRAD_BF16 = 2**-8 of the
largest entry; three Adam steps within 0.25 learn_rate per element and
1e-3 learn_rate on average; eval embeddings within TIGHT; served ids
equal except among scores within 1e-5. RecDCL's histories hold the
batch's final embeddings: within TIGHT after a step from the same
tables, and after the second and third of three steps, when the tables
they come from are Adam steps apart, within the tables' bar.
`odeint_euler` and `batch_norm` are float32 round-off apart: TIGHT.
"""

from __future__ import annotations

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
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine import loop as t_loop
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import base as t_base
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import ode as t_ode
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.models import base as j_base
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import ode as j_ode
from idgrec_tpu.serving import Recommender as JRecommender
from test_torch_zoo_noise import (  # noqa: F401  (fixtures)
    B,
    D,
    EARLIER,
    GRAD_BF16,
    LOSS_RTOL,
    LR,
    NOISY,
    ROOT,
    TIGHT,
    _batch,
    _close_in_lr,
    _grad_close,
    _jbatch,
    _tbatch,
    datasets,
)
from test_torch_zoo_noise import _cfg as _noise_cfg

STATEFUL = ("LightGODE", "RecDCL")
STRATEGIES = ("MF", "GODE", "MF_init")
# (model, train_strategy) cases of the JAX reference; RecDCL has none
CASES = [("LightGODE", s) for s in STRATEGIES] + [("RecDCL", None)]
HISTORIES = ("i_target_his", "u_target_his")
SEED, STATE_SEED, USERS_EVERY = 9, 13, 7


def _cfg(name, strategy=None, **extra):
    if strategy is not None:
        extra["train_strategy"] = strategy
    return _noise_cfg(name, **extra)


def _jmodel(datasets, name, strategy=None, backend="fused", **extra):
    cfg = {**_cfg(name, strategy, **extra), "propagation_backend": backend}
    jmodel = j_get_model(name)(JConfig(cfg), datasets[1])
    jmodel.device_put()
    return jmodel


def _tmodel(datasets, name, strategy=None, params=None, state=None, **extra):
    tmodel = t_get_model(name)(TConfig(_cfg(name, strategy, **extra)), datasets[0],
                               device="cpu")
    if params is not None:
        convert.load_jax_params(tmodel, params)
    if state is not None:
        tmodel.load_model_state(state)
    return tmodel


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _reference(datasets, name, strategy):
    """One JAX run on fused from PRNGKey(SEED)'s tables and
    PRNGKey(STATE_SEED)'s state: three Adam steps of three batches (each
    step's terms, gradients, new state and tables), then the eval
    embeddings and the served ids of every USERS_EVERY-th user."""
    jmodel = _jmodel(datasets, name, strategy)
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    state = jmodel.init_state(jax.random.PRNGKey(STATE_SEED))
    start, start_state = jax.device_get(params), _numpy(jax.device_get(state))

    def loss(prm, st, batch, key):
        terms, new_state = jmodel.loss_terms(prm, st, (), batch, key, 0)
        return sum(terms), (terms, new_state)

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng, steps = opt.init(params), np.random.default_rng(0), []
    for s in range(3):
        u, p, n = _batch(datasets[0], rng)
        (_, (terms, state)), grads = step(params, state, _jbatch(u, p, n),
                                          jax.random.PRNGKey(10 + s))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(batch=(u, p, n), terms=np.asarray(terms), grads=_numpy(grads),
                          state=_numpy(state), params=jax.device_get(params)))
    users = np.arange(0, datasets[0].num_users, USERS_EVERY)
    jrec = JRecommender(jmodel, params, state, (), datasets[1], rng=jax.random.PRNGKey(5))
    items, scores = jrec.recommend(users, k=10)
    embeddings = np.concatenate([np.asarray(x) for x in jrec._repr])
    return dict(start=start, start_state=start_state, steps=steps, users=users, items=items,
                scores=scores, embeddings=embeddings)


@pytest.fixture(scope="module")
def reference(datasets):
    """`_reference` of a model and strategy, run once a module."""
    return functools.lru_cache(maxsize=None)(
        lambda name, strategy: _reference(datasets, name, strategy))


def _ids(case):
    name, strategy = case
    return name if strategy is None else f"{name}-{strategy}"


# ---------------------------------------------------------------------------
# registry, configs, tables, state


def test_state_models_are_registered():
    assert set(STATEFUL) <= set(t_available())
    for name in STATEFUL:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", STATEFUL)
def test_config_copy_is_the_jax_file_byte_for_byte(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()


@pytest.mark.parametrize("name,leaves", [("LightGODE", 8), ("RecDCL", 37)])
def test_tables_state_and_leaves_match_jax(datasets, name, leaves):
    jmodel = _jmodel(datasets, name, backend="gather")
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    jstate = jax.device_get(jmodel.init_state(jax.random.PRNGKey(1)))
    tmodel = _tmodel(datasets, name)
    assert convert.table_names(tmodel) == tuple(sorted(jparams))
    for k, v in jparams.items():
        assert tuple(getattr(tmodel, k).shape) == np.shape(v), k
    assert tmodel.state_names == tuple(sorted(jstate))
    for k, v in jstate.items():
        assert tuple(getattr(tmodel, k).shape) == np.shape(v), k
    assert convert.jax_num_leaves(tmodel) == leaves
    assert tuple(tmodel.loss_names) == tuple(jmodel.loss_names)
    g = tmodel.graph
    assert isinstance(g, t_prop.DenseSquareAdj) and g.runs_kernel(D) and not g.has_diag


def test_recdcl_state_is_drawn_after_the_tables_and_outside_the_parameters(datasets):
    """Standard normal histories from the init generator after the tables
    (the tables equal a model's without them), buffers on the model's
    device: not parameters, not in the state dict, no gradient, no Adam
    state."""
    gen = torch.Generator().manual_seed(3)
    tmodel = t_get_model("RecDCL")(TConfig(_cfg("RecDCL")), datasets[0], device="cpu",
                                   generator=gen)
    tables = tmodel.init_params(torch.Generator().manual_seed(3))
    after = torch.Generator().manual_seed(3)
    tmodel.init_params(after)
    for k, v in tables.items():
        assert torch.equal(getattr(tmodel, k).detach(), v)
    want = torch.randn((datasets[0].num_users, D), generator=after)
    assert torch.equal(tmodel.u_target_his, want)
    assert abs(float(tmodel.i_target_his.std()) - 1.0) < 0.05
    assert set(tmodel.state_dict()) == set(convert.table_names(tmodel))
    assert not set(HISTORIES) & {k for k, _ in tmodel.named_parameters()}
    runner = TRunner(tmodel, LR, B, B)
    runner.run_epoch(*_tbatch(*_batch(datasets[0], np.random.default_rng(1))).values())
    for k in HISTORIES:
        assert not getattr(tmodel, k).requires_grad and getattr(tmodel, k).grad is None
    assert len(runner.opt.state) == len(convert.table_names(tmodel))


@pytest.mark.parametrize("name", EARLIER + NOISY + ("CGCL", "NCL", "HCCF", "IMPGCN", "NGCF",
                                                    "GCMC", "GCCF", "LightGODE"))
def test_models_without_state_keep_their_leaves(datasets, name):
    """No state: a JAX checkpoint has 3n + 2 leaves, the port's 3n + 3
    (two generators), as before the state subtree existed."""
    extra = {"GCN_layer": "3"} if name == "IMPGCN" else {}
    tmodel = t_get_model(name)(TConfig(_noise_cfg(name, **extra)), datasets[0], device="cpu")
    n = len(convert.table_names(tmodel))
    assert tmodel.state_names == () and tmodel.model_state() == {}
    assert convert.jax_num_leaves(tmodel) == 3 * n + 2
    tree = t_loop.training_state_tree(tmodel, TRunner(tmodel, LR, B, B).opt,
                                      torch.Generator(), torch.Generator())
    assert tree["state"] == {} and len(t_ckpt.tree_leaves(tree)) == 3 * n + 3


# ---------------------------------------------------------------------------
# the pieces: the ODE, batch norm


@pytest.mark.parametrize("ts", [[0.0, 4.0], [0.0, 0.5, 1.25, 4.0], [1.0, 3.0, 2.5]])
def test_odeint_euler_matches_jax(ts):
    rng = np.random.default_rng(len(ts))
    a = rng.normal(size=(24, 24)).astype(np.float32) / 6
    y0, e = (rng.normal(size=(24, 8)).astype(np.float32) for _ in range(2))
    want = j_ode.odeint_euler(lambda t, y: jnp.matmul(a, y, precision="highest") + t * e,
                              jnp.asarray(y0), ts)
    ta, te = torch.from_numpy(a), torch.from_numpy(e)
    got = t_ode.odeint_euler(lambda t, y: ta @ y + t * te, torch.from_numpy(y0), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    # one step a pair, not a fold: [0, T] is e0 + T * f(0, e0)
    if len(ts) == 2:
        one = torch.from_numpy(y0) + (ts[1] - ts[0]) * (ta @ torch.from_numpy(y0) + ts[0] * te)
        assert torch.equal(got, one)


@pytest.mark.parametrize("affine", [False, True])
def test_batch_norm_matches_jax(affine):
    rng = np.random.default_rng(7)
    x = (3.0 + 2.0 * rng.normal(size=(256, D))).astype(np.float32)
    gamma = rng.normal(size=(D,)).astype(np.float32) if affine else None
    beta = rng.normal(size=(D,)).astype(np.float32) if affine else None
    args = (gamma, beta) if affine else ()
    want = j_base.batch_norm(jnp.asarray(x), *(jnp.asarray(a) for a in args))
    tx = torch.from_numpy(x).requires_grad_()
    got = t_base.batch_norm(tx, *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TIGHT)
    # the population variance: each column has mean 0 and variance 1 before the affine
    plain = t_base.batch_norm(tx).detach().double()
    np.testing.assert_allclose(plain.var(dim=0, correction=0).numpy(), 1.0, rtol=1e-4)
    cot = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_base.batch_norm(v, *(jnp.asarray(a) for a in args)),
                     jnp.asarray(x))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving


class _CountingGraph:
    """A graph whose applications are counted."""

    def __init__(self, graph):
        self.graph, self.calls = graph, 0

    def matmul(self, x, gate=None):
        self.calls += 1
        return self.graph.matmul(x, gate)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_terms_gradients_and_state_match_jax(datasets, reference, case):
    name, strategy = case
    ref = reference(name, strategy)
    first = ref["steps"][0]
    assert all(np.isfinite(g).all() for g in first["grads"].values())
    tmodel = _tmodel(datasets, name, strategy, ref["start"], ref["start_state"])
    tmodel.graph = counting = _CountingGraph(tmodel.graph)
    terms = tmodel.loss_terms(_tbatch(*first["batch"]))
    np.testing.assert_allclose([float(t.detach()) for t in terms], first["terms"], rtol=LOSS_RTOL)
    sum(terms).backward()
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), first["grads"][k], GRAD_BF16)
    # the applications of Â a step: LightGODE's one Euler step unless MF,
    # RecDCL's two layers
    assert counting.calls == {"MF": 0, "GODE": 1, "MF_init": 1, None: 2}[strategy]
    for k in tmodel.state_names:
        np.testing.assert_allclose(getattr(tmodel, k).numpy(), first["state"][k], **TIGHT)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_three_adam_steps_evaluate_and_serve_like_jax(datasets, reference, case):
    """Three steps in both packages, the histories carried by each; then
    the eval embeddings and the served ids from the JAX tables."""
    name, strategy = case
    ref = reference(name, strategy)
    tmodel = _tmodel(datasets, name, strategy, ref["start"], ref["start_state"])
    trun = TRunner(tmodel, LR, B, B)
    for s, step in enumerate(ref["steps"]):
        tterms = trun.run_epoch(*_tbatch(*step["batch"]).values()).numpy()
        np.testing.assert_allclose(tterms, step["terms"], rtol=LOSS_RTOL * 10 ** s)
        for k, v in step["params"].items():
            _close_in_lr(getattr(tmodel, k).detach().numpy(), np.asarray(v))
        for k in tmodel.state_names:
            if s == 0:
                np.testing.assert_allclose(getattr(tmodel, k).numpy(), step["state"][k], **TIGHT)
            else:  # rows of embeddings from tables one or two Adam steps apart
                _close_in_lr(getattr(tmodel, k).numpy(), step["state"][k])
    convert.load_jax_params(tmodel, ref["steps"][-1]["params"])
    tu, ti = tmodel.eval_embeddings()
    np.testing.assert_allclose(torch.cat([tu, ti]).numpy(), ref["embeddings"], **TIGHT)
    t_items, t_scores = TRecommender(tmodel, datasets[0]).recommend(ref["users"], k=10)
    np.testing.assert_allclose(t_scores, ref["scores"], rtol=0, atol=1e-5)
    assert ((t_items == ref["items"]) | (np.abs(t_scores - ref["scores"]) <= 1e-5)).all()


def test_lightgode_rejects_an_unknown_strategy(datasets):
    with pytest.raises(ValueError, match="unknown train_strategy"):
        _tmodel(datasets, "LightGODE", "ODE")


def test_lightgode_mf_serves_copies_of_its_tables(datasets):
    tmodel = _tmodel(datasets, "LightGODE", "MF")
    u, i = tmodel.eval_embeddings()
    assert torch.equal(u, tmodel.user_emb) and u.data_ptr() != tmodel.user_emb.data_ptr()
    assert torch.equal(i, tmodel.item_emb) and not u.requires_grad


# ---------------------------------------------------------------------------
# RecDCL's histories


def test_recdcl_step_writes_the_batch_rows_last(datasets):
    """The step reads the old histories and then writes the batch's final
    embeddings at its rows (a batch repeats users and items; every write
    of a row writes the same values); the other rows keep theirs."""
    tmodel = _tmodel(datasets, "RecDCL")
    u, p, n = _batch(datasets[0], np.random.default_rng(2))
    assert len(np.unique(u)) < len(u) and len(np.unique(p)) < len(p)
    before = {k: v.clone() for k, v in tmodel.model_state().items()}
    final_u, final_i = tmodel.eval_embeddings()
    tmodel.loss_terms(_tbatch(u, p, n))
    for k, final, rows in (("u_target_his", final_u, u), ("i_target_his", final_i, p)):
        hist = getattr(tmodel, k)
        rows = torch.from_numpy(rows.astype(np.int64))
        assert torch.equal(hist[rows], final[rows])
        others = torch.ones(hist.shape[0], dtype=torch.bool)
        others[rows] = False
        assert torch.equal(hist[others], before[k][others])


def test_recdcl_zero_coefficients_give_exact_zeros(datasets):
    zeros = dict(all_bt_coeff="0", poly_coeff="0", mom_coeff="0")
    tmodel = _tmodel(datasets, "RecDCL", **zeros)
    jmodel = _jmodel(datasets, "RecDCL", backend="gather", **zeros)
    batch = _batch(datasets[0], np.random.default_rng(4))
    terms = tmodel.loss_terms(_tbatch(*batch))
    params, state = jmodel.init_params(jax.random.PRNGKey(0)), jmodel.init_state(
        jax.random.PRNGKey(1))
    jterms, _ = jmodel.loss_terms(params, state, (), _jbatch(*batch), jax.random.PRNGKey(2), 0)
    assert [float(t) for t in terms] == [float(t) for t in jterms] == [0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# checkpoints and resume


def test_jax_recdcl_checkpoint_loads_into_the_port(datasets, tmp_path):
    """A JAX RecDCL checkpoint, 37 leaves (11 tables × 3 + Adam's count +
    the key + the two histories), loads the tables, Adam's state and the
    histories; the server ignores the state."""
    ck = str(tmp_path / "jax_RecDCL")
    res = j_loop.train_model("RecDCL", datasets[1],
                             JConfig({**_cfg("RecDCL"), "propagation_backend": "dense"}), seed=1,
                             log_dir=None, echo=False, max_epochs=1, checkpoint_dir=ck)
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = _tmodel(datasets, "RecDCL")
    assert len(leaves) == convert.jax_num_leaves(model) == 37
    runner = TRunner(model, LR, B, datasets[0].num_train)
    assert convert.load_jax_checkpoint(model, runner.opt, ck)["epoch"] == 1
    jparams, jstate = jax.device_get(res.params), jax.device_get(res.state)
    for k in convert.table_names(model):
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(jparams[k]))
    for k in HISTORIES:
        np.testing.assert_array_equal(getattr(model, k).numpy(), np.asarray(jstate[k]))
    assert convert.adam_state_to_numpy(runner.opt, model)["count"] == \
        -(-datasets[0].num_train // B)
    rec = TRecommender.from_checkpoint("RecDCL", datasets[0], TConfig(_cfg("RecDCL")), ck,
                                       device="cpu")
    assert torch.equal(rec.model.item_emb, model.item_emb)


def test_recdcl_resume_equals_straight_run(datasets, tmp_path):
    """Three epochs straight, and two then one resumed from the second's
    checkpoint: the tables, the histories and the losses are equal bit for
    bit, and the checkpoint carries the histories after the tables and
    generators."""
    tdata = datasets[0]
    cfg = TConfig(_cfg("RecDCL", training_epochs="3"))
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("RecDCL", tdata, cfg, checkpoint_dir=str(tmp_path / "a"),
                                  **kw)
    t_loop.train_model("RecDCL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=2,
                       **kw)
    leaves, _ = t_ckpt.read_checkpoint(str(tmp_path / "b"), 2)
    assert len(leaves) == 3 * 11 + 3 + 2
    resumed = t_loop.train_model("RecDCL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k])
    assert set(straight.state) == set(HISTORIES)
    for k in HISTORIES:
        assert torch.equal(straight.state[k], resumed.state[k])
        np.testing.assert_array_equal(leaves[3 * 11 + 3 + HISTORIES.index(k)].shape,
                                      straight.state[k].shape)
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
