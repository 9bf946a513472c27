"""NGCF, GCMC and GCCF in the port against the JAX package: the same
tables carried across (`convert`), the same batches, the same dropout
masks. Each model runs its published config at the test's sizes (d = 32,
every layer 32 wide; NGCF and GCCF 2 layers, GCMC its one) over the
default route (bfloat16 on ``auto``: dense, whose
products run kernel K6's plain version on the CPU, the `self`
adjacency's diagonal added after it). K6 computes the JAX fused
backend's function, so the JAX side runs ``propagation_backend = fused``.

One JAX trace a model: its step (`jax.value_and_grad` of the loss terms)
is jitted once, with the masks ``jax.random.bernoulli`` draws while it
traces returned beside the gradients, and the port replays them
(tests/test_torch_zoo_noise.py's Replay). The first step, three Adam
steps, the eval embeddings and the served ids all come from that one
run (`_reference`).

Node dropout (off in every published config) forces the gather backend
in both packages. Its forward and its eval path equal JAX's; its
gradient is held to the gradient of the same loss with the product
taken as a dense matrix carrying the same dropped values, which the
JAX package's own gradient is not (it multiplies by the dropped matrix
where the transpose is needed: `test_jax_node_dropout_gradient_is_not_the_transpose`).

Bars (tests/test_torch_zoo.py's, with their reasons there): loss terms
within rtol LOSS_RTOL = 1e-5; gradients within GRAD_BF16 = 2**-8 of the
largest entry; three Adam steps within 0.25 learn_rate per element and
1e-3 learn_rate on average; eval embeddings within TIGHT; served ids
equal except among scores within 1e-5. On the gather route (node
dropout) both packages sum in float32: loss terms within LOSS_RTOL,
gradients within GRAD_F32 = 1e-5 of the largest entry.
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
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.serving import Recommender as JRecommender
from test_torch_zoo_noise import (  # noqa: F401  (fixtures)
    B,
    D,
    GRAD_BF16,
    LOSS_RTOL,
    LR,
    ROOT,
    TIGHT,
    _batch,
    _close_in_lr,
    _grad_close,
    _jbatch,
    _tbatch,
    datasets,
    tape_and_replay,
)
from test_torch_zoo_noise import _cfg as _noise_cfg

WEIGHTED = ("NGCF", "GCMC", "GCCF")
GRAD_F32 = 1e-5
# the layers 32 wide (GCMC's MLP takes its GCN layer's output, so its
# widths must equal embedding_size, as they do in its published config)
_EXTRA = {"NGCF": {"layer_size": "[32, 32, 32]"},
          "GCMC": {"GCN_layer": "1", "layer_size": "[32, 32, 32]"},
          "GCCF": {"layer_size": "[32, 32, 32]"}}
# tables at the published layer counts (NGCF and GCCF 3, GCMC 1), and the
# leaves of a JAX checkpoint of them (3n + 2)
_PUBLISHED_LEAVES = {"NGCF": 44, "GCMC": 20, "GCCF": 26}
SEED, USERS_EVERY = 9, 7


def _cfg(name, **extra):
    return _noise_cfg(name, **{**_EXTRA[name], **extra})


@contextlib.contextmanager
def _recording_bernoulli():
    """``jax.random.bernoulli`` recording its outputs (tracers under jit)
    into the list it yields."""
    original, masks = jax.random.bernoulli, []

    def draw(*args, **kwargs):
        out = original(*args, **kwargs)
        masks.append(out)
        return out

    jax.random.bernoulli = draw
    try:
        yield masks
    finally:
        jax.random.bernoulli = original


def _jit_step(jmodel):
    """jit(value_and_grad) of JAX's loss terms; the aux output holds the
    terms and the masks drawn, in draw order."""
    def loss(params, batch, key):
        with _recording_bernoulli() as masks:
            terms, _ = jmodel.loss_terms(params, {}, (), batch, key, 0)
        return sum(terms), (terms, list(masks))

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(params, batch, key):
        (_, (terms, masks)), grads = step(params, batch, key)
        return (np.asarray(terms), {k: np.asarray(v) for k, v in grads.items()},
                [np.asarray(m) for m in masks])

    return run


def _jmodel(datasets, name, backend="fused", **extra):
    jmodel = j_get_model(name)(JConfig({**_cfg(name, **extra), "propagation_backend": backend}),
                               datasets[1])
    jmodel.device_put()
    return jmodel


def _reference(datasets, name):
    """One JAX run of ``name`` on fused from PRNGKey(SEED)'s tables: three
    steps of three batches under Adam (each step's terms, gradients and
    masks), then the eval embeddings and the served ids of every
    USERS_EVERY-th user from the stepped tables."""
    jmodel = _jmodel(datasets, name)
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    start = jax.device_get(params)
    step = _jit_step(jmodel)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng, steps = opt.init(params), np.random.default_rng(0), []
    for s in range(3):
        u, p, n = _batch(datasets[0], rng)
        terms, grads, masks = step(params, _jbatch(u, p, n), jax.random.PRNGKey(10 + s))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(batch=(u, p, n), terms=terms, grads=grads, masks=masks,
                          params=jax.device_get(params)))
    users = np.arange(0, datasets[0].num_users, USERS_EVERY)
    jrec = JRecommender(jmodel, params, {}, (), datasets[1], rng=jax.random.PRNGKey(5))
    items, scores = jrec.recommend(users, k=10)
    embeddings = np.concatenate([np.asarray(x) for x in jrec._repr])
    return dict(start=start, steps=steps, users=users, items=items, scores=scores,
                embeddings=embeddings)


@pytest.fixture(scope="module")
def reference(datasets):
    """`_reference` of a model, run once a module."""
    return functools.lru_cache(maxsize=None)(lambda name: _reference(datasets, name))


def _tmodel(datasets, name, params, **extra):
    tmodel = t_get_model(name)(TConfig(_cfg(name, **extra)), datasets[0], device="cpu")
    convert.load_jax_params(tmodel, params)
    return tmodel


def _bernoullis(masks):
    return [("bernoulli", m) for m in masks]


# ---------------------------------------------------------------------------
# registry, configs, tables


def test_weighted_models_are_registered():
    assert set(WEIGHTED) <= set(t_available())
    assert len(t_available()) == 24
    for name in WEIGHTED:
        assert t_get_model(name).model_name == name


@pytest.mark.parametrize("name", WEIGHTED)
def test_config_copy_is_the_jax_file_byte_for_byte(name):
    assert t_load_config(name).as_dict() == j_load_config(name).as_dict()
    assert t_load_config(name).str("compute_dtype", "bfloat16") == "bfloat16"
    assert t_load_config(name).str("propagation_backend", "auto") == "auto"
    assert (ROOT / "idgrec_torch" / "configure" / f"{name}.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / f"{name}.txt").read_bytes()


@pytest.mark.parametrize("name", WEIGHTED)
def test_tables_and_leaves_at_the_published_layers_match_jax(datasets, name):
    """Table names (uppercase ``W_`` sorts before lowercase) and shapes as
    JAX's at the published layer count, and the leaf count of a JAX
    checkpoint of them."""
    extra = {"GCN_layer": t_load_config(name)["GCN_layer"]}
    jmodel = _jmodel(datasets, name, backend="gather", **extra)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = t_get_model(name)(TConfig(_cfg(name, **extra)), datasets[0], device="cpu")
    assert convert.table_names(tmodel) == tuple(sorted(jparams))
    for k, v in jparams.items():
        assert tuple(getattr(tmodel, k).shape) == np.shape(v), k
    assert convert.jax_num_leaves(tmodel) == _PUBLISHED_LEAVES[name]
    assert tmodel.state_names == () and tuple(tmodel.loss_names) == tuple(jmodel.loss_names)
    assert tmodel.eval_embeddings()[0].shape == (datasets[0].num_users, D * (1 + tmodel.num_layers))


@pytest.mark.parametrize("name", WEIGHTED)
def test_route_is_dense_k6_with_the_jax_adjacency(datasets, name):
    tmodel = t_get_model(name)(TConfig(_cfg(name)), datasets[0], device="cpu")
    g = tmodel.graph
    assert isinstance(g, t_prop.DenseSquareAdj) and g.quant == "none" and g.runs_kernel(D)
    assert g.has_diag == (name != "GCMC")


# ---------------------------------------------------------------------------
# one step, three Adam steps, evaluation and serving, with JAX's masks


@pytest.mark.parametrize("name", WEIGHTED)
def test_loss_terms_and_gradients_match_jax(datasets, reference, tape_and_replay, name):
    _, replay = tape_and_replay
    ref = reference(name)
    first = ref["steps"][0]
    layers = int(_cfg(name)["GCN_layer"])
    assert [m.shape for m in first["masks"]] == [(500, D)] * layers
    # JAX's gradient is finite on this set: no layer output is a zero row
    assert all(np.isfinite(g).all() for g in first["grads"].values())
    tmodel = _tmodel(datasets, name, ref["start"])
    replay.load(_bernoullis(first["masks"]))
    terms = tmodel.loss_terms(_tbatch(*first["batch"]), torch.Generator())
    replay.done()
    np.testing.assert_allclose([float(t.detach()) for t in terms], first["terms"], rtol=LOSS_RTOL)
    sum(terms).backward()
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), first["grads"][k], GRAD_BF16)


@pytest.mark.parametrize("name", WEIGHTED)
def test_three_adam_steps_evaluate_and_serve_like_jax(datasets, reference, tape_and_replay,
                                                      name):
    _, replay = tape_and_replay
    ref = reference(name)
    tmodel = _tmodel(datasets, name, ref["start"])
    trun = TRunner(tmodel, LR, B, B)
    for s, step in enumerate(ref["steps"]):
        replay.load(_bernoullis(step["masks"]))
        tterms = trun.run_epoch(*_tbatch(*step["batch"]).values(),
                                generator=torch.Generator()).numpy()
        replay.done()
        np.testing.assert_allclose(tterms, step["terms"], rtol=LOSS_RTOL * 10 ** s)
        for k, v in step["params"].items():
            _close_in_lr(getattr(tmodel, k).detach().numpy(), np.asarray(v))
    convert.load_jax_params(tmodel, ref["steps"][-1]["params"])
    tu, ti = tmodel.eval_embeddings()
    np.testing.assert_allclose(torch.cat([tu, ti]).numpy(), ref["embeddings"], **TIGHT)
    t_items, t_scores = TRecommender(tmodel, datasets[0]).recommend(ref["users"], k=10)
    np.testing.assert_allclose(t_scores, ref["scores"], rtol=0, atol=1e-5)
    assert ((t_items == ref["items"]) | (np.abs(t_scores - ref["scores"]) <= 1e-5)).all()


@pytest.mark.parametrize("name", WEIGHTED)
def test_dropout_needs_a_generator_and_evaluation_draws_nothing(datasets, name):
    tmodel = t_get_model(name)(TConfig(_cfg(name)), datasets[0], device="cpu")
    batch = _tbatch(*_batch(datasets[0], np.random.default_rng(1)))
    with pytest.raises(ValueError, match="pass a torch.Generator"):
        tmodel.loss_terms(batch)
    quiet = t_get_model(name)(TConfig(_cfg(name, mess_dropout="False")), datasets[0],
                              device="cpu")
    assert all(bool(torch.isfinite(t)) for t in quiet.loss_terms(batch))
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    for a, b in zip(tmodel.eval_embeddings(gen), tmodel.eval_embeddings()):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------------
# node dropout


def _dense_dropped_product(jmodel):
    """JAX's ``_propagated_graph_matmul`` with the same draw, the product
    taken as the dense matrix of the dropped values: the function whose
    gradient the node-dropout step should have."""
    g = jmodel.graph.graph
    keep = 1.0 - jmodel.node_drop_prob
    n = g.n_rows

    def product(h, rng, training):
        mask = jax.random.bernoulli(rng, keep, g.vals.shape)
        vals = jnp.where(mask, g.vals / keep, 0.0)
        dense = jnp.zeros((n, n), jnp.float32).at[g.rows, g.cols].add(vals)
        return jnp.matmul(dense, h, precision=jax.lax.Precision.HIGHEST)

    return product


@pytest.fixture(scope="module")
def node_dropout_reference(datasets):
    """NGCF with node dropout from PRNGKey(SEED)'s tables, one batch on
    gather: JAX's terms, gradients and masks, and the gradients of the
    dense-product reference from the same key."""
    extra = {"node_dropout": "True", "node_drop_prob": "0.3"}
    jmodel = _jmodel(datasets, "NGCF", backend="gather", **extra)
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    batch = _batch(datasets[0], np.random.default_rng(3))
    key = jax.random.PRNGKey(4)
    terms, grads, masks = _jit_step(jmodel)(params, _jbatch(*batch), key)
    jmodel._propagated_graph_matmul = _dense_dropped_product(jmodel)
    dense_terms, dense_grads, dense_masks = _jit_step(jmodel)(params, _jbatch(*batch), key)
    assert all(np.array_equal(a, b) for a, b in zip(masks, dense_masks))
    return dict(extra=extra, params=jax.device_get(params), batch=batch, terms=terms,
                grads=grads, masks=masks, dense_terms=dense_terms, dense_grads=dense_grads,
                jmodel=_jmodel(datasets, "NGCF", backend="gather", **extra))


def test_node_dropout_product_is_the_dropped_matrix_and_its_transpose(datasets):
    """`edge_dropout_matmul` against a dense float64 matrix of the same
    dropped values: the forward multiplies by it, the backward by its
    transpose; padding and self loops map to themselves."""
    tmodel = t_get_model("NGCF")(TConfig(_cfg("NGCF", node_dropout="True")), datasets[0],
                                 device="cpu")
    adj = tmodel.graph
    g = adj.graph
    assert isinstance(adj, t_prop.GatherSquareAdj) and g.symmetric
    perm = adj.t_perm
    assert torch.equal(perm[g.nnz:], torch.arange(g.nnz, g.vals.numel()))
    loops = (g.rows[: g.nnz] == g.cols[: g.nnz]).nonzero().flatten()
    assert len(loops) == g.n_rows and torch.equal(perm[loops], loops)
    assert torch.equal(g.rows[perm], g.cols) and torch.equal(g.cols[perm], g.rows)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(g.n_cols, 8, dtype=torch.float32, requires_grad=True)
    cot = torch.randn(g.n_rows, 8, dtype=torch.float32)
    state = gen.get_state()
    y = adj.edge_dropout_matmul(x, 0.7, gen)
    (y * cot).sum().backward()
    gen.set_state(state)
    mask = torch.rand(g.vals.shape, generator=gen) < 0.7
    vals = torch.where(mask, g.vals / torch.tensor(0.7), 0.0).double()
    dense = torch.zeros(g.n_rows, g.n_cols, dtype=torch.float64).index_put_(
        (g.rows, g.cols), vals, accumulate=True)
    assert not torch.equal(dense, dense.T)  # (u, i) and (i, u) drawn apart
    np.testing.assert_allclose(y.detach().numpy(), (dense @ x.detach().double()).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), (dense.T @ cot.double()).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_node_dropout_step_matches_jax_forward_and_the_dense_gradient(
        datasets, tape_and_replay, node_dropout_reference):
    """The masks in JAX's order (per layer the node mask over the padded
    edge values, then the message mask); the loss terms equal JAX's, the
    gradients the dense-product reference's; the eval path equals JAX's."""
    _, replay = tape_and_replay
    ref = node_dropout_reference
    nnz_padded = ref["jmodel"].graph.graph.vals.shape
    assert [m.shape for m in ref["masks"]] == [nnz_padded, (500, 32)] * 2
    tmodel = _tmodel(datasets, "NGCF", ref["params"], **ref["extra"])
    assert isinstance(tmodel.graph, t_prop.GatherSquareAdj)
    assert tmodel.graph.graph.vals.shape == nnz_padded
    replay.load(_bernoullis(ref["masks"]))
    terms = tmodel.loss_terms(_tbatch(*ref["batch"]), torch.Generator())
    replay.done()
    np.testing.assert_allclose([float(t.detach()) for t in terms], ref["terms"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ref["dense_terms"], ref["terms"], rtol=LOSS_RTOL)
    sum(terms).backward()
    for k in convert.table_names(tmodel):
        _grad_close(getattr(tmodel, k).grad.numpy(), ref["dense_grads"][k], GRAD_F32)
    ju, ji = ref["jmodel"].eval_embeddings(ref["params"], {}, (), jax.random.PRNGKey(0))
    tu, ti = tmodel.eval_embeddings()
    np.testing.assert_allclose(torch.cat([tu, ti]).numpy(),
                               np.concatenate([np.asarray(ju), np.asarray(ji)]), **TIGHT)


def test_jax_node_dropout_gradient_is_not_the_transpose(node_dropout_reference):
    """The JAX package's symmetric `SparseGraph` stores its transpose as
    the forward arrays, and its node dropout reuses the dropped values
    there: its backward multiplies by Â_drop where Â_dropᵀ is needed.
    Its loss terms equal the dense-product reference's; its gradients do
    not (the port's do, above)."""
    ref = node_dropout_reference
    worst = max(float(np.abs(ref["grads"][k] - ref["dense_grads"][k]).max())
                / float(np.abs(ref["dense_grads"][k]).max()) for k in ("user_emb", "item_emb"))
    assert worst > 100 * GRAD_F32, worst
    for k in ref["grads"]:
        assert np.isfinite(ref["grads"][k]).all()
