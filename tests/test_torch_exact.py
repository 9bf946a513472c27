"""The exact modes of the port (compute_dtype bfloat16 and float32 on
the dense, fused and gather backends; the sym, self and gen
normalizations; the gate; gradients; training, evaluation and serving of
LightGCN as a whole) against the JAX package on the same inputs.

Tolerances:
* float32 paths at TIGHT (rtol 3e-5, atol 3e-6): the same float32 terms
  summed in another order.
* bfloat16 forward products at TIGHT too: both packages round the same
  right-scaled activations to bfloat16, the counts are exact, every
  product is exact in float32, and only the order of the float32
  additions differs (the port multiplies the rounded operands in
  float32, `propagate._exact_impl`, because a bfloat16 `torch.matmul`
  would round its result; the fused backend's plain version does the
  same).
* bfloat16 gradients through the dense backend at BF16 (2**-7 of the
  largest entry): XLA's transposed product rounds the gradient to
  bfloat16 on the way out, the port rounds the cotangent to bfloat16 on
  the way in (the swapped product, as the fused backend of both
  packages does). Through the fused backend both round the cotangent
  going in: TIGHT.
* the int8 dense mode: one application shares its quantized inputs bit
  for bit, so TIGHT.
* trained weights in units of learn_rate, as tests/test_torch_training.py:
  0.25 learn_rate per element and 1e-3 learn_rate on average where the
  gradients agree to float32 round-off (float32-gather, bfloat16-fused).
  For bfloat16-dense the gradients differ by bfloat16 roundings
  (above): Adam's first updates are learn_rate · g/|g|, so a gradient
  entry whose terms nearly cancel can change sign between the packages
  and move by up to 2 learn_rate (0.16 % of the entries do, measured);
  the bar is 2 learn_rate per element, at most 0.5 % of the entries
  above 0.25 learn_rate, and 1e-2 learn_rate on average. A wrong
  gradient moves most entries by 1-2 learn_rate and fails all three.
* evaluator metrics within 1e-6 and served ids equal: the same weights,
  embeddings within TIGHT, no tie at the cut for these seeds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import base as t_base
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import base as j_base
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import propagate as j_prop
from idgrec_tpu.serving import Recommender as JRecommender

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
_SHAPE = (300, 500, 4000, 800)
D = 8
_GEN = dict(alpha=0.6, beta=0.3)
_BACKENDS = ("dense", "fused", "gather")
_DTYPES = ("bfloat16", "float32")


def _pair(shape=_SHAPE, seed=5):
    return (t_dataset.make_synthetic_dataset(*shape, seed=seed),
            j_dataset.make_synthetic_dataset(*shape, seed=seed))


@pytest.fixture(scope="module")
def datasets():
    return _pair()


def _build(datasets, variant, backend, dtype, **kw):
    tdata, jdata = datasets
    kw = {**(_GEN if variant == "gen" else {}), **kw}
    t = t_prop.build_adjacency(tdata, variant, backend, compute_dtype=dtype, emb_size=D,
                               device="cpu", **kw)
    j = j_prop.build_adjacency(jdata, variant, backend, compute_dtype=dtype, emb_size=D, **kw)
    return t, j


def _x(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _bf16_bar(ref: np.ndarray) -> dict:
    return dict(rtol=0.0, atol=2.0 ** -7 * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
def test_matmul_matches_jax(datasets, variant, backend, dtype):
    t, j = _build(datasets, variant, backend, dtype)
    assert type(t).__name__ == type(j).__name__
    x = _x(t.shape[0])
    got = t.matmul(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(j.matmul(jnp.asarray(x))), **TIGHT)


@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
def test_dense_int8_matches_jax(datasets, variant):
    t, j = _build(datasets, variant, "dense", "int8")
    assert isinstance(t, t_prop.DenseSquareAdj) and t.quant == j.quant == "int8"
    x = _x(t.shape[0], seed=1)
    np.testing.assert_allclose(t.matmul(torch.from_numpy(x)).numpy(),
                               np.asarray(j.matmul(jnp.asarray(x))), **TIGHT)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
def test_dense_matches_gather_square(datasets, variant, dtype):
    """The JAX package's own matrix (tests/test_propagate.py): the
    backends of the port agree with each other."""
    tdata, _ = datasets
    kw = _GEN if variant == "gen" else {}
    x = torch.from_numpy(_x(tdata.num_nodes, seed=2))
    gather = t_prop.build_adjacency(tdata, variant, "gather", compute_dtype="float32",
                                    device="cpu", **kw).matmul(x).numpy()
    for backend in ("dense", "fused"):
        got = t_prop.build_adjacency(tdata, variant, backend, compute_dtype=dtype, device="cpu",
                                     **kw).matmul(x).numpy()
        if dtype == "float32" and backend == "dense":
            np.testing.assert_allclose(got, gather, rtol=1e-4, atol=1e-5)
        else:  # operands rounded to bfloat16
            np.testing.assert_allclose(got, gather, **_bf16_bar(gather))


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("dense", "float32"),
                                           ("dense", "int8"), ("fused", "bfloat16"),
                                           ("gather", "float32")])
def test_gate_matches_jax(datasets, backend, dtype):
    t, j = _build(datasets, "sym", backend, dtype)
    rng = np.random.default_rng(3)
    x = _x(t.shape[0], seed=3)
    gate = (rng.random(t.shape[0]) < 0.6).astype(np.float32)
    got = t.matmul(torch.from_numpy(x), gate=torch.from_numpy(gate))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j.matmul(jnp.asarray(x), gate=jnp.asarray(gate))),
                               **TIGHT)
    # gated-out rows are zero
    assert not bool(got[torch.from_numpy(gate) == 0].any())


@pytest.mark.parametrize("variant,backend,dtype", [
    ("sym", "dense", "float32"), ("gen", "dense", "float32"), ("self", "gather", "float32"),
    ("gen", "gather", "bfloat16"), ("sym", "fused", "bfloat16"), ("self", "fused", "float32"),
    ("sym", "dense", "bfloat16"), ("self", "dense", "bfloat16"),
])
def test_matmul_gradient_matches_jax(datasets, variant, backend, dtype):
    t, j = _build(datasets, variant, backend, dtype)
    x, w = _x(t.shape[0], seed=4), _x(t.shape[0], seed=5)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t.matmul(xt) * torch.from_numpy(w)).sum().backward()
    ref = np.asarray(jax.grad(lambda v: jnp.sum(j.matmul(v) * jnp.asarray(w)))(jnp.asarray(x)))
    bar = _bf16_bar(ref) if (backend, dtype) == ("dense", "bfloat16") else TIGHT
    np.testing.assert_allclose(xt.grad.numpy(), ref, **bar)


def test_dense_gradient_is_the_swapped_product(datasets):
    """The autograd.Function saves the int8 matrix only and runs the
    backward as the same product on the swapped cotangents."""
    tdata, _ = datasets
    adj = t_prop.build_adjacency(tdata, "gen", "dense", compute_dtype="float32", device="cpu",
                                 **_GEN)
    rng = np.random.default_rng(6)
    u_pad, i_pad = adj.m.shape
    zu = torch.from_numpy(rng.normal(size=(u_pad, D)).astype(np.float32)).requires_grad_(True)
    zi = torch.from_numpy(rng.normal(size=(i_pad, D)).astype(np.float32)).requires_grad_(True)
    g_yu = torch.from_numpy(rng.normal(size=(u_pad, D)).astype(np.float32))
    g_yi = torch.from_numpy(rng.normal(size=(i_pad, D)).astype(np.float32))
    yu, yi = t_prop.exact_dual_matmul(adj.m, zi, zu, torch.float32)
    assert yu.grad_fn is not None and not any(
        isinstance(t, torch.Tensor) and t.dtype != torch.int8 and t.numel() >= adj.m.numel()
        for t in vars(yu.grad_fn).values())
    torch.autograd.backward([yu, yi], [g_yu, g_yi])
    m = adj.m.to(torch.float64)
    np.testing.assert_allclose(zi.grad.numpy(), (m.T @ g_yu.double()).numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(zu.grad.numpy(), (m @ g_yi.double()).numpy(), rtol=1e-5, atol=1e-5)


def test_quantize_cols_bit_equal():
    rng = np.random.default_rng(9)
    z = rng.normal(size=(1000, 6)).astype(np.float32) * 3
    z[:, 2] = 0.0                                  # amax 0 -> scale 1
    z[:4, 3] = [127.0, 0.5, 1.5, -2.5]             # exact rounding ties
    z[:, 4] *= 1e-30                               # tiny scales
    tq, ts = t_prop._quantize_cols(torch.from_numpy(z))
    jq, js = j_prop._quantize_cols(jnp.asarray(z))
    assert tq.dtype == torch.int8 and ts.shape == (6,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("gather", "float32"),
                                           ("fused", "bfloat16")])
def test_lightgcn_propagate_loop_matches_jax(datasets, backend, dtype, reduce, include_layer0):
    t, j = _build(datasets, "sym", backend, dtype)
    x = _x(t.shape[0], seed=7)
    got = t_base.lightgcn_propagate(t, torch.from_numpy(x), 3, include_layer0, reduce)
    ref = j_base.lightgcn_propagate(j, jnp.asarray(x), 3, include_layer0, reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("backend,dtype", [("dense", "float32"), ("gather", "bfloat16"),
                                           ("fused", "bfloat16"), ("fused", "int8")])
def test_lightgcn_layer_outputs_match_jax(datasets, backend, dtype):
    t, j = _build(datasets, "sym", backend, dtype)
    x = _x(t.shape[0], seed=8)
    outs = t_base.lightgcn_layer_outputs(t, torch.from_numpy(x), 2)
    refs = j_base.lightgcn_layer_outputs(j, jnp.asarray(x), 2)
    assert len(outs) == len(refs) == 3
    # the quantized chain crosses int8 round()s: tests/test_torch_propagate.py's NOISE
    bar = dict(rtol=2e-2, atol=1e-2) if dtype == "int8" else TIGHT
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **bar)


def test_auto_backend_is_dense_and_default_dtype_is_bfloat16(datasets):
    tdata, jdata = datasets
    t = t_prop.build_adjacency(tdata, device="cpu")
    j = j_prop.build_adjacency(jdata)
    assert isinstance(t, t_prop.DenseSquareAdj) and isinstance(j, j_prop.DenseSquareAdj)
    assert t.compute_dtype_name == j.compute_dtype_name == "bfloat16" and t.quant == "none"
    np.testing.assert_array_equal(t.m.numpy(), np.asarray(j.m))
    for name in ("left_u", "left_i", "right_u", "right_i", "diag_u", "diag_i"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("variant", ["self", "gen"])
def test_variant_vectors_bit_equal(datasets, variant):
    t, j = _build(datasets, variant, "fused", "bfloat16")
    assert (t.has_diag, t.quant) == (j.has_diag, j.quant) == (variant == "self", "none")
    for name in ("left_u", "left_i", "right_u", "right_i", "diag_u", "diag_i"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_dense_budget_counts_int8_bytes(datasets, monkeypatch):
    tdata, _ = datasets
    pad_bytes = t_prop._pad_up(tdata.num_users) * t_prop._pad_up(tdata.num_items)
    monkeypatch.setattr(t_prop, "dense_budget", lambda device: pad_bytes)
    assert isinstance(t_prop.build_adjacency(tdata, device="cpu"), t_prop.DenseSquareAdj)
    monkeypatch.setattr(t_prop, "dense_budget", lambda device: pad_bytes - 1)
    assert isinstance(t_prop.build_adjacency(tdata, device="cpu"), t_prop.GatherSquareAdj)


def test_build_adjacency_rejects(datasets):
    tdata, _ = datasets
    with pytest.raises(ValueError, match="dense or fused"):
        t_prop.build_adjacency(tdata, backend="gather", compute_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        t_prop.build_adjacency(tdata, compute_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        t_prop.build_adjacency(tdata, "rect", device="cpu")
    with pytest.raises(ValueError, match="alpha and beta"):
        t_prop.build_adjacency(tdata, "gen", device="cpu")
    adj = t_prop.build_adjacency(tdata, backend="dense", device="cpu")
    assert not adj.supports_rows
    with pytest.raises(NotImplementedError, match="B.B9"):
        adj.matmul_rows(None, None, None)


# ---------------------------------------------------------------------------
# the slice as a whole: LightGCN trains, evaluates and serves

LR, B = 0.001, 256
_TRAIN_SHAPE = (200, 300, 3000, 400)
_MODES = [("dense", "bfloat16"), ("gather", "float32"), ("fused", "bfloat16")]


def _cfg(backend, dtype):
    return {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001", "GCN_layer": "3",
            "compute_dtype": dtype, "propagation_backend": backend, "learn_rate": str(LR),
            "batch_size": str(B), "test_batch_size": "64", "top_K": "[5, 10]"}


@pytest.fixture(scope="module", params=_MODES, ids=lambda m: f"{m[0]}-{m[1]}")
def trained(request):
    """Three one-step epochs of LightGCN in both packages from converted
    weights and the same (user, pos, neg) arrays."""
    backend, dtype = request.param
    cfg = _cfg(backend, dtype)
    tdata, jdata = _pair(_TRAIN_SHAPE, seed=4)
    jmodel = j_get_model("LightGCN")(JConfig(cfg), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(7))
    tmodel = t_get_model("LightGCN")(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    jrun, trun = JRunner(jmodel, LR, B, B), TRunner(tmodel, LR, B, B)
    opt_state, rng, steps = jrun.init_opt_state(params), np.random.default_rng(0), []
    for step in range(3):
        pick = rng.integers(0, tdata.num_train, B)
        u, p, n = tdata.train_user[pick], tdata.train_item[pick], rng.integers(0, tdata.num_items, B)
        params, opt_state, _, jterms = jrun.run_epoch(
            params, opt_state, {}, (), *(jnp.asarray(a, jnp.int32) for a in (u, p, n)),
            jax.random.PRNGKey(1), step)
        tterms = trun.run_epoch(*(torch.from_numpy(np.asarray(a, np.int64)) for a in (u, p, n)),
                                epoch=step)
        steps.append((np.asarray(jterms), tterms.numpy(), jax.device_get(params),
                      convert.jax_params_from_model(tmodel)))
    return dict(mode=request.param, cfg=cfg, steps=steps, params=params, jmodel=jmodel,
                tmodel=tmodel, jdata=jdata, tdata=tdata)


def test_model_builds_the_configured_adjacency(trained):
    backend, dtype = trained["mode"]
    want = {"dense": t_prop.DenseSquareAdj, "gather": t_prop.GatherSquareAdj,
            "fused": t_prop.FusedSquareAdj}[backend]
    assert isinstance(trained["tmodel"].graph, want)
    assert type(trained["jmodel"].graph).__name__ == want.__name__


@pytest.mark.parametrize("step", [0, 1, 2])
def test_step_loss_terms_match_jax(trained, step):
    jterms, tterms, _, _ = trained["steps"][step]
    assert tterms.shape == (2,) and np.isfinite(tterms).all()
    np.testing.assert_allclose(tterms, jterms, rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_step_parameters_match_jax(trained, step):
    _, _, jparams, tparams = trained["steps"][step]
    rounded = trained["mode"] == ("dense", "bfloat16")
    for k in convert.EMBEDDING_KEYS:
        diff = np.abs(tparams[k] - np.asarray(jparams[k])) / LR
        assert diff.max() <= (2.0 + 1e-3 if rounded else 0.25), (k, diff.max())
        assert (diff > 0.25).mean() <= (5e-3 if rounded else 0.0), (k, (diff > 0.25).mean())
        assert diff.mean() <= (1e-2 if rounded else 1e-3), (k, diff.mean())


def test_eval_embeddings_and_metrics_match_jax(trained):
    jmodel, tmodel, params = trained["jmodel"], trained["tmodel"], trained["params"]
    convert.load_jax_params(tmodel, jax.device_get(params))
    j_user, j_item = jmodel.eval_embeddings(params, {}, (), jax.random.PRNGKey(0))
    t_user, t_item = tmodel.eval_embeddings()
    np.testing.assert_allclose(t_user.numpy(), np.asarray(j_user), **TIGHT)
    np.testing.assert_allclose(t_item.numpy(), np.asarray(j_item), **TIGHT)
    cfg = trained["cfg"]
    ref = JEvaluator(jmodel, trained["jdata"], JConfig(cfg)).evaluate(
        params, {}, (), jax.random.PRNGKey(0))
    got = TEvaluator(tmodel, trained["tdata"], TConfig(cfg)).evaluate()
    for name in ("recall", "precision", "ndcg"):
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-6)
    assert got["recall"][1] > 0


def test_served_ids_match_jax(trained):
    jmodel, tmodel, params = trained["jmodel"], trained["tmodel"], trained["params"]
    convert.load_jax_params(tmodel, jax.device_get(params))
    users = np.array([0, 3, 17, 42, 150, 199])
    t_items, t_scores = TRecommender(tmodel, trained["tdata"]).recommend(users, k=10)
    j_items, j_scores = JRecommender(jmodel, params, {}, (), trained["jdata"]).recommend(users, k=10)
    np.testing.assert_array_equal(t_items, np.asarray(j_items))
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=1e-5, atol=1e-6)
