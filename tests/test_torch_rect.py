"""The rectangular adjacency R̃ = Du^-1/2 · R · Di^-1/2 of the port and
EGCF's alternating mode on it, against the JAX package on the same
inputs (JAX's bitpack kernel interpreted on the CPU).

Tolerances, with their reasons:
* float32 products at TIGHT (rtol 3e-5, atol 3e-6): the same float32
  terms summed in another order.
* bfloat16 products and bitpack (both dtypes: K11 rounds the activations
  to bfloat16) within BF16 = 2**-7 of the largest entry: the forward
  rounds the same right-scaled activations, but on the way back XLA
  rounds the transposed product's result to bfloat16 where the port
  rounds the cotangent going in (the square dense backend's convention,
  tests/test_torch_exact.py).
* int8: the raw int32 sums exactly; one product's outputs and gradients
  within a few ulps (QUANT_ULPS), since both packages quantize the same
  inputs with IEEE division and dequantize with the same float32
  operations.
* EGCF from carried JAX weights, at tests/test_torch_egcf.py's bars:
  loss terms within rtol 1e-5; float32 modes' embeddings and gradients
  at TIGHT; bfloat16 and bitpack within BF16 of the largest entry (a tanh
  ulp between XLA and PyTorch can move a bfloat16 rounding); int8 three
  layers at NOISE (rtol 2e-2, atol 1e-2 of the largest entry, relative
  L2 error below 1e-2), because tanh's ulps can move an activation by 1
  lsb on a rounding tie; three Adam steps within 0.25 learn_rate per
  element and 1e-3 learn_rate on average, and bfloat16-dense at the bar
  tests/test_torch_exact.py states for its gradients' roundings (at
  most 0.5 % of the entries above 0.25 learn_rate, 1e-2 on average; an
  entry whose gradient changes sign moves by up to 2 learn_rate an
  update, so 2 learn_rate per step taken), and its later steps' loss
  terms start from weights apart by up to 1e-2 learn_rate on average
  (1e-5 on entries of about 0.1): rtol 1e-4 after the first step;
  metrics within 1e-6 and served ids equal except among scores within
  1e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch import convert
from idgrec_torch.config import Config as TConfig
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.data import graph as t_graph
from idgrec_torch.engine import checkpoint as t_ckpt
from idgrec_torch.engine.evaluator import Evaluator as TEvaluator
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import bitmm as t_bitmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.data import graph as j_graph
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.engine.evaluator import Evaluator as JEvaluator
from idgrec_tpu.engine.trainer import EpochRunner as JRunner
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import propagate as j_prop

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
BF16 = 2.0 ** -7
QUANT_ULPS = 4
D, NU, NI = 16, 200, 300
_SHAPE = (NU, NI, 3000, 400)
LR, B = 0.001, 256
_CFG = {"dataset": "tiny", "embedding_size": str(D), "reg_lambda": "0.0001", "GCN_layer": "3",
        "ssl_lambda": "0.1", "temperature": "0.1", "mode": "alternating",
        "compute_dtype": "int8", "learn_rate": str(LR), "batch_size": str(B),
        "test_batch_size": "64", "top_K": "[5, 10]", "interval": "1"}
# (backend, compute_dtype) of the products; int4 runs the int8 path
_MODES = [("dense", "float32"), ("dense", "bfloat16"), ("dense", "int8"), ("dense", "int4"),
          ("gather", "float32"), ("gather", "bfloat16"), ("bitpack", "bfloat16"),
          ("bitpack", "float32")]
_MODEL_MODES = [m for m in _MODES if m[1] != "int4"]


def _ids(mode):
    return "-".join(mode)


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5))


def _counted(mod):
    """A dataset whose counts are not binary (duplicated pairs summed)."""
    rng = np.random.default_rng(6)
    u, i = rng.integers(0, 60, 900), rng.integers(0, 90, 900)
    return mod.Dataset.from_pairs(u, i, u[:50], i[:50], num_users=60, num_items=90)


def _within_ulps(got, ref, ulps=QUANT_ULPS):
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= ulps * np.spacing(np.abs(ref).astype(np.float32))).all(), float(err.max())


def _noise(got, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, **NOISE)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


def _close(got, ref, backend, dtype):
    if dtype in ("int8", "int4"):
        _within_ulps(got, ref)
    elif dtype == "float32" and backend != "bitpack":
        np.testing.assert_allclose(got, ref, **TIGHT)
    else:
        assert np.abs(got - ref).max() <= BF16 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the graph and the products


@pytest.mark.parametrize("binary", [True, False])
def test_normalized_rectangular_equals_jax(datasets, binary):
    tdata, jdata = datasets if binary else (_counted(t_dataset), _counted(j_dataset))
    got = t_graph.normalized_rectangular(tdata)
    want = j_graph.normalized_rectangular(jdata, cache=False)
    assert got.shape == want.shape == (tdata.num_users, tdata.num_items)
    assert not got.symmetric and got.nnz == want.nnz
    for name in ("rows", "cols", "vals", "t_rows", "t_cols", "t_vals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.vals.dtype == torch.float32


@pytest.fixture(scope="module")
def rect_adjs(datasets):
    tdata, jdata = datasets
    return {mode: (t_prop.build_rect_adjacency(tdata, *mode, device="cpu"),
                   j_prop.build_rect_adjacency(jdata, *mode)) for mode in _MODES}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(NI, D)).astype(np.float32),
            rng.normal(size=(NU, D)).astype(np.float32),
            rng.normal(size=(NU, D)).astype(np.float32),
            rng.normal(size=(NI, D)).astype(np.float32))


@pytest.mark.parametrize("mode", _MODES, ids=_ids)
def test_rect_products_and_gradients_match_jax(rect_adjs, mode):
    t, j = rect_adjs[mode]
    xi, xu, w_u, w_i = _inputs(3)
    for name, x, w in (("matmul", xi, w_u), ("t_matmul", xu, w_i)):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = getattr(t, name)(xt)
        (out * torch.from_numpy(w)).sum().backward()
        ref, vjp = jax.vjp(getattr(j, name), jnp.asarray(x))
        (ref_grad,) = vjp(jnp.asarray(w))
        assert out.dtype == torch.float32 and out.shape == ref.shape
        _close(out.detach().numpy(), np.asarray(ref), *mode)
        _close(xt.grad.numpy(), np.asarray(ref_grad), *mode)


@pytest.mark.parametrize("mode", _MODES, ids=_ids)
def test_rect_builder_picks_the_jax_class(rect_adjs, mode):
    t, j = rect_adjs[mode]
    assert type(t).__name__ == type(j).__name__ and t.shape == j.shape == (NU, NI)
    if mode[0] == "dense":
        assert t.quant == j.quant == ("int8" if mode[1] in ("int8", "int4") else "none")
        # JAX's M, its columns padded further to the square matrix's
        # multiple (K6's column strip)
        assert t.m.shape[1] % t_prop.DENSE_COL_PAD == 0 and t.m.shape[0] == j.m.shape[0]
        np.testing.assert_array_equal(t.m.numpy(), _padded_like(np.asarray(j.m), t.m))
        # the int8 mode keeps Mᵀ for the card's transposed product
        assert (t.m_t is not None) == (t.quant == "int8")
        if t.m_t is not None:
            assert torch.equal(t.m_t, t.m.T)
    if mode[0] == "bitpack":
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        np.testing.assert_array_equal(t.packed_t.numpy(), np.asarray(j.packed_t))
        assert t.plans is None  # plans are made on the card only
    if mode[0] != "gather":
        np.testing.assert_array_equal(t.left.numpy(), np.asarray(j.left))
        np.testing.assert_array_equal(t.right.numpy(), np.asarray(j.right))


def _padded_like(a, m):
    """``a`` (JAX's [pad(U), pad(I)] matrix) zero-padded to ``m``'s shape."""
    out = np.zeros(tuple(m.shape), a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


@pytest.mark.parametrize("transpose", [False, True])
def test_int8_raw_sums_equal_jax(rect_adjs, transpose):
    t, j = rect_adjs[("dense", "int8")]
    rng = np.random.default_rng(4)
    z = rng.normal(size=(t.m.shape[0] if transpose else t.m.shape[1], D)).astype(np.float32)
    q, s = t_prop._quantize_cols(torch.from_numpy(z))
    jq, js = j_prop._quantize_cols(jnp.asarray(z))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = t_prop.int8_matmul(t.m, t.m_t, q, transpose)
    jm = jnp.asarray(_padded_like(np.asarray(j.m), t.m))
    mm = jm.T if transpose else jm
    want = np.asarray(jnp.matmul(mm, jq, preferred_element_type=jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_prop.int8_matmul_plain(t.m, q, transpose).numpy(), want)
    # the product of quant_matmul, and its straight-through backward
    zt = torch.from_numpy(z).requires_grad_(True)
    out = t_prop.quant_matmul(transpose, t.m, zt, t.m_t)
    g = rng.normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    ref, vjp = jax.vjp(lambda e: j_prop.quant_matmul(transpose, jm, e), jnp.asarray(z))
    _within_ulps(out.detach().numpy(), np.asarray(ref))
    _within_ulps(zt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_int4_runs_the_int8_path(rect_adjs):
    t8, t4 = rect_adjs[("dense", "int8")][0], rect_adjs[("dense", "int4")][0]
    xi, xu, _, _ = _inputs(5)
    assert torch.equal(t8.matmul(torch.from_numpy(xi)), t4.matmul(torch.from_numpy(xi)))
    assert torch.equal(t8.t_matmul(torch.from_numpy(xu)), t4.t_matmul(torch.from_numpy(xu)))


def test_exact_matmul_is_one_side_of_the_dual(rect_adjs):
    """The one-direction products are the dual's block products: the
    dual's results keep every bit."""
    m = rect_adjs[("dense", "float32")][0].m
    rng = np.random.default_rng(7)
    zu = torch.from_numpy(rng.normal(size=(m.shape[0], D)).astype(np.float32))
    zi = torch.from_numpy(rng.normal(size=(m.shape[1], D)).astype(np.float32))
    yu, yi = t_prop.fusedmm.dual_matmul_f32(m, zu, zi)
    assert torch.equal(t_prop.exact_matmul(False, m, zi, torch.float32), yu)
    assert torch.equal(t_prop.exact_matmul(True, m, zu, torch.float32), yi)
    np.testing.assert_allclose(yu.numpy(), m.double().numpy() @ zi.double().numpy(), **TIGHT)


def test_bit_rect_matmul_backward_is_the_other_packing(rect_adjs):
    t = rect_adjs[("bitpack", "bfloat16")][0]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(NI, D)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(NU, D)).astype(np.float32))
    y = t_bitmm.bit_rect_matmul(t.packed, t.packed_t, x, NU)
    assert torch.equal(y, t_bitmm.bit_matmul(t.packed, x.detach(), NU))
    (y * g).sum().backward()
    assert torch.equal(x.grad, t_bitmm.bit_matmul_plain(t.packed_t, g, NI))


@pytest.mark.parametrize("data_kind,backend,dtype,match", [
    ("binary", "fused", "bfloat16", "applies to the square adjacency only"),
    ("binary", "fused", "int8", "applies to the square adjacency only"),
    ("binary", "gather", "int8", "int8 requires the dense backend"),
    ("binary", "gather", "int4", "int8 requires the dense backend"),
    ("binary", "bitpack", "int8", "int8 requires the dense backend"),
    ("counted", "bitpack", "bfloat16", "requires binary interaction counts"),
    ("binary", "sparse", "bfloat16", "unknown propagation backend"),
])
def test_rect_rejections_match_jax(datasets, data_kind, backend, dtype, match):
    tdata, jdata = datasets if data_kind == "binary" else (_counted(t_dataset),
                                                           _counted(j_dataset))
    with pytest.raises(ValueError, match=match) as t_err:
        t_prop.build_rect_adjacency(tdata, backend, dtype, device="cpu")
    with pytest.raises(ValueError, match=match) as j_err:
        j_prop.build_rect_adjacency(jdata, backend, dtype)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_auto_selects_dense_never_fused(datasets, dtype):
    t = t_prop.build_rect_adjacency(datasets[0], "auto", dtype, device="cpu")
    j = j_prop.build_rect_adjacency(datasets[1], "auto", dtype)
    assert isinstance(t, t_prop.DenseRectAdj) and isinstance(j, j_prop.DenseRectAdj)
    # the square builder upgrades the same request to fused in the quantized modes
    square = t_prop.build_adjacency(datasets[0], "sym", "auto", compute_dtype=dtype, device="cpu")
    assert isinstance(square, t_prop.FusedSquareAdj) == (dtype != "bfloat16")


# ---------------------------------------------------------------------------
# EGCF, mode = alternating


def _models(datasets, backend, dtype, seed=7):
    tdata, jdata = datasets
    cfg = {**_CFG, "propagation_backend": backend, "compute_dtype": dtype}
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


def _model_close(got, ref, backend, dtype):
    if dtype == "int8":
        _noise(got, ref)
    else:
        _close(got, ref, backend, dtype)


@pytest.mark.parametrize("mode", _MODEL_MODES, ids=_ids)
def test_alternating_eval_embeddings_match_jax(datasets, mode):
    jmodel, tmodel, params = _models(datasets, *mode)
    assert not hasattr(tmodel, "graph")
    assert type(tmodel.user_graph).__name__ == type(jmodel.user_graph).__name__
    ju, ji = jmodel.eval_embeddings(params, {}, (), jax.random.PRNGKey(0))
    tu, ti = tmodel.eval_embeddings()
    assert tu.shape == (NU, D) and ti.shape == (NI, D)
    _model_close(torch.cat([tu, ti]).numpy(), np.concatenate([np.asarray(ju), np.asarray(ji)]),
                 *mode)


@pytest.mark.parametrize("mode", _MODEL_MODES, ids=_ids)
def test_alternating_loss_terms_and_gradients_match_jax(datasets, mode):
    jmodel, tmodel, params = _models(datasets, *mode, seed=9)
    u, p, n = _batch(datasets[0], np.random.default_rng(4))
    batch = dict(zip(("user", "pos", "neg"), _j32(u, p, n)))

    def j_loss(prm):
        terms, _ = jmodel.loss_terms(prm, {}, (), batch, jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    (_, jterms), ref = jax.value_and_grad(j_loss, has_aux=True)(params)
    terms = tmodel.loss_terms(dict(zip(("user", "pos", "neg"), _t64(u, p, n))))
    np.testing.assert_allclose([float(t.detach()) for t in terms], np.asarray(jterms), rtol=1e-5)
    sum(terms).backward()
    _model_close(tmodel.item_emb.grad.numpy(), np.asarray(ref["item_emb"]), *mode)


@pytest.mark.parametrize("mode", _MODEL_MODES, ids=_ids)
def test_alternating_three_adam_steps_match_jax(datasets, mode):
    jmodel, tmodel, params = _models(datasets, *mode, seed=8)
    jrun, trun = JRunner(jmodel, LR, B, B), TRunner(tmodel, LR, B, B)
    opt_state, rng = jrun.init_opt_state(params), np.random.default_rng(0)
    for step in range(3):
        u, p, n = _batch(datasets[0], rng)
        params, opt_state, _, jterms = jrun.run_epoch(params, opt_state, {}, (), *_j32(u, p, n),
                                                      jax.random.PRNGKey(1), step)
        tterms = trun.run_epoch(*_t64(u, p, n), epoch=step).numpy()
        assert tterms.shape == (3,) and np.isfinite(tterms).all()
        bf16_dense = mode == ("dense", "bfloat16")
        np.testing.assert_allclose(tterms, np.asarray(jterms),
                                   rtol=1e-4 if bf16_dense and step else 1e-5)
        diff = np.abs(tmodel.item_emb.detach().numpy()
                      - np.asarray(jax.device_get(params)["item_emb"])) / LR
        if bf16_dense:
            assert (diff.max() <= 2.0 * (step + 1) and (diff > 0.25).mean() <= 5e-3
                    and diff.mean() <= 1e-2), \
                (diff.max(), (diff > 0.25).mean(), diff.mean())
        else:
            assert diff.max() <= 0.25 and diff.mean() <= 1e-3, (diff.max(), diff.mean())


@pytest.mark.parametrize("which", ["evaluator", "recommender"])
def test_alternating_evaluates_and_serves_like_jax(datasets, which):
    tdata, jdata = datasets
    jmodel, tmodel, params = _models(datasets, "dense", "int8", seed=8)
    cfg = {**_CFG, "propagation_backend": "dense"}
    if which == "evaluator":
        ref = JEvaluator(jmodel, jdata, JConfig(cfg)).evaluate(params, {}, (),
                                                              jax.random.PRNGKey(0))
        got = TEvaluator(tmodel, tdata, TConfig(cfg)).evaluate()
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


def test_alternating_bpr_rises_while_the_loss_falls_in_both_packages():
    """EGCF's alternating mode at its published learn_rate and SSL weights,
    on data a model cannot learn beyond popularity (`make_synthetic_dataset`):
    over the first epochs the summed loss falls while the BPR sum rises,
    in the JAX package and in the port alike, from the same weights on the
    same batches. The port's epoch sums track JAX's within rtol 1e-3 (int8
    trajectories over 38 Adam steps: a tanh ulp moves an activation by 1
    lsb on a rounding tie, the bar of the three Adam steps compounded)."""
    shape, b, lr = (1000, 1500, 40_000, 1000), 2048, 0.001
    tdata = t_dataset.make_synthetic_dataset(*shape, seed=0)
    jdata = j_dataset.make_synthetic_dataset(*shape, seed=0)
    cfg = {**_CFG, "embedding_size": "64", "learn_rate": str(lr), "batch_size": str(b),
           "propagation_backend": "dense"}
    jmodel = j_get_model("EGCF")(JConfig(cfg), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = t_get_model("EGCF")(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    n = (tdata.num_train // b) * b
    jrun, trun = JRunner(jmodel, lr, b, n), TRunner(tmodel, lr, b, n)
    opt_state, rng, sums = jrun.init_opt_state(params), np.random.default_rng(1), []
    for epoch in range(2):
        pick = rng.permutation(tdata.num_train)[:n]
        u, p, neg = (tdata.train_user[pick], tdata.train_item[pick],
                     rng.integers(0, tdata.num_items, n))
        params, opt_state, _, jterms = jrun.run_epoch(params, opt_state, {}, (), *_j32(u, p, neg),
                                                      jax.random.PRNGKey(epoch), epoch)
        sums.append((np.asarray(jterms), trun.run_epoch(*_t64(u, p, neg), epoch=epoch).numpy()))
    (j0, t0), (j1, t1) = sums
    for terms in (j0, t0, j1, t1):
        assert terms.shape == (3,) and np.isfinite(terms).all()
    np.testing.assert_allclose(t0, j0, rtol=1e-3)
    np.testing.assert_allclose(t1, j1, rtol=1e-3)
    for first, second in ((j0, j1), (t0, t1)):
        assert second[0] > first[0] and second.sum() < first.sum(), (first, second)


def test_jax_alternating_checkpoint_loads_into_the_port(datasets, tmp_path):
    cfg = {**_CFG, "compute_dtype": "float32", "propagation_backend": "dense"}
    res = j_loop.train_model("EGCF", datasets[1], JConfig(cfg), seed=1, log_dir=None, echo=False,
                             max_epochs=1, checkpoint_dir=str(tmp_path))
    leaves, _ = t_ckpt.read_checkpoint(str(tmp_path), 1)
    model = t_get_model("EGCF")(TConfig(cfg), datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 5
    runner = TRunner(model, LR, B, datasets[0].num_train)
    assert convert.load_jax_checkpoint(model, runner.opt, str(tmp_path))["epoch"] == 1
    want = np.asarray(jax.device_get(res.params)["item_emb"])
    np.testing.assert_array_equal(model.item_emb.detach().numpy(), want)
    # the loaded weights give JAX's embeddings
    jmodel = j_get_model("EGCF")(JConfig(cfg), datasets[1])
    jmodel.device_put()
    ju, ji = jmodel.eval_embeddings(jax.device_get(res.params), {}, (), jax.random.PRNGKey(0))
    tu, ti = model.eval_embeddings()
    np.testing.assert_allclose(torch.cat([tu, ti]).numpy(),
                               np.concatenate([np.asarray(ju), np.asarray(ji)]), **TIGHT)
    rec = TRecommender.from_checkpoint("EGCF", datasets[0], TConfig(cfg), str(tmp_path),
                                       device="cpu")
    assert torch.equal(rec.model.item_emb, model.item_emb)


# ---------------------------------------------------------------------------
# the bfloat16 dense route on K6 (its plain version on the CPU)


def _old_rect(adj, x, transpose):
    """`DenseRectAdj.matmul` / `.t_matmul` as the bfloat16 dense route ran
    before K6: `exact_matmul` (one side of `fusedmm.dual_matmul_f32`) on
    the scaled activations padded to M's side."""
    scale_in, scale_out = (adj.left, adj.right) if transpose else (adj.right, adj.left)
    n_in, n_out = (adj.m.shape[0], adj.num_items) if transpose else (adj.m.shape[1],
                                                                      adj.num_users)
    z = t_prop._pad_rows(scale_in[:, None] * x.to(torch.float32), n_in)
    y = t_prop.exact_matmul(transpose, adj.m, z, torch.bfloat16)
    return (scale_out[:, None] * y[:n_out]).to(x.dtype)


# K6 takes d % 32 == 0: the route's width in these cases
D_K6 = 32


def _inputs_k6(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, D_K6)).astype(np.float32) for n in (NI, NU, NU, NI))


def _value_and_grad(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("transpose", [False, True])
def test_bf16_dense_route_equals_the_old_route_bit_for_bit(rect_adjs, transpose):
    """K6's plain version with one side left out computes what
    `exact_matmul` computed, bit for bit, forward and backward, on M
    padded to DENSE_COL_PAD."""
    t = rect_adjs[("dense", "bfloat16")][0]
    assert t.runs_kernel(D_K6) and not t.runs_kernel(D)
    assert t.m.shape[1] % t_prop.DENSE_COL_PAD == 0
    xi, xu, w_u, w_i = _inputs_k6(11)
    x, w = (xu, w_i) if transpose else (xi, w_u)
    got = _value_and_grad(t.t_matmul if transpose else t.matmul, x, w)
    want = _value_and_grad(lambda v: _old_rect(t, v, transpose), x, w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_matmul_both_equals_the_two_directions_bit_for_bit(rect_adjs):
    """One two-sided call gives the bits of the two one-sided ones, values
    and gradients (each side scaled by its own input's largest activation
    on the card; the same row blocks of M here)."""
    t = rect_adjs[("dense", "bfloat16")][0]
    assert t.runs_kernel(D_K6)
    xi, xu, w_u, w_i = _inputs_k6(12)
    outs = []
    for both in (True, False):
        a, b = torch.from_numpy(xi).requires_grad_(True), torch.from_numpy(xu).requires_grad_(True)
        ya, yb = t.matmul_both(a, b) if both else (t.matmul(a), t.t_matmul(b))
        ((ya * torch.from_numpy(w_u)).sum() + (yb * torch.from_numpy(w_i)).sum()).backward()
        outs.append((ya.detach(), yb.detach(), a.grad, b.grad))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_one_sided_k6_is_one_side_of_the_dual():
    """`fused_adj_matmul` with a side given as None: the other side's
    result over M's padded rows, the same bits as the two-sided call's,
    no result and no gradient for the absent side."""
    rng = np.random.default_rng(13)
    m = torch.from_numpy((rng.random((128, 512)) < 0.05).astype(np.int8))
    zu = torch.from_numpy(rng.normal(size=(100, D_K6)).astype(np.float32))
    zi = torch.from_numpy(rng.normal(size=(300, D_K6)).astype(np.float32)).requires_grad_(True)
    yu, none_i = t_prop.fusedmm.fused_adj_matmul(m, None, zi)
    assert none_i is None and yu.shape == (128, D_K6)
    dual_u, dual_i = t_prop.fusedmm.fused_adj_matmul(m, zu, zi.detach())
    assert torch.equal(yu[:100], dual_u)
    none_u, yi = t_prop.fusedmm.fused_adj_matmul(m, zu, None)
    assert none_u is None and yi.shape == (512, D_K6) and torch.equal(yi[:300], dual_i)
    g = torch.from_numpy(rng.normal(size=(128, D_K6)).astype(np.float32))
    (yu * g).sum().backward()
    assert zi.grad.shape == (300, D_K6)
    assert torch.equal(zi.grad, t_prop.fusedmm.fused_adj_matmul(m, g, None)[1][:300])
    with pytest.raises(ValueError, match="do not fit"):
        t_prop.fusedmm.fused_adj_matmul(m, None, None)


def test_the_route_calls_k6_in_bfloat16_only(datasets, monkeypatch):
    """bfloat16 at d % 32 == 0 goes through K6's wrapper, one side left out
    a direction and none in `matmul_both`; float32, int8 and other widths
    never call it."""
    calls = []
    real = t_prop.fusedmm.fused_adj_matmul

    def spy(m, zu, zi):
        calls.append((zu is not None, zi is not None))
        return real(m, zu, zi)

    monkeypatch.setattr(t_prop.fusedmm, "fused_adj_matmul", spy)
    tdata = datasets[0]
    for dtype, d, want in (("bfloat16", 32, [(False, True), (True, False), (True, True)]),
                           ("bfloat16", 24, []), ("float32", 32, []), ("int8", 32, [])):
        calls.clear()
        adj = t_prop.build_rect_adjacency(tdata, "dense", dtype, device="cpu")
        assert adj.runs_kernel(d) == bool(want)
        xi, xu = torch.ones(NI, d), torch.ones(NU, d)
        adj.matmul(xi)
        adj.t_matmul(xu)
        adj.matmul_both(xi, xu)
        assert calls == want, (dtype, d)
