"""SGL and its edge-dropout views in the port against the JAX package, on
the CPU: the same tables carried across (`convert`), the same batches,
and the same views, drawn by both packages from one numpy generator
state. The model runs its published config at the test's sizes (d = 32,
batch 256; ``ssl_ratio`` 0.1; ``aug_type`` 'ed' with one layer, and 'rw'
with two where named; the quantized views' chains run two) on each route
the JAX package gives it; the port's kernels run
their plain versions (K4, K6, K7, K8, K11) and the JAX Pallas kernels run
interpreted. Each JAX side runs its own backend of the same name: the
port's dense matrix pads its columns to 256 where JAX's pads to 128, and
the fused int4 rows differ in padding only.

Bars:
* the views' drop lists and scales, the gather views, the chains' raw
  integer sums at k·d: equal;
* one product (`DenseDropSquareAdj`, `BitDropSquareAdj`,
  `shared_chain_matmul`) forward within TIGHT (the same bfloat16 or
  float32 operands, exact products, float32 sums in another order), its
  gradient within GRAD = 2**-7 of the largest entry (on the bfloat16
  routes the port rounds the cotangent going in where XLA rounds the
  product coming out, 2**-9 relative each);
* `fused_chain_views_t`: the clean chain equal to `fused_chain_t` bit for
  bit; the chains against JAX's within the quantized bar of
  tests/test_torch_propagate.py (NOISE, a relative L2 error below 1e-2:
  a tie of the int8 rounding moves one activation by 1 lsb), their
  gradients likewise;
* the model, from carried JAX weights: loss terms within rtol LOSS_RTOL
  (1e-4 on the quantized routes, dense int8's clean chain and the fused
  int8 / int4 views, whose int8 ties can move one activation by 1 lsb),
  gradients within GRAD of the largest entry (NOISE_GRAD on the
  quantized routes); three Adam steps at tests/test_torch_rect.py's bar
  for the bfloat16 routes (an entry whose gradient changes sign moves by
  up to 2 learn_rate an update); eval embeddings within TIGHT (NOISE on
  the quantized routes); served ids equal except among scores within
  1e-5.
"""

from __future__ import annotations

import dataclasses
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
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import available_models as t_available
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.ops import scatter as t_scatter
from idgrec_torch.serving import Recommender as TRecommender
from idgrec_tpu.config import Config as JConfig
from idgrec_tpu.config import load_model_config as j_load_config
from idgrec_tpu.data import graph as j_graph
from idgrec_tpu.engine import loop as j_loop
from idgrec_tpu.models import available_models as j_available
from idgrec_tpu.models import get_model as j_get_model
from idgrec_tpu.ops import fusedmm as j_fusedmm
from idgrec_tpu.ops import propagate as j_prop
from idgrec_tpu.serving import Recommender as JRecommender
from test_torch_zoo_noise import (  # noqa: F401  (fixtures)
    LOSS_RTOL,
    LR,
    ROOT,
    TIGHT,
    _batch,
    _cfg,
    _grad_close,
    _jbatch,
    _tbatch,
    datasets,
)

GRAD = 2.0 ** -7
NOISE = dict(rtol=2e-2, atol=1e-2)
NOISE_GRAD = 2e-2
QUANT_LOSS_RTOL = 1e-4
SEED, VIEW_SEED, USERS_EVERY = 9, 3, 7
RATIO = 0.3  # the pieces' tests: more dropped edges than the config's 0.1
# the routes the JAX package gives SGL: (backend, compute_dtype)
ROUTES = {"dense_bf16": ("dense", "bfloat16"), "dense_f32": ("dense", "float32"),
          "dense_int8": ("dense", "int8"), "fused_bf16": ("fused", "bfloat16"),
          "fused_int8": ("fused", "int8"), "fused_int4": ("fused", "int4"),
          "bitpack": ("bitpack", "bfloat16"), "gather": ("gather", "float32")}
# the routes whose chains quantize (dense int8 its clean chain), and the
# quantized views route among them
QUANT_ROUTES = ("dense_int8", "fused_int8", "fused_int4")
VIEWS_ROUTES = ("fused_int8", "fused_int4")


def _sgl_cfg(route="dense_bf16", **extra):
    """The published config at the test's sizes on ``route``: one layer
    with 'ed' views, two with 'rw' (a view graph a layer)."""
    backend, dtype = ROUTES[route]
    layers = "2" if extra.get("aug_type") == "rw" else "1"
    return _cfg("SGL", propagation_backend=backend, compute_dtype=dtype,
                **{"GCN_layer": layers, **extra})


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t_vjp(fn, x, ct):
    """(fn(x), d<fn(x), ct>/dx) through autograd."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _j_vjp(fn, x, ct):
    y, back = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(back(jnp.asarray(ct))[0])


def _dropped(view):
    return [np.asarray(a) for a in (view.du_rows, view.du_cols, view.di_rows, view.di_cols)]


# ---------------------------------------------------------------------------
# registry, config, routes and the matrices each route holds


def test_sgl_is_registered_and_the_zoo_is_whole():
    assert t_get_model("SGL").model_name == "SGL"
    assert t_available() == sorted(j_available()) and len(t_available()) == 25
    cls, jcls = t_get_model("SGL"), j_get_model("SGL")
    assert tuple(cls.loss_names) == tuple(jcls.loss_names) == ("bpr", "reg", "ssl")
    assert cls.aggregates_per_step == 3 and cls.respects_early_stop is False


def test_config_copy_is_the_jax_file_byte_for_byte():
    assert t_load_config("SGL").as_dict() == j_load_config("SGL").as_dict()
    assert (ROOT / "idgrec_torch" / "configure" / "SGL.txt").read_bytes() == \
        (ROOT / "idgrec_tpu" / "configure" / "SGL.txt").read_bytes()


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_and_the_copies_of_m_they_hold(datasets, route):
    """The chains' route as the JAX package picks it, and no second copy
    of M where the model's own is the binary matrix: dense and fused
    bfloat16 share the model's matrix, the quantized views route holds
    none, bitpack shares the packed pair and its plans."""
    tmodel = t_get_model("SGL")(TConfig(_sgl_cfg(route)), datasets[0], device="cpu")
    jmodel = j_get_model("SGL")(JConfig(_sgl_cfg(route)), datasets[1])
    assert (tmodel._batched, tmodel._batched_quant) == (jmodel._batched, jmodel._batched_quant)
    assert type(tmodel.graph).__name__ == type(jmodel.graph).__name__
    g, shared = tmodel.graph, tmodel._shared
    if route.startswith("dense"):
        assert shared is g.m
    elif route == "fused_bf16":
        assert shared is g.m8
    elif route in VIEWS_ROUTES:
        assert shared is None and t_prop.supports_chain_views_t(g, 3, 32)
    elif route == "bitpack":
        assert shared[0] is g.packed and shared[1] is g.packed_t
    else:
        assert shared is None


def _jax_item_pad(num_items, d, quant):
    """The JAX package's padded item count of its fused matrix at
    ``emb_size`` d (its build_adjacency: the fine multiple where the
    single-panel accumulator fits, else PANEL)."""
    fine = j_fusedmm.PACK_TILE if quant == "int4" else j_fusedmm.TI
    mult = fine if j_fusedmm.fused_fits(num_items, d, fine) else j_fusedmm.PANEL
    return -(-num_items // mult) * mult


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("num_items", [300, 20_000, 38_048, 45_056, 53_248, 60_000, 91_599])
def test_views_rule_decides_as_jax(quant, d, num_items):
    """The port's copy of the JAX package's views rule (`ref_views_fit`)
    against JAX's `supports_chain_views_t` on the padded shape JAX's build
    gives: the same decision at every catalog size and width."""
    i_pad = _jax_item_pad(num_items, d, quant)
    assert t_prop.ref_item_pad(num_items, d, quant) == i_pad
    cols = i_pad // 2 if quant == "int4" else i_pad
    jg = j_prop.FusedSquareAdj(jax.ShapeDtypeStruct((1024, cols), jnp.int8), *([None] * 6),
                               num_users=1000, num_items=num_items, has_diag=False, quant=quant)
    tg = t_prop.FusedSquareAdj(torch.empty((1024, cols), dtype=torch.int8, device="meta"),
                               *([None] * 6), num_users=1000, num_items=num_items,
                               has_diag=False, quant=quant)
    assert t_prop.ref_views_fit(tg, 3, d) == j_prop.supports_chain_views_t(jg, 3, d)


def _declined(monkeypatch):
    """Both packages' wide view allowance set below the test graph's
    [3d, I_pad] accumulator, so that SGL's quantized views decline."""
    monkeypatch.setattr(j_fusedmm, "MAX_YI_VMEM_BYTES_WIDE", 4096)
    monkeypatch.setattr(t_prop, "REF_YI_BUDGET_WIDE", 4096)


@pytest.mark.parametrize("route", VIEWS_ROUTES)
def test_declined_views_take_three_passes_in_both_packages(datasets, monkeypatch, route):
    """Above the JAX package's allowance its SGL runs three passes: the
    clean chain quantized and each view a bfloat16 drop adjacency over the
    shared binary matrix. The port takes the same route and builds that
    matrix (the int8 model's own), and its step matches JAX's at the
    quantized bars."""
    _declined(monkeypatch)
    ref = _reference(datasets, route, "ed")
    jmodel = j_get_model("SGL")(JConfig(_sgl_cfg(route)), datasets[1])
    assert jmodel._batched_quant and not j_prop.supports_chain_views_t(jmodel.graph, 3, 32)
    tmodel = _tmodel(datasets, route, ref)
    assert tmodel._batched_quant and not tmodel._views_route
    assert not t_prop.supports_chain_views_t(tmodel.graph, 3, 32)
    g = tmodel.graph
    assert tmodel._shared is not None and (tmodel._shared is g.m8) == (g.quant == "int8")
    assert all(isinstance(v, t_prop.DenseDropSquareAdj) for view in tmodel.views for v in view)
    first = ref["steps"][0]
    terms = tmodel.loss_terms(_tbatch(*first["batch"]))
    np.testing.assert_allclose([float(t.detach()) for t in terms], first["terms"],
                               rtol=QUANT_LOSS_RTOL)
    sum(terms).backward()
    for k in ("item_emb", "user_emb"):
        _grad_close(getattr(tmodel, k).grad.numpy(), first["grads"][k], NOISE_GRAD)


def test_non_binary_counts_build_the_binary_matrix_apart(datasets):
    counts = datasets[0].csr_vals.copy()
    counts[::7] = 3
    heavy = dataclasses.replace(datasets[0], csr_vals=counts)
    model = t_get_model("SGL")(TConfig(_sgl_cfg()), heavy, device="cpu")
    assert not model._batched and model._shared is not model.graph.m
    assert int(model.graph.m.max()) == 3 and int(model._shared.max()) == 1
    assert torch.equal(model._shared, model.graph.m.clamp(max=1))


@pytest.mark.parametrize("aug,error", [("nd", NotImplementedError), ("walk", ValueError)])
def test_unsupported_augmentations_raise(datasets, aug, error):
    with pytest.raises(error):
        t_get_model("SGL")(TConfig(_sgl_cfg(aug_type=aug)), datasets[0], device="cpu")


def test_a_step_needs_the_epochs_views(datasets):
    model = t_get_model("SGL")(TConfig(_sgl_cfg()), datasets[0], device="cpu")
    with pytest.raises(RuntimeError, match="epoch_context"):
        model.loss_terms(_tbatch(*_batch(datasets[0], np.random.default_rng(0))))


# ---------------------------------------------------------------------------
# the views: drawn alike, built alike


def test_gather_views_equal_jax(datasets):
    """`edge_dropout_adjacency` keeps the same edges with the same values
    and padding as JAX's, and leaves the generator in the same state."""
    trng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    got = t_graph.edge_dropout_adjacency(datasets[0], RATIO, trng)
    want = j_graph.edge_dropout_adjacency(datasets[1], RATIO, jrng)
    assert got.nnz == want.nnz and got.symmetric and want.symmetric
    for k in ("rows", "cols", "vals", "t_rows", "t_cols", "t_vals"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
    assert trng.bit_generator.state == jrng.bit_generator.state
    view = t_prop.build_dropout_adjacency(datasets[0], RATIO, np.random.default_rng(4), "gather",
                                          device="cpu")
    assert isinstance(view, t_prop.GatherSquareAdj)
    np.testing.assert_array_equal(view.graph.vals.numpy(), want.vals)


@pytest.mark.parametrize("backend", ["dense", "fused", "bitpack"])
def test_drop_lists_and_scales_equal_jax(datasets, backend):
    tdata, jdata = datasets
    trng, jrng = np.random.default_rng(6), np.random.default_rng(6)
    shared = t_prop.build_dropout_shared(tdata, backend, "cpu")
    got = t_prop.build_dropout_adjacency(tdata, RATIO, trng, backend, shared=shared, device="cpu")
    want = j_prop.build_dropout_adjacency(jdata, RATIO, jrng, backend)
    assert trng.bit_generator.state == jrng.bit_generator.state
    for a, b in zip(_dropped(got), _dropped(want)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert (np.asarray(want.du_vals) == 1).all() and (np.asarray(want.di_vals) == 1).all()
    assert np.diff(_dropped(got)[0]).min() >= 0 and np.diff(_dropped(got)[2]).min() >= 0
    for k in ("left_u", "left_i", "right_u", "right_i"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    nnz = int(tdata.nnz)
    assert len(_dropped(got)[0]) == nnz - int(round((1 - RATIO) * nnz))


@pytest.mark.parametrize("side", ["users", "items"])
def test_correction_backward_sums_the_sorted_twin(datasets, side):
    """`scatter.correction` on one view's drop list: the forward is K4 on
    (rows, z[cols]); the backward runs K4 on the same edges sorted the
    other way, bit for bit, and equals the transpose's sum in float64
    within float32 rounding."""
    tdata = datasets[0]
    shared = t_prop.build_dropout_shared(tdata, "dense", "cpu")
    view = t_prop.build_dropout_adjacency(tdata, RATIO, np.random.default_rng(9), "dense",
                                          shared=shared, device="cpu")
    by_user, by_item = (view.du_rows, view.du_cols), (view.di_rows, view.di_cols)
    nu, ni = tdata.num_users, tdata.num_items
    (rows, cols), (t_rows, t_cols), n_rows, n_z = (
        (by_user, by_item, nu, ni) if side == "users" else (by_item, by_user, ni, nu))
    z = torch.from_numpy(_x(n_z, 32, 1)).requires_grad_(True)
    g = torch.from_numpy(_x(n_rows, 32, 2))
    out = t_scatter.correction(z, (rows, cols), (t_rows, t_cols), n_rows)
    assert torch.equal(out, t_scatter.scatter_add_rows_plain(rows, z.detach()[cols], n_rows))
    out.backward(g)
    assert torch.equal(z.grad, t_scatter.scatter_add_rows_plain(t_rows, g[t_cols], n_z))
    want = np.zeros((n_z, 32))
    np.add.at(want, cols.numpy(), g.numpy().astype(np.float64)[rows.numpy()])
    np.testing.assert_allclose(z.grad.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _views(datasets, backend, dtype):
    """(port adjacency, port view, JAX adjacency, JAX view) from one
    generator state, each view on its package's shared state."""
    tdata, jdata = datasets
    tg = t_prop.build_adjacency(tdata, "sym", backend, compute_dtype=dtype, device="cpu")
    jg = j_prop.build_adjacency(jdata, "sym", backend, compute_dtype=dtype, emb_size=32)
    tshared = t_prop.build_dropout_shared(tdata, backend, "cpu", tg)
    jshared = j_prop.build_dropout_shared(jdata, backend)
    tv = t_prop.build_dropout_adjacency(tdata, RATIO, np.random.default_rng(8), backend, dtype,
                                        tshared, device="cpu")
    jv = j_prop.build_dropout_adjacency(jdata, RATIO, np.random.default_rng(8), backend, dtype,
                                        m_bin=jshared)
    return tg, tv, jg, jv


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("dense", "float32"),
                                           ("bitpack", "bfloat16")])
def test_drop_view_product_and_gradient_match_jax(datasets, backend, dtype):
    """One view's Â' @ x against JAX's `DenseDropSquareAdj` /
    `BitDropSquareAdj`, forward and backward, and against the same
    product on a dense matrix of the view's kept edges."""
    tg, tv, jg, jv = _views(datasets, backend, dtype)
    assert isinstance(tv, t_prop.BitDropSquareAdj if backend == "bitpack"
                      else t_prop.DenseDropSquareAdj)
    assert backend != "dense" or tv.m_bin is tg.m
    x, ct = _x(tg.shape[0], 32, 1), _x(tg.shape[0], 32, 2)
    got, got_g = _t_vjp(tv.matmul, x, ct)
    want, want_g = _j_vjp(jv.matmul, x, ct)
    np.testing.assert_allclose(got, want, **TIGHT)
    _grad_close(got_g, want_g, GRAD)
    # the kept edges' normalized matrix, in float64
    nu = datasets[0].num_users
    users = np.repeat(np.arange(nu), np.diff(datasets[0].row_ptr))
    full = np.zeros((nu, datasets[0].num_items))
    full[users, datasets[0].col_idx] = 1.0
    du_rows, du_cols, _, _ = _dropped(tv)
    full[du_rows, du_cols] = 0.0
    a = tv.left_u.numpy()[:, None].astype(np.float64) * full * tv.right_i.numpy()[None, :]
    ref = np.concatenate([a @ x[nu:], a.T @ x[:nu]])
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_shared_chain_matches_jax_and_three_products(datasets, dtype):
    """The clean chain and two views side by side at 3d: against JAX's
    `shared_chain_matmul` forward and backward, and against each chain's
    own product."""
    tdata, jdata = datasets
    tg, tv1, jg, jv1 = _views(datasets, "dense", dtype)
    tv2 = t_prop.build_dropout_adjacency(tdata, RATIO, np.random.default_rng(11), "dense", dtype,
                                         tg.m, device="cpu")
    jv2 = j_prop.build_dropout_adjacency(jdata, RATIO, np.random.default_rng(11), "dense", dtype,
                                         m_bin=jv1.m_bin)
    n = tg.shape[0]
    xs = [_x(n, 32, s) for s in (1, 2, 3)]
    cts = [_x(n, 32, s) for s in (4, 5, 6)]
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    outs = t_prop.shared_chain_matmul(tg.m, [tg, tv1, tv2], txs, compute_dtype=dtype)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()

    def j_fn(*a):
        return j_prop.shared_chain_matmul(jv1.m_bin, [jg, jv1, jv2], list(a), compute_dtype=dtype)

    jouts, back = jax.vjp(j_fn, *(jnp.asarray(x) for x in xs))
    jgrads = back([jnp.asarray(c) for c in cts])
    for o, jo, x, jgr in zip(outs, jouts, txs, jgrads):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TIGHT)
        _grad_close(x.grad.numpy(), np.asarray(jgr), GRAD)
    for o, c, x in zip(outs, (tg, tv1, tv2), xs):
        np.testing.assert_allclose(o.detach().numpy(), c.matmul(torch.from_numpy(x)).numpy(),
                                   **TIGHT)


@pytest.mark.parametrize("quant,aug", [("int8", "ed"), ("int4", "ed"), ("int8", "rw")])
def test_quantized_views_match_jax(datasets, quant, aug):
    """`fused_chain_views_t` at 3d = 96: the raw integer sums of one
    application equal JAX's T-kernel's; the clean chain is `fused_chain_t`
    bit for bit; the three chains and their gradients against JAX's."""
    tdata, jdata = datasets
    layers = 2
    tg = t_prop.build_adjacency(tdata, "sym", "fused", compute_dtype=quant, device="cpu")
    jg = j_prop.build_adjacency(jdata, "sym", "fused", compute_dtype=quant, emb_size=32)
    assert t_prop.supports_chain_views_t(tg, 3, 32)
    count = 1 if aug == "ed" else layers
    trng, jrng = np.random.default_rng(12), np.random.default_rng(12)
    tviews = tuple(tuple(t_prop.build_dropout_adjacency(tdata, RATIO, trng, "fused", quant,
                                                        device="cpu") for _ in range(count))
                   for _ in range(2))
    jshared = j_prop.build_dropout_shared(jdata, "fused")
    jviews = tuple(tuple(j_prop.build_dropout_adjacency(jdata, RATIO, jrng, "fused", quant,
                                                        m_bin=jshared) for _ in range(count))
                   for _ in range(2))
    assert all(type(v) is t_prop.DropLists for vl in tviews for v in vl)
    # one application's raw sums at 96, the padded rows and columns zero
    nu, ni = tdata.num_users, tdata.num_items
    rng = np.random.default_rng(13)
    qu = rng.integers(-127, 128, size=(96, nu), dtype=np.int8)
    qi = rng.integers(-127, 128, size=(96, ni), dtype=np.int8)
    (tu_pad, ti_pad), (ju_pad, ji_pad) = tg.padded_shape, (jg.m8.shape[0], jg.padded_shape[1])

    def padded(q, cols):
        return np.pad(q, ((0, 0), (0, cols - q.shape[1])))

    assert t_prop.dual_t_route(tg.m8, 96, quant) == "n" and t_prop.dual_t_route(tg.m8, 64,
                                                                                  quant) == "t"
    tyu, tyi = t_prop._raw_dual_t(tg.m8, torch.from_numpy(padded(qu, tu_pad)),
                                  torch.from_numpy(padded(qi, ti_pad)), quant)
    jdual = j_fusedmm.fused_adj_matmul_int4_t if quant == "int4" else \
        j_fusedmm.fused_adj_matmul_int8_t
    jyu, jyi = jdual(jg.m8, jnp.asarray(padded(qu, ju_pad)), jnp.asarray(padded(qi, ji_pad)),
                     True)
    np.testing.assert_array_equal(tyu.numpy()[:, :nu], np.asarray(jyu)[:, :nu])
    np.testing.assert_array_equal(tyi.numpy()[:, :ni], np.asarray(jyi)[:, :ni])
    # the K7 / K8 route on the 32-row blocks is K1's / K5's, block by block
    k1 = [t_prop._raw_dual_t(tg.m8, torch.from_numpy(padded(qu[j:j + 32], tu_pad)),
                             torch.from_numpy(padded(qi[j:j + 32], ti_pad)), quant)
          for j in (0, 32, 64)]
    assert torch.equal(torch.cat([a for a, _ in k1]), tyu)
    assert torch.equal(torch.cat([b for _, b in k1]), tyi)

    x = _x(nu + ni, 32, 14)
    xt = torch.from_numpy(x).requires_grad_(True)
    outs = t_prop.fused_chain_views_t(tg, tviews, xt, layers)
    sum((o ** 2).sum() for o in outs).backward()
    clean = t_prop.fused_chain_t(tg, torch.from_numpy(x), layers)
    assert torch.equal(outs[0].detach(), clean)

    @jax.jit
    def j_forward_backward(a):
        outs_, back = jax.vjp(lambda b: j_prop.fused_chain_views_t(jg, jviews, b, layers), a)
        return outs_, back([2.0 * o for o in outs_])[0]  # the sum of squares' gradient

    jouts, jgrad = j_forward_backward(jnp.asarray(x))
    jgrad = np.asarray(jgrad)
    for o, jo in zip(outs, jouts):
        got, want = o.detach().numpy(), np.asarray(jo)
        np.testing.assert_allclose(got, want, **NOISE)
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    _grad_close(xt.grad.numpy(), jgrad, NOISE_GRAD)


# ---------------------------------------------------------------------------
# the model from carried JAX weights: a step, three Adam steps, evaluation
# and serving, on every route


def _reference(datasets, route, aug):
    """One JAX run of SGL on ``route`` from PRNGKey(SEED)'s tables and the
    views of rng(VIEW_SEED): three steps of three batches under Adam
    (each step's terms and gradients, the tables after it), then from the
    stepped tables the eval representation and the served ids of every
    USERS_EVERY-th user."""
    tdata, jdata = datasets
    jmodel = j_get_model("SGL")(JConfig(_sgl_cfg(route, aug_type=aug)), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    start = jax.device_get(params)
    ctx = jmodel.epoch_context(params, {}, 0, np.random.default_rng(VIEW_SEED))

    def loss(p, c, b):
        terms, _ = jmodel.loss_terms(p, {}, c, b, jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    opt_state, rng, steps = opt.init(params), np.random.default_rng(0), []
    for _ in range(3):
        batch = _batch(tdata, rng)
        (_, terms), grads = step(params, ctx, _jbatch(*batch))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(batch=batch, terms=np.asarray(terms),
                          grads={k: np.asarray(v) for k, v in grads.items()},
                          params=jax.device_get(params)))
    rep = jax.jit(lambda p, c: jmodel.eval_embeddings(p, {}, c, jax.random.PRNGKey(0)))(params,
                                                                                        ctx)
    jmodel.eval_embeddings = lambda *a, **k: rep  # the server reuses it
    users = np.arange(0, tdata.num_users, USERS_EVERY)
    items, scores = JRecommender(jmodel, params, {}, ctx, jdata).recommend(users, k=10)
    return dict(start=start, steps=steps, rep=np.concatenate([np.asarray(r) for r in rep]),
                users=users, items=items, scores=scores)


@pytest.fixture(scope="module")
def reference(datasets):
    cached = functools.lru_cache(maxsize=None)(lambda route, aug: _reference(datasets, route, aug))
    return lambda route, aug="ed": cached(route, aug)


def _tmodel(datasets, route, ref, aug="ed", params=None):
    tmodel = t_get_model("SGL")(TConfig(_sgl_cfg(route, aug_type=aug)), datasets[0],
                                device="cpu")
    convert.load_jax_params(tmodel, ref["start"] if params is None else params)
    tmodel.epoch_context(0, np.random.default_rng(VIEW_SEED))
    return tmodel


def _bars(route):
    quant = route in QUANT_ROUTES
    return (QUANT_LOSS_RTOL if quant else LOSS_RTOL, NOISE_GRAD if quant else GRAD,
            NOISE if quant else TIGHT)


@pytest.mark.parametrize("route,aug", [(r, "ed") for r in ROUTES] + [("dense_bf16", "rw")])
def test_one_step_matches_jax(datasets, reference, route, aug):
    ref = reference(route, aug)
    first = ref["steps"][0]
    loss_rtol, grad_bar, _ = _bars(route)
    tmodel = _tmodel(datasets, route, ref, aug)
    assert len(tmodel.views[0]) == (1 if aug == "ed" else 2)
    terms = tmodel.loss_terms(_tbatch(*first["batch"]))
    np.testing.assert_allclose([float(t.detach()) for t in terms], first["terms"], rtol=loss_rtol)
    sum(terms).backward()
    for k in ("item_emb", "user_emb"):
        _grad_close(getattr(tmodel, k).grad.numpy(), first["grads"][k], grad_bar)


@pytest.mark.parametrize("route", VIEWS_ROUTES)
def test_quantized_views_at_an_off_32_width_match_jax(datasets, route):
    """At d = 16 the three chains run side by side at 3d = 48, a width off
    32 (on the card K7 / K8 on features zero-padded to 64): one step from
    carried JAX weights against JAX's, at the quantized routes' bars."""
    tdata, jdata = datasets
    cfg = _sgl_cfg(route, embedding_size="16")
    jmodel = j_get_model("SGL")(JConfig(cfg), jdata)
    jmodel.device_put()
    params = jmodel.init_params(jax.random.PRNGKey(SEED))
    ctx = jmodel.epoch_context(params, {}, 0, np.random.default_rng(VIEW_SEED))
    batch = _batch(tdata, np.random.default_rng(0))

    def loss(p):
        terms, _ = jmodel.loss_terms(p, {}, ctx, _jbatch(*batch), jax.random.PRNGKey(0), 0)
        return sum(terms), terms

    (_, jterms), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    tmodel = t_get_model("SGL")(TConfig(cfg), tdata, device="cpu")
    convert.load_jax_params(tmodel, jax.device_get(params))
    tmodel.epoch_context(0, np.random.default_rng(VIEW_SEED))
    assert tmodel._views_route and tmodel.embedding_size == 16
    terms = tmodel.loss_terms(_tbatch(*batch))
    np.testing.assert_allclose([float(t.detach()) for t in terms], np.asarray(jterms),
                               rtol=QUANT_LOSS_RTOL)
    sum(terms).backward()
    for k in ("item_emb", "user_emb"):
        _grad_close(getattr(tmodel, k).grad.numpy(), np.asarray(jgrads[k]), NOISE_GRAD)


@pytest.mark.parametrize("route", list(ROUTES))
def test_three_adam_steps_match_jax(datasets, reference, route):
    ref = reference(route)
    loss_rtol, _, _ = _bars(route)
    tmodel = _tmodel(datasets, route, ref)
    trun = TRunner(tmodel, LR, 256, 256)
    for s, step in enumerate(ref["steps"]):
        tterms = trun.run_epoch(*_tbatch(*step["batch"]).values()).numpy()
        np.testing.assert_allclose(tterms, step["terms"], rtol=max(loss_rtol, 1e-4 if s else 0))
        for k, v in step["params"].items():
            diff = np.abs(getattr(tmodel, k).detach().numpy() - np.asarray(v)) / LR
            assert (diff.max() <= 2.0 * (s + 1) and (diff > 0.25).mean() <= 5e-3
                    and diff.mean() <= 1e-2), (k, diff.max(), (diff > 0.25).mean(), diff.mean())


@pytest.mark.parametrize("route", list(ROUTES))
def test_eval_embeddings_and_server_match_jax(datasets, reference, route):
    """From JAX's stepped tables: the clean chain, and the served ids."""
    ref = reference(route)
    _, _, rep_bar = _bars(route)
    tmodel = _tmodel(datasets, route, ref, params=ref["steps"][-1]["params"])
    rep = torch.cat(tmodel.eval_embeddings()).numpy()
    np.testing.assert_allclose(rep, ref["rep"], **rep_bar)
    items, scores = TRecommender(tmodel, datasets[0]).recommend(ref["users"], k=10)
    np.testing.assert_allclose(scores, ref["scores"], rtol=0, atol=1e-5)
    assert ((items == ref["items"]) | (np.abs(scores - ref["scores"]) <= 1e-5)).all()


# ---------------------------------------------------------------------------
# the run harness: the final evaluation, resume, a JAX checkpoint


def test_train_model_evaluates_after_the_last_epoch_and_resumes(datasets, tmp_path,
                                                                 monkeypatch):
    """SGL ignores early stopping and evaluates once more after its last
    epoch, with the views of one more `epoch_context`; a run resumed from
    its checkpoint redraws the same views (the numpy generator's state is
    checkpointed) and equals a straight one."""
    tdata = datasets[0]
    cfg = TConfig(_sgl_cfg(training_epochs="2", early_stopping="0"))
    epochs = []
    real = t_get_model("SGL").epoch_context

    def spy(self, epoch, np_rng):
        epochs.append(epoch)
        return real(self, epoch, np_rng)

    monkeypatch.setattr(t_get_model("SGL"), "epoch_context", spy)
    kw = dict(seed=3, log_dir=None, echo=False, device="cpu")
    straight = t_loop.train_model("SGL", tdata, cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    assert epochs == [0, 1, 2]
    assert np.isfinite(straight.last_result["recall"]).all()
    t_loop.train_model("SGL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), max_epochs=1, **kw)
    resumed = t_loop.train_model("SGL", tdata, cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k])
    assert straight.history[-1]["loss"] == resumed.history[-1]["loss"]
    np.testing.assert_array_equal(straight.last_result["recall"], resumed.last_result["recall"])


def test_jax_sgl_checkpoint_loads_into_the_port(datasets, tmp_path):
    ck = str(tmp_path / "jax_sgl")
    cfg = _sgl_cfg()
    res = j_loop.train_model("SGL", datasets[1], JConfig(cfg), seed=1, log_dir=None, echo=False,
                             max_epochs=1, checkpoint_dir=ck)
    leaves, _ = t_ckpt.read_checkpoint(ck, 1)
    model = t_get_model("SGL")(TConfig(cfg), datasets[0], device="cpu")
    assert len(leaves) == convert.jax_num_leaves(model) == 8
    runner = TRunner(model, LR, 256, datasets[0].num_train)
    assert convert.load_jax_checkpoint(model, runner.opt, ck)["epoch"] == 1
    for k, v in jax.device_get(res.params).items():
        np.testing.assert_array_equal(getattr(model, k).detach().numpy(), np.asarray(v))
    rec = TRecommender.from_checkpoint("SGL", datasets[0], TConfig(cfg), ck, device="cpu")
    items, scores = rec.recommend([1, 17], k=5)
    assert items.shape == (2, 5) and np.isfinite(scores).all()
