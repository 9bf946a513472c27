"""The port's batch-row partial product (ops/gathermm.py,
`DenseSquareAdj.matmul_rows`, `lightgcn_propagate_rows`) against the JAX
package on the same inputs (its Pallas row-gather kernels interpreted on
the CPU), and against the port's own full product.

Tolerances:
* forward products at TIGHT (rtol 3e-5, atol 3e-6): both packages feed
  the same operands (z rounded to its type the same way), the counts are
  exact and every product is exact in float32 for bfloat16 z; only the
  order of the float32 additions differs;
* float32 gradients at TIGHT; bfloat16 gradients within one bfloat16 ulp
  (rtol 2**-7): both packages round the cotangent to bfloat16, sum in
  float32 and round dz to bfloat16, so a float32 sum that differs in its
  last bits can round to the neighbouring bfloat16 value;
* the rows path against the full path's rows at TIGHT, except the int8
  dense mode, whose full product quantizes the activations while its row
  product does not (as in the JAX package): it is held to the bfloat16
  dense adjacency's full product instead."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import base as t_base
from idgrec_torch.ops import gathermm as t_gathermm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.models import base as j_base
from idgrec_tpu.ops import gathermm as j_gathermm
from idgrec_tpu.ops import propagate as j_prop

TIGHT = dict(rtol=3e-5, atol=3e-6)
D = 8
_SHAPE = (300, 500, 4000, 800)
_DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def _x(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _grad_bar(dtype: str, ref: np.ndarray) -> dict:
    if dtype == "float32":
        return TIGHT
    return dict(rtol=2.0 ** -7, atol=3e-6 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,top", [(300, 1), (131, 5), (1, 127)])
def test_gather_matmul_matches_jax(dtype, b, top):
    """Repeated rows; B not a multiple of the JAX row block (128)."""
    rng = np.random.default_rng(b)
    r, c, z_rows = 260, 1100, 1030
    m = np.where(rng.random((r, c)) < 0.1, rng.integers(1, top + 1, (r, c)), 0).astype(np.int8)
    rows = np.concatenate([rng.integers(0, r, b - b // 2), rng.integers(0, 20, b // 2)])
    z, g = _x(z_rows, seed=1), _x(b, seed=2)
    tdt, jdt = _DTYPES[dtype]
    # the port's matrix is the dense backend's: columns padded to 128
    mt = torch.zeros((r, 1152), dtype=torch.int8)
    mt[:, :c] = torch.from_numpy(m)
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    got = t_gathermm.gather_matmul(mt, torch.from_numpy(rows), zt)
    got.backward(torch.from_numpy(g))
    ref, vjp = jax.vjp(lambda v: j_gathermm.gather_matmul(
        jnp.asarray(j_gathermm.pack_rows3(m)), jnp.asarray(rows, jnp.int32), v, True),
        jnp.asarray(z, jdt))
    (ref_dz,) = vjp(jnp.asarray(g))
    assert got.dtype == torch.float32 and got.shape == (b, D)
    assert zt.grad.dtype == tdt and zt.grad.shape == (z_rows, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TIGHT)
    ref_dz = np.asarray(ref_dz.astype(jnp.float32))
    np.testing.assert_allclose(zt.grad.float().numpy(), ref_dz, **_grad_bar(dtype, ref_dz))


def test_gather_matmul_row_out_of_range_raises():
    m = torch.ones((10, 128), dtype=torch.int8)
    z = torch.ones((128, D))
    for bad in (10, -1):
        with pytest.raises(IndexError):
            t_gathermm.gather_matmul(m, torch.tensor([0, bad]), z)


def _build(datasets, variant, dtype):
    tdata, jdata = datasets
    t = t_prop.build_adjacency(tdata, variant, "dense", compute_dtype=dtype, with_transpose=True,
                               device="cpu")
    j = j_prop.build_adjacency(jdata, variant, "dense", compute_dtype=dtype, with_transpose=True)
    return t, j


def _rows(n_users, n_items, seed=3):
    rng = np.random.default_rng(seed)
    ru = np.concatenate([rng.integers(0, n_users, 150), rng.integers(0, 10, 50)])
    ri = np.concatenate([rng.integers(0, n_items, 300), rng.integers(0, 10, 100)])
    return ru, ri


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("variant", ["sym", "self"])
def test_matmul_rows_matches_jax(datasets, variant, dtype):
    t, j = _build(datasets, variant, dtype)
    assert t.supports_rows and j.supports_rows and t.quant == j.quant
    assert t.m_t.shape == t.m.T.shape and torch.equal(t.m_t, t.m.T)
    ru, ri = _rows(t.num_users, t.num_items)
    x, wu, wi = _x(t.shape[0], seed=4), _x(ru.size, seed=5), _x(ri.size, seed=6)
    xt = torch.from_numpy(x).requires_grad_(True)
    yu, yi = t.matmul_rows(xt, torch.from_numpy(ru), torch.from_numpy(ri))
    ((yu * torch.from_numpy(wu)).sum() + (yi * torch.from_numpy(wi)).sum()).backward()

    def loss(v):
        a, b = j.matmul_rows(v, jnp.asarray(ru), jnp.asarray(ri))
        return jnp.sum(a * wu) + jnp.sum(b * wi)

    ref_u, ref_i = j.matmul_rows(jnp.asarray(x), jnp.asarray(ru), jnp.asarray(ri))
    ref_grad = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    np.testing.assert_allclose(yu.detach().numpy(), np.asarray(ref_u), **TIGHT)
    np.testing.assert_allclose(yi.detach().numpy(), np.asarray(ref_i), **TIGHT)
    bar = _grad_bar("float32" if dtype == "float32" else "bfloat16", ref_grad)
    np.testing.assert_allclose(xt.grad.numpy(), ref_grad, **bar)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("variant", ["sym", "self"])
def test_matmul_rows_are_the_full_products_rows(datasets, variant, dtype):
    tdata, _ = datasets
    adj = t_prop.build_adjacency(tdata, variant, "dense", compute_dtype=dtype,
                                 with_transpose=True, device="cpu")
    full_adj = adj if dtype != "int8" else t_prop.build_adjacency(
        tdata, variant, "dense", compute_dtype="bfloat16", device="cpu")
    ru, ri = _rows(adj.num_users, adj.num_items, seed=7)
    x = torch.from_numpy(_x(adj.shape[0], seed=8))
    yu, yi = adj.matmul_rows(x, torch.from_numpy(ru), torch.from_numpy(ri))
    full = full_adj.matmul(x)
    np.testing.assert_allclose(yu.numpy(), full[ru].numpy(), **TIGHT)
    np.testing.assert_allclose(yi.numpy(), full[adj.num_users + ri].numpy(), **TIGHT)


@pytest.mark.parametrize("include_layer0,reduce", [(True, "mean"), (False, "sum"),
                                                   (True, "sum")])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lightgcn_propagate_rows_matches_jax_and_the_full_path(datasets, dtype, include_layer0,
                                                               reduce):
    t, j = _build(datasets, "sym", dtype)
    ru, ri = _rows(t.num_users, t.num_items, seed=9)
    x = _x(t.shape[0], seed=10)
    got_u, got_i = t_base.lightgcn_propagate_rows(
        t, torch.from_numpy(x), 3, torch.from_numpy(ru), torch.from_numpy(ri), t.num_users,
        include_layer0, reduce)
    ref_u, ref_i = j_base.lightgcn_propagate_rows(
        j, jnp.asarray(x), 3, jnp.asarray(ru), jnp.asarray(ri), j.num_users, include_layer0,
        reduce)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ref_u), **TIGHT)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(ref_i), **TIGHT)
    full = t_base.lightgcn_propagate(t, torch.from_numpy(x), 3, include_layer0, reduce)
    np.testing.assert_allclose(got_u.numpy(), full[ru].numpy(), **TIGHT)
    np.testing.assert_allclose(got_i.numpy(), full[t.num_users + ri].numpy(), **TIGHT)


def test_zero_layers_rows_are_layer0(datasets):
    t, _ = _build(datasets, "sym", "float32")
    ru, ri = _rows(t.num_users, t.num_items, seed=11)
    x = torch.from_numpy(_x(t.shape[0], seed=12))
    got_u, got_i = t_base.lightgcn_propagate_rows(t, x, 0, torch.from_numpy(ru),
                                                  torch.from_numpy(ri), t.num_users)
    assert torch.equal(got_u, x[ru]) and torch.equal(got_i, x[t.num_users + ri])


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("batch,c,d", [(2048, 38144, 64), (4096, 31744, 64), (1, 128, 8),
                                       (300, 1280, 24), (2048, 128, 64), (70_000, 38144, 64),
                                       (700, 1024, 96), (4096, 31744, 256)])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_plan_rows_matmul_fills_the_card(batch, c, d, per_sm, backward):
    """The split's blocks fit one wave of 132 SMs (K13: two; unless one
    share already takes more), each share holds at least one stage, and
    the plan is a function of its arguments alone."""
    sms = 132
    s = t_gathermm.plan_rows_matmul(batch, c, d, sms, per_sm, backward)
    assert s == t_gathermm.plan_rows_matmul(batch, c, d, sms, per_sm, backward)
    groups = -(-d // t_gathermm.FEATURES)
    if backward:
        assert s in t_gathermm.K13_SHARES
        blocks = -(-c // t_gathermm.K13_COLS) * groups
        assert s == 1 or batch // s >= t_gathermm.K13_ROWS
    else:
        blocks = -(-batch // t_gathermm.K12_ROWS) * groups
        assert 1 <= s <= c // t_gathermm.K12_COLS
    waves = 2 if backward else 1
    assert s == 1 or blocks * s <= waves * sms * per_sm
    # the most that fits: one more share would not
    if backward and s < 8 and batch // (2 * s) >= t_gathermm.K13_ROWS:
        assert blocks * 2 * s > waves * sms * per_sm
    if not backward and s < c // t_gathermm.K12_COLS:
        assert blocks * (s + 1) > sms * per_sm
