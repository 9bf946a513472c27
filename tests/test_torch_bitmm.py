"""The port's bit-packed backend (ops/bitmm.py, `BitSquareAdj`) against
the JAX package on the same inputs (JAX Pallas kernels interpreted on the
CPU, as tests/test_propagate.py runs them).

Tolerances:
* the packed bytes are equal;
* products and gradients at TIGHT (rtol 3e-5, atol 3e-6): both packages
  round the same float32 activations (and, backward, the same
  cotangents) to bfloat16, every product of a bit and a bfloat16 value is
  exact, and only the order of the float32 additions differs;
* the bitpack backend against the bfloat16 fused backend of the port at
  TIGHT for the same reason (K11 against K6 on the card)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import bitmm as t_bitmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import bitmm as j_bitmm
from idgrec_tpu.ops import propagate as j_prop

TIGHT = dict(rtol=3e-5, atol=3e-6)
D = 8
_SHAPE = (300, 500, 4000, 800)
_GEN = dict(alpha=0.6, beta=0.3)


def _binary(r, c, density, seed=0):
    return (np.random.default_rng(seed).random((r, c)) < density).astype(np.int8)


def _x(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5))


@pytest.mark.parametrize("r,c,density", [(300, 500, 0.05), (1025, 513, 0.3), (8, 1, 1.0),
                                         (40, 70, 0.0)])
def test_pack_pair_bytes_equal_jax(r, c, density):
    m = _binary(r, c, density)
    t, t_t = t_bitmm.pack_pair(torch.from_numpy(m))
    j, j_t = j_bitmm.pack_pair(m)
    assert t.dtype == torch.int8 and t.shape == j.shape and t_t.shape == j_t.shape
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t_t.numpy(), j_t)
    np.testing.assert_array_equal(t_bitmm.pack_rows(torch.from_numpy(m)).numpy(),
                                  j_bitmm.pack_rows(m))


def test_unpack_rows_inverts_pack_rows():
    m = _binary(300, 500, 0.1, seed=1)
    back = t_bitmm.unpack_rows(t_bitmm.pack_rows(torch.from_numpy(m)))
    assert back.shape == (1024, 512)
    np.testing.assert_array_equal(back[:300, :500].numpy(), m)
    assert not bool(back[300:].any()) and not bool(back[:, 500:].any())


@pytest.mark.parametrize("d", [8, 16])
def test_bit_matmul_matches_jax(d):
    m = _binary(300, 500, 0.05, seed=2)
    x = _x(500, seed=3, d=d)
    packed = j_bitmm.pack_rows(m)
    got = t_bitmm.bit_matmul(torch.from_numpy(packed), torch.from_numpy(x), 300)
    ref = j_bitmm.bit_matmul(jnp.asarray(packed), jnp.asarray(j_bitmm.pack_rows(m.T)),
                             jnp.asarray(x), 300, True)
    assert got.dtype == torch.float32 and got.shape == (300, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TIGHT)


def test_bit_adj_matmul_and_gradient_match_jax():
    m = _binary(300, 500, 0.05, seed=4)
    p, pt = j_bitmm.pack_pair(m)
    xu, xi, wu, wi = _x(300, 5), _x(500, 6), _x(300, 7), _x(500, 8)
    tu, ti = torch.from_numpy(xu).requires_grad_(True), torch.from_numpy(xi).requires_grad_(True)
    yu, yi = t_bitmm.bit_adj_matmul(torch.from_numpy(p), torch.from_numpy(pt), tu, ti)
    ((yu * torch.from_numpy(wu)).sum() + (yi * torch.from_numpy(wi)).sum()).backward()

    def loss(a, b):
        ju, ji = j_bitmm.bit_adj_matmul(jnp.asarray(p), jnp.asarray(pt), a, b, True)
        return jnp.sum(ju * wu) + jnp.sum(ji * wi)

    ref_u, ref_i = j_bitmm.bit_adj_matmul(jnp.asarray(p), jnp.asarray(pt), jnp.asarray(xu),
                                          jnp.asarray(xi), True)
    gu, gi = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xu), jnp.asarray(xi))
    for a, b in ((yu, ref_u), (yi, ref_i), (tu.grad, gu), (ti.grad, gi)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TIGHT)


@pytest.mark.parametrize("case", ["uniform", "skewed", "empty", "one_row"])
def test_plan_rows_splits_the_stripes_by_cost(case):
    """K11's plan: PLAN_PARTS + 1 non-decreasing stripe indices from 0 to
    the number of stripes (32 pieces of 16 bytes of a packed row, the last
    of a row cut short), each warp's cost (a piece 1, a non-zero byte
    _ENTRY_COST more) within one stripe's cost of an even share; then each
    row group's first and last warp."""
    rng = np.random.default_rng(9)
    r, c = (3000, 1500) if case != "one_row" else (8, 1100)
    m = (rng.random((r, c)) < 0.01).astype(np.int8)
    if case == "skewed":  # a popular row group, as the item side of an interaction matrix
        m[16:24] = rng.random((8, c)) < 0.9
    elif case == "empty":
        m[:] = 0
    packed = t_bitmm.pack_rows(torch.from_numpy(m))
    plan = t_bitmm.plan_rows(packed)
    g, cp = packed.shape
    stripes = -(-cp // 512)
    parts = t_bitmm.PLAN_PARTS
    assert plan.dtype == torch.int32 and tuple(plan.shape) == (parts + 1 + 2 * g,)
    plan, owners = plan[: parts + 1], plan[parts + 1:].view(g, 2).numpy()
    assert int(plan[0]) == 0 and int(plan[-1]) == g * stripes
    assert bool((plan[1:] >= plan[:-1]).all())
    for row, first in enumerate(range(0, g * stripes, stripes)):
        for w, s_ in zip(owners[row], (first, first + stripes - 1)):
            assert plan[w] <= s_ < plan[w + 1]
    nz = np.pad(packed.numpy() != 0, ((0, 0), (0, stripes * 512 - cp))).reshape(-1, 512).sum(1)
    pieces = np.full(stripes, 32)
    pieces[-1] = (cp - (stripes - 1) * 512) // 16
    cost = nz * t_bitmm._ENTRY_COST + np.tile(pieces, g)
    share = cost.sum() / t_bitmm.PLAN_PARTS
    csum = np.concatenate([[0], np.cumsum(cost)])
    per_warp = csum[plan[1:].numpy()] - csum[plan[:-1].numpy()]
    assert per_warp.sum() == cost.sum() and per_warp.max() <= share + cost.max()


def _build(datasets, variant, dtype):
    tdata, jdata = datasets
    kw = _GEN if variant == "gen" else {}
    t = t_prop.build_adjacency(tdata, variant, "bitpack", compute_dtype=dtype, device="cpu",
                               **kw)
    j = j_prop.build_adjacency(jdata, variant, "bitpack", compute_dtype=dtype, **kw)
    return t, j


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
def test_bit_square_adj_matches_jax(datasets, variant, dtype, gated):
    t, j = _build(datasets, variant, dtype)
    assert isinstance(t, t_prop.BitSquareAdj) and type(j).__name__ == "BitSquareAdj"
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.packed_t.numpy(), np.asarray(j.packed_t))
    assert t.has_diag == j.has_diag == (variant == "self")
    x, w = _x(t.shape[0], seed=9), _x(t.shape[0], seed=10)
    gate = (np.random.default_rng(11).random(t.shape[0]) < 0.6).astype(np.float32)
    tg, jg = (torch.from_numpy(gate), jnp.asarray(gate)) if gated else (None, None)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t.matmul(xt, gate=tg)
    (got * torch.from_numpy(w)).sum().backward()
    ref = j.matmul(jnp.asarray(x), gate=jg)
    ref_grad = jax.grad(lambda v: jnp.sum(j.matmul(v, gate=jg) * w))(jnp.asarray(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TIGHT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), **TIGHT)


@pytest.mark.parametrize("variant", ["sym", "self"])
def test_bitpack_equals_fused_bfloat16(datasets, variant):
    """One product: the same bfloat16 operands and exact products as K6's
    plain version, another order of float32 additions."""
    tdata, _ = datasets
    x = torch.from_numpy(_x(tdata.num_nodes, seed=12))
    got = t_prop.build_adjacency(tdata, variant, "bitpack", device="cpu").matmul(x)
    want = t_prop.build_adjacency(tdata, variant, "fused", device="cpu").matmul(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TIGHT)


def test_bitpack_rejects_what_jax_rejects(datasets):
    tdata, jdata = datasets
    for dtype in ("int8", "int4"):
        with pytest.raises(ValueError, match="dense or fused"):
            t_prop.build_adjacency(tdata, backend="bitpack", compute_dtype=dtype, device="cpu")
        with pytest.raises(ValueError, match="dense or fused"):
            j_prop.build_adjacency(jdata, backend="bitpack", compute_dtype=dtype)
    counted = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    counted.csr_vals = counted.csr_vals.copy()
    counted.csr_vals[3] = 2.0
    with pytest.raises(ValueError, match="binary"):
        t_prop.build_adjacency(counted, backend="bitpack", device="cpu")
