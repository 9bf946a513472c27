"""The per-application dual products of the fused backend (the entry
points of kernels K6, K7 and K8, through their plain versions on the
CPU) and `FusedSquareAdj.matmul` against the JAX package, whose Pallas
kernels run interpreted (`fusedmm.interpret_default`).

Tolerances:
* `fused_adj_matmul` and its gradient at TIGHT (rtol 3e-5, atol 3e-6):
  both packages round the same activations (or cotangents) to bfloat16,
  every product is exact in float32, only the order of the float32
  additions differs.
* `fused_adj_matmul_int8` / `_int4` raw sums: integers, exactly equal.
* `quant_fused_dual` / `quant_fused_dual4`, forward and backward: the
  same quantized integers and scales bit for bit, then one float32
  multiplication: exactly equal.
* `FusedSquareAdj.matmul` in int8 and int4: one application from the
  same inputs, TIGHT (float32 scale products in another association
  could differ by an ulp; here they are equal in practice).
* repeated `matmul` against the transposed chain, port against port:
  exactly equal (the promise of the JAX `fused_chain_t` docstring), for
  the layer list, the mean combine and the gradient."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import base as t_base
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import fusedmm as t_fused
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import fusedmm as j_fused
from idgrec_tpu.ops import propagate as j_prop

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
_SHAPE = (300, 500, 4000, 800)
D = 8


def _counts(rng, shape, top=1, density=0.05):
    mask = rng.random(shape) < density
    return np.where(mask, rng.integers(1, top + 1, shape), 0).astype(np.int8)


def _acts(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.fixture(scope="module")
def datasets():
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=5),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=5))


def _build(datasets, variant, dtype):
    tdata, jdata = datasets
    kw = dict(alpha=0.6, beta=0.3) if variant == "gen" else {}
    return (t_prop.build_adjacency(tdata, variant, "fused", compute_dtype=dtype, emb_size=D,
                                   device="cpu", **kw),
            j_prop.build_adjacency(jdata, variant, "fused", compute_dtype=dtype, emb_size=D, **kw))


# ---------------------------------------------------------------------------
# B6: the bfloat16 dual


@pytest.mark.parametrize("u,i", [(1024, 512), (1000, 500), (2048, 1024)])
def test_fused_adj_matmul_matches_jax(u, i):
    rng = np.random.default_rng(0)
    u_pad, i_pad = -(-u // 1024) * 1024, -(-i // 512) * 512
    m = _counts(rng, (u_pad, i_pad), top=3)
    zu = rng.normal(size=(u, D)).astype(np.float32)
    zi = rng.normal(size=(i, D)).astype(np.float32)
    yu, yi = t_fused.fused_adj_matmul(torch.from_numpy(m), torch.from_numpy(zu),
                                      torch.from_numpy(zi))
    ryu, ryi = j_fused.fused_adj_matmul(jnp.asarray(m), jnp.asarray(zu), jnp.asarray(zi), True)
    assert yu.dtype == yi.dtype == torch.float32
    assert tuple(yu.shape) == (u, D) and tuple(yi.shape) == (i, D)
    np.testing.assert_allclose(yu.numpy(), np.asarray(ryu), **TIGHT)
    np.testing.assert_allclose(yi.numpy(), np.asarray(ryi), **TIGHT)


def test_fused_adj_matmul_gradient_matches_jax():
    rng = np.random.default_rng(1)
    m = _counts(rng, (1024, 512), top=3)
    zu = rng.normal(size=(1000, D)).astype(np.float32)
    zi = rng.normal(size=(500, D)).astype(np.float32)
    wu = rng.normal(size=(1000, D)).astype(np.float32)
    wi = rng.normal(size=(500, D)).astype(np.float32)
    a, b = (torch.from_numpy(zu).requires_grad_(True), torch.from_numpy(zi).requires_grad_(True))
    yu, yi = t_fused.fused_adj_matmul(torch.from_numpy(m), a, b)
    ((yu * torch.from_numpy(wu)).sum() + (yi * torch.from_numpy(wi)).sum()).backward()

    def loss(zu_, zi_):
        ru, ri = j_fused.fused_adj_matmul(jnp.asarray(m), zu_, zi_, True)
        return jnp.sum(ru * jnp.asarray(wu)) + jnp.sum(ri * jnp.asarray(wi))

    gu, gi = jax.grad(loss, argnums=(0, 1))(jnp.asarray(zu), jnp.asarray(zi))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gu), **TIGHT)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gi), **TIGHT)
    # the backward is the forward on the swapped cotangents
    su, si = t_fused.fused_adj_matmul(torch.from_numpy(m), torch.from_numpy(wu),
                                      torch.from_numpy(wi))
    assert torch.equal(a.grad, su) and torch.equal(b.grad, si)


def test_fused_adj_matmul_rounds_operands_to_bfloat16_and_keeps_float32_sums():
    rng = np.random.default_rng(2)
    m = _counts(rng, (1024, 512), top=5, density=0.3)
    zu = rng.normal(size=(1024, D)).astype(np.float32)
    zi = rng.normal(size=(512, D)).astype(np.float32)
    yu, yi = t_fused.fused_adj_matmul_plain(torch.from_numpy(m), torch.from_numpy(zu),
                                            torch.from_numpy(zi))
    zu16 = torch.from_numpy(zu).to(torch.bfloat16).double()
    zi16 = torch.from_numpy(zi).to(torch.bfloat16).double()
    m64 = torch.from_numpy(m).double()
    # against float64 sums of the rounded operands: float32 round-off only,
    # far inside one bfloat16 ulp of the sums (2**-8)
    np.testing.assert_allclose(yu.numpy(), (m64 @ zi16).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yi.numpy(), (m64.T @ zu16).numpy(), rtol=1e-5, atol=1e-5)


def _k6_fixed_point(m8: torch.Tensor, zu: torch.Tensor, zi: torch.Tensor) -> list:
    """K6's arithmetic on the CPU, for the test below: each entry's
    product v * bf16(z) (exact) scaled by 2**(31 - e), where amax < 2**e
    is the largest |bf16(z)| of the side the sum runs over (the shift at
    most 120, 0 when amax is 0), rounded half to even to int64; integer
    sums; then float32. Per side: (the sums, their float64 values
    without the rounding, the bound on the products' rounding)."""

    def side(m, z, rows):
        zb = torch.nn.functional.pad(z.to(torch.bfloat16).double(),
                                     (0, 0, 0, m.shape[1] - z.shape[0]))
        amax = float(zb.abs().max())
        shift = 0 if amax == 0 else min(31 - math.frexp(amax)[1], 120)
        prod = torch.round(m.double()[:, :, None] * zb[None] * 2.0 ** shift).to(torch.int64)
        # half a step of the fixed point per non-zero entry of the row
        bound = (m != 0).sum(1, keepdim=True).double() * 2.0 ** (-shift - 1)
        return ((prod.sum(1).double() * 2.0 ** -shift).float()[:rows],
                (m.double() @ zb)[:rows], bound[:rows])

    return [side(m8, zi, zu.shape[0]), side(m8.T, zu, zi.shape[0])]


@pytest.mark.parametrize("u_pad,i_pad,density,top,scale", [
    (64, 256, 0.05, 3, 1.0),
    (64, 128, 1.0, 5, 1.0),        # dense: the longest sums
    (64, 256, 0.3, 127, 1e-6),     # the largest counts, cotangent-sized activations
    (64, 128, 0.0, 1, 1.0),        # all zero
    (64, 128, 0.05, 2, 1e3),
    (64, 256, 0.3, -127, None),    # counts of both signs, |z| from 2**-20 to 2**10
])
def test_k6_fixed_point_sums_match_plain(u_pad, i_pad, density, top, scale):
    """K6 rounds each entry's product once to 64-bit fixed point, the
    scale a power of two from the largest activation of the side, and
    sums integers: that stays within TIGHT (relative to the largest sum)
    of the plain version's float32 sums of the same bfloat16 operands,
    and within half a fixed-point step per entry (then one float32
    rounding) of the exact sums."""
    rng = np.random.default_rng(7)
    if top > 0:
        m = _counts(rng, (u_pad, i_pad), top=top, density=density)
    else:
        mask = rng.random((u_pad, i_pad)) < density
        m = np.where(mask, rng.integers(top, -top + 1, (u_pad, i_pad)), 0).astype(np.int8)
    u, i = u_pad - 5, i_pad - 9

    def acts(n):
        if scale is not None:
            return rng.normal(size=(n, D)).astype(np.float32) * np.float32(scale)
        mag = 2.0 ** rng.uniform(-20, 10, (n, D))
        return (np.where(rng.random((n, D)) < 0.5, -mag, mag)).astype(np.float32)

    zu, zi = torch.from_numpy(acts(u)), torch.from_numpy(acts(i))
    mt = torch.from_numpy(m)
    for (got, exact, bound), want in zip(_k6_fixed_point(mt, zu, zi),
                                         t_fused.fused_adj_matmul_plain(mt, zu, zi)):
        assert got.shape == want.shape and got.dtype == torch.float32
        top_sum = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-6 * max(top_sum, 1e-30))
        err = (got.double() - exact).abs()
        assert bool((err <= bound + exact.abs() * 2.0 ** -24).all())


def test_fused_adj_matmul_validates():
    m = torch.zeros((1024, 512), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not fit"):
        t_fused.fused_adj_matmul(m, torch.zeros(1025, D), torch.zeros(512, D))
    with pytest.raises(ValueError, match="do not fit"):
        t_fused.fused_adj_matmul(m, torch.zeros(1024, D), torch.zeros(512, D + 1))


# ---------------------------------------------------------------------------
# B7: the [N, d]-layout int8 and int4 duals


@pytest.mark.parametrize("u,i,top", [(256, 1024, 1), (1024, 512, 127), (128, 512, 3)])
def test_int8_raw_sums_equal_jax(u, i, top):
    rng = np.random.default_rng(3)
    m, qu, qi = _counts(rng, (u, i), top=top, density=0.2), _acts(rng, (u, D)), _acts(rng, (i, D))
    yu, yi = t_fused.fused_adj_matmul_int8(*(torch.from_numpy(a) for a in (m, qu, qi)))
    ryu, ryi = j_fused.fused_adj_matmul_int8(*(jnp.asarray(a) for a in (m, qu, qi)), True)
    assert yu.dtype == torch.float32 and tuple(yu.shape) == (u, D) and tuple(yi.shape) == (i, D)
    np.testing.assert_array_equal(yu.numpy(), np.asarray(ryu))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ryi))
    np.testing.assert_array_equal(yu.numpy(), m.astype(np.int64) @ qi.astype(np.int64))
    np.testing.assert_array_equal(yi.numpy(), m.astype(np.int64).T @ qu.astype(np.int64))


@pytest.mark.parametrize("u,i,top", [(256, 4096, 1), (128, 2048, 7)])
def test_int4_raw_sums_equal_jax_and_int8(u, i, top):
    rng = np.random.default_rng(4)
    m, qu, qi = _counts(rng, (u, i), top=top, density=0.2), _acts(rng, (u, D)), _acts(rng, (i, D))
    m4 = t_fused.pack_nibbles(torch.from_numpy(m))
    np.testing.assert_array_equal(m4.numpy(), j_fused.pack_nibbles(m))
    yu, yi = t_fused.fused_adj_matmul_int4(m4, torch.from_numpy(qu), torch.from_numpy(qi))
    ryu, ryi = j_fused.fused_adj_matmul_int4(jnp.asarray(m4.numpy()), jnp.asarray(qu),
                                             jnp.asarray(qi), True)
    np.testing.assert_array_equal(yu.numpy(), np.asarray(ryu))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ryi))
    yu8, yi8 = t_fused.fused_adj_matmul_int8(*(torch.from_numpy(a) for a in (m, qu, qi)))
    assert torch.equal(yu, yu8) and torch.equal(yi, yi8)


def test_n_layout_sums_are_the_transposed_layout_sums():
    rng = np.random.default_rng(5)
    m, qu, qi = _counts(rng, (128, 2048), top=7), _acts(rng, (128, D)), _acts(rng, (2048, D))
    mt, qut, qit = (torch.from_numpy(a) for a in (m, qu, qi))
    yu, yi = t_fused.fused_adj_matmul_int8(mt, qut, qit)
    yuT, yiT = t_fused.fused_adj_matmul_int8_t(mt, qut.T.contiguous(), qit.T.contiguous())
    assert torch.equal(yu, yuT.T) and torch.equal(yi, yiT.T)
    m4 = t_fused.pack_nibbles(mt)
    yu4, yi4 = t_fused.fused_adj_matmul_int4(m4, qut, qit)
    yu4T, yi4T = t_fused.fused_adj_matmul_int4_t(m4, qut.T.contiguous(), qit.T.contiguous())
    assert torch.equal(yu4, yu4T.T) and torch.equal(yi4, yi4T.T)


@pytest.mark.parametrize("mode,u_pad,i_pad,d,want", [
    ("bf16", 31744, 38400, 64, True), ("int8", 31744, 38400, 128, True),
    ("int8", 1024, 512, 32, True), ("int4", 31744, 38912, 64, True),
    ("int8", 1024, 512, 96, True), ("int8", 1024, 512, 48, False),
    ("int8", 1024, 512, 8, False), ("int4", 1024, 1024, 64, False),
    ("bf16", 1000, 512, 64, False), ("bf16", 1024, 384, 64, False),
    ("bf16", 2 ** 23 + 64, 512, 64, False), ("int8", 0, 512, 64, False),
])
def test_kernel_accepts_n(mode, u_pad, i_pad, d, want):
    assert t_fused.kernel_accepts_n(u_pad, i_pad, d, mode) is want
    if not want:
        with pytest.raises(ValueError, match="takes d % 32 == 0"):
            t_fused._require_n("kernel", mode, u_pad, i_pad, d)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d,group,passes", [
    (64, 64, 1), (128, 128, 1), (2048, 128, 16), (96, 32, 3), (32, 32, 1), (192, 64, 3),
    (256, 128, 2),
])
def test_k7_feature_passes(d, group, passes, mode):
    """K6 (bf16), K7 (int8) and K8 (int4) share one scan: it reads the
    stored matrix once per 128 features where d % 128 == 0, else once per
    64 or 32, the group their launcher takes from the wrapper, at every
    width the kernel takes."""
    assert t_fused.scan_feature_group(d) == group
    assert t_fused.scan_passes(d) == passes
    assert group * passes == d
    assert t_fused.kernel_accepts_n(1024, t_fused.PACK_TILE, d, mode)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_fused_dual_forward_and_backward_equal_jax(quant):
    rng = np.random.default_rng(6)
    u, i = 256, 2048
    m = _counts(rng, (u, i), top=3, density=0.1)
    zu = (rng.normal(size=(u, D)) * 2).astype(np.float32)
    zi = (rng.normal(size=(i, D)) * 0.1).astype(np.float32)
    zi[:, 2] = 0.0                                     # a zero feature: scale 1
    g_yu = rng.normal(size=(u, D)).astype(np.float32)
    g_yi = rng.normal(size=(i, D)).astype(np.float32)
    if quant == "int4":
        tm = t_fused.pack_nibbles(torch.from_numpy(m))
        jm, t_fn, j_fn = jnp.asarray(tm.numpy()), t_prop.quant_fused_dual4, j_prop.quant_fused_dual4
    else:
        tm, jm = torch.from_numpy(m), jnp.asarray(m)
        t_fn, j_fn = t_prop.quant_fused_dual, j_prop.quant_fused_dual
    a, b = torch.from_numpy(zi).requires_grad_(True), torch.from_numpy(zu).requires_grad_(True)
    yu, yi = t_fn(tm, a, b)
    torch.autograd.backward([yu, yi], [torch.from_numpy(g_yu), torch.from_numpy(g_yi)])
    (ryu, ryi), vjp = jax.vjp(lambda zi_, zu_: j_fn(jm, zi_, zu_, True), jnp.asarray(zi),
                              jnp.asarray(zu))
    r_dzi, r_dzu = vjp((jnp.asarray(g_yu), jnp.asarray(g_yi)))
    np.testing.assert_array_equal(yu.detach().numpy(), np.asarray(ryu))
    np.testing.assert_array_equal(yi.detach().numpy(), np.asarray(ryi))
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(r_dzi))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(r_dzu))


def test_quant_dual_matmul_equals_quant_fused_dual():
    """The dense backend's int8 product (float32 products of the
    integers) and the fused one (the kernel's plain version) are the
    same integers."""
    rng = np.random.default_rng(7)
    m = torch.from_numpy(_counts(rng, (256, 512), top=127, density=0.5))
    zi = torch.from_numpy(rng.normal(size=(512, D)).astype(np.float32))
    zu = torch.from_numpy(rng.normal(size=(256, D)).astype(np.float32))
    for a, b in zip(t_prop.quant_dual_matmul(m, zi, zu), t_prop.quant_fused_dual(m, zi, zu)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# FusedSquareAdj.matmul


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
def test_fused_matmul_quantized_matches_jax(datasets, variant, dtype):
    t, j = _build(datasets, variant, dtype)
    assert t.quant == j.quant == dtype and t.has_diag == j.has_diag
    x = np.random.default_rng(8).normal(size=(t.shape[0], D)).astype(np.float32)
    got = t.matmul(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(j.matmul(jnp.asarray(x))), **TIGHT)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_fused_matmul_gate_and_gradient_match_jax(datasets, dtype):
    t, j = _build(datasets, "self", dtype)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(t.shape[0], D)).astype(np.float32)
    w = rng.normal(size=(t.shape[0], D)).astype(np.float32)
    gate = (rng.random(t.shape[0]) < 0.6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t.matmul(xt, gate=torch.from_numpy(gate))
    (got * torch.from_numpy(w)).sum().backward()
    ref, vjp = jax.vjp(lambda v: j.matmul(v, gate=jnp.asarray(gate)), jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TIGHT)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), **TIGHT)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("variant", ["sym", "gen"])
def test_repeated_matmul_equals_the_chain(datasets, variant, dtype):
    t, _ = _build(datasets, variant, dtype)
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(t.shape[0], D))
                         .astype(np.float32))
    layers = t_prop.fused_chain_t(t, x, 3, True, None)
    h = x
    for want in layers[1:]:
        h = t.matmul(h)
        assert torch.equal(h, want)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_loop_equals_resident_chain_forward_and_backward(datasets, monkeypatch, dtype, reduce):
    """`lightgcn_propagate` through the per-application loop (the route
    a width the chain's kernels decline takes) against the resident
    chain on the same weights: equal values and equal gradients."""
    t, _ = _build(datasets, "sym", dtype)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(t.shape[0], D)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(t.shape[0], D)).astype(np.float32))
    a = torch.from_numpy(x).requires_grad_(True)
    chain = t_base.lightgcn_propagate(t, a, 3, True, reduce)
    (chain * w).sum().backward()
    monkeypatch.setattr(t_chainmm, "supports_chain_resident", lambda *args, **kw: False)
    b = torch.from_numpy(x).requires_grad_(True)
    loop = t_base.lightgcn_propagate(t, b, 3, True, reduce)
    (loop * w).sum().backward()
    assert torch.equal(chain, loop)
    assert torch.equal(a.grad, b.grad)


def test_self_loop_variant_takes_the_loop(datasets):
    """The resident chain has no diagonal term, so the `self` variant
    runs one `matmul` per layer in every quantized mode."""
    t, j = _build(datasets, "self", "int8")
    assert t.has_diag and not t_chainmm.supports_chain_resident(t, D, 2, "mean", None)
    x = np.random.default_rng(12).normal(size=(t.shape[0], D)).astype(np.float32)
    got = t_base.lightgcn_propagate(t, torch.from_numpy(x), 1, True, "mean")
    h1 = np.asarray(j.matmul(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), (x + h1) / 2.0, **TIGHT)


@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("mode", ["int8", "int4", "bf16"])
def test_padded_features_give_the_unpadded_plain_version(mode, d):
    """How K6, K7 and K8 run a width off 32 on the card: the features
    zero-padded to `feature_pad` (d), the results sliced back. Through
    the plain versions: K7's and K8's integer sums equal the unpadded call
    bit for bit; K6's plain version (a float32 product whose order of
    additions may follow the width) within TIGHT, and the padded features
    of every result are the kernels' (no extra column survives)."""
    rng = np.random.default_rng(d)
    m = torch.from_numpy(_counts(rng, (128, 2048), top=7))
    wide = t_fused.feature_pad(d)
    assert wide % 32 == 0 and wide - d < 32
    assert t_fused.kernel_accepts_n(128, 2048, wide, mode)
    assert not t_fused.kernel_accepts_n(128, 2048, d, mode)
    if mode == "bf16":
        zu, zi = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((100, d), (2000, d)))
        fn, args = t_fused.fused_adj_matmul_plain, (m, zu, zi)
    else:
        qu, qi = (torch.from_numpy(_acts(rng, s)) for s in ((128, d), (2048, d)))
        fn = (t_fused.fused_adj_matmul_int8_plain if mode == "int8"
              else t_fused.fused_adj_matmul_int4_plain)
        args = (m if mode == "int8" else t_fused.pack_nibbles(m), qu, qi)
    got = t_fused.padded_features(fn, *args)
    want = fn(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        if mode == "bf16":
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TIGHT)
        else:
            assert torch.equal(g, w)
    if mode == "bf16":  # one side left out, as the rectangular adjacency runs it
        yu, yi = t_fused.padded_features(fn, m, None, zi)
        assert yi is None and yu.shape == (128, d)
        np.testing.assert_allclose(yu.numpy(), fn(m, None, zi)[0].numpy(), **TIGHT)


@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_duals_at_an_off_32_width_are_the_padded_route(quant, d):
    """`quant_fused_dual_t` (the [d, N] route SGL's views take at 3d) and
    `FusedSquareAdj.matmul` at d = 16 and 48: equal bit for bit to the
    same functions run on features zero-padded to `feature_pad` (d), the
    card's route; the forward and the straight-through backward."""
    data = t_dataset.make_synthetic_dataset(150, 300, 2000, 100, seed=3, name="w")
    adj = t_prop.build_adjacency(data, "sym", "fused", compute_dtype=quant, device="cpu")
    assert t_prop.dual_t_route(adj.m8, d, quant) == "n"
    rng = np.random.default_rng(d + 1)
    n = data.num_users + data.num_items
    x, ct = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    wide = t_fused.feature_pad(d)
    xw = np.pad(x, ((0, 0), (0, wide - d)))
    ctw = np.pad(ct, ((0, 0), (0, wide - d)))
    for fn in (adj.matmul,
               lambda z: t_prop.fused_chain_t(adj, z, 1, include_layer0=False, reduce="sum")):
        outs = []
        for a, c in ((x, ct), (xw, ctw)):
            xt = torch.from_numpy(a).requires_grad_(True)
            y = fn(xt)
            (y * torch.from_numpy(c)).sum().backward()
            outs.append((y.detach(), xt.grad))
        (y, g), (yw, gw) = outs
        assert torch.equal(y, yw[:, :d]) and torch.equal(g, gw[:, :d])
