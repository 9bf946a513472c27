"""The tanh chain's sweeps, `chainmm.dual_sweep_tanh` (forward) and
`dual_sweep_tanh_inject` (the straight-through backward), instances of
`chainmm.DualSweep`: on the card the dual kernel (K1, or K5 on the
nibble-packed matrix) with K9's or K10's epilogue in its turn-out; on
the CPU their plain versions, the plain dual followed by K9's or K10's
plain version on each side that runs. EGCF's seed sweeps run one side alone or want one side's next
input alone.

Bars:
* a sweep against the separate plain calls (the dual, then K9 or K10 on
  each side), int8 and int4, every combine mode, with and without a
  next input, injecting or not, and the seed sweeps' per-side cases:
  exact equality (z or the store, the combine, the h slice, amax); a
  side left out writes nothing;
* the tanh chain with and without the seed sweep, forward (combine and
  h streams) and backward, against the chain as it ran before its
  epilogues moved into the dual (the plain dual, then one K9 or K10
  call per side, the seed's bookkeeping in the loop): exact, int8 and
  int4;
* the chain against the JAX chain (Pallas kernels interpreted on the
  CPU), the bars of tests/test_torch_egcf.py: three layers at NOISE
  (rtol 2e-2, atol 1e-2 of the largest entry) plus a relative L2 error
  below 1e-2, since an ulp on a rounding tie moves one quantized
  activation by 1 lsb; gradients at NOISE. One counted layer after the
  seed sweep: the user side within 5 ulps of the reference (the bar of
  tests/test_torch_egcf.py, XLA:CPU's tanh against PyTorch's, whose
  arguments are equal here), the item side within TANH_ULPS = 6. The
  sixth ulp is traced: the seed sweep's tanh differs between XLA:CPU
  and PyTorch by an ulp or more in many of its outputs, which moves the
  amax of the users' next input, and so the item side's dequantization
  scale amax / 127, by one ulp in some features; the item side's tanh
  argument then differs by an ulp, and XLA's tanh of it lies up to 6
  ulps from PyTorch's (the port's own chain equals its per-sweep route
  bit for bit, above);
* the chain against the JAX per-sweep route with PyTorch's tanh in
  place of XLA's: exact, so the tanh is all that separates them."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import fusedmm as t_fusedmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import propagate as j_prop

torch.set_num_threads(1)

TANH_ULPS = 6
NOISE = dict(rtol=2e-2, atol=1e-2)
D = 8
_SHAPE = (300, 500, 4000, 800)
_COMBINES = (t_chainmm.COMBINE_NONE, t_chainmm.COMBINE_SET, t_chainmm.COMBINE_ADD)
_PLAIN_DUAL = {"int8": t_fusedmm.fused_adj_matmul_int8_t_plain,
               "int4": t_fusedmm.fused_adj_matmul_int4_t_plain}


def _sweep_inputs(seed, u_pad=128, i_pad=4096):
    """One sweep's operands from a seed: the stored counts of int8 and
    int4, the quantized inputs and scales (K3's plain version), (user,
    item) post and pre vectors zero past the real nodes, [d, N]
    combines or cotangents, and tanh outputs for the backward's h."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((u_pad, i_pad)) < 0.03, rng.integers(1, 8, (u_pad, i_pad)), 0)
    m8 = torch.from_numpy(m.astype(np.int8))
    qs = []
    for n in (u_pad, i_pad):
        z = torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32))
        qs.append(t_prop.quantize_rows_plain(z, z.abs().amax(dim=1)))
    (qu, su), (qi, si) = qs
    post, pre, ext, h = [], [], [], []
    for n, real in ((u_pad, u_pad - 7), (i_pad, i_pad - 300)):
        vec = rng.random((2, n)).astype(np.float32)
        vec[:, real:] = 0.0
        post.append(torch.from_numpy(vec[0]))
        pre.append(torch.from_numpy(vec[1]))
        ext.append(torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32) * 1e-2))
        h.append(torch.tanh(torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32))))
    stored = {"int8": m8, "int4": t_fusedmm.pack_nibbles(m8)}
    return stored, qu, su, qi, si, tuple(post), tuple(pre), tuple(ext), tuple(h)


def _equal(a, b):
    return (a is None and b is None) or torch.equal(a, b)


def _nan_like(ts):
    return [torch.full_like(t, float("nan")) for t in ts]


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("combine", _COMBINES)
@pytest.mark.parametrize("want_next", [True, False])
def test_tanh_sweep_equals_separate_plain_calls(quant, combine, want_next):
    stored, qu, su, qi, si, post, pre, c0, _ = _sweep_inputs(1)
    m = stored[quant]
    c_got, c_want, c_int8 = ([t.clone() for t in c0] for _ in range(3))
    hs_got, hs_want, hs_int8 = (_nan_like(c0) for _ in range(3))
    before = (t_chainmm.dual_sweep_tanh.launches, t_chainmm.chain_sweep_tanh.launches)
    got = t_chainmm.dual_sweep_tanh(quant, m, qu, su, qi, si, post, pre, c_got, combine,
                                    want_next, hs_got)
    # the CPU takes the plain version: no kernel is counted
    assert (t_chainmm.dual_sweep_tanh.launches, t_chainmm.chain_sweep_tanh.launches) == before
    yu, yi = _PLAIN_DUAL[quant](m, qu, qi)
    want = (*t_chainmm.chain_sweep_tanh_plain(yu, si[:, 0], post[0], pre[0], c_want[0],
                                              hs_want[0], combine, want_next),
            *t_chainmm.chain_sweep_tanh_plain(yi, su[:, 0], post[1], pre[1], c_want[1],
                                              hs_want[1], combine, want_next))
    int8 = t_chainmm.dual_sweep_tanh.plain("int8", stored["int8"], qu, su, qi, si, post, pre,
                                           c_int8, combine, want_next, hs_int8)
    assert all(_equal(a, b) and _equal(a, c) for a, b, c in zip(got, want, int8))
    for a, b, c in zip(c_got + hs_got, c_want + hs_want, c_int8 + hs_int8):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(hs_got[0], torch.tanh(post[0][None, :] * (yu * si)))
    if combine == t_chainmm.COMBINE_NONE:
        assert all(torch.equal(a, b) for a, b in zip(c_got, c0))
    assert (got[1] is None) == (not want_next) and (got[3] is None) == (not want_next)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tanh_seed_sweep_runs_the_users_alone(quant):
    """The forward's seed sweep: the user side as the separate call
    computes it, the item side neither read nor written."""
    stored, qu, su, qi, si, post, pre, c0, _ = _sweep_inputs(2)
    c, hs = [t.clone() for t in c0], _nan_like(c0)
    got = t_chainmm.dual_sweep_tanh(quant, stored[quant], qu, su, qi, si, post, pre, c,
                                    t_chainmm.COMBINE_NONE, True, hs, (True, False))
    c_want, hs_want = c0[0].clone(), torch.full_like(c0[0], float("nan"))
    yu, _ = _PLAIN_DUAL[quant](stored[quant], qu, qi)
    want = t_chainmm.chain_sweep_tanh_plain(yu, si[:, 0], post[0], pre[0], c_want, hs_want,
                                            t_chainmm.COMBINE_NONE, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] is None and got[3] is None
    assert torch.equal(hs[0], hs_want) and torch.equal(c[0], c0[0])
    assert bool(hs[1].isnan().all()) and torch.equal(c[1], c0[1])


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("inject,want_next", [(True, True), (True, False), (False, True),
                                              (False, False)])
def test_tanh_sweep_inject_equals_separate_plain_calls(quant, inject, want_next):
    stored, qu, su, qi, si, post, pre, g0, h = _sweep_inputs(3)
    m = stored[quant]
    g = tuple(t.clone() for t in g0)
    h_arg = h if want_next else (None, None)
    before = (t_chainmm.dual_sweep_tanh_inject.launches,
              t_chainmm.chain_sweep_tanh_inject.launches)
    got = t_chainmm.dual_sweep_tanh_inject(quant, m, qu, su, qi, si, post, pre, g, inject,
                                           want_next, h_arg)
    assert (t_chainmm.dual_sweep_tanh_inject.launches,
            t_chainmm.chain_sweep_tanh_inject.launches) == before
    yu, yi = _PLAIN_DUAL[quant](m, qu, qi)
    want = (*t_chainmm.chain_sweep_tanh_inject_plain(yu, si[:, 0], post[0], pre[0], g[0],
                                                     h_arg[0], inject, want_next),
            *t_chainmm.chain_sweep_tanh_inject_plain(yi, su[:, 0], post[1], pre[1], g[1],
                                                     h_arg[1], inject, want_next))
    int8 = t_chainmm.dual_sweep_tanh_inject.plain("int8", stored["int8"], qu, su, qi, si, post,
                                                  pre, g, inject, want_next, h_arg)
    assert all(_equal(a, b) and _equal(a, c) for a, b, c in zip(got, want, int8))
    assert all(torch.equal(a, b) for a, b in zip(g, g0))  # read only
    assert (got[1] is None) == (not want_next)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["users_next_alone", "items_alone"])
def test_tanh_seed_backward_sweeps_per_side(quant, case):
    """The backward's seed sweeps: sweep K − 1 wants the users' next
    input alone (no inject; the items' store is G₀), sweep K runs the
    item side alone (inject G₀, no next input)."""
    stored, qu, su, qi, si, post, pre, g, h = _sweep_inputs(4)
    yu, yi = _PLAIN_DUAL[quant](stored[quant], qu, qi)
    if case == "users_next_alone":
        got = t_chainmm.dual_sweep_tanh_inject(quant, stored[quant], qu, su, qi, si, post, pre,
                                               g, False, (True, False), (h[0], None))
        want = (*t_chainmm.chain_sweep_tanh_inject_plain(yu, si[:, 0], post[0], pre[0], g[0],
                                                         h[0], False, True),
                *t_chainmm.chain_sweep_tanh_inject_plain(yi, su[:, 0], post[1], pre[1], g[1],
                                                         None, False, False))
        assert want[3] is None
    else:
        got = t_chainmm.dual_sweep_tanh_inject(quant, stored[quant], qu, su, qi, si, post, pre,
                                               (None, g[1]), True, False, (None, None),
                                               (False, True))
        want = (None, None, *t_chainmm.chain_sweep_tanh_inject_plain(
            yi, su[:, 0], post[1], pre[1], g[1], None, True, False))
    assert all(_equal(a, b) for a, b in zip(got, want))


def _per_sweep_forward(adj, xu, xi, layers, seed):
    """The tanh chain's forward as it ran before its epilogue moved into
    the dual: the plain dual, then one K9 call per side (the seed sweep:
    the user side alone)."""
    u_pad, i_pad = adj.padded_shape
    ru, ri, lu, li = t_chainmm._vectors(adj, u_pad, i_pad)
    first = 1 if seed else 0
    n_sweeps = layers + first
    hs_u = torch.full((n_sweeps, D, u_pad), float("nan"))
    hs_i = torch.full((n_sweeps, D, i_pad), float("nan"))
    cu, ci = torch.zeros_like(xu), torch.zeros_like(xi)
    ones_d = torch.ones(D)
    zi, amax_i = t_chainmm.chain_sweep_epilogue_plain(xi, ones_d, torch.ones(i_pad), ri, ci,
                                                      t_chainmm.COMBINE_NONE, True)
    if seed:
        qu, su = torch.zeros((D, u_pad), dtype=torch.int8), torch.ones((D, 1))
    else:
        zu, amax_u = t_chainmm.chain_sweep_epilogue_plain(xu, ones_d, torch.ones(u_pad), ru, cu,
                                                          t_chainmm.COMBINE_NONE, True)
    for k in range(n_sweeps):
        if not (seed and k == 0):
            qu, su = t_prop.quantize_rows_plain(zu, amax_u)
        if not (seed and k == 1):
            qi, si = t_prop.quantize_rows_plain(zi, amax_i)
        yu, yi = _PLAIN_DUAL[adj.quant](adj.m8, qu, qi)
        combine = _COMBINES[(k >= first) + (k > first)]
        more = k < n_sweeps - 1
        zu, amax_u = t_chainmm.chain_sweep_tanh_plain(yu, si[:, 0], lu, ru, cu, hs_u[k], combine,
                                                      more)
        if not (seed and k == 0):
            zi, amax_i = t_chainmm.chain_sweep_tanh_plain(yi, su[:, 0], li, ri, ci, hs_i[k],
                                                          combine, more)
    return cu, ci, hs_u, hs_i


def _per_sweep_backward(adj, gu, gi, hs_u, hs_i, layers, seed):
    """The tanh chain's backward as it ran before: the plain dual, then
    one K10 call per side, the seed's sweeps spelled out."""
    u_pad, i_pad = adj.padded_shape
    ru, ri, lu, li = t_chainmm._vectors(adj, u_pad, i_pad)
    n_sweeps = layers + (1 if seed else 0)
    last = n_sweeps - 1
    ones_d = torch.ones(D)
    tanh_inject = t_chainmm.chain_sweep_tanh_inject_plain
    zu, amax_u = tanh_inject(gu, ones_d, torch.ones(u_pad), lu, gu, hs_u[last], False, True)
    zi, amax_i = tanh_inject(gi, ones_d, torch.ones(i_pad), li, gi, hs_i[last], False, True)
    for k in range(n_sweeps):
        qu, su = t_prop.quantize_rows_plain(zu, amax_u)
        if seed and k == last:
            qi, si = torch.zeros((D, i_pad), dtype=torch.int8), torch.ones((D, 1))
        else:
            qi, si = t_prop.quantize_rows_plain(zi, amax_i)
        yu, yi = _PLAIN_DUAL[adj.quant](adj.m8, qu, qi)
        if not seed:
            more = k < last
            hidx = layers - 2 - k
            zu, amax_u = tanh_inject(yu, si[:, 0], ru, lu, gu, hs_u[hidx] if more else None,
                                     more, more)
            zi, amax_i = tanh_inject(yi, su[:, 0], ri, li, gi, hs_i[hidx] if more else None,
                                     more, more)
        elif k < layers - 1:
            hidx = layers - 1 - k
            zu, amax_u = tanh_inject(yu, si[:, 0], ru, lu, gu, hs_u[hidx], True, True)
            zi, amax_i = tanh_inject(yi, su[:, 0], ri, li, gi, hs_i[hidx], True, True)
        elif k == layers - 1:
            zu, amax_u = tanh_inject(yu, si[:, 0], ru, lu, gu, hs_u[0], False, True)
            g0_i, _ = tanh_inject(yi, su[:, 0], ri, li, gi, None, False, False)
        else:
            zi, _ = tanh_inject(yi, su[:, 0], ri, li, g0_i, None, True, False)
            zu = torch.zeros_like(gu)
    return zu, zi


@pytest.fixture(scope="module")
def adjs():
    tdata = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    jdata = j_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    return {quant: (t_prop.build_adjacency(tdata, "sym", "fused", compute_dtype=quant,
                                           emb_size=D, device="cpu"),
                    j_prop.build_adjacency(jdata, "sym", "fused", compute_dtype=quant,
                                           emb_size=D))
            for quant in ("int8", "int4")}


@pytest.mark.parametrize("quant,seed,layers", [
    ("int8", True, 3), ("int8", False, 3), ("int8", True, 1), ("int4", True, 3),
    ("int4", False, 2),
])
def test_tanh_chain_equals_the_separate_sweeps(adjs, quant, seed, layers):
    t, _ = adjs[quant]
    u_pad, i_pad = t.padded_shape
    rng = np.random.default_rng(layers + 2 * seed)
    xu = torch.zeros((D, u_pad)) if seed else torch.from_numpy(
        rng.normal(size=(D, u_pad)).astype(np.float32))
    xi = torch.from_numpy(rng.normal(size=(D, i_pad)).astype(np.float32))
    got = t_chainmm._run_chain_act(t, xu, xi, layers, seed, t_chainmm.KERNELS)
    want = _per_sweep_forward(t, xu, xi, layers, seed)
    first = 1 if seed else 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3][first:], want[3][first:])
    gu, gi = (torch.from_numpy(rng.normal(size=(D, n)).astype(np.float32) * 1e-2)
              for n in (u_pad, i_pad))
    g_got = t_chainmm._run_chain_act_bwd(t, gu, gi, got[2], got[3], layers, seed,
                                         t_chainmm.KERNELS)
    g_want = _per_sweep_backward(t, gu, gi, want[2], want[3], layers, seed)
    assert torch.equal(g_got[0], g_want[0]) and torch.equal(g_got[1], g_want[1])
    assert bool(g_got[1].abs().sum() > 0)
    if seed:
        assert not bool(g_got[0].any())


def _within_ulps(got, ref, ulps=TANH_ULPS):
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= ulps * np.spacing(np.abs(ref).astype(np.float32))).all(), float(err.max())


def _noise(got, ref):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, **NOISE)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


@pytest.mark.parametrize("quant,seed,layers", [("int8", True, 1), ("int4", True, 3),
                                               ("int8", True, 3)])
def test_tanh_chain_and_gradient_meet_jax(adjs, quant, seed, layers):
    t, j = adjs[quant]
    rng = np.random.default_rng(7 + layers)
    x, w = (rng.normal(size=(t.shape[0], D)).astype(np.float32) for _ in range(2))
    if seed:
        x[: t.num_users] = 0.0  # EGCF's x0 = [0; E_i]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_chainmm.fused_chain_resident(t, xt, layers, False, "sum", torch.tanh, seed)
    (out * torch.from_numpy(w)).sum().backward()
    xj = jnp.asarray(x)
    ref = np.asarray(j_chainmm.fused_chain_resident(j, xj, layers, False, "sum", jnp.tanh, seed))
    ref_grad = np.asarray(jax.grad(lambda e: jnp.sum(j_chainmm.fused_chain_resident(
        j, e, layers, False, "sum", jnp.tanh, seed) * w))(xj))
    if layers == 1:
        nu = t.num_users
        _within_ulps(out.detach().numpy()[:nu], ref[:nu], 5)
        _within_ulps(out.detach().numpy()[nu:], ref[nu:])
    else:
        _noise(out.detach().numpy(), ref)
    _noise(xt.grad.numpy(), ref_grad)


def _torch_tanh(a):
    return jnp.asarray(torch.tanh(torch.from_numpy(np.array(a))).numpy())


@pytest.mark.parametrize("quant,seed,layers", [("int8", True, 1), ("int8", True, 3),
                                               ("int4", True, 3), ("int8", False, 2)])
def test_tanh_chain_equals_jax_route_with_torch_tanh(adjs, quant, seed, layers):
    """What separates the port's tanh chain from JAX's is the tanh
    alone: the JAX per-sweep route (idgrec_tpu/ops/propagate.py
    `fused_chain_t`) with PyTorch's tanh in place of XLA's equals the
    port's chain bit for bit, the seed sweep and the quantization scales
    included; with XLA's tanh it does not."""
    t, j = adjs[quant]
    rng = np.random.default_rng(7 + layers)
    x = rng.normal(size=(t.shape[0], D)).astype(np.float32)
    if seed:
        x[: t.num_users] = 0.0
    out = t_chainmm.fused_chain_resident(t, torch.from_numpy(x), layers, False, "sum",
                                         torch.tanh, seed).numpy()
    xj = jnp.asarray(x)
    ref = np.asarray(j_prop.fused_chain_t(j, xj, layers, False, "sum", _torch_tanh, seed))
    assert np.array_equal(out, ref)
    ref_xla = np.asarray(j_prop.fused_chain_t(j, xj, layers, False, "sum", jnp.tanh, seed))
    assert not np.array_equal(out, ref_xla)
