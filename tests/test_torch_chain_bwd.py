"""The port's straight-through backward chain against the JAX package's
on the same inputs (JAX Pallas kernels interpreted on the CPU), and
against autograd through the port's own per-sweep chain.

Tolerances, the bars of tests/test_chainmm.py:
* one sweep shares the quantization of the cotangent bit for bit, so
  only f32 epilogue ulps separate the paths: TIGHT;
* deeper chains cross int8 round()s, where an ulp-perturbed value on a
  rounding tie moves one quantized cotangent by 1 lsb: NOISE, plus a
  relative L2 error below 1e-2;
* the port's two routes (the resident backward chain and autograd
  through `fused_chain_t`) run the same operations in the same order:
  exact equality."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import propagate as j_prop

TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
D = 16
_SHAPE = (300, 500, 4000, 800)


@pytest.fixture(scope="module")
def adjs():
    t = t_prop.build_adjacency(t_dataset.make_synthetic_dataset(*_SHAPE, seed=5), "sym", "auto",
                               compute_dtype="int8", emb_size=D, device="cpu")
    j = j_prop.build_adjacency(j_dataset.make_synthetic_dataset(*_SHAPE, seed=5), "sym", "auto",
                               compute_dtype="int8", emb_size=D)
    return t, j


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    w = rng.normal(size=(n, D)).astype(np.float32)  # the cotangent of a linear loss
    return x, w


def _torch_grad(fn, adj, x, w, layers, include_layer0, reduce):
    xt = torch.from_numpy(x).requires_grad_(True)
    (fn(adj, xt, layers, include_layer0, reduce) * torch.from_numpy(w)).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("layers", [1, 3])
def test_chain_gradient_matches_jax(adjs, layers, reduce, include_layer0):
    t, j = adjs
    x, w = _inputs(t.shape[0], seed=layers)
    ref = np.asarray(jax.grad(lambda e: jnp.sum(
        j_chainmm.fused_chain_resident(j, e, layers, include_layer0, reduce) * w))(jnp.asarray(x)))
    got = _torch_grad(t_chainmm.fused_chain_resident, t, x, w, layers, include_layer0, reduce)
    np.testing.assert_allclose(got, ref, **(TIGHT if layers == 1 else NOISE))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2
    # the second, independent gradient: autograd through the per-sweep chain
    per_sweep = _torch_grad(t_prop.fused_chain_t, t, x, w, layers, include_layer0, reduce)
    np.testing.assert_array_equal(got, per_sweep)


def test_gradient_of_a_sparse_batch_cotangent(adjs):
    """A training batch's cotangent: a few non-zero rows at 1/B scale.
    Features whose amax is 0 take scale 1 on both sides."""
    t, j = adjs
    rng = np.random.default_rng(8)
    x = rng.normal(size=(t.shape[0], D)).astype(np.float32)
    w = np.zeros_like(x)
    rows = rng.choice(t.shape[0], 40, replace=False)
    w[rows] = rng.normal(size=(40, D)).astype(np.float32) / 2048
    w[:, 3] = 0.0
    ref = np.asarray(jax.grad(lambda e: jnp.sum(
        j_chainmm.fused_chain_resident(j, e, 3, True, "mean") * w))(jnp.asarray(x)))
    got = _torch_grad(t_chainmm.fused_chain_resident, t, x, w, 3, True, "mean")
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got / scale, ref / scale, **NOISE)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2
    assert not got[:, 3].any() and not ref[:, 3].any()


def test_backward_is_straight_through(adjs):
    """The backward needs nothing of the forward: the gradient of a
    linear loss does not depend on where it is taken."""
    t, _ = adjs
    x, w = _inputs(t.shape[0], seed=11)
    a = _torch_grad(t_chainmm.fused_chain_resident, t, x, w, 3, True, "mean")
    b = _torch_grad(t_chainmm.fused_chain_resident, t, x * 5 + 1, w, 3, True, "mean")
    np.testing.assert_array_equal(a, b)


def test_kernel_and_plain_chain_share_the_gradient_on_cpu(adjs):
    t, _ = adjs
    x, w = _inputs(t.shape[0], seed=12)
    a = _torch_grad(t_chainmm.fused_chain_resident, t, x, w, 3, False, "sum")
    b = _torch_grad(t_chainmm.fused_chain_resident_plain, t, x, w, 3, False, "sum")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("want_next", [True, False])
def test_inject_epilogue_plain(inject, want_next):
    rng = np.random.default_rng(13)
    y, g = (torch.from_numpy(rng.normal(size=(4, 12)).astype(np.float32)) for _ in range(2))
    s = torch.from_numpy(rng.random(4).astype(np.float32))
    post, pre = (torch.from_numpy(rng.random(12).astype(np.float32)) for _ in range(2))
    g0 = g.clone()
    out, amax = t_chainmm.chain_sweep_inject(y, s, post, pre, g, inject, want_next)
    store = post[None, :] * (y * s[:, None])
    if inject:
        store = g0 + store
    want = pre[None, :] * store if want_next else store
    assert torch.equal(out, want) and torch.equal(g, g0)
    if want_next:
        assert torch.equal(amax, want.abs().amax(dim=1))
    else:
        assert amax is None


def test_quant_fused_dual_t_straight_through(adjs):
    """The dual's backward is the same function on the swapped
    cotangents, as the JAX custom VJP: bit-equal inputs give TIGHT."""
    t, j = adjs
    rng = np.random.default_rng(14)
    u_pad, i_pad = t.padded_shape
    zi = rng.normal(size=(D, i_pad)).astype(np.float32)
    zu = rng.normal(size=(D, u_pad)).astype(np.float32)
    wu = rng.normal(size=(D, u_pad)).astype(np.float32)
    wi = rng.normal(size=(D, i_pad)).astype(np.float32)

    def j_loss(zi_, zu_):
        yu, yi = j_prop.quant_fused_dual_t(j.m8, zi_, zu_, "int8", True)
        return jnp.sum(yu * wu) + jnp.sum(yi * wi)

    ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(zi), jnp.asarray(zu))
    zi_t = torch.from_numpy(zi).requires_grad_(True)
    zu_t = torch.from_numpy(zu).requires_grad_(True)
    yu, yi = t_prop.quant_fused_dual_t(t.m8, zi_t, zu_t)
    ((yu * torch.from_numpy(wu)).sum() + (yi * torch.from_numpy(wi)).sum()).backward()
    np.testing.assert_allclose(zi_t.grad.numpy(), np.asarray(ref[0]), **TIGHT)
    np.testing.assert_allclose(zu_t.grad.numpy(), np.asarray(ref[1]), **TIGHT)
