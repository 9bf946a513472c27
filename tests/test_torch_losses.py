"""The port's losses against the JAX package's on the same inputs.

Tolerances: values and gradients within rtol 1e-5 / atol 1e-7 (f32
sums taken in another order); `reg_loss_indexed` equals `reg_loss` on
the gathered rows exactly in value, and its count-based backward meets
autograd's sequential duplicate adds within the same bar."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.ops import losses as t_losses
from idgrec_tpu.ops import losses as j_losses

BAR = dict(rtol=1e-5, atol=1e-7)


def _embs(seed, b=64, d=16, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, d)) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("scale", [0.1, 1.0, 6.0])
def test_bpr_loss_value_and_grads(scale):
    arrs = _embs(0, scale=scale)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = t_losses.bpr_loss(*ts)
    got.backward()
    ref, grads = jax.value_and_grad(j_losses.bpr_loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(got.item(), float(ref), **BAR)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BAR)


def test_bpr_loss_keeps_the_literal_epsilon():
    # a hopeless triple: sigmoid underflows, the loss is -log(1e-7)
    u = torch.full((1, 4), 10.0)
    got = t_losses.bpr_loss(u, -u, u)
    np.testing.assert_allclose(got.item(), -np.log(1e-7), rtol=1e-6)
    assert t_losses._BPR_EPS == j_losses._BPR_EPS == 1e-7


def test_reg_loss_value_and_grads():
    rng = np.random.default_rng(1)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((20, 8), (33, 8), (7, 8))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = t_losses.reg_loss(*ts)
    got.backward()
    ref, grads = jax.value_and_grad(lambda *a: j_losses.reg_loss(*a), argnums=(0, 1, 2))(
        *map(jnp.asarray, arrs))
    np.testing.assert_allclose(got.item(), float(ref), **BAR)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BAR)


@pytest.mark.parametrize("batch", [64, 48])  # a power of two and not
def test_reg_loss_indexed_value_and_grads(batch):
    rng = np.random.default_rng(2)
    ut = rng.normal(size=(30, 8)).astype(np.float32)
    it = rng.normal(size=(25, 8)).astype(np.float32)
    u, p, n = (rng.integers(0, hi, batch) for hi in (30, 25, 25))  # many duplicates

    ut_t = torch.from_numpy(ut).requires_grad_(True)
    it_t = torch.from_numpy(it).requires_grad_(True)
    idx = [torch.from_numpy(a) for a in (u, p, n)]
    got = t_losses.reg_loss_indexed(ut_t, it_t, *idx)
    assert got.item() == t_losses.reg_loss(ut_t[idx[0]], it_t[idx[1]], it_t[idx[2]]).item()
    (3.0 * got).backward()

    jidx = [jnp.asarray(a, jnp.int32) for a in (u, p, n)]
    ref, grads = jax.value_and_grad(
        lambda a, b: 3.0 * j_losses.reg_loss_indexed(a, b, *jidx), argnums=(0, 1))(
        jnp.asarray(ut), jnp.asarray(it))
    np.testing.assert_allclose(3.0 * got.item(), float(ref), **BAR)
    np.testing.assert_allclose(ut_t.grad.numpy(), np.asarray(grads[0]), **BAR)
    np.testing.assert_allclose(it_t.grad.numpy(), np.asarray(grads[1]), **BAR)

    # autograd through the gathers: the sequential duplicate adds
    ua = torch.from_numpy(ut).requires_grad_(True)
    ia = torch.from_numpy(it).requires_grad_(True)
    (3.0 * t_losses.reg_loss(ua[idx[0]], ia[idx[1]], ia[idx[2]])).backward()
    np.testing.assert_allclose(ut_t.grad.numpy(), ua.grad.numpy(), **BAR)
    np.testing.assert_allclose(it_t.grad.numpy(), ia.grad.numpy(), **BAR)


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_infonce_loss_value_and_grads(same, temperature):
    """Both views, or one view against itself (EGCF's InfoNCE(u, u))."""
    a, b, _ = _embs(5, b=32, d=16)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = ta if same else torch.from_numpy(b).requires_grad_(True)
    got = t_losses.infonce_loss(ta, tb, temperature)
    got.backward()
    if same:
        ref, grads = jax.value_and_grad(
            lambda x: j_losses.infonce_loss(x, x, temperature))(jnp.asarray(a))
        pairs = [(ta, grads)]
    else:
        ref, grads = jax.value_and_grad(
            lambda x, y: j_losses.infonce_loss(x, y, temperature), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
        pairs = list(zip((ta, tb), grads))
    np.testing.assert_allclose(got.item(), float(ref), **BAR)
    for t, g in pairs:
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **BAR)
    assert t_losses._INFONCE_EPS == j_losses._INFONCE_EPS == 1e-5


@pytest.mark.parametrize("sizes", [(64, 64), (64,), (48, 64)])  # powers of two and not
def test_reg_loss_counted_value_and_grads(sizes):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(25, 8)).astype(np.float32)
    idxs = [rng.integers(0, 25, s) for s in sizes]  # many duplicates
    tt = torch.from_numpy(table).requires_grad_(True)
    got = t_losses.reg_loss_counted(tt, *(torch.from_numpy(i) for i in idxs))
    assert got.item() == t_losses.reg_loss(*(tt[torch.from_numpy(i)] for i in idxs)).item()
    (3.0 * got).backward()
    ref, grad = jax.value_and_grad(lambda t: 3.0 * j_losses.reg_loss_counted(
        t, *(jnp.asarray(i, jnp.int32) for i in idxs)))(jnp.asarray(table))
    np.testing.assert_allclose(3.0 * got.item(), float(ref), **BAR)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(grad), **BAR)
    if all(s & (s - 1) == 0 for s in sizes):
        np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(grad))
