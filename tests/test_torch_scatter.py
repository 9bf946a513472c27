"""The port's batch row scatter (K4's plain version on the CPU) and the
batch gathers against numpy and the JAX package (Pallas interpreted).

Tolerances: `scatter_add_rows` adds duplicates in batch order, the
order of `np.add.at`: exact equality with numpy, and with the JAX
kernel (same order). Gather values are exact; their gradients are the
same scatter: exact against numpy, rtol 1e-5 / atol 1e-6 against
`jax.grad` of plain indexing (XLA's scatter order is unspecified)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.ops import scatter as t_scatter
from idgrec_tpu.ops import scatter as j_scatter


def _case(seed, batch, n_rows, d, span=None):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, span or n_rows, batch)
    vals = rng.normal(size=(batch, d)).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("batch,n_rows,d,span", [
    (96, 50, 8, None),      # the JAX test's case
    (4096, 300, 16, 7),     # heavy duplicates: ~585 occurrences per row
    (512, 2000, 64, None),  # mostly distinct rows
    (1, 3, 4, None),
])
def test_scatter_add_rows_equals_np_add_at(batch, n_rows, d, span):
    idx, vals = _case(0, batch, n_rows, d, span)
    want = np.zeros((n_rows, d), np.float32)
    np.add.at(want, idx, vals)
    got = t_scatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), n_rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rows, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_add_rows_equals_jax_kernel():
    idx, vals = _case(1, 256, 120, 16, 30)
    ref = np.asarray(j_scatter.scatter_add_rows(jnp.asarray(idx, jnp.int32),
                                                jnp.asarray(vals), 120))
    got = t_scatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), 120)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_scatter_add_rows_empty_batch():
    got = t_scatter.scatter_add_rows(torch.zeros(0, dtype=torch.int64), torch.zeros((0, 8)), 5)
    assert tuple(got.shape) == (5, 8) and not got.any()


@pytest.mark.parametrize("idx,vals,exc", [
    (torch.tensor([0, 9]), torch.zeros((2, 4)), IndexError),
    (torch.tensor([-1, 2]), torch.zeros((2, 4)), IndexError),
    (torch.tensor([0, 1], dtype=torch.int32), torch.zeros((2, 4)), ValueError),
    (torch.tensor([0, 1]), torch.zeros((3, 4)), ValueError),
    (torch.tensor([0, 1]), torch.zeros((2, 4), dtype=torch.float64), ValueError),
])
def test_scatter_add_rows_validates(idx, vals, exc):
    with pytest.raises(exc):
        t_scatter.scatter_add_rows(idx, vals, 9)


def test_step_route_equals_np_add_at_and_jax_kernel():
    """The gathers' backward route (no range check on the card; on the
    CPU the plain version) on a duplicate-heavy batch, positives then
    negatives as the item table's backward concatenates them: equal to
    np.add.at and to the JAX kernel, and to the public wrapper."""
    rng = np.random.default_rng(3)
    p, n = rng.integers(0, 40, 300), rng.integers(0, 40, 300)
    gp, gn = (rng.normal(size=(300, 16)).astype(np.float32) for _ in range(2))
    idx, vals = np.concatenate([p, n]), np.concatenate([gp, gn])
    got = t_scatter.scatter_add_rows_unchecked(torch.from_numpy(idx), torch.from_numpy(vals), 50)
    want = np.zeros((50, 16), np.float32)
    np.add.at(want, idx, vals)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(j_scatter.scatter_add_rows(jnp.asarray(idx, jnp.int32), jnp.asarray(vals),
                                                50))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), t_scatter.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(vals), 50))


def test_public_wrapper_keeps_its_index_error():
    vals = torch.zeros((3, 4))
    with pytest.raises(IndexError):
        t_scatter.scatter_add_rows(torch.tensor([0, 5, 2]), vals, 5)
    assert t_scatter.scratch_size(38048, 4096) == 4 * 4096 + 4 + 2 * 38048
    assert t_scatter.scratch_size(7, 3) == 4 * 4 + 4 + 2 * 7


def _gather_inputs():
    rng = np.random.default_rng(2)
    ua = rng.normal(size=(40, 8)).astype(np.float32)
    ia = rng.normal(size=(60, 8)).astype(np.float32)
    u, p, n = rng.integers(0, 40, 32), rng.integers(0, 60, 32), rng.integers(0, 60, 32)
    return ua, ia, u, p, n


def test_gather_batch_embeddings_values_and_grads():
    ua, ia, u, p, n = _gather_inputs()
    ua_t = torch.from_numpy(ua).requires_grad_(True)
    ia_t = torch.from_numpy(ia).requires_grad_(True)
    ut, pt, nt = (torch.from_numpy(a) for a in (u, p, n))
    ue, pe, ne = t_scatter.gather_batch_embeddings(ua_t, ia_t, ut, pt, nt)
    np.testing.assert_array_equal(ue.detach().numpy(), ua[u])
    np.testing.assert_array_equal(pe.detach().numpy(), ia[p])
    np.testing.assert_array_equal(ne.detach().numpy(), ia[n])
    (torch.sum(ue * pe) - torch.sum(ue * ne)).backward()

    # numpy: the cotangent rows scattered in batch order
    du = np.zeros_like(ua)
    np.add.at(du, u, ia[p] - ia[n])
    di = np.zeros_like(ia)
    np.add.at(di, np.concatenate([p, n]), np.concatenate([ua[u], -ua[u]]))
    np.testing.assert_array_equal(ua_t.grad.numpy(), du)
    np.testing.assert_array_equal(ia_t.grad.numpy(), di)

    def j_loss(ua_, ia_):
        ue_, pe_, ne_ = j_scatter.gather_batch_embeddings(
            ua_, ia_, *(jnp.asarray(a, jnp.int32) for a in (u, p, n)))
        return jnp.sum(ue_ * pe_) - jnp.sum(ue_ * ne_)

    ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(ua), jnp.asarray(ia))
    np.testing.assert_allclose(ua_t.grad.numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ia_t.grad.numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-6)


def test_gather_user_pos_values_and_grads():
    ua, ia, u, p, _ = _gather_inputs()
    ua_t = torch.from_numpy(ua).requires_grad_(True)
    ia_t = torch.from_numpy(ia).requires_grad_(True)
    ue, pe = t_scatter.gather_user_pos(ua_t, ia_t, torch.from_numpy(u), torch.from_numpy(p))
    np.testing.assert_array_equal(ue.detach().numpy(), ua[u])
    torch.sum(ue * pe).backward()
    du, di = np.zeros_like(ua), np.zeros_like(ia)
    np.add.at(du, u, ia[p])
    np.add.at(di, p, ua[u])
    np.testing.assert_array_equal(ua_t.grad.numpy(), du)
    np.testing.assert_array_equal(ia_t.grad.numpy(), di)


def test_supports_gate():
    assert t_scatter.supports_fast_scatter(70_000, 64)
    assert t_scatter.supports_fast_scatter(70_000, 64, "int4")
    assert not t_scatter.supports_fast_scatter(70_000, 64, "bfloat16")
    assert not t_scatter.supports_fast_scatter(70_000, 64, "float32")
