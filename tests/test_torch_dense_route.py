"""The dense backend's route through kernels K6 (bfloat16) and K7 (int8):
`DenseSquareAdj.matmul` on the CPU, where each kernel's wrapper runs its
plain version, against the products the dense backend ran before it
took the kernels (`exact_dual_matmul`, `quant_dual_matmul`, both on
`fusedmm.dual_matmul_f32`), the rule that chooses the route
(`DenseSquareAdj.runs_kernel`), the matrix's padding and the budget
that counts it.

Tolerance: none. K6's plain version multiplies the same bfloat16-rounded
operands in float32 by the same row blocks as `exact_dual_matmul`, and
K7's plain version sums the same integers exactly (float64, rounded
once) where `quant_dual_matmul` sums them exactly in float32 (every sum
below 2**24), so forward and backward are equal bit for bit, also to
the products over the matrix padded as before (columns to 128).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import base as t_base
from idgrec_torch.ops import fusedmm
from idgrec_torch.ops import propagate as t_prop

torch.set_num_threads(1)

# 300 items pad to 384 columns at 128 and to 512 at 256: the padding moves
_SHAPE = (300, 300, 4000, 400)
_GEN = dict(alpha=0.6, beta=0.3)


@pytest.fixture(scope="module")
def data():
    return t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)


def _adj(data, dtype, variant="sym", **kw):
    kw = {**(_GEN if variant == "gen" else {}), **kw}
    return t_prop.build_adjacency(data, variant, "dense", compute_dtype=dtype, device="cpu", **kw)


def _old_route(adj, m, x, gate=None):
    """`DenseSquareAdj.matmul` as the dense backend ran it before K6 and
    K7: both directions through `exact_dual_matmul` / `quant_dual_matmul`
    on activations padded to ``m``'s shape."""
    nu, ni = adj.num_users, adj.num_items
    right_u, right_i, left_u, left_i = t_prop._gated(adj, gate)
    u_pad, i_pad = m.shape
    zi = t_prop._pad_rows(right_i[:, None] * x[nu:].to(torch.float32), i_pad)
    zu = t_prop._pad_rows(right_u[:, None] * x[:nu].to(torch.float32), u_pad)
    if adj.quant == "int8":
        yu, yi = t_prop.quant_dual_matmul(m, zi, zu)
    else:
        yu, yi = t_prop.exact_dual_matmul(m, zi, zu, t_prop._DTYPES[adj.compute_dtype_name])
    return t_prop._finish(adj, x, left_u[:, None] * yu[:nu], left_i[:, None] * yi[:ni])


def _value_and_grad(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("variant", ["sym", "self", "gen"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kernel_route_equals_the_old_route_bit_for_bit(data, dtype, variant, gated):
    adj = _adj(data, dtype, variant)
    d = 32
    assert adj.runs_kernel(d)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(adj.shape[0], d)).astype(np.float32)
    w = rng.normal(size=(adj.shape[0], d)).astype(np.float32)
    gate = (torch.from_numpy((rng.random(adj.shape[0]) < 0.7).astype(np.float32))
            if gated else None)
    old_m = t_prop._count_matrix_int8(data, torch.device("cpu"))
    assert old_m.shape[1] < adj.m.shape[1]
    got = _value_and_grad(lambda v: adj.matmul(v, gate), x, w)
    for m in (adj.m, old_m):
        want = _value_and_grad(lambda v: _old_route(adj, m, v, gate), x, w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_routes_call_the_kernels(data, monkeypatch):
    """bfloat16 goes through K6's wrapper, int8 through K7's, float32 and
    a width the kernels decline through neither."""
    calls = []
    for name in ("fused_adj_matmul", "fused_adj_matmul_int8"):
        real = getattr(fusedmm, name)

        def spy(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(fusedmm, name, spy)
    x = torch.ones(data.num_users + data.num_items, 32)
    expect = {"bfloat16": ["fused_adj_matmul"], "int8": ["fused_adj_matmul_int8"],
              "float32": []}
    for dtype, want in expect.items():
        calls.clear()
        _adj(data, dtype).matmul(x)
        assert calls == want, dtype
    calls.clear()
    _adj(data, "bfloat16").matmul(torch.ones(data.num_users + data.num_items, 24))
    assert calls == []


@pytest.mark.parametrize("d,expect", [(8, False), (16, False), (24, False), (32, True),
                                      (48, False), (64, True), (96, True), (128, True),
                                      (2048, True)])
@pytest.mark.parametrize("shape", [(300, 300), (1, 1), (1000, 1100), (129, 257), (4097, 38_048)])
def test_runs_kernel_is_d_mod_32_at_every_padded_shape(shape, d, expect):
    nu, ni = shape
    data = t_dataset.make_synthetic_dataset(nu, ni, min(nu * ni // 2, 3 * (nu + ni)), 1, seed=2)
    for dtype in ("bfloat16", "int8"):
        adj = _adj(data, dtype)
        u_pad, i_pad = adj.m.shape
        assert u_pad % 128 == 0 and i_pad % t_prop.DENSE_COL_PAD == 0
        assert u_pad - nu < 128 and i_pad - ni < t_prop.DENSE_COL_PAD
        assert adj.runs_kernel(d) == expect == (d % 32 == 0)
        mode = "int8" if dtype == "int8" else "bf16"
        assert adj.runs_kernel(d) == fusedmm.kernel_accepts_n(u_pad, i_pad, d, mode)
    assert not _adj(data, "float32").runs_kernel(d)


def test_float32_runs_dual_matmul_f32(data, monkeypatch):
    adj = _adj(data, "float32")
    seen = []
    real = fusedmm.dual_matmul_f32

    def spy(m8, zu, zi):
        seen.append((m8.shape, zu.dtype, zi.dtype))
        return real(m8, zu, zi)

    monkeypatch.setattr(fusedmm, "dual_matmul_f32", spy)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(adj.shape[0], 32))
                         .astype(np.float32))
    y = adj.matmul(x)
    assert seen == [(adj.m.shape, torch.float32, torch.float32)]
    m = adj.m.to(torch.float64)
    nu = adj.num_users
    zu = adj.right_u[:, None].double() * x[:nu].double()
    zi = adj.right_i[:, None].double() * x[nu:].double()
    want_u = adj.left_u[:, None].double() * (m[:nu, : adj.num_items] @ zi)
    want_i = adj.left_i[:, None].double() * (m[:nu, : adj.num_items].T @ zu)
    np.testing.assert_allclose(y.numpy(), torch.cat([want_u, want_i]).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dense_budget_counts_the_padded_columns(data, monkeypatch):
    m = _adj(data, "bfloat16").m
    monkeypatch.setattr(t_prop, "dense_budget", lambda device: m.numel())
    assert isinstance(t_prop.build_adjacency(data, device="cpu"), t_prop.DenseSquareAdj)
    monkeypatch.setattr(t_prop, "dense_budget", lambda device: m.numel() - 1)
    assert isinstance(t_prop.build_adjacency(data, device="cpu"), t_prop.GatherSquareAdj)
    # the rectangular adjacency pads its columns alike (K6's strip), and
    # its budget counts them
    rect = t_prop.build_rect_adjacency(data, "dense", device="cpu")
    assert rect.m.shape == m.shape
    assert isinstance(t_prop.build_rect_adjacency(data, device="cpu"), t_prop.GatherRectAdj)
    monkeypatch.setattr(t_prop, "dense_budget", lambda device: m.numel())
    assert isinstance(t_prop.build_rect_adjacency(data, device="cpu"), t_prop.DenseRectAdj)


def test_batch_rows_on_the_new_padding(data):
    """M and Mᵀ keep K12's and K13's column multiple (128), and the
    batch-row product equals the full propagation's rows."""
    adj = _adj(data, "bfloat16", with_transpose=True)
    assert adj.m.shape[1] % 128 == 0 and adj.m_t.shape[1] % 128 == 0
    assert torch.equal(adj.m_t, adj.m.T)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(adj.shape[0], 32)).astype(np.float32))
    rows_u = torch.from_numpy(rng.integers(0, adj.num_users, 40))
    rows_i = torch.from_numpy(rng.integers(0, adj.num_items, 50))
    tu, ti = t_base.lightgcn_propagate_rows(adj, x, 2, rows_u, rows_i, adj.num_users)
    full = t_base.lightgcn_propagate(adj, x, 2)
    np.testing.assert_allclose(tu.numpy(), full[rows_u].numpy(), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(ti.numpy(), full[adj.num_users + rows_i].numpy(), rtol=3e-5,
                               atol=3e-6)
