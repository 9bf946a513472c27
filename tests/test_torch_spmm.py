"""The port's sparse graphs and sparse product against the JAX package
on the same inputs.

Tolerances: the graph arrays are equal (the same numpy construction;
the port stores indices as int64); `spmm`, its gradient and
`spmm_transpose` are float32 segment sums of the same terms in the same
(row-sorted) order, held at TIGHT (rtol 3e-5, atol 3e-6)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.data import graph as t_graph
from idgrec_torch.ops import spmm as t_spmm
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.data import graph as j_graph
from idgrec_tpu.ops.spmm import spmm as j_spmm_fn
from idgrec_tpu.ops.spmm import spmm_transpose as j_spmm_transpose

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
_SHAPE = (300, 500, 4000, 800)
D = 8


def _pair(seed=5):
    return (t_dataset.make_synthetic_dataset(*_SHAPE, seed=seed),
            j_dataset.make_synthetic_dataset(*_SHAPE, seed=seed))


def _makers(name):
    if name == "sym":
        return (lambda d: t_graph.normalized_adjacency(d),
                lambda d: j_graph.normalized_adjacency(d, cache=False))
    if name == "self":
        return (lambda d: t_graph.normalized_adjacency_with_self(d),
                lambda d: j_graph.normalized_adjacency_with_self(d, cache=False))
    return (lambda d: t_graph.generalized_normalized_adjacency(d, 0.6, 0.3),
            lambda d: j_graph.generalized_normalized_adjacency(d, 0.6, 0.3, cache=False))


@pytest.fixture(scope="module", params=["sym", "self", "gen"])
def graphs(request):
    tdata, jdata = _pair()
    tb, jb = _makers(request.param)
    return tb(tdata), jb(jdata)


def test_graph_arrays_equal_jax(graphs):
    t, j = graphs
    assert (t.n_rows, t.n_cols, t.nnz, t.symmetric) == (j.n_rows, j.n_cols, j.nnz, j.symmetric)
    for name in ("rows", "cols", "t_rows", "t_cols"):
        a = getattr(t, name)
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), getattr(j, name), err_msg=name)
    for name in ("vals", "t_vals"):
        a = getattr(t, name)
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), getattr(j, name), err_msg=name)


def test_graph_padding_and_counts(graphs):
    t, _ = graphs
    n = t.rows.numel()
    assert n % 1024 == 0 and n >= t.nnz
    assert bool((t.rows[1:] >= t.rows[:-1]).all()) and bool((t.t_rows[1:] >= t.t_rows[:-1]).all())
    # padding entries are zero-valued and point at the last row and column
    assert not bool(t.vals[t.nnz:].any())
    assert bool((t.rows[t.nnz:] == t.n_rows - 1).all())
    assert bool((t.cols[t.nnz:] == t.n_cols - 1).all())
    np.testing.assert_array_equal(t.row_counts.numpy(),
                                  np.bincount(t.rows.numpy(), minlength=t.n_rows))
    np.testing.assert_array_equal(t.t_row_counts.numpy(),
                                  np.bincount(t.t_rows.numpy(), minlength=t.n_cols))


def test_spmm_matches_jax(graphs):
    t, j = graphs
    x = np.random.default_rng(0).normal(size=(t.n_cols, D)).astype(np.float32)
    got = t_spmm.spmm(t, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (t.n_rows, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_spmm_fn(j, jnp.asarray(x))), **TIGHT)
    np.testing.assert_allclose(
        t_spmm.spmm_transpose(t, torch.from_numpy(x)).numpy(),
        np.asarray(j_spmm_transpose(j, jnp.asarray(x))), **TIGHT)


def test_spmm_gradient_matches_jax(graphs):
    t, j = graphs
    rng = np.random.default_rng(1)
    x = rng.normal(size=(t.n_cols, D)).astype(np.float32)
    w = rng.normal(size=(t.n_rows, D)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.spmm(t, xt) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda v: jnp.sum(j_spmm_fn(j, v) * jnp.asarray(w)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), **TIGHT)


def test_spmm_matches_scipy_and_repeats_bit_equal(graphs):
    t, j = graphs
    x = np.random.default_rng(2).normal(size=(t.n_cols, D)).astype(np.float32)
    got = t_spmm.spmm(t, torch.from_numpy(x))
    assert torch.equal(got, t_spmm.spmm(t, torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), j.to_scipy() @ x, rtol=1e-4, atol=1e-5)


def test_spmm_bfloat16_accumulates_in_float32(graphs):
    t, j = graphs
    x = np.random.default_rng(3).normal(size=(t.n_cols, D)).astype(np.float32)
    got = t_spmm.spmm(t, torch.from_numpy(x).to(torch.bfloat16))
    ref = j_spmm_fn(j, jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # the same bf16 inputs, f32 sums of the same terms, one rounding to
    # bf16 at the end: an ulp of the f32 sum can flip that rounding, so
    # the bar is one bf16 ulp (2**-8 relative)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_spmm_validates():
    tdata, _ = _pair()
    g = t_graph.normalized_adjacency(tdata)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_spmm.spmm(g, torch.zeros(g.n_cols + 1, D))


def test_degrees_and_edges_match_jax():
    tdata, jdata = _pair(seed=6)
    for a, b in zip(t_graph._degrees(tdata), j_graph._degrees(jdata)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_graph._interaction_edges(tdata), j_graph._interaction_edges(jdata)):
        np.testing.assert_array_equal(a, b)


def test_from_coo_unsorted_rectangular_matches_jax():
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 40, 300), rng.integers(0, 70, 300)
    vals = rng.normal(size=300).astype(np.float32)
    t = t_graph.SparseGraph.from_coo(rows, cols, vals, (40, 70))
    j = j_graph.SparseGraph.from_coo(rows, cols, vals, (40, 70))
    x = rng.normal(size=(70, D)).astype(np.float32)
    y = rng.normal(size=(40, D)).astype(np.float32)
    np.testing.assert_allclose(t_spmm.spmm(t, torch.from_numpy(x)).numpy(),
                               np.asarray(j_spmm_fn(j, jnp.asarray(x))), **TIGHT)
    np.testing.assert_allclose(t_spmm.spmm_transpose(t, torch.from_numpy(y)).numpy(),
                               np.asarray(j_spmm_transpose(j, jnp.asarray(y))), **TIGHT)
    assert t.transpose().shape == (70, 40) and not t.symmetric
