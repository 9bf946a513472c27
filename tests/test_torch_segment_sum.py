"""K4's sorted-segment entry (`scatter.segment_sum_rows`, SGL's drop
corrections) on the CPU, where its wrapper runs the plain version, and the
row offsets SGL's views carry.

Bars:
* `segment_sum_rows_plain` equals K4's plain version on the gathered rows,
  `scatter_add_rows_plain(rows, z[cols], n)`, bit for bit: it is defined
  so, and the kernel is held to it bit for bit on the card;
* against JAX's sorted segment sum of the gathered rows (the form of
  idgrec_tpu/ops/propagate.py's drop corrections) within float32
  rtol 1e-5 / atol 1e-6: XLA may add a segment in another order;
* the offsets (`row_offsets`, the views' `du_ptr` / `di_ptr`) equal
  `np.bincount` cumsums exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.ops import scatter as t_scatter

torch.set_num_threads(1)


def _list(seed: int, n_rows: int, n_z: int, counts: dict[int, int], mean: float = 3.0):
    """A list sorted by row over ``n_rows`` rows (row r: ``counts[r]``
    entries where given, else Poisson(mean), many rows empty), its columns
    in [0, n_z) in random order within a row; (rows, cols, ptr)."""
    rng = np.random.default_rng(seed)
    per = rng.poisson(mean, n_rows)
    per[rng.random(n_rows) < 0.3] = 0
    for r, c in counts.items():
        per[r] = c
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), per)
    cols = rng.integers(0, n_z, rows.size).astype(np.int64)
    ptr = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    return rows, cols, ptr


# rows of one entry, of 33 (one past a warp of entries) and above 4,096
# (K4's hot-row window); row 0 and the last row empty
_HOT = {0: 0, 1: 1, 7: 33, 20: 4_100, 59: 0}


@pytest.mark.parametrize("d", [8, 16, 48])
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_plain_equals_k4_plain_on_the_gathered_rows(d, layout):
    n_rows, n_z = 60, 90
    rows, cols, ptr = _list(d, n_rows, n_z, _HOT)
    rng = np.random.default_rng(d + 1)
    zn = rng.normal(size=(n_z, d)).astype(np.float32)
    z = torch.from_numpy(zn)
    if layout == "transposed":
        z = torch.from_numpy(np.ascontiguousarray(zn.T)).T  # strides (1, n_z)
        assert not z.is_contiguous()
    got = t_scatter.segment_sum_rows(torch.from_numpy(ptr), torch.from_numpy(cols), z)
    want = t_scatter.scatter_add_rows_plain(torch.from_numpy(rows), z[torch.from_numpy(cols)],
                                            n_rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rows, d)
    assert torch.equal(got, want)
    assert not got[0].any() and not got[-1].any()


@pytest.mark.parametrize("d", [8, 48])
def test_plain_matches_jax_sorted_segment_sum(d):
    n_rows, n_z = 60, 90
    rows, cols, ptr = _list(d + 7, n_rows, n_z, _HOT)
    z = np.random.default_rng(d).normal(size=(n_z, d)).astype(np.float32)
    got = t_scatter.segment_sum_rows_plain(torch.from_numpy(ptr), torch.from_numpy(cols),
                                           torch.from_numpy(z))
    want = jax.ops.segment_sum(jnp.take(jnp.asarray(z), jnp.asarray(cols), axis=0),
                               jnp.asarray(rows), num_segments=n_rows, indices_are_sorted=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_out_rows_past_the_list_are_zero():
    rows, cols, ptr = _list(3, 40, 50, {2: 33})
    z = torch.from_numpy(np.random.default_rng(3).normal(size=(50, 16)).astype(np.float32))
    short = t_scatter.segment_sum_rows(torch.from_numpy(ptr), torch.from_numpy(cols), z)
    long = t_scatter.segment_sum_rows(torch.from_numpy(ptr), torch.from_numpy(cols), z, 64)
    assert tuple(long.shape) == (64, 16)
    assert torch.equal(long[:40], short) and not long[40:].any()


@pytest.mark.parametrize("n_rows,counts", [(60, _HOT), (5, {0: 0, 1: 0, 2: 0, 3: 0, 4: 0}),
                                           (1, {0: 7})])
def test_row_offsets_equal_bincount_cumsum(n_rows, counts):
    rows, _, ptr = _list(5, n_rows, 10, counts)
    got = t_scatter.row_offsets(torch.from_numpy(rows), n_rows)
    want = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_rows))])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ptr)


@pytest.mark.parametrize("ptr,cols,z,out_rows", [
    (torch.tensor([0, 2], dtype=torch.int32), torch.tensor([0, 1]), torch.zeros(3, 4), None),
    (torch.tensor([0, 2]), torch.tensor([0, 1], dtype=torch.int32), torch.zeros(3, 4), None),
    (torch.tensor([0, 2]), torch.tensor([0, 1]), torch.zeros(3, 4, dtype=torch.float64), None),
    (torch.tensor([0, 1, 2]), torch.tensor([0, 1]), torch.zeros(3, 4), 1),
])
def test_bad_operands_raise(ptr, cols, z, out_rows):
    with pytest.raises(ValueError):
        t_scatter.segment_sum_rows(ptr, cols, z, out_rows)


def test_unsupported_device_raises():
    z = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_scatter.segment_sum_rows(torch.tensor([0, 0]), torch.zeros(0, dtype=torch.int64), z)


@pytest.fixture(scope="module")
def data():
    return t_dataset.make_synthetic_dataset(120, 180, 2500, 200, seed=3)


@pytest.mark.parametrize("backend", ["dense", "bitpack", "lists"])
def test_views_carry_the_offsets_of_their_lists(data, backend):
    """Every view (`DenseDropSquareAdj`, `BitDropSquareAdj`, the bare
    `DropLists` of the quantized views route) carries both lists' offsets,
    the `np.bincount` cumsums of its sorted rows."""
    shared = None if backend == "lists" else t_prop.build_dropout_shared(data, backend, "cpu")
    view = t_prop.build_dropout_adjacency(data, 0.1, np.random.default_rng(4),
                                          "dense" if backend == "lists" else backend,
                                          shared=shared, device="cpu")
    assert isinstance(view, t_prop.DropLists)
    for rows, ptr, n in ((view.du_rows, view.du_ptr, data.num_users),
                         (view.di_rows, view.di_ptr, data.num_items)):
        want = np.concatenate([[0], np.cumsum(np.bincount(rows.numpy(), minlength=n))])
        assert ptr.dtype == torch.int64 and tuple(ptr.shape) == (n + 1,)
        np.testing.assert_array_equal(ptr.numpy(), want)


@pytest.mark.parametrize("side", ["users", "items"])
def test_correction_with_offsets_equals_without(data, side):
    """`scatter.correction` on a view's lists with their offsets, forward
    and backward, gives the bits it gives on (rows, cols) alone (offsets
    made at the call), and K4's plain version's on the gathered rows; the
    backward into more rows than the list's (the padded [N, d] views of the
    quantized route) leaves the rows past it zero."""
    shared = t_prop.build_dropout_shared(data, "dense", "cpu")
    view = t_prop.build_dropout_adjacency(data, 0.1, np.random.default_rng(5), "dense",
                                          shared=shared, device="cpu")
    by_user = (view.du_rows, view.du_cols, view.du_ptr)
    by_item = (view.di_rows, view.di_cols, view.di_ptr)
    nu, ni = data.num_users, data.num_items
    (by_row, by_col, n_rows, n_z) = ((by_user, by_item, nu, ni) if side == "users"
                                     else (by_item, by_user, ni, nu))
    rng = np.random.default_rng(6)
    zt = torch.from_numpy(rng.normal(size=(16, n_z + 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n_rows, 16)).astype(np.float32))
    outs = []
    for edges in ((by_row, by_col), (by_row[:2], by_col[:2])):
        z = zt.clone().requires_grad_(True)
        out = t_scatter.correction(z.T, *edges, n_rows)
        out.backward(g)
        outs.append((out.detach(), z.grad.T))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    out, dz = outs[0]
    assert torch.equal(out, t_scatter.scatter_add_rows_plain(by_row[0], zt.T[by_row[1]], n_rows))
    assert tuple(dz.shape) == (n_z + 5, 16) and not dz[n_z:].any()
    assert torch.equal(dz[:n_z], t_scatter.scatter_add_rows_plain(by_col[0], g[by_col[1]], n_z))
