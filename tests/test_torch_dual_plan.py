"""The plan of M's non-zero entries that kernels K6, K7 and K8 walk
(`fusedmm.DualPlan`, `dual_plan`, `dual_path`), K6's plain version in its
own arithmetic (`fused_adj_matmul_fixed_plain`), and the plans the
adjacencies, SGL's shared state and a mesh shard hold, on the CPU.

Bars:
* `dual_plan`: its lists equal numpy's `nonzero` of M in row-major and
  in column-major order, exactly (padding rows and columns, empty rows,
  a column of 200 entries, counts up to 127);
* `fused_adj_matmul_fixed_plain` against JAX's `fused_adj_matmul`
  (its Pallas kernel interpreted) and against the float32
  `fused_adj_matmul_plain` at TIGHT (rtol 3e-5, atol 3e-6): the same
  bfloat16 operands and exact products, each rounded once at 2**-31 of
  its side's largest activation, sums in another order; with and without
  the plan equal bit for bit;
* every plan an object holds equals `dual_plan` of its own matrix (int4:
  of the unpacked matrix);
* gradients through `fused_adj_matmul`, `quant_fused_dual`,
  `quant_fused_dual4` and `quant_fused_dual_t` with a plan equal those
  without one; K8's plain version with a plan equals it without one and
  K7's plain version on the unpacked matrix, bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.config import Config as TConfig
from idgrec_torch.config import load_model_config as t_load_config
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import fusedmm as t_fused
from idgrec_torch.ops import propagate as t_prop
from idgrec_torch.parallel import spmm_shard as t_shard
from idgrec_torch.parallel.mesh import Mesh, use_mesh
from idgrec_tpu.ops import fusedmm as j_fused

torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
_SHAPE = (200, 300, 3000, 400)


def _counts(rng, shape, top=3, density=0.05):
    mask = rng.random(shape) < density
    return np.where(mask, rng.integers(1, top + 1, shape), 0).astype(np.int8)


def _matrix(case: str) -> np.ndarray:
    """A padded count matrix: ``rows`` of 290 real rows in 320 and 470 real
    columns in 512, some rows empty, one column of 200 entries, counts up
    to 127."""
    rng = np.random.default_rng(len(case))
    m = np.zeros((320, 512), dtype=np.int8)
    top = 127 if case == "counts" else 1
    m[:290, :470] = _counts(rng, (290, 470), top=top)
    m[10:40] = 0  # empty rows
    if case == "hot":
        m[rng.choice(290, 200, replace=False), 7] = 1
    if case == "empty":
        m[:] = 0
    return m


@pytest.fixture(scope="module")
def data():
    return t_dataset.make_synthetic_dataset(*_SHAPE, seed=3)


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("case", ["binary", "counts", "hot", "empty"])
def test_dual_plan_lists_numpy_nonzero_in_both_orders(case):
    m = _matrix(case)
    plan = t_fused.dual_plan(torch.from_numpy(m))
    assert plan.shape == m.shape and plan.nnz == int((m != 0).sum())
    rows, cols = np.nonzero(m)  # row-major
    np.testing.assert_array_equal(plan.row_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum((m != 0).sum(1))]))
    np.testing.assert_array_equal(plan.row_idx.numpy(), cols)
    np.testing.assert_array_equal(plan.row_val.numpy(), m[rows, cols])
    t_cols, t_rows = np.nonzero(m.T)  # column-major
    np.testing.assert_array_equal(plan.col_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum((m != 0).sum(0))]))
    np.testing.assert_array_equal(plan.col_idx.numpy(), t_rows)
    np.testing.assert_array_equal(plan.col_val.numpy(), m[t_rows, t_cols])
    assert plan.row_ptr.dtype == plan.col_ptr.dtype == torch.int64
    assert plan.row_idx.dtype == plan.col_idx.dtype == torch.int32
    assert plan.row_val.dtype == plan.col_val.dtype == torch.int8
    for ptr, first in ((plan.row_ptr, plan.row_first), (plan.col_ptr, plan.col_first)):
        steps = np.arange(0, plan.nnz, t_fused.PLAN_STEP)
        np.testing.assert_array_equal(first.numpy(),
                                      np.searchsorted(ptr.numpy(), steps, side="right") - 1)
        # the run of each PLAN_STEP-th entry holds it
        runs = first.numpy()
        assert np.all(ptr.numpy()[runs] <= steps) and np.all(ptr.numpy()[runs + 1] > steps)
    assert plan.nbytes == sum(t.numel() * t.element_size() for t in plan.tensors())


def test_dual_plan_takes_int8_matrices_only():
    with pytest.raises(ValueError, match="int8"):
        t_fused.dual_plan(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="int8"):
        t_fused.dual_plan(torch.zeros(4, dtype=torch.int8))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256, 1024, 2048])
def test_dual_path_takes_the_plan_where_given(d):
    plan = t_fused.dual_plan(torch.from_numpy(_matrix("binary")))
    assert t_fused.dual_path(d, None) == ("scan", t_fused.scan_passes(d))
    assert t_fused.dual_path(d, plan) == ("plan", 0)
    fpl = t_fused.walk_features(d)
    assert fpl in (1, 2, 3, 4, 6, 8) and d % (32 * fpl) == 0


# ---------------------------------------------------------------------------
# K6's plain version in its own arithmetic


@pytest.mark.parametrize("u,i", [(1024, 512), (1000, 500), (2048, 1024)])
@pytest.mark.parametrize("with_plan", [False, True])
def test_fixed_plain_matches_jax(u, i, with_plan):
    rng = np.random.default_rng(0)
    u_pad, i_pad = -(-u // 1024) * 1024, -(-i // 512) * 512
    m = _counts(rng, (u_pad, i_pad))
    zu = rng.normal(size=(u, 8)).astype(np.float32)
    zi = rng.normal(size=(i, 8)).astype(np.float32)
    mt = torch.from_numpy(m)
    plan = t_fused.dual_plan(mt) if with_plan else None
    yu, yi = t_fused.fused_adj_matmul_fixed_plain(mt, torch.from_numpy(zu), torch.from_numpy(zi),
                                                  plan)
    ryu, ryi = j_fused.fused_adj_matmul(jnp.asarray(m), jnp.asarray(zu), jnp.asarray(zi), True)
    assert yu.dtype == yi.dtype == torch.float32
    assert tuple(yu.shape) == (u, 8) and tuple(yi.shape) == (i, 8)
    np.testing.assert_allclose(yu.numpy(), np.asarray(ryu), **TIGHT)
    np.testing.assert_allclose(yi.numpy(), np.asarray(ryi), **TIGHT)


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("sides", ["both", "users", "items"])
def test_fixed_plain_matches_the_float_plain_and_its_plan(d, sides):
    rng = np.random.default_rng(d)
    m = torch.from_numpy(_matrix("counts"))
    zu = torch.from_numpy(rng.normal(size=(290, d)).astype(np.float32))
    zi = torch.from_numpy((1e3 * rng.normal(size=(470, d))).astype(np.float32))
    zu = None if sides == "items" else zu
    zi = None if sides == "users" else zi
    plan = t_fused.dual_plan(m)
    got = t_fused.fused_adj_matmul_fixed_plain(m, zu, zi)
    again = t_fused.fused_adj_matmul_fixed_plain(m, zu, zi, plan)
    want = t_fused.fused_adj_matmul_plain(m, zu, zi)
    for g, a, w in zip(got, again, want):
        assert (g is None) == (a is None) == (w is None)
        if w is None:
            continue
        assert g.shape == w.shape and torch.equal(g, a)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TIGHT)
    # a one-sided result is the same side of the two-sided one
    if sides != "both":
        k = 0 if sides == "users" else 1
        both = t_fused.fused_adj_matmul_fixed_plain(
            m, torch.from_numpy(rng.normal(size=(290, d)).astype(np.float32)) if zu is None
            else zu, torch.from_numpy(rng.normal(size=(470, d)).astype(np.float32)) if zi is None
            else zi)
        side, rows = got[1 - k], both[1 - k].shape[0]
        # M's padded rows on the absent side; the padding sums nothing
        assert side.shape[0] == m.shape[1 - k] and not bool(side[rows:].any())
        assert torch.equal(side[:rows], both[1 - k])


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_fixed_plain_nan_over_the_other_side(bad):
    rng = np.random.default_rng(1)
    m = torch.from_numpy(_matrix("binary"))
    zu = torch.from_numpy(rng.normal(size=(290, 32)).astype(np.float32))
    zi = torch.from_numpy(rng.normal(size=(470, 32)).astype(np.float32))
    zu[5, 3] = bad
    yu, yi = t_fused.fused_adj_matmul_fixed_plain(m, zu, zi)
    assert bool(torch.isnan(yi).all()) and bool(torch.isfinite(yu).all())


def test_fixed_plain_scales_each_side_by_its_amax():
    """Activations from 2**-20 to 2**10: the products round at 2**-31 of
    the side's largest activation, so the small ones keep their
    relative precision only down to that."""
    rng = np.random.default_rng(2)
    m = torch.from_numpy(_matrix("counts"))
    scale = 2.0 ** rng.integers(-20, 11, size=(470, 1))
    zi = torch.from_numpy((scale * rng.normal(size=(470, 64))).astype(np.float32))
    zu = torch.from_numpy(rng.normal(size=(290, 64)).astype(np.float32))
    yu, yi = t_fused.fused_adj_matmul_fixed_plain(m, zu, zi)
    wu, wi = t_fused.fused_adj_matmul_plain(m, zu, zi)
    top = float(zi.to(torch.bfloat16).abs().max())
    rows = (m.abs().sum(1).to(torch.float32)[:, None] * 2.0 ** -31 * 2 * top)
    assert bool(((yu - wu).abs() <= rows[:290] + 3e-5 * wu.abs()).all())
    np.testing.assert_allclose(yi.numpy(), wi.numpy(), **TIGHT)


def test_fixed_plain_runs_in_feature_chunks(monkeypatch):
    """The chunking by `_FIXED_FEATURES` leaves every bit."""
    rng = np.random.default_rng(4)
    m = torch.from_numpy(_matrix("hot"))
    zu = torch.from_numpy(rng.normal(size=(290, 96)).astype(np.float32))
    zi = torch.from_numpy(rng.normal(size=(470, 96)).astype(np.float32))
    whole = t_fused.fused_adj_matmul_fixed_plain(m, zu, zi)
    monkeypatch.setattr(t_fused, "_FIXED_FEATURES", 7)
    for a, b in zip(t_fused.fused_adj_matmul_fixed_plain(m, zu, zi), whole):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the objects that launch K6 or K7 hold a plan of their own M


def _same_plan(plan, m):
    want = t_fused.dual_plan(m)
    assert plan is not None and plan.shape == tuple(m.shape)
    for a, b in zip(plan.tensors(), want.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend,dtype,has_plan", [
    ("dense", "bfloat16", True), ("dense", "int8", True), ("dense", "float32", False),
    ("fused", "bfloat16", True), ("fused", "int8", True), ("fused", "int4", True),
    ("fused", "float32", True)])
def test_square_adjacency_carries_the_plan_of_its_matrix(data, backend, dtype, has_plan):
    """The int4 matrix's plan is the unpacked matrix's, made before
    packing (K8 walks it)."""
    adj = t_prop.build_adjacency(data, "sym", backend, compute_dtype=dtype, device="cpu")
    m = adj.m if backend == "dense" else adj.m8
    if backend == "fused" and dtype == "int4":
        m = t_fused.unpack_nibbles(m)
    if has_plan:
        _same_plan(adj.plan, m)
    else:
        assert adj.plan is None


@pytest.mark.parametrize("dtype,has_plan", [("bfloat16", True), ("float32", False),
                                            ("int8", False)])
def test_rect_adjacency_carries_the_plan_of_its_matrix(data, dtype, has_plan):
    adj = t_prop.build_rect_adjacency(data, "dense", dtype, device="cpu")
    if has_plan:
        _same_plan(adj.plan, adj.m)
    else:
        assert adj.plan is None


def _sgl_cfg(backend, dtype):
    cfg = {**t_load_config("SGL").as_dict(), "dataset": "tiny", "embedding_size": "32",
           "GCN_layer": "1", "batch_size": "64", "test_batch_size": "64",
           "propagation_backend": backend, "compute_dtype": dtype}
    return TConfig(cfg)


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("fused", "bfloat16"),
                                           ("dense", "int8")])
def test_sgl_views_share_the_models_plan(data, backend, dtype):
    model = t_get_model("SGL")(_sgl_cfg(backend, dtype), data, device="cpu")
    model.epoch_context(0, np.random.default_rng(0))
    g = model.graph
    own = g.m if backend == "dense" else g.m8
    assert model._shared is own and model._shared_plan is g.plan
    for views in model.views:
        for v in views:
            assert v.m_bin is own and v.plan is model._shared_plan


def test_sgl_non_binary_counts_plan_the_binary_matrix(data):
    counts = data.csr_vals.copy()
    counts[::7] = 3
    heavy = dataclasses.replace(data, csr_vals=counts)
    model = t_get_model("SGL")(_sgl_cfg("dense", "bfloat16"), heavy, device="cpu")
    assert model._shared is not model.graph.m
    _same_plan(model._shared_plan, model._shared)
    _same_plan(model.graph.plan, model.graph.m)


def test_sgl_float32_views_hold_no_plan(data):
    model = t_get_model("SGL")(_sgl_cfg("dense", "float32"), data, device="cpu")
    assert model._shared_plan is None


@pytest.mark.parametrize("backend,dtype", [("dense", "bfloat16"), ("dense", "int8"),
                                           ("fused", "bfloat16"), ("fused", "int8")])
@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_shard_carries_the_plan_of_its_rows(data, backend, dtype, rank):
    """Under a model axis of 2 the adjacency holds this rank's rows of M
    and the plan of those rows; the shard's product on its plan equals
    the product without one."""
    with use_mesh(Mesh(1, 2, rank)):
        adj = t_prop.build_adjacency(data, "sym", backend, compute_dtype=dtype, device="cpu")
        shared = t_prop.build_dropout_shared(data, backend, "cpu", adj)
    m = adj.m if backend == "dense" else adj.m8
    whole = t_prop.build_adjacency(data, "sym", backend, compute_dtype=dtype, device="cpu")
    whole_m = whole.m if backend == "dense" else whole.m8
    rows = m.shape[0]
    assert adj.shard is not None and torch.equal(m, whole_m[rank * rows:(rank + 1) * rows])
    _same_plan(adj.plan, m)
    assert shared is m and t_prop.shared_plan(shared, adj) is adj.plan
    route = t_shard.shard_route(adj, 32)
    rng = np.random.default_rng(rank)
    if route == "k7":
        zu = torch.from_numpy(rng.integers(-127, 128, (rows, 32)).astype(np.int8))
        zi = torch.from_numpy(rng.integers(-127, 128, (m.shape[1], 32)).astype(np.int8))
    else:
        zu = torch.from_numpy(rng.normal(size=(rows, 32)).astype(np.float32))
        zi = torch.from_numpy(rng.normal(size=(m.shape[1], 32)).astype(np.float32))
    for a, b in zip(t_shard.shard_dual(route, m, zu, zi, torch.bfloat16, adj.plan),
                    t_shard.shard_dual(route, m, zu, zi, torch.bfloat16)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the wrappers and their gradients with a plan


def _grads(fn, m, zu, zi, plan):
    a, b = zu.clone().requires_grad_(True), zi.clone().requires_grad_(True)
    ys = fn(m, a, b, plan)
    rng = np.random.default_rng(9)
    loss = sum((y * torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))).sum()
               for y in ys)
    loss.backward()
    return [y.detach() for y in ys] + [a.grad, b.grad]


@pytest.mark.parametrize("d", [32, 48])
def test_fused_adj_matmul_gradient_with_plan_equals_without(d):
    rng = np.random.default_rng(d)
    m = torch.from_numpy(_matrix("counts"))
    zu = torch.from_numpy(rng.normal(size=(290, d)).astype(np.float32))
    zi = torch.from_numpy(rng.normal(size=(470, d)).astype(np.float32))
    plan = t_fused.dual_plan(m)
    for a, b in zip(_grads(t_fused.fused_adj_matmul, m, zu, zi, plan),
                    _grads(t_fused.fused_adj_matmul, m, zu, zi, None)):
        assert torch.equal(a, b)


def test_quantized_duals_gradient_with_plan_equals_without():
    rng = np.random.default_rng(5)
    m = torch.from_numpy(_matrix("counts"))
    plan = t_fused.dual_plan(m)
    zi = torch.from_numpy(rng.normal(size=(512, 32)).astype(np.float32))
    zu = torch.from_numpy(rng.normal(size=(320, 32)).astype(np.float32))

    def n_dual(m_, a, b, plan_):
        return t_prop.quant_fused_dual(m_, b, a, plan_)

    def t_dual(m_, a, b, plan_):
        return t_prop.quant_fused_dual_t(m_, b.T, a.T, "int8", plan_)

    for fn in (n_dual, t_dual):
        for a, b in zip(_grads(fn, m, zu, zi, plan), _grads(fn, m, zu, zi, None)):
            assert torch.equal(a, b)


def test_plan_of_another_matrix_is_refused():
    m = torch.from_numpy(_matrix("binary"))
    other = t_fused.dual_plan(m[:256])
    with pytest.raises(ValueError, match="does not fit"):
        t_fused.fused_adj_matmul_fixed_plain(m, torch.ones(290, 32), torch.ones(470, 32), other)


# ---------------------------------------------------------------------------
# K8 on the plan of the unpacked matrix


def _packed(case: str) -> torch.Tensor:
    """A `_matrix` padded to `fusedmm.PACK_TILE` columns and its counts cut
    to `NIBBLE_MAX`, packed."""
    m = np.zeros((320, t_fused.PACK_TILE), dtype=np.int8)
    m[:, :512] = np.minimum(_matrix(case), t_fused.NIBBLE_MAX)
    return t_fused.pack_nibbles(torch.from_numpy(m))


@pytest.mark.parametrize("case", ["binary", "counts", "hot"])
def test_int4_plan_is_the_plan_of_the_unpacked_matrix(case):
    m4 = _packed(case)
    plan = t_fused.dual_plan(t_fused.unpack_nibbles(m4))
    assert plan.shape == (320, 2 * m4.shape[1])
    _same_plan(plan, t_fused.unpack_nibbles(m4))


@pytest.mark.parametrize("d", [32, 48, 64])
def test_k8_plain_with_plan_equals_without_and_k7(d):
    """K8's plain version (and its wrapper on the CPU) takes the plan and
    gives the bits it gives without one, which are K7's plain version's on
    the unpacked matrix."""
    rng = np.random.default_rng(d)
    m4 = _packed("counts")
    m8 = t_fused.unpack_nibbles(m4)
    plan = t_fused.dual_plan(m8)
    qu = torch.from_numpy(rng.integers(-127, 128, (320, d)).astype(np.int8))
    qi = torch.from_numpy(rng.integers(-127, 128, (m8.shape[1], d)).astype(np.int8))
    want = t_fused.fused_adj_matmul_int8_plain(m8, qu, qi)
    for got in (t_fused.fused_adj_matmul_int4_plain(m4, qu, qi, plan),
                t_fused.fused_adj_matmul_int4_plain(m4, qu, qi),
                t_fused.fused_adj_matmul_int4(m4, qu, qi, plan)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_int4_duals_gradient_with_plan_equals_without():
    rng = np.random.default_rng(6)
    m4 = _packed("counts")
    plan = t_fused.dual_plan(t_fused.unpack_nibbles(m4))
    zi = torch.from_numpy(rng.normal(size=(2 * m4.shape[1], 32)).astype(np.float32))
    zu = torch.from_numpy(rng.normal(size=(320, 32)).astype(np.float32))

    def n_dual(m_, a, b, plan_):
        return t_prop.quant_fused_dual4(m_, b, a, plan_)

    def t_dual(m_, a, b, plan_):
        return t_prop.quant_fused_dual_t(m_, b.T, a.T, "int4", plan_)

    for fn in (n_dual, t_dual):
        for a, b in zip(_grads(fn, m4, zu, zi, plan), _grads(fn, m4, zu, zi, None)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("rank", [0, 1])
def test_int4_mesh_shard_carries_the_plan_of_its_rows(data, rank):
    """Under a model axis of 2 the int4 adjacency holds this rank's packed
    rows and the plan of those rows unpacked; K8's shard product on it
    equals the product without one."""
    with use_mesh(Mesh(1, 2, rank)):
        adj = t_prop.build_adjacency(data, "sym", "fused", compute_dtype="int4", device="cpu")
    whole = t_prop.build_adjacency(data, "sym", "fused", compute_dtype="int4", device="cpu")
    rows = adj.m8.shape[0]
    assert adj.shard is not None and t_shard.shard_route(adj, 32) == "k8"
    assert torch.equal(adj.m8, whole.m8[rank * rows:(rank + 1) * rows])
    _same_plan(adj.plan, t_fused.unpack_nibbles(adj.m8))
    rng = np.random.default_rng(rank)
    zu = torch.from_numpy(rng.integers(-127, 128, (rows, 32)).astype(np.int8))
    zi = torch.from_numpy(rng.integers(-127, 128, (2 * adj.m8.shape[1], 32)).astype(np.int8))
    for a, b in zip(t_shard.shard_dual("k8", adj.m8, zu, zi, plan=adj.plan),
                    t_shard.shard_dual("k8", adj.m8, zu, zi)):
        assert torch.equal(a, b)
