"""The port's sharded propagation (idgrec_torch/parallel/spmm_shard.py)
on one gloo group of 4 CPU ranks, at model widths 2 (a 2x2 mesh) and 4
(a 1x4 mesh) of the same ranks, against the port on one process and the
JAX package's single-device products on the same numpy inputs.

Every case runs in the group once (tests/_torch_mesh_worker.py
``suite_spmm_shard``); the parent computes the references while the
ranks run, then compares. The join has a 120 s timeout.

Bars:
* against the port on one process: the quantized duals (int8 and int4,
  dense and fused) and their straight-through gradients equal bit for
  bit (the same global scales, integer sums exact in float32, the
  all-gathered rows the single product's); the exact modes within TIGHT
  (float32 partial sums of the rows of M added over the ranks);
* the raw integer sums of the sharded K7/K8 route equal the single
  product's, and each rank's shard product equals the plain product on
  its rows of M;
* against JAX: the exact modes within TIGHT, the quantized ones within a
  relative L2 error of 1e-2 (the two packages' rounding ties may move
  an activation by one step);
* each rank holds 1/width of M's bytes, and the resident chain declines.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_worker import Group
from idgrec_torch.data.dataset import make_synthetic_dataset as t_make
from idgrec_torch.ops import fusedmm as t_fusedmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data.dataset import make_synthetic_dataset as j_make
from idgrec_tpu.ops import propagate as j_prop

SHAPE, SEED, D = (400, 300, 4000, 500), 7, 16
TIGHT = dict(rtol=3e-5, atol=3e-6)
WIDTHS = (2, 4)
# name -> (variant, backend, compute_dtype, gated)
CASES = {
    "dense_bf16": ("sym", "dense", "bfloat16", False),
    "dense_f32": ("sym", "dense", "float32", False),
    "dense_int8": ("sym", "dense", "int8", False),
    "fused_bf16": ("sym", "fused", "bfloat16", False),
    "fused_int8": ("sym", "fused", "int8", False),
    "fused_int4": ("sym", "fused", "int4", False),
    "self_diag": ("self", "dense", "float32", False),
    "fused_bf16_diag": ("self", "fused", "bfloat16", False),
    "gate": ("sym", "dense", "float32", True),
    "fused_int8_gate": ("sym", "fused", "int8", True),
}
QUANT = {name for name, c in CASES.items() if c[2] in ("int8", "int4")}
N = SHAPE[0] + SHAPE[1]


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "shape": SHAPE, "seed": SEED, "cases": CASES,
        "x": rng.normal(size=(N, D)).astype(np.float32),
        "ct": rng.normal(size=(N, D)).astype(np.float32),
        "gate": (rng.random(N) > 0.3).astype(np.float32),
        "qu": rng.integers(-127, 128, size=(1024, 32)).astype(np.int8),
        "qi": rng.integers(-127, 128, size=(2048, 32)).astype(np.int8),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def data():
    return t_make(*SHAPE, seed=SEED, name="shardtest"), j_make(*SHAPE, seed=SEED, name="shardtest")


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    started = Group("spmm_shard", tmp_path_factory.mktemp("spmm_shard"), 4, INPUTS)
    refs = {name: _port_single(data[0], name) for name in CASES}
    refs.update({name: _port_gather(data[0], name) for name in GATHER})
    return started.join(), refs


def _port_single(tdata, name):
    variant, backend, dtype, gated = CASES[name]
    adj = t_prop.build_adjacency(tdata, variant, backend, compute_dtype=dtype, device="cpu")
    x = torch.from_numpy(INPUTS["x"]).requires_grad_(True)
    y = adj.matmul(x, torch.from_numpy(INPUTS["gate"]) if gated else None)
    (y * torch.from_numpy(INPUTS["ct"])).sum().backward()
    m = adj.m8 if isinstance(adj, t_prop.FusedSquareAdj) else adj.m
    return dict(y=y.detach().numpy(), grad=x.grad.numpy(), m=m, padded=adj.padded_shape)


GATHER = ("gather_square", "gather_rect", "gather_rect_t")


def _gather_operands(name):
    x, ct, nu = INPUTS["x"], INPUTS["ct"], SHAPE[0]
    return {"gather_square": (x, ct), "gather_rect": (x[nu:], ct[:nu]),
            "gather_rect_t": (x[:nu], ct[nu:])}[name]


def _port_gather(tdata, name):
    sq = t_prop.build_adjacency(tdata, "sym", "gather", compute_dtype="float32", device="cpu")
    rect = t_prop.build_rect_adjacency(tdata, "gather", compute_dtype="float32", device="cpu")
    fn = {"gather_square": sq.matmul, "gather_rect": rect.matmul,
          "gather_rect_t": rect.t_matmul}[name]
    x, ct = _gather_operands(name)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(ct)).sum().backward()
    return dict(y=y.detach().numpy(), grad=xt.grad.numpy())


def _jax(jdata, name):
    """The JAX package's single-device product and its vjp."""
    if name in GATHER:
        sq = j_prop.build_adjacency(jdata, "sym", "gather", compute_dtype="float32")
        rect = j_prop.build_rect_adjacency(jdata, "gather", compute_dtype="float32")
        fn = {"gather_square": sq.matmul, "gather_rect": rect.matmul,
              "gather_rect_t": rect.t_matmul}[name]
        x, ct = _gather_operands(name)
    else:
        variant, backend, dtype, gated = CASES[name]
        # the port's dense bfloat16 products run K6's function: JAX's fused backend
        backend = "fused" if (backend, dtype) == ("dense", "bfloat16") else backend
        adj = j_prop.build_adjacency(jdata, variant, backend, compute_dtype=dtype)
        gate = jnp.asarray(INPUTS["gate"]) if gated else None
        x, ct = INPUTS["x"], INPUTS["ct"]

        def fn(v):
            return adj.matmul(v, gate)
    y, back = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(back(jnp.asarray(ct))[0])


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_dual_matches_one_process(group, width, name):
    results, refs = group
    ref = refs[name]
    for rank_out in results:
        got = rank_out[width, name]
        assert got["sharded"]
        if name in QUANT:
            np.testing.assert_array_equal(got["y"], ref["y"])
            np.testing.assert_array_equal(got["grad"], ref["grad"])
        else:
            np.testing.assert_allclose(got["y"], ref["y"], **TIGHT)
            np.testing.assert_allclose(got["grad"], ref["grad"], **TIGHT)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", list(CASES) + list(GATHER))
def test_sharded_product_matches_jax(group, data, width, name):
    got = group[0][0][width, name]
    y, grad = _jax(data[1], name)
    if name in QUANT:
        assert _rel_l2(got["y"], y) < 1e-2 and _rel_l2(got["grad"], grad) < 1e-2
    else:
        np.testing.assert_allclose(got["y"], y, **TIGHT)
        np.testing.assert_allclose(got["grad"], grad, **TIGHT)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", GATHER)
def test_sharded_gather_matches_one_process(group, width, name):
    results, refs = group
    for rank_out in results:
        np.testing.assert_allclose(rank_out[width, name]["y"], refs[name]["y"], **TIGHT)
        np.testing.assert_allclose(rank_out[width, name]["grad"], refs[name]["grad"], **TIGHT)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_raw_integer_sums_equal_the_single_product(group, data, width, quant):
    """The assembled raw sums of K7/K8's route equal the product of the
    whole matrix; each rank's shard product is the plain product on its
    rows of M."""
    adj = t_prop.build_adjacency(data[0], "sym", "fused", compute_dtype=quant, device="cpu")
    u_pad, i_pad = adj.padded_shape
    qu = torch.from_numpy(INPUTS["qu"][:u_pad])
    qi = torch.from_numpy(INPUTS["qi"][:i_pad])
    plain = (t_fusedmm.fused_adj_matmul_int4_plain if quant == "int4"
             else t_fusedmm.fused_adj_matmul_int8_plain)
    yu, yi = plain(adj.m8, qu, qi)
    for rank_out in group[0]:
        got = rank_out[width, f"raw_{quant}"]
        np.testing.assert_array_equal(got["yu"], yu.numpy())
        np.testing.assert_array_equal(got["yi"], yi.numpy())
        lo = got["index"] * got["rows"]
        k_yu, k_yi = plain(adj.m8[lo: lo + got["rows"]], qu[lo: lo + got["rows"]], qi)
        np.testing.assert_array_equal(got["shard_yu"], k_yu.numpy())
        np.testing.assert_array_equal(got["shard_yi"], k_yi.numpy())


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_rows_of_m_and_the_chain_declines(group, data, width, name):
    results, refs = group
    ref = refs[name]
    full_rows = results[0][width, name]["padded"][0]
    assert results[0][width, name]["padded"][1] == ref["padded"][1]
    assert full_rows % (64 * width) == 0 and full_rows >= ref["padded"][0]
    for rank_out in results:
        got = rank_out[width, name]
        assert got["m_rows"] * width == full_rows
        assert got["m_bytes"] * width == full_rows * ref["m"].shape[1] * ref["m"].element_size()
        assert got["chain"] is False
    if CASES[name][1] == "fused" and CASES[name][2] in ("int8", "int4"):
        # without a mesh the same matrix takes the resident chain
        assert t_prop.supports_chain_t(t_prop.build_adjacency(
            data[0], CASES[name][0], "fused", compute_dtype=CASES[name][2], device="cpu"))


@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_routes_on_the_shards(group, width):
    """The per-shard product at d = 32 is the single-card route's kernel:
    K6 for bfloat16 (fused, and dense where K6 takes the width), K7 for
    int8, K8 for int4; float32 keeps its float32 products."""
    routes = {name: group[0][0][width, name]["route"] for name in CASES}
    assert routes["fused_bf16"] == routes["dense_bf16"] == routes["fused_bf16_diag"] == "k6"
    assert routes["fused_int8"] == routes["dense_int8"] == routes["fused_int8_gate"] == "k7"
    assert routes["fused_int4"] == "k8"
    assert routes["dense_f32"] == routes["self_diag"] == routes["gate"] == "exact"
