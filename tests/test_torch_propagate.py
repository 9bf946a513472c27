"""The port's quantized fused backend against the JAX package on the
same inputs (JAX Pallas kernels interpreted on the CPU).

Tolerances, the bars of tests/test_chainmm.py:
* the adjacency fields and `_quantize_rows` are bit-equal;
* one sweep (K=1) shares the quantization of the inputs bit for bit,
  so only f32 epilogue ulps could separate the paths: TIGHT;
* deeper chains cross int8 round()s, where an ulp-perturbed value on a
  rounding tie moves one activation by 1 lsb: NOISE, plus a relative
  L2 error below 1e-2."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.models import base as t_base
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.models import base as j_base
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import propagate as j_prop

TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
D = 8


def _pair(shape=(300, 500, 4000, 800), seed=5):
    return (t_dataset.make_synthetic_dataset(*shape, seed=seed),
            j_dataset.make_synthetic_dataset(*shape, seed=seed))


@pytest.fixture(scope="module")
def adjs():
    tdata, jdata = _pair()
    t = t_prop.build_adjacency(tdata, "sym", "auto", compute_dtype="int8", emb_size=D,
                               device="cpu")
    j = j_prop.build_adjacency(jdata, "sym", "auto", compute_dtype="int8", emb_size=D)
    return t, j


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def test_build_adjacency_bit_equal(adjs):
    t, j = adjs
    assert isinstance(j, j_prop.FusedSquareAdj) and j.quant == "int8"
    assert t.padded_shape == tuple(j.m8.shape) == (1024, 512)
    np.testing.assert_array_equal(t.m8.numpy(), np.asarray(j.m8))
    for name in ("left_u", "left_i", "right_u", "right_i", "diag_u", "diag_i"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.num_users, t.num_items, t.has_diag) == (j.num_users, j.num_items, j.has_diag)


def test_count_matrix_counts_and_padding():
    tdata = t_dataset.Dataset.from_pairs([0, 0, 0, 2], [1, 1, 3, 0], [1], [2])
    jdata = j_dataset.Dataset.from_pairs([0, 0, 0, 2], [1, 1, 3, 0], [1], [2])
    got = t_prop._count_matrix_int8(tdata, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), j_prop._count_matrix_int8(jdata))
    assert got.shape == (128, 128) and int(got[0, 1]) == 2


def test_quantize_rows_bit_equal():
    rng = np.random.default_rng(9)
    z = rng.normal(size=(6, 1000)).astype(np.float32) * 3
    z[2] = 0.0                                    # amax 0 -> scale 1
    z[3, :4] = [127.0, 0.5, 1.5, -2.5]            # exact rounding ties
    z[4] *= 1e-30                                 # tiny scales
    tq, ts = t_prop._quantize_rows(torch.from_numpy(z))
    jq, js = j_prop._quantize_rows(jnp.asarray(z))
    assert tq.dtype == torch.int8 and ts.shape == (6, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_one_sweep_tight(adjs, include_layer0, reduce):
    t, j = adjs
    x = _x(t.shape[0])
    j_t = np.asarray(j_prop.fused_chain_t(j, jnp.asarray(x), 1, include_layer0, reduce))
    j_r = np.asarray(j_chainmm.fused_chain_resident(j, jnp.asarray(x), 1, include_layer0, reduce))
    xt = torch.from_numpy(x)
    assert t_chainmm.supports_chain_resident(t, D, 1, reduce, None)
    got_r = t_chainmm.fused_chain_resident(t, xt, 1, include_layer0, reduce).numpy()
    got_t = t_prop.fused_chain_t(t, xt, 1, include_layer0, reduce).numpy()
    for got in (got_r, got_t):
        np.testing.assert_allclose(got, j_t, **TIGHT)
        np.testing.assert_allclose(got, j_r, **TIGHT)


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_three_sweeps_noise(adjs, include_layer0, reduce):
    t, j = adjs
    x = _x(t.shape[0], seed=1)
    xt = torch.from_numpy(x)
    got = t_chainmm.fused_chain_resident(t, xt, 3, include_layer0, reduce).numpy()
    # the port's two routes run the same operations in the same order
    np.testing.assert_array_equal(
        got, t_prop.fused_chain_t(t, xt, 3, include_layer0, reduce).numpy())
    for ref in (j_prop.fused_chain_t(j, jnp.asarray(x), 3, include_layer0, reduce),
                j_chainmm.fused_chain_resident(j, jnp.asarray(x), 3, include_layer0, reduce)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, **NOISE)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


def test_layer_list_and_tanh_chain_t(adjs):
    t, j = adjs
    x = _x(t.shape[0], seed=2)
    outs = t_prop.fused_chain_t(t, torch.from_numpy(x), 2, True, None)
    refs = j_prop.fused_chain_t(j, jnp.asarray(x), 2, True, None)
    assert len(outs) == len(refs) == 3
    for a, b in zip(outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **NOISE)
    # tanh chains are ROADMAP B.B4: neither route runs them yet
    with pytest.raises(NotImplementedError, match="B.B4"):
        t_prop.fused_chain_t(t, torch.from_numpy(x), 2, False, "sum", activation=torch.tanh)
    assert not t_chainmm.supports_chain_resident(t, D, 2, "sum", torch.tanh, False)


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_zero_layers_is_layer0(adjs, reduce):
    t, j = adjs
    x = _x(t.shape[0], seed=4)
    got = t_base.lightgcn_propagate(t, torch.from_numpy(x), 0, True, reduce)
    ref = np.asarray(j_base.lightgcn_propagate(j, jnp.asarray(x), 0, True, reduce))
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="no embeddings"):
        t_base.lightgcn_propagate(t, torch.from_numpy(x), 0, False, reduce)


def test_plain_chain_is_the_cpu_chain(adjs):
    t, _ = adjs
    xt = torch.from_numpy(_x(t.shape[0], seed=3))
    assert torch.equal(t_chainmm.fused_chain_resident(t, xt, 3),
                       t_chainmm.fused_chain_resident_plain(t, xt, 3))


def test_resolve_backend_matches_jax():
    tdata, jdata = _pair((40, 60, 500, 100), 2)
    for backend, dtype in (("auto", "int8"), ("auto", "bfloat16"), ("dense", "int8"),
                           ("fused", "int8"), ("gather", "int8"), ("auto", "int4")):
        assert t_prop.resolve_backend(tdata, backend, compute_dtype=dtype, device="cpu") == \
            j_prop.resolve_backend(jdata, backend, compute_dtype=dtype), (backend, dtype)
    with pytest.raises(ValueError):
        t_prop.resolve_backend(tdata, "bogus", device="cpu")


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="bfloat16", backend="bitpack"), dict(compute_dtype="float32", backend="bitpack"),
    dict(compute_dtype="int4", backend="bitpack"), dict(compute_dtype="int8", backend="bitpack"),
    dict(compute_dtype="int8", backend="dense", with_transpose=True),
    dict(compute_dtype="bfloat16", backend="dense", with_transpose=True),
])
def test_unported_paths_raise(kw):
    tdata, _ = _pair((40, 60, 500, 100), 2)
    item = "B.B9" if kw.get("with_transpose") else "A.8"
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        t_prop.build_adjacency(tdata, device="cpu", **kw)


def test_build_adjacency_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tdata, _ = _pair((40, 60, 500, 100), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_prop.build_adjacency(tdata, compute_dtype="int8")
