"""The port's int4 mode (nibble-packed count matrix, kernel K5's plain
version on the CPU) against the JAX package and against the port's own
int8 mode.

int4 changes the storage of M and nothing else: the activations are
int8 and the integer products identical. So the bars are
* the packed bytes, and the raw integer products against the JAX
  Pallas kernel (interpreted): exact equality;
* everything the port computes in int4 (the dual and its gradient, both
  chains forward and backward, LightGCN's embeddings and three Adam
  steps) against the same in int8: exact equality;
* the chain against the JAX int4 chains: TIGHT at one sweep (only f32
  epilogue ulps separate the paths), NOISE at three (an ulp on a
  rounding tie moves one activation by 1 lsb), as
  tests/test_torch_propagate.py and tests/test_torch_chain_bwd.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idgrec_torch.config import Config as TConfig
from idgrec_torch.data import dataset as t_dataset
from idgrec_torch.engine.trainer import EpochRunner as TRunner
from idgrec_torch.models import get_model as t_get_model
from idgrec_torch.ops import chainmm as t_chainmm
from idgrec_torch.ops import fusedmm as t_fusedmm
from idgrec_torch.ops import propagate as t_prop
from idgrec_tpu.data import dataset as j_dataset
from idgrec_tpu.ops import chainmm as j_chainmm
from idgrec_tpu.ops import fusedmm as j_fusedmm
from idgrec_tpu.ops import propagate as j_prop

# The shapes are tiny and the test workers share the cores: intra-op
# threads would only contend with each other.
torch.set_num_threads(1)

TIGHT = dict(rtol=3e-5, atol=3e-6)
NOISE = dict(rtol=2e-2, atol=1e-2)
D = 8
_SHAPE = (300, 500, 4000, 800)


def _counts(rng, shape, density=0.05, top=t_fusedmm.NIBBLE_MAX):
    return np.where(rng.random(shape) < density, rng.integers(1, top + 1, shape), 0).astype(np.int8)


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.fixture(scope="module")
def adjs():
    tdata = t_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    jdata = j_dataset.make_synthetic_dataset(*_SHAPE, seed=5)
    t8 = t_prop.build_adjacency(tdata, compute_dtype="int8", emb_size=D, device="cpu")
    t4 = t_prop.build_adjacency(tdata, compute_dtype="int4", emb_size=D, device="cpu")
    j4 = j_prop.build_adjacency(jdata, "sym", "auto", compute_dtype="int4", emb_size=D)
    return t8, t4, j4


def test_constants_match_jax():
    assert (t_fusedmm.NIBBLE_MAX, t_fusedmm.PACK_TILE) == (j_fusedmm.NIBBLE_MAX,
                                                           j_fusedmm.PACK_TILE) == (7, 2048)


@pytest.mark.parametrize("shape", [(128, 2048), (256, 6144)])
def test_pack_nibbles_byte_equal_to_jax(shape):
    m = _counts(np.random.default_rng(0), shape, density=0.3)
    got = t_fusedmm.pack_nibbles(torch.from_numpy(m))
    assert got.dtype == torch.int8 and tuple(got.shape) == (shape[0], shape[1] // 2)
    np.testing.assert_array_equal(got.numpy(), j_fusedmm.pack_nibbles(m))
    # the layout by hand: byte p of tile t = column 2048 t + p | column 2048 t + 1024 + p << 4
    t, p = shape[1] // 2048 - 1, 17
    assert int(got[5, 1024 * t + p]) == int(m[5, 2048 * t + p]) | (int(m[5, 2048 * t + 1024 + p]) << 4)


def test_unpack_inverts_pack_and_matches_jax():
    m = _counts(np.random.default_rng(1), (64, 4096), density=0.5)
    packed = t_fusedmm.pack_nibbles(torch.from_numpy(m))
    assert torch.equal(t_fusedmm.unpack_nibbles(packed), torch.from_numpy(m))
    # bytes with the top bit set (a high nibble of 8..15) unpack unsigned, as in JAX
    raw = np.random.default_rng(2).integers(-128, 128, (8, 2048)).astype(np.int8)
    np.testing.assert_array_equal(t_fusedmm.unpack_nibbles(torch.from_numpy(raw)).numpy(),
                                  np.asarray(j_fusedmm.unpack_nibbles(jnp.asarray(raw))))


@pytest.mark.parametrize("case", ["columns", "negative", "above_nibble_max", "dtype"])
def test_pack_nibbles_refuses(case):
    m = torch.zeros((8, 2048), dtype=torch.int8)
    if case == "columns":
        m = torch.zeros((8, 1024), dtype=torch.int8)
    elif case == "negative":
        m[0, 0] = -1
    elif case == "above_nibble_max":
        m[0, 0] = t_fusedmm.NIBBLE_MAX + 1
    else:
        m = m.to(torch.int32)
    with pytest.raises(ValueError):
        t_fusedmm.pack_nibbles(m)


@pytest.mark.parametrize("u_pad,i_pad,d", [(256, 2048, 8), (1024, 4096, 16)])
def test_int4_products_equal_jax_kernel_and_int8_plain(u_pad, i_pad, d):
    rng = np.random.default_rng(3)
    m = _counts(rng, (u_pad, i_pad))
    qu, qi = _q(rng, (d, u_pad)), _q(rng, (d, i_pad))
    m4 = t_fusedmm.pack_nibbles(torch.from_numpy(m))
    got = t_fusedmm.fused_adj_matmul_int4_t_plain(m4, torch.from_numpy(qu), torch.from_numpy(qi))
    ref = j_fusedmm.fused_adj_matmul_int4_t(jnp.asarray(m4.numpy()), jnp.asarray(qu),
                                            jnp.asarray(qi), interpret=True)
    same = t_fusedmm.fused_adj_matmul_int8_t_plain(torch.from_numpy(m), torch.from_numpy(qu),
                                                   torch.from_numpy(qi))
    wrapper = t_fusedmm.fused_adj_matmul_int4_t(m4, torch.from_numpy(qu), torch.from_numpy(qi))
    for a, b, c, w in zip(got, ref, same, wrapper):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c) and torch.equal(a, w)
    # exact integers: the products against int64 arithmetic
    np.testing.assert_array_equal(got[0].numpy(), (qi.astype(np.int64) @ m.T.astype(np.int64)))


@pytest.mark.parametrize("quant,u_pad,i_pad,d,ok", [
    ("int4", 1024, 2048, 64, True), ("int4", 1024, 2560, 64, False),
    ("int4", 1000, 2048, 64, False), ("int4", 1024, 2048, 32, False),
    ("int8", 1024, 2560, 64, True), ("int8", 1024, 2048, 64, True),
])
def test_kernel_accepts(quant, u_pad, i_pad, d, ok):
    assert t_fusedmm.kernel_accepts(u_pad, i_pad, d, quant) is ok


def test_build_adjacency_int4(adjs):
    t8, t4, j4 = adjs
    assert t4.quant == j4.quant == "int4"
    assert t4.padded_shape == (1024, 2048) and tuple(t4.m8.shape) == (1024, 1024)
    assert t4.m8.dtype == torch.int8
    # the JAX `build_adjacency` pads the rows to 2,048 (a TPU tile preference), the
    # port to TU: the stored bytes agree on the rows both have
    assert j4.padded_shape == (2048, 2048)
    np.testing.assert_array_equal(t4.m8.numpy(), np.asarray(j4.m8)[:1024])
    assert not np.asarray(j4.m8)[1024:].any()
    unpacked = t_fusedmm.unpack_nibbles(t4.m8)
    assert torch.equal(unpacked[:, : t8.padded_shape[1]], t8.m8)
    assert not bool(unpacked[:, t8.padded_shape[1]:].any())
    for name in ("left_u", "left_i", "right_u", "right_i"):
        np.testing.assert_array_equal(getattr(t4, name).numpy(), np.asarray(getattr(j4, name)))
    assert t_prop.supports_chain_t(t4, D) and t_chainmm.supports_chain_resident(t4, D, 3, "mean", None)


def test_build_adjacency_int4_refuses_counts_above_nibble_max():
    users = [0] * 9 + [1, 2]
    items = [1] * 9 + [0, 2]
    tdata = t_dataset.Dataset.from_pairs(users, items, [1], [2])
    jdata = j_dataset.Dataset.from_pairs(users, items, [1], [2])
    with pytest.raises(ValueError) as t_err:
        t_prop.build_adjacency(tdata, compute_dtype="int4", device="cpu")
    with pytest.raises(ValueError) as j_err:
        j_prop.build_adjacency(jdata, "sym", "auto", compute_dtype="int4")
    assert str(t_err.value) == str(j_err.value)
    assert "<= 7 (got 9); use int8" in str(t_err.value)
    # int8 takes the same data
    assert t_prop.build_adjacency(tdata, compute_dtype="int8", device="cpu").quant == "int8"


def test_quant_fused_dual_t_int4_equals_int8_and_jax(adjs):
    t8, t4, j4 = adjs
    rng = np.random.default_rng(14)
    u_pad, i8 = t8.padded_shape
    i4 = t4.padded_shape[1]
    zi = np.zeros((D, i4), np.float32)
    zi[:, :i8] = rng.normal(size=(D, i8))
    zu, wu = (rng.normal(size=(D, u_pad)).astype(np.float32) for _ in range(2))
    wi = np.zeros((D, i4), np.float32)
    wi[:, :i8] = rng.normal(size=(D, i8))
    grads, outs = [], []
    for adj, cols in ((t8, i8), (t4, i4)):
        zi_t = torch.from_numpy(zi[:, :cols].copy()).requires_grad_(True)
        zu_t = torch.from_numpy(zu).requires_grad_(True)
        yu, yi = t_prop.quant_fused_dual_t(adj.m8, zi_t, zu_t, adj.quant)
        ((yu * torch.from_numpy(wu)).sum() + (yi * torch.from_numpy(wi[:, :cols])).sum()).backward()
        outs.append((yu.detach(), yi.detach()[:, :i8]))
        grads.append((zi_t.grad[:, :i8], zu_t.grad))
    for a, b in zip(outs[0] + grads[0], outs[1] + grads[1]):
        assert torch.equal(a, b)

    def j_loss(zi_, zu_):
        yu, yi = j_prop.quant_fused_dual_t(j4.m8, zi_, jnp.pad(zu_, ((0, 0), (0, 1024))), "int4",
                                           True)
        return jnp.sum(yu[:, :u_pad] * wu) + jnp.sum(yi * wi)

    ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(zi), jnp.asarray(zu))
    np.testing.assert_allclose(grads[1][0].numpy(), np.asarray(ref[0])[:, :i8], **TIGHT)
    np.testing.assert_allclose(grads[1][1].numpy(), np.asarray(ref[1]), **TIGHT)
    with pytest.raises(ValueError, match="unknown quant"):
        t_prop.quant_fused_dual_t(t8.m8, torch.from_numpy(zi[:, :i8]), torch.from_numpy(zu), "int2")


def _x(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)).astype(np.float32), rng.normal(size=(n, D)).astype(np.float32))


def _torch_run(fn, adj, x, w, layers, include_layer0, reduce):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(adj, xt, layers, include_layer0, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("layers", [1, 3])
def test_int4_chains_equal_int8_and_meet_jax(adjs, layers, reduce, include_layer0):
    t8, t4, j4 = adjs
    x, w = _x(t8.shape[0], seed=layers)
    want_out, want_grad = _torch_run(t_chainmm.fused_chain_resident, t8, x, w, layers,
                                     include_layer0, reduce)
    for fn in (t_chainmm.fused_chain_resident, t_chainmm.fused_chain_resident_plain,
               t_prop.fused_chain_t):
        out, grad = _torch_run(fn, t4, x, w, layers, include_layer0, reduce)
        assert torch.equal(out, want_out) and torch.equal(grad, want_grad), fn.__name__
    bar = TIGHT if layers == 1 else NOISE
    for j_fn in (j_chainmm.fused_chain_resident, j_prop.fused_chain_t):
        ref = np.asarray(j_fn(j4, jnp.asarray(x), layers, include_layer0, reduce))
        np.testing.assert_allclose(want_out.numpy(), ref, **bar)
        assert np.linalg.norm(want_out.numpy() - ref) / np.linalg.norm(ref) < 1e-2
    ref_grad = np.asarray(jax.grad(lambda e: jnp.sum(
        j_chainmm.fused_chain_resident(j4, e, layers, include_layer0, reduce) * w))(jnp.asarray(x)))
    np.testing.assert_allclose(want_grad.numpy(), ref_grad, **bar)
    assert np.linalg.norm(want_grad.numpy() - ref_grad) / np.linalg.norm(ref_grad) < 1e-2


_CFG = {"dataset": "tiny", "embedding_size": "16", "reg_lambda": "0.0001", "GCN_layer": "3",
        "learn_rate": "0.001", "batch_size": "256", "test_batch_size": "64", "top_K": "[5, 10]"}


def test_lightgcn_int4_embeddings_and_three_adam_steps_equal_int8():
    """Counterpart of the JAX package's int4 == int8 engine test."""
    data = t_dataset.make_synthetic_dataset(200, 300, 3000, 400, seed=4)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        pick = rng.integers(0, data.num_train, 256)
        batches.append(tuple(torch.from_numpy(np.asarray(a, np.int64)) for a in (
            data.train_user[pick], data.train_item[pick], rng.integers(0, data.num_items, 256))))
    records = {}
    for mode in ("int8", "int4"):
        model = t_get_model("LightGCN")(TConfig({**_CFG, "compute_dtype": mode}), data,
                                        device="cpu", generator=torch.Generator().manual_seed(3))
        assert model.graph.quant == mode
        runner = TRunner(model, 0.001, 256, 256)
        rec = [model.eval_embeddings()]
        for step, batch in enumerate(batches):
            rec.append((runner.run_epoch(*batch, epoch=step), model.user_emb.detach().clone(),
                        model.item_emb.detach().clone()))
        rec.append(model.eval_embeddings())
        records[mode] = rec
    a, b = records["int8"], records["int4"]
    for x, y in zip(a[0] + a[-1], b[0] + b[-1]):
        assert torch.equal(x, y)
    for step in range(1, 4):
        for x, y in zip(a[step], b[step]):
            assert torch.equal(x, y), step
    assert not torch.equal(a[1][1], a[3][1])  # the steps moved the tables
