"""Kernels K1-K5 against their plain PyTorch versions on the card.

These need an NVIDIA GPU with nvcc (the kernels build at first use);
without one they skip with a reason. Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: K1's and K5's raw integer products are equal to their plain
versions', and K5's to K1's on the unpacked matrix; the int4 chain and
its gradient are bit-equal to the int8 chain's; K3 and K2 are
bit-equal (IEEE division, round-half-even, no FMA contraction, an
order-free max), K2's inject mode too; K4 is bit-equal (no atomics:
duplicates are added in batch order); the 3-sweep chain and its
straight-through backward chain are bit-equal to the plain chains built
from the same operations; the gradients of one training step's loss
are bit-equal between the kernel path and the plain path."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idgrec_torch.data.dataset import make_synthetic_dataset
from idgrec_torch.config import Config
from idgrec_torch.models import get_model
from idgrec_torch.ops import chainmm, fusedmm, propagate, scatter

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _int8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


@pytest.mark.parametrize("u_pad,i_pad,density,top", [
    (3072, 2048, 0.02, 3),      # sparse counts, several strips and row shares
    (1024, 512, 1.0, 5),        # dense: no tile is skipped
    (64, 256, 0.3, 127),        # one chunk, one strip, the largest counts
    (2048, 1024, 0.0, 1),       # all zero
])
def test_k1_equals_plain(cuda, u_pad, i_pad, density, top):
    rng = np.random.default_rng(0)
    mask = rng.random((u_pad, i_pad)) < density
    m = torch.from_numpy(np.where(mask, rng.integers(1, top + 1, (u_pad, i_pad)), 0)
                         .astype(np.int8)).to(cuda)
    qu, qi = _int8(rng, (64, u_pad)).to(cuda), _int8(rng, (64, i_pad)).to(cuda)
    got = fusedmm.fused_adj_matmul_int8_t(m, qu, qi)
    want = fusedmm.fused_adj_matmul_int8_t_plain(m, qu, qi)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_k1_rejects_what_it_does_not_take(cuda):
    m = torch.zeros((1024, 512), dtype=torch.int8, device=cuda)
    q = torch.zeros((32, 1024), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        fusedmm.fused_adj_matmul_int8_t(m, q, torch.zeros((32, 512), dtype=torch.int8, device=cuda))


def test_k3_and_k2_equal_plain(cuda):
    g = torch.Generator(device="cpu").manual_seed(1)
    z = (torch.randn(64, 4096, generator=g) * 3).to(cuda)
    amax = z.abs().amax(dim=1)
    for a, b in zip(propagate.quantize_rows(z, amax), propagate.quantize_rows_plain(z, amax)):
        assert torch.equal(a, b)
    y = torch.randn(64, 4096, generator=g).to(cuda)
    s = torch.rand(64, generator=g).to(cuda)
    post, pre = torch.rand(4096, generator=g).to(cuda), torch.rand(4096, generator=g).to(cuda)
    c0 = torch.randn(64, 4096, generator=g).to(cuda)
    for combine in (chainmm.COMBINE_NONE, chainmm.COMBINE_SET, chainmm.COMBINE_ADD):
        c1, c2 = c0.clone(), c0.clone()
        z1, a1 = chainmm.chain_sweep_epilogue(y, s, post, pre, c1, combine, True)
        z2, a2 = chainmm.chain_sweep_epilogue_plain(y, s, post, pre, c2, combine, True)
        assert torch.equal(z1, z2) and torch.equal(a1, a2) and torch.equal(c1, c2)


def test_chain_equals_plain_chain(cuda):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype="int8", emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    got = chainmm.fused_chain_resident(adj, x, 3)
    want = chainmm.fused_chain_resident_plain(adj, x, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("want_next", [True, False])
def test_k2_inject_equals_plain(cuda, inject, want_next):
    g = torch.Generator(device="cpu").manual_seed(3)
    y = torch.randn(64, 4096, generator=g).to(cuda)
    s = torch.rand(64, generator=g).to(cuda)
    post, pre = torch.rand(4096, generator=g).to(cuda), torch.rand(4096, generator=g).to(cuda)
    cot = (torch.randn(64, 4096, generator=g) * 1e-3).to(cuda)
    cot0 = cot.clone()
    out1, a1 = chainmm.chain_sweep_inject(y, s, post, pre, cot, inject, want_next)
    out2, a2 = chainmm.chain_sweep_inject_plain(y, s, post, pre, cot, inject, want_next)
    assert torch.equal(out1, out2) and torch.equal(cot, cot0)
    assert (a1 is None and a2 is None) if not want_next else torch.equal(a1, a2)


@pytest.mark.parametrize("batch,n_rows,d,span", [
    (4096, 38048, 64, 38048),   # a training batch's item table
    (2048, 31668, 64, 200),     # heavy duplicates
    (1000, 777, 48, 3),         # nearly every entry a duplicate, d not a power of two
    (1, 5, 64, 5),
])
def test_k4_equals_plain_and_add_at(cuda, batch, n_rows, d, span):
    rng = np.random.default_rng(4)
    idx = rng.integers(0, span, batch)
    vals = rng.normal(size=(batch, d)).astype(np.float32)
    want_np = np.zeros((n_rows, d), np.float32)
    np.add.at(want_np, idx, vals)
    idx_t, vals_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    before = scatter.scatter_add_rows.launches
    got = scatter.scatter_add_rows(idx_t, vals_t, n_rows)
    assert scatter.scatter_add_rows.launches == before + 1
    assert torch.equal(got, scatter.scatter_add_rows_plain(idx_t, vals_t, n_rows))
    np.testing.assert_array_equal(got.cpu().numpy(), want_np)


def test_k4_rejects_what_it_does_not_take(cuda):
    vals = torch.zeros((4, 64), device=cuda)
    with pytest.raises(IndexError):
        scatter.scatter_add_rows(torch.tensor([0, 1, 2, 9], device=cuda), vals, 9)
    with pytest.raises(IndexError):
        scatter.scatter_add_rows(torch.tensor([0, -1, 2, 3], device=cuda), vals, 9)
    with pytest.raises(ValueError):
        scatter.scatter_add_rows(torch.tensor([0, 1, 2, 3], device=cuda, dtype=torch.int32),
                                 vals, 9)
    with pytest.raises(ValueError):
        scatter.scatter_add_rows(torch.tensor([0, 1, 2, 3], device=cuda), vals.T.contiguous().T, 9)


@pytest.mark.parametrize("include_layer0", [True, False])
@pytest.mark.parametrize("layers", [1, 3])
def test_backward_chain_equals_plain_chain(cuda, include_layer0, layers):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype="int8", emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    # a sparse cotangent, as a training batch gives
    cot = torch.zeros(data.num_nodes, 64)
    rows = torch.randint(0, data.num_nodes, (512,), generator=g)
    cot[rows] = torch.randn(512, 64, generator=g) / 512
    cot = cot.to(cuda)
    grads = []
    for fn in (chainmm.fused_chain_resident, chainmm.fused_chain_resident_plain):
        xx = x.clone().requires_grad_(True)
        fn(adj, xx, layers, include_layer0, "mean").backward(cot)
        grads.append(xx.grad)
    assert bool(grads[0].abs().sum() > 0)
    assert torch.equal(grads[0], grads[1])


def test_training_step_gradients_equal_plain_path(cuda, monkeypatch):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = Config({"dataset": "t", "embedding_size": "64", "reg_lambda": "0.0001",
                  "GCN_layer": "3", "compute_dtype": "int8"})
    model = get_model("LightGCN")(cfg, data, device=cuda,
                                  generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device="cpu").manual_seed(5)
    pick = torch.randint(0, data.num_train, (2048,), generator=g).numpy()
    batch = {"user": torch.from_numpy(data.train_user[pick]).to(cuda),
             "pos": torch.from_numpy(data.train_item[pick]).to(cuda),
             "neg": torch.randint(0, data.num_items, (2048,), generator=g).to(cuda)}

    def grads():
        model.zero_grad(set_to_none=True)
        bpr, reg = model.loss_terms(batch)
        (bpr + reg).backward()
        return model.user_emb.grad.clone(), model.item_emb.grad.clone(), bpr.detach(), reg.detach()

    got = grads()
    monkeypatch.setattr(chainmm, "KERNELS", chainmm.PLAIN)
    monkeypatch.setattr(scatter, "scatter_add_rows", scatter.scatter_add_rows_plain)
    want = grads()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _counts(rng, u_pad, i_pad, density, top):
    mask = rng.random((u_pad, i_pad)) < density
    return torch.from_numpy(np.where(mask, rng.integers(1, top + 1, (u_pad, i_pad)), 0)
                            .astype(np.int8))


@pytest.mark.parametrize("u_pad,i_pad,density,top", [
    (3072, 4096, 0.02, 3),      # sparse counts, two tiles, several strips and row shares
    (1024, 2048, 1.0, 7),       # dense at the largest count: no tile is skipped
    (64, 2048, 0.3, 7),         # one chunk
    (2048, 2048, 0.0, 1),       # all zero
    (31744, 38912, 0.001, 1),   # the full shape of the yelp2018-scale matrix
])
def test_k5_equals_plain_and_k1(cuda, u_pad, i_pad, density, top):
    rng = np.random.default_rng(0)
    m = _counts(rng, u_pad, i_pad, density, top).to(cuda)
    m4 = fusedmm.pack_nibbles(m)
    assert m4.shape == (u_pad, i_pad // 2) and torch.equal(fusedmm.unpack_nibbles(m4), m)
    qu, qi = _int8(rng, (64, u_pad)).to(cuda), _int8(rng, (64, i_pad)).to(cuda)
    before = fusedmm.fused_adj_matmul_int4_t.launches
    got = fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)
    assert fusedmm.fused_adj_matmul_int4_t.launches == before + 1
    for a, b, c in zip(got, fusedmm.fused_adj_matmul_int4_t_plain(m4, qu, qi),
                       fusedmm.fused_adj_matmul_int8_t(m, qu, qi)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_k5_unpacks_high_nibbles_above_seven(cuda):
    """A byte whose high nibble is 8..15 is negative as int8: the
    kernel unpacks unsigned, as `unpack_nibbles` does."""
    rng = np.random.default_rng(1)
    m4 = torch.from_numpy(rng.integers(-128, 128, (128, 1024)).astype(np.int8)).to(cuda)
    qu, qi = _int8(rng, (64, 128)).to(cuda), _int8(rng, (64, 2048)).to(cuda)
    for a, b in zip(fusedmm.fused_adj_matmul_int4_t(m4, qu, qi),
                    fusedmm.fused_adj_matmul_int4_t_plain(m4, qu, qi)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "shape", "alignment", "width", "columns", "rows"])
def test_k5_rejects_what_it_does_not_take(cuda, case):
    def z(shape, dtype=torch.int8):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    m4, qu, qi = z((1024, 1024)), z((64, 1024)), z((64, 2048))
    if case == "dtype":
        qu = z((64, 1024), torch.uint8)
    elif case == "shape":
        qi = z((64, 1024))              # the stored, not the logical, column count
    elif case == "alignment":
        qu = z((64 * 1024 + 1,))[1:].view(64, 1024)
    elif case == "width":
        qu, qi = z((32, 1024)), z((32, 2048))
    elif case == "columns":
        m4, qi = z((1024, 512)), z((64, 1024))   # I_pad = 1,024 is not a PACK_TILE multiple
    else:
        m4, qu = z((96, 1024)), z((64, 96))
    with pytest.raises(ValueError):
        fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)


def test_int4_chain_and_gradient_equal_int8(cuda):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj8 = propagate.build_adjacency(data, compute_dtype="int8", emb_size=64, device=cuda)
    adj4 = propagate.build_adjacency(data, compute_dtype="int4", emb_size=64, device=cuda)
    assert adj4.quant == "int4" and adj4.padded_shape == (3072, 6144)
    assert chainmm.supports_chain_resident(adj4, 64, 3, "mean", None)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    cot = (torch.randn(data.num_nodes, 64, generator=g) / 512).to(cuda)
    outs = []
    for adj, fn in ((adj8, chainmm.fused_chain_resident), (adj4, chainmm.fused_chain_resident),
                    (adj4, chainmm.fused_chain_resident_plain)):
        xx = x.clone().requires_grad_(True)
        out = fn(adj, xx, 3)
        out.backward(cot)
        outs.append((out.detach(), xx.grad))
    for out, grad in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(grad, outs[0][1])
