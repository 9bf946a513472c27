"""Kernels K1-K4 against their plain PyTorch versions on the card.

These need an NVIDIA GPU with nvcc (the kernels build at first use);
without one they skip with a reason. Run them on the card with
``python -m pytest tests/test_torch_cuda.py``.

Tolerances: K1's raw integer products are equal; K3 and K2 are
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
