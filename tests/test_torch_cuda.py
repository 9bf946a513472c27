"""Kernels K1-K8 against their plain PyTorch versions on the card.

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
are bit-equal between the kernel path and the plain path. K7's and
K8's raw integer products are equal to their plain versions' and to
K1's and K5's on the transposed activations; repeated
`FusedSquareAdj.matmul` equals the chain's layers bit for bit. K6 agrees
with its plain version within rtol 3e-5 / atol 3e-6 of the largest sum
(identical bfloat16 operands, exact products: only the order of the
float32 additions differs) and gives the same bits on every launch; its
backward against autograd through the plain version within 2**-7
relative to the largest gradient (the kernel rounds the cotangent to
bfloat16 going in, autograd rounds the gradient coming out)."""

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


# ---------------------------------------------------------------------------
# K6, K7, K8: the per-application duals in [N, d] layout


@pytest.mark.parametrize("u_pad,i_pad,density,top,d", [
    (3072, 2048, 0.02, 3, 64),     # sparse counts, several strips and row shares
    (1024, 512, 1.0, 5, 64),       # dense: no tile is skipped
    (64, 256, 0.3, 127, 64),       # one chunk, one strip, the largest counts
    (2048, 1024, 0.0, 1, 64),      # all zero
    (1024, 768, 0.05, 2, 32),      # one group of 32 features
    (2048, 1024, 0.05, 2, 128),    # two groups of 64
    (1024, 512, 0.05, 2, 96),      # three groups of 32
])
def test_k7_equals_plain_and_k1(cuda, u_pad, i_pad, density, top, d):
    rng = np.random.default_rng(0)
    m = _counts(rng, u_pad, i_pad, density, top).to(cuda)
    qu, qi = _int8(rng, (u_pad, d)).to(cuda), _int8(rng, (i_pad, d)).to(cuda)
    before = fusedmm.fused_adj_matmul_int8.launches
    got = fusedmm.fused_adj_matmul_int8(m, qu, qi)
    assert fusedmm.fused_adj_matmul_int8.launches == before + 1
    assert got[0].shape == (u_pad, d) and got[1].shape == (i_pad, d)
    for a, b in zip(got, fusedmm.fused_adj_matmul_int8_plain(m, qu, qi)):
        assert torch.equal(a, b)
    if d == 64:
        k1 = fusedmm.fused_adj_matmul_int8_t(m, qu.T.contiguous(), qi.T.contiguous())
        for a, b in zip(got, k1):
            assert torch.equal(a, b.T)


@pytest.mark.parametrize("u_pad,i_pad,density,top,d", [
    (3072, 4096, 0.02, 3, 64),
    (1024, 2048, 1.0, 7, 64),
    (64, 2048, 0.3, 7, 64),
    (2048, 2048, 0.0, 1, 64),
    (1024, 2048, 0.05, 2, 32),
    (1024, 4096, 0.05, 2, 128),
])
def test_k8_equals_plain_k5_and_k7(cuda, u_pad, i_pad, density, top, d):
    rng = np.random.default_rng(0)
    m = _counts(rng, u_pad, i_pad, density, top).to(cuda)
    m4 = fusedmm.pack_nibbles(m)
    qu, qi = _int8(rng, (u_pad, d)).to(cuda), _int8(rng, (i_pad, d)).to(cuda)
    before = fusedmm.fused_adj_matmul_int4.launches
    got = fusedmm.fused_adj_matmul_int4(m4, qu, qi)
    assert fusedmm.fused_adj_matmul_int4.launches == before + 1
    for a, b, c in zip(got, fusedmm.fused_adj_matmul_int4_plain(m4, qu, qi),
                       fusedmm.fused_adj_matmul_int8(m, qu, qi)):
        assert torch.equal(a, b) and torch.equal(a, c)
    if d == 64:
        k5 = fusedmm.fused_adj_matmul_int4_t(m4, qu.T.contiguous(), qi.T.contiguous())
        for a, b in zip(got, k5):
            assert torch.equal(a, b.T)


def test_k8_unpacks_high_nibbles_above_seven(cuda):
    rng = np.random.default_rng(1)
    m4 = torch.from_numpy(rng.integers(-128, 128, (128, 1024)).astype(np.int8)).to(cuda)
    qu, qi = _int8(rng, (128, 64)).to(cuda), _int8(rng, (2048, 64)).to(cuda)
    for a, b in zip(fusedmm.fused_adj_matmul_int4(m4, qu, qi),
                    fusedmm.fused_adj_matmul_int4_plain(m4, qu, qi)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("u_pad,i_pad,density,top,d,scale", [
    (3072, 2048, 0.02, 3, 64, 1.0),
    (1024, 512, 1.0, 5, 64, 1.0),       # dense: the longest sums
    (64, 256, 0.3, 127, 64, 1e-6),      # cotangent-sized activations
    (2048, 1024, 0.0, 1, 64, 1.0),      # all zero
    (1024, 768, 0.05, 2, 32, 1e3),
    (2048, 1024, 0.05, 2, 128, 1.0),
])
def test_k6_matches_plain_and_repeats_bit_equal(cuda, u_pad, i_pad, density, top, d, scale):
    rng = np.random.default_rng(0)
    m = _counts(rng, u_pad, i_pad, density, top).to(cuda)
    u, i = u_pad - 5, i_pad - 9          # the wrapper pads the activations
    zu = torch.from_numpy((rng.normal(size=(u, d)) * scale).astype(np.float32)).to(cuda)
    zi = torch.from_numpy((rng.normal(size=(i, d)) * scale).astype(np.float32)).to(cuda)
    before = fusedmm.fused_adj_matmul.launches
    got = fusedmm.fused_adj_matmul(m, zu, zi)
    assert fusedmm.fused_adj_matmul.launches == before + 1
    again = fusedmm.fused_adj_matmul(m, zu, zi)
    want = fusedmm.fused_adj_matmul_plain(m, zu, zi)
    assert got[0].shape == (u, d) and got[1].shape == (i, d)
    for a, b, c in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        top_sum = float(c.abs().max())
        torch.testing.assert_close(a, c, rtol=3e-5, atol=3e-6 * max(top_sum, 1e-30))


def test_k6_non_finite_activations_give_nan(cuda):
    m = torch.ones((64, 256), dtype=torch.int8, device=cuda)
    zu = torch.ones((64, 64), device=cuda)
    zi = torch.ones((256, 64), device=cuda)
    zi[3, 5] = float("inf")
    yu, yi = fusedmm.fused_adj_matmul(m, zu, zi)
    assert bool(torch.isnan(yu).all()) and bool(torch.isfinite(yi).all())


def test_k6_backward_is_the_swapped_product(cuda):
    rng = np.random.default_rng(2)
    m = _counts(rng, 2048, 1024, 0.03, 2).to(cuda)
    zu = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda)
    g_yu = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    g_yi = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda)
    grads = []
    for fn in (fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_plain):
        a, b = zu.clone().requires_grad_(True), zi.clone().requires_grad_(True)
        yu, yi = fn(m, a, b)
        torch.autograd.backward([yu, yi], [g_yu, g_yi])
        grads.append((a.grad, b.grad))
    swapped = fusedmm.fused_adj_matmul(m, g_yu, g_yi)
    for got, ref, same in zip(grads[0], grads[1], swapped):
        assert torch.equal(got, same)
        assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@pytest.mark.parametrize("case", ["dtype", "shape", "alignment", "width", "columns", "rows"])
@pytest.mark.parametrize("kernel", ["k6", "k7", "k8"])
def test_n_layout_kernels_reject_what_they_do_not_take(cuda, kernel, case):
    def z(shape, dtype=torch.int8):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    cols = 2048 if kernel == "k8" else 512
    m = z((1024, cols // 2 if kernel == "k8" else cols))
    act = torch.float32 if kernel == "k6" else torch.int8
    au, ai = z((1024, 64), act), z((cols, 64), act)
    if case == "dtype":
        m = m.to(torch.uint8)
    elif case == "shape":
        ai = z((cols // 2, 64), act) if kernel != "k6" else z((cols + 1, 64), act)
    elif case == "alignment":
        if kernel == "k6":
            m = z((1024 * cols + 1,))[1:].view(1024, cols)
        else:
            au = z((1024 * 64 + 1,))[1:].view(1024, 64)
    elif case == "width":
        au, ai = z((1024, 48), act), z((cols, 48), act)
    elif case == "columns":
        bad = 1024 if kernel == "k8" else 384
        m, ai = z((1024, bad // 2 if kernel == "k8" else bad)), z((bad, 64), act)
    else:
        m, au = z((96, m.shape[1])), z((96, 64), act)
    fn = {"k6": fusedmm.fused_adj_matmul, "k7": fusedmm.fused_adj_matmul_int8,
          "k8": fusedmm.fused_adj_matmul_int4}[kernel]
    with pytest.raises((ValueError, RuntimeError)):
        fn(m, au, ai)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_repeated_matmul_equals_the_chain_layers(cuda, dtype):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype=dtype, emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    layers = propagate.fused_chain_t(adj, x, 3, True, None)
    h = x
    for want in layers[1:]:
        h = adj.matmul(h)
        assert torch.equal(h, want)


@pytest.mark.parametrize("backend,dtype", [("fused", "bfloat16"), ("fused", "int8"),
                                           ("fused", "int4"), ("dense", "bfloat16"),
                                           ("dense", "float32"), ("dense", "int8")])
def test_backends_agree_with_gather_on_the_card(cuda, backend, dtype):
    """One application against the float32 gather product: float32
    within 1e-5 of the largest entry, bfloat16 operands within 2**-7,
    int8 activations within 2e-2."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    ref = propagate.build_adjacency(data, "self", "gather", compute_dtype="float32", device=cuda)
    adj = propagate.build_adjacency(data, "self", backend, compute_dtype=dtype, emb_size=64,
                                    device=cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    want, got = ref.matmul(x), adj.matmul(x)
    assert torch.equal(ref.matmul(x), want)      # the sorted segment sum repeats bit-equal
    bar = {"float32": 1e-5, "bfloat16": 2.0 ** -7}.get(dtype, 2e-2)
    assert float((got - want).abs().max()) <= bar * float(want.abs().max())


def test_int8_trains_at_width_128_through_k7(cuda):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = Config({"dataset": "t", "embedding_size": "128", "reg_lambda": "0.0001",
                  "GCN_layer": "2", "compute_dtype": "int8"})
    model = get_model("LightGCN")(cfg, data, device=cuda,
                                  generator=torch.Generator().manual_seed(0))
    assert not chainmm.supports_chain_resident(model.graph, 128, 2, "mean", None)
    g = torch.Generator(device="cpu").manual_seed(5)
    pick = torch.randint(0, data.num_train, (2048,), generator=g).numpy()
    batch = {"user": torch.from_numpy(data.train_user[pick]).to(cuda),
             "pos": torch.from_numpy(data.train_item[pick]).to(cuda),
             "neg": torch.randint(0, data.num_items, (2048,), generator=g).to(cuda)}
    before = fusedmm.fused_adj_matmul_int8.launches
    bpr, reg = model.loss_terms(batch)
    (bpr + reg).backward()
    assert fusedmm.fused_adj_matmul_int8.launches == before + 4   # 2 layers, forward and backward
    assert bool(torch.isfinite(model.user_emb.grad).all())
    assert bool(model.item_emb.grad.abs().sum() > 0)
