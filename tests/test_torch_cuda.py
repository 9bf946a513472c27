"""Kernels K1-K13 against their plain PyTorch versions on the card.

These need an NVIDIA GPU with nvcc (the kernels build at first use);
without one they skip with a reason. Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: K1's and K5's raw integer products are equal to their plain
versions', K1's to K7's on the transposed activations and across two
launches, and K5's to K1's on the unpacked matrix and across two
launches; the chain's sweeps (K1 or K5 with K2's epilogue in the
turn-out, forward and inject) are bit-equal to the dual followed by two
K2 launches and to their plain versions, non-finite inputs included;
all four sweeps on the previous sweep's (z, amax), rounded in the
turn-in, are bit-equal to K3 on each input followed by the sweep on
(q, s), zero inputs and non-finite amax included, and to their plain
versions where all stays finite; no chain of a path launches K3;
the int4 chain and its gradient are bit-equal to the int8 chain's; K3 and K2 are
bit-equal (IEEE division, round-half-even, no FMA contraction, an
order-free max), K2's inject mode too; K4 is bit-equal (no atomics:
duplicates are added in batch order); the 3-sweep chain and its
straight-through backward chain are bit-equal to the plain chains built
from the same operations; the gradients of one training step's loss
are bit-equal between the kernel path and the plain path. K7's and
K8's raw integer products are equal to their plain versions' and to
K1's and K5's on the transposed activations, K8's to K7's on the
unpacked matrix at every feature group, each across two launches;
repeated `FusedSquareAdj.matmul` equals the chain's layers bit for bit.
K6 agrees with its plain version within rtol 3e-5 / atol 3e-6 of the largest sum
(identical bfloat16 operands, exact products each rounded once to 64-bit
fixed point, integer sums: far below that bar) and gives the same bits
on every launch; its
backward against autograd through the plain version within 2**-7
relative to the largest gradient (the kernel rounds the cotangent to
bfloat16 going in, autograd rounds the gradient coming out). K9 and K10
are bit-equal to their plain versions (the CUDA math library's tanhf is
PyTorch's tanh on the card; no FMA contraction), and so are the tanh
chain with and without the seed sweep, forward and backward, and one
EGCF training step; the forward also equals `fused_chain_t`'s. K11 (the
bit-packed product), K12 and K13 (the batch-row partial product and its
backward) agree with their plain versions within rtol 3e-5 / atol 3e-6
of the largest sum (the same exact products, float32 sums in another
order) and give the same bits on every launch; K11 agrees with K6 on the
same binary matrix within the same bar. K11 one direction a call
(`bitmm.bit_rect_matmul`, forward and backward) is bit-equal to the K11
wrapper on each packing; the int8 product on `torch._int_mm` (the
rectangular adjacency's) equals the exact int32 sums in both directions;
the rectangular adjacency on the card matches its CPU twin: int8 bit for
bit, the other backends within the bar above. The dense backend's
bfloat16 products (K6) equal the fused backend's bit for bit, forward and
backward, and its int8 products (K7) equal the exact route they replaced;
K6 at d = 192 reads M three times and stays within its bar; each zoo
model's training step, and the steps' draws on a CUDA generator, run
with no synchronisation; NCL's k-means with its sums on K4 equals the
same clustering with K4's plain version bit for bit, without a
synchronisation. NGCF, GCMC, GCCF, LightGODE and RecDCL (its histories
too) take a step on K6 within K6's bars of the same step on K6's plain
version, and another under sync debug mode "error", as NGCF's node
dropout on the gather backend does; K6 at d = 2,048 (RecDCL's width)
reads M sixteen times and stays within its bar. K6 with one side left out
(the rectangular adjacency's direction) stays within its bar of the plain
version and gives the bits of the same side of the two-sided launch;
`DenseRectAdj.matmul_both` gives the bits of its two one-direction calls
in one launch; LightGCL's and CVGA's steps on K6 stay within K6's bars of
the same steps on the plain version, without a synchronisation."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from idgrec_torch.data.dataset import make_synthetic_dataset
from idgrec_torch.config import Config
from idgrec_torch.models import get_model
from idgrec_torch.ops import bitmm, chainmm, fusedmm, gathermm, propagate, scatter

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _int8(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


@pytest.mark.parametrize("u_pad,i_pad,density,top", [
    (3072, 2048, 0.02, 3),      # sparse counts, several row blocks of the turns
    (1024, 512, 1.0, 5),        # dense: every entry taken
    (64, 256, 0.3, 127),        # one row block, the largest counts
    (2048, 1024, 0.0, 1),       # all zero
    (1024, 512, 1.0, None),     # every entry 127: the longest sums
])
def test_k1_equals_plain(cuda, u_pad, i_pad, density, top):
    """K1 (the scan with the layout turned at both edges) equals its
    plain version and K7 on the transposed activations, and a second
    launch gives the same bits."""
    rng = np.random.default_rng(0)
    if top is None:
        m = torch.full((u_pad, i_pad), 127, dtype=torch.int8, device=cuda)
    else:
        mask = rng.random((u_pad, i_pad)) < density
        m = torch.from_numpy(np.where(mask, rng.integers(1, top + 1, (u_pad, i_pad)), 0)
                             .astype(np.int8)).to(cuda)
    qu, qi = _int8(rng, (64, u_pad)).to(cuda), _int8(rng, (64, i_pad)).to(cuda)
    before = fusedmm.fused_adj_matmul_int8_t.launches
    got = fusedmm.fused_adj_matmul_int8_t(m, qu, qi)
    again = fusedmm.fused_adj_matmul_int8_t(m, qu, qi)
    assert fusedmm.fused_adj_matmul_int8_t.launches == before + 2
    want = fusedmm.fused_adj_matmul_int8_t_plain(m, qu, qi)
    k7 = fusedmm.fused_adj_matmul_int8(m, qu.T.contiguous(), qi.T.contiguous())
    for a, b, c, e in zip(got, again, want, k7):
        assert a.shape == c.shape and a.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, c) and torch.equal(a, e.T)


def test_k1_does_not_synchronise(cuda):
    """A K1 call (allocations, checks, three launches) issues no
    synchronisation with the host."""
    rng = np.random.default_rng(3)
    m = _counts(rng, 2048, 1024, 0.05, 3).to(cuda)
    qu, qi = _int8(rng, (64, 2048)).to(cuda), _int8(rng, (64, 1024)).to(cuda)
    fusedmm.fused_adj_matmul_int8_t(m, qu, qi)  # built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fusedmm.fused_adj_matmul_int8_t(m, qu, qi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, fusedmm.fused_adj_matmul_int8_t_plain(m, qu, qi)):
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
    (10000, 38048, 64, 3000),   # several rounds of the link kernel
    (9000, 50, 16, 5),          # hot rows past one 4,096-position bitmap window
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


@pytest.mark.parametrize("d", [1, 63, 64, 128])
@pytest.mark.parametrize("case", ["one_row", "sampled", "hot_rows"])
def test_k4_step_shapes_equal_plain(cuda, case, d):
    """B = 4,096 into 38,048 rows: every entry one row (the hot-row
    bitmap), a sampled batch (short buckets), and rows with 33-40 entries
    beside single ones (both paths in one launch)."""
    rng = np.random.default_rng(5)
    n_rows, batch = 38048, 4096
    if case == "one_row":
        idx = np.full(batch, 12345)
    elif case == "sampled":
        idx = rng.integers(0, n_rows, batch)
        idx[rng.integers(0, batch, 600)] = rng.integers(0, 50, 600)
    else:
        idx = rng.integers(0, n_rows, batch)
        for r, c in ((7, 33), (n_rows - 1, 40), (2024, 32)):
            idx[rng.choice(batch, c, replace=False)] = r
    vals = rng.normal(size=(batch, d)).astype(np.float32)
    idx_t, vals_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(vals).to(cuda)
    got = scatter.scatter_add_rows(idx_t, vals_t, n_rows)
    assert torch.equal(got, scatter.scatter_add_rows_plain(idx_t, vals_t, n_rows))
    want_np = np.zeros((n_rows, d), np.float32)
    np.add.at(want_np, idx, vals)
    np.testing.assert_array_equal(got.cpu().numpy(), want_np)


def test_k4_empty_batch_and_repeats_bit_for_bit(cuda):
    empty = scatter.scatter_add_rows(torch.zeros(0, dtype=torch.int64, device=cuda),
                                     torch.zeros((0, 64), device=cuda), 31668)
    assert tuple(empty.shape) == (31668, 64) and not bool(empty.any())
    rng = np.random.default_rng(6)
    idx = torch.from_numpy(rng.integers(0, 300, 4096)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(cuda)
    first = scatter.scatter_add_rows(idx, vals, 38048)
    again = scatter.scatter_add_rows_unchecked(idx, vals, 38048)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("nu,ni", [(31668, 38048), (5000, 5000)])
def test_k4_step_tables_equal_plain(cuda, nu, ni):
    """The step's entry as the gathers' backward calls it: the user table,
    then the item table on the positives and negatives concatenated, one
    launch each, equal to the plain version over two rounds."""
    rng = np.random.default_rng(7)
    u = torch.from_numpy(rng.integers(0, 300, 2048)).to(cuda)
    p, n = (torch.from_numpy(rng.integers(0, 500, 2048)).to(cuda) for _ in range(2))
    gu, gp, gn = (torch.from_numpy(rng.normal(size=(2048, 64)).astype(np.float32)).to(cuda)
                  for _ in range(3))
    for _ in range(2):
        before = scatter.scatter_add_rows.launches
        got_u = scatter.scatter_add_rows_unchecked(u, gu, nu)
        got_i = scatter.scatter_add_rows_unchecked(torch.cat([p, n]), torch.cat([gp, gn]), ni)
        assert scatter.scatter_add_rows.launches == before + 2
        want_i = scatter.scatter_add_rows_plain(torch.cat([p, n]), torch.cat([gp, gn]), ni)
        assert torch.equal(got_i.view(torch.int32), want_i.view(torch.int32))
        want_u = scatter.scatter_add_rows_plain(u, gu, nu)
        assert torch.equal(got_u.view(torch.int32), want_u.view(torch.int32))


def test_gather_backward_reads_nothing_back(cuda):
    """The training step's backward through the batch gathers issues no
    synchronisation: the step's K4 entry does not check the range."""
    rng = np.random.default_rng(8)
    ua = torch.from_numpy(rng.normal(size=(31668, 64)).astype(np.float32)).to(cuda)
    ia = torch.from_numpy(rng.normal(size=(38048, 64)).astype(np.float32)).to(cuda)
    ua.requires_grad_(True)
    ia.requires_grad_(True)
    batch = {"user": torch.from_numpy(rng.integers(0, 31668, 2048)).to(cuda),
             "pos": torch.from_numpy(rng.integers(0, 38048, 2048)).to(cuda),
             "neg": torch.from_numpy(rng.integers(0, 38048, 2048)).to(cuda)}
    from idgrec_torch.models import base

    ue, pe, ne = base.batch_final_embeddings(ua, ia, batch, "int8")
    loss = (ue * (pe - ne)).sum()
    before = scatter.scatter_add_rows.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert scatter.scatter_add_rows.launches == before + 2
    du = np.zeros((31668, 64), np.float32)
    np.add.at(du, batch["user"].cpu().numpy(), (pe - ne).detach().cpu().numpy())
    np.testing.assert_array_equal(ua.grad.cpu().numpy(), du)


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

    k3_before = propagate.quantize_rows.launches
    got = grads()
    # the chain's sweeps round their inputs in the turn-in: no K3 launch a step
    assert propagate.quantize_rows.launches == k3_before
    monkeypatch.setattr(chainmm, "KERNELS", chainmm.PLAIN)
    monkeypatch.setattr(scatter, "scatter_add_rows", scatter.scatter_add_rows_plain)
    monkeypatch.setattr(scatter, "scatter_add_rows_unchecked", scatter.scatter_add_rows_plain)
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


@pytest.mark.parametrize("kind,u_pad,i_pad", [
    ("dense15", 64, 2048),      # every nibble 15 (both of every byte), the smallest shape
    ("zeros", 64, 2048),        # nothing to take
    ("dense15", 1024, 4096),    # fully dense over several turn blocks and K2 blocks
    ("high_only", 2048, 4096),  # counts 8..15 in the high nibbles only (the top bit set)
    ("random", 3072, 6144),     # sparse counts 1..15
])
def test_k5_edges_repeat_and_equal_k1(cuda, kind, u_pad, i_pad):
    """K5 (K1's turns around K8's scan of the packed bytes) on the
    design's edges: equal to its plain version and to K1 on the
    unpacked matrix, the same bits on a second launch."""
    rng = np.random.default_rng(12)
    if kind == "dense15":
        m = torch.full((u_pad, i_pad), 15, dtype=torch.int8)
    elif kind == "zeros":
        m = torch.zeros((u_pad, i_pad), dtype=torch.int8)
    elif kind == "high_only":
        m = _counts(rng, u_pad, i_pad, 0.2, 8) + 7
        m = m * (m > 7)
        m.view(u_pad, -1, 2, fusedmm.PACK_TILE // 2)[:, :, 0, :] = 0
    else:
        m = _counts(rng, u_pad, i_pad, 0.01, 15)
    m = m.to(cuda)
    m4 = _pack15(m)
    qu, qi = _int8(rng, (64, u_pad)).to(cuda), _int8(rng, (64, i_pad)).to(cuda)
    got = fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)
    again = fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)
    for a, b, c, e in zip(got, again, fusedmm.fused_adj_matmul_int4_t_plain(m4, qu, qi),
                          fusedmm.fused_adj_matmul_int8_t(m, qu, qi)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, c) and torch.equal(a, e)


def test_k5_does_not_synchronise(cuda):
    rng = np.random.default_rng(13)
    m4 = fusedmm.pack_nibbles(_counts(rng, 2048, 2048, 0.05, 3).to(cuda))
    qu, qi = _int8(rng, (64, 2048)).to(cuda), _int8(rng, (64, 2048)).to(cuda)
    fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)  # built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fusedmm.fused_adj_matmul_int4_t(m4, qu, qi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, fusedmm.fused_adj_matmul_int4_t_plain(m4, qu, qi)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the chain's sweep: K1 or K5 with K2's epilogue in the turn-out


def _sweep_inputs(cuda, quant, seed, u_pad=3072, i_pad=4096):
    """A sweep's operands: the stored matrix, K3's quantized inputs and
    scales, (user, item) post and pre vectors (zero past the real nodes,
    as the chain pads them) and [d, N] combines or cotangents."""
    rng = np.random.default_rng(seed)
    m = _counts(rng, u_pad, i_pad, 0.02, 3).to(cuda)
    stored = fusedmm.pack_nibbles(m) if quant == "int4" else m
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = []
    for n in (u_pad, i_pad):
        z = (torch.randn(64, n, generator=g) * 0.3).to(cuda)
        q.append(propagate.quantize_rows(z, z.abs().amax(dim=1)))
    (qu, su), (qi, si) = q
    post, pre, ext = [], [], []
    for n, real in ((u_pad, u_pad - 100), (i_pad, i_pad - 1100)):
        vec = torch.rand(2, n, generator=g)
        vec[:, real:] = 0.0
        post.append(vec[0].to(cuda))
        pre.append(vec[1].to(cuda))
        ext.append((torch.randn(64, n, generator=g) * 1e-2).to(cuda))
    return stored, qu, su, qi, si, tuple(post), tuple(pre), tuple(ext)


def _separate_sweep(quant, m, qu, su, qi, si, post, pre, ext, flag, want_next, inject):
    """The route the fused sweep replaced: the dual kernel, then K2 (or
    its inject mode) on each side."""
    dual = fusedmm.fused_adj_matmul_int8_t if quant == "int8" else fusedmm.fused_adj_matmul_int4_t
    ys = dual(m, qu, qi)
    out = []
    for y, s_, k in ((ys[0], si, 0), (ys[1], su, 1)):
        if inject:
            out += chainmm.chain_sweep_inject(y, s_[:, 0], post[k], pre[k], ext[k], flag,
                                              want_next)
        else:
            out += chainmm.chain_sweep_epilogue(y, s_[:, 0], post[k], pre[k], ext[k], flag,
                                                want_next)
    return out


def _same(a, b):
    return (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("combine", [chainmm.COMBINE_NONE, chainmm.COMBINE_SET,
                                     chainmm.COMBINE_ADD])
@pytest.mark.parametrize("want_next", [True, False])
def test_dual_sweep_equals_separate_route(cuda, quant, combine, want_next):
    """The forward sweep with K2's epilogue in the dual's turn-out equals
    the dual followed by two K2 launches and its plain version, bit for
    bit (z, the combine, amax); it counts one dual launch and no K2."""
    m, qu, su, qi, si, post, pre, c0 = _sweep_inputs(cuda, quant, 21)
    dual = fusedmm.fused_adj_matmul_int8_t if quant == "int8" else fusedmm.fused_adj_matmul_int4_t
    c_f, c_s, c_p = ([t.clone() for t in c0] for _ in range(3))
    before = (dual.launches, chainmm.dual_sweep.launches, chainmm.chain_sweep_epilogue.launches)
    got = chainmm.dual_sweep(quant, m, qu, su, qi, si, post, pre, c_f, combine, want_next)
    assert (dual.launches, chainmm.dual_sweep.launches,
            chainmm.chain_sweep_epilogue.launches) == (before[0] + 1, before[1] + 1, before[2])
    sep = _separate_sweep(quant, m, qu, su, qi, si, post, pre, c_s, combine, want_next, False)
    plain = chainmm.dual_sweep_plain(quant, m, qu, su, qi, si, post, pre, c_p, combine,
                                     want_next)
    for a, b, c in zip(got, sep, plain):
        assert _same(a, b) and _same(a, c)
    for a, b, c in zip(c_f, c_s, c_p):
        assert _same(a, b) and _same(a, c)
    if want_next:
        assert bool(got[1].gt(0).all()) and bool(got[3].gt(0).all())


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("inject,want_next", [(True, True), (True, False), (False, False),
                                              (False, True)])
def test_dual_sweep_inject_equals_separate_route(cuda, quant, inject, want_next):
    """The backward sweep with K2's inject mode in the turn-out equals
    the dual followed by two inject launches and its plain version, bit
    for bit; the cotangent is read only."""
    m, qu, su, qi, si, post, pre, g0 = _sweep_inputs(cuda, quant, 22)
    g = tuple(t.clone() for t in g0)
    before = chainmm.chain_sweep_inject.launches
    got = chainmm.dual_sweep_inject(quant, m, qu, su, qi, si, post, pre, g, inject, want_next)
    assert chainmm.chain_sweep_inject.launches == before
    sep = _separate_sweep(quant, m, qu, su, qi, si, post, pre, g, inject, want_next, True)
    plain = chainmm.dual_sweep_inject_plain(quant, m, qu, su, qi, si, post, pre, g, inject,
                                            want_next)
    for a, b, c in zip(got, sep, plain):
        assert _same(a, b) and _same(a, c)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["inf_scale", "nan_scale", "nan_block", "nan_tail"])
@pytest.mark.parametrize("inject", [False, True])
def test_dual_sweep_non_finite_equals_separate_route(cuda, quant, case, inject):
    """A non-finite activation gives what the separate route gives, bit
    for bit: an infinite scale (its feature's products inf, and NaN
    where a sum is 0), a NaN scale, and NaN cotangents or combines over
    one whole K2 block of 1,024 nodes or over the user side's last,
    partial block. The amax is NaN only where K2's is."""
    m, qu, su, qi, si, post, pre, e0 = _sweep_inputs(cuda, quant, 23, 2560, 6144)
    su, si = su.clone(), si.clone()
    e0 = tuple(t.clone() for t in e0)
    if case == "inf_scale":
        si[5] = float("inf")
        su[9] = float("inf")
    elif case == "nan_scale":
        si[3] = float("nan")
    elif case == "nan_block":
        e0[0][7, 1024:2048] = float("nan")
        e0[1][11, :1024] = float("nan")
    else:
        e0[0][13, 2048:] = float("nan")
    fused = chainmm.dual_sweep_inject if inject else chainmm.dual_sweep
    flag = True if inject else chainmm.COMBINE_ADD
    e_f, e_s = [t.clone() for t in e0], [t.clone() for t in e0]
    got = fused(quant, m, qu, su, qi, si, post, pre, e_f, flag, True)
    sep = _separate_sweep(quant, m, qu, su, qi, si, post, pre, e_s, flag, True, inject)
    for a, b in zip(list(got) + e_f, sep + e_s):
        assert _same(a, b)
    if case in ("inf_scale", "nan_scale") or (inject and case == "nan_block"):
        assert not bool(torch.isfinite(torch.cat([got[1], got[3]])).all())


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_chain_forward_and_backward_do_not_synchronise(cuda, quant):
    """One chain forward and backward (the fused sweeps, K2 for the
    prologues) issues no synchronisation with the host; K2 runs only in
    the two prologues, its inject mode never standalone, and K3 never
    standalone: every sweep rounds its two inputs in the turn-in."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype=quant, emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(4)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5).to(cuda)
    cot = (torch.randn(data.num_nodes, 64, generator=g) / 512).to(cuda)
    xx = x.clone().requires_grad_(True)
    chainmm.fused_chain_resident(adj, xx, 3).backward(cot)  # built and loaded outside the check
    counters = (chainmm.chain_sweep_epilogue, chainmm.chain_sweep_inject, chainmm.dual_sweep,
                chainmm.dual_sweep_inject, propagate.quantize_rows)
    before = [fn.launches for fn in counters]
    rounded = [fn.quantized_in_sweep for fn in counters[2:4]]
    xk = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chainmm.fused_chain_resident(adj, xk, 3).backward(cot)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [fn.launches - b for fn, b in zip(counters, before)] == [4, 0, 3, 3, 0]
    assert [fn.quantized_in_sweep - b for fn, b in zip(counters[2:4], rounded)] == [6, 6]
    assert torch.equal(xk.grad, xx.grad)


# ---------------------------------------------------------------------------
# the tanh chain's sweep: K1 or K5 with K9's or K10's epilogue in the
# turn-out, each side with its own next input, or left out


def _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, ext, hs, flag, want_next, inject,
                         sides=(True, True)):
    """The route the fused tanh sweep replaced: the dual kernel, then K9
    (or K10) on each side that runs."""
    dual = fusedmm.fused_adj_matmul_int8_t if quant == "int8" else fusedmm.fused_adj_matmul_int4_t
    ys = dual(m, qu, qi)
    want_next = want_next if isinstance(want_next, tuple) else (want_next,) * 2
    out = []
    for y, s_, k in ((ys[0], si, 0), (ys[1], su, 1)):
        if not sides[k]:
            out += [None, None]
        elif inject:
            out += chainmm.chain_sweep_tanh_inject(y, s_[:, 0], post[k], pre[k], ext[k], hs[k],
                                                   flag, want_next[k])
        else:
            out += chainmm.chain_sweep_tanh(y, s_[:, 0], post[k], pre[k], ext[k], hs[k], flag,
                                            want_next[k])
    return out


def _tanh_h(cuda, seed, u_pad, i_pad):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.tanh(torch.randn(64, n, generator=g)).to(cuda) for n in (u_pad, i_pad))


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("combine", [chainmm.COMBINE_NONE, chainmm.COMBINE_SET,
                                     chainmm.COMBINE_ADD])
@pytest.mark.parametrize("want_next", [True, False])
def test_dual_sweep_tanh_equals_separate_route(cuda, quant, combine, want_next):
    """The forward tanh sweep with K9's epilogue in the dual's turn-out
    equals the dual followed by two K9 launches and its plain version,
    bit for bit (z, the combine, the h slices, amax); the h slice is
    torch.tanh's; it counts one dual launch and no K9."""
    m, qu, su, qi, si, post, pre, c0 = _sweep_inputs(cuda, quant, 31)
    dual = fusedmm.fused_adj_matmul_int8_t if quant == "int8" else fusedmm.fused_adj_matmul_int4_t
    c_f, c_s, c_p = ([t.clone() for t in c0] for _ in range(3))
    h_f, h_s, h_p = ([torch.full_like(t, float("nan")) for t in c0] for _ in range(3))
    before = (dual.launches, chainmm.dual_sweep_tanh.launches, chainmm.chain_sweep_tanh.launches)
    got = chainmm.dual_sweep_tanh(quant, m, qu, su, qi, si, post, pre, c_f, combine, want_next,
                                  h_f)
    assert (dual.launches, chainmm.dual_sweep_tanh.launches,
            chainmm.chain_sweep_tanh.launches) == (before[0] + 1, before[1] + 1, before[2])
    sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, c_s, h_s, combine,
                               want_next, False)
    plain = chainmm.dual_sweep_tanh.plain(quant, m, qu, su, qi, si, post, pre, c_p, combine,
                                          want_next, h_p)
    for a, b, c in zip(list(got) + c_f + h_f, sep + c_s + h_s, list(plain) + c_p + h_p):
        assert _same(a, b) and _same(a, c)
    yu = (fusedmm.fused_adj_matmul_int8_t_plain if quant == "int8"
          else fusedmm.fused_adj_matmul_int4_t_plain)(m, qu, qi)[0]
    assert torch.equal(h_f[0], torch.tanh(post[0][None, :] * (yu * si)))
    if want_next:
        assert bool(got[1].gt(0).all()) and bool(got[3].gt(0).all())


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("inject,want_next", [(True, True), (True, False), (False, False),
                                              (False, True)])
def test_dual_sweep_tanh_inject_equals_separate_route(cuda, quant, inject, want_next):
    """The backward tanh sweep with K10's epilogue in the turn-out equals
    the dual followed by two K10 launches and its plain version, bit for
    bit; the cotangent and h are read only."""
    m, qu, su, qi, si, post, pre, g0 = _sweep_inputs(cuda, quant, 32)
    h = _tanh_h(cuda, 32, *(t.shape[1] for t in g0))
    h_arg = h if want_next else (None, None)
    g = tuple(t.clone() for t in g0)
    before = chainmm.chain_sweep_tanh_inject.launches
    got = chainmm.dual_sweep_tanh_inject(quant, m, qu, su, qi, si, post, pre, g, inject,
                                         want_next, h_arg)
    assert chainmm.chain_sweep_tanh_inject.launches == before
    sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, g, h_arg, inject, want_next,
                               True)
    plain = chainmm.dual_sweep_tanh_inject.plain(quant, m, qu, su, qi, si, post, pre, g, inject,
                                                 want_next, h_arg)
    for a, b, c in zip(got, sep, plain):
        assert _same(a, b) and _same(a, c)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["forward_users_alone", "users_next_alone", "items_alone"])
def test_tanh_seed_sweeps_per_side(cuda, quant, case):
    """EGCF's seed sweeps: the forward's seed sweep runs the user side
    alone; the backward's sweep K − 1 wants the users' next input alone;
    its sweep K runs the item side alone. Each equals the separate route
    bit for bit; a side left out writes nothing (the forward's item
    combine and h slice keep their contents)."""
    m, qu, su, qi, si, post, pre, e0 = _sweep_inputs(cuda, quant, 33, 2560, 6144)
    h = _tanh_h(cuda, 33, 2560, 6144)
    e_f, e_s = [t.clone() for t in e0], [t.clone() for t in e0]
    if case == "forward_users_alone":
        h_f, h_s = ([torch.full_like(t, float("nan")) for t in e0] for _ in range(2))
        args = (chainmm.COMBINE_NONE, True, (True, False))
        got = chainmm.dual_sweep_tanh(quant, m, qu, su, qi, si, post, pre, e_f, *args[:2], h_f,
                                      args[2])
        sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, e_s, h_s, *args[:2],
                                   False, args[2])
        assert bool(h_f[1].isnan().all()) and torch.equal(e_f[1], e0[1])
        outs = list(got) + e_f + h_f[:1], sep + e_s + h_s[:1]
    else:
        if case == "users_next_alone":
            args = ((h[0], None), False, (True, False), (True, True))
        else:
            args = ((None, None), True, False, (False, True))
        got = chainmm.dual_sweep_tanh_inject(quant, m, qu, su, qi, si, post, pre, e_f, *args[1:3],
                                             args[0], args[3])
        sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, e_s, *args[:3], True,
                                   args[3])
        outs = list(got), sep
    for a, b in zip(*outs):
        assert _same(a, b)
    users, items = case != "items_alone", case != "forward_users_alone"
    assert (got[0] is not None, got[1] is not None, got[2] is not None, got[3]) == (
        users, users, items, None)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["inf_scale", "nan_scale", "nan_block", "nan_tail"])
@pytest.mark.parametrize("inject", [False, True])
def test_dual_sweep_tanh_non_finite_equals_separate_route(cuda, quant, case, inject):
    """A non-finite input gives what the separate route (the dual, then
    K9 or K10 on each side) gives, bit for bit: an infinite scale, a NaN
    scale, and NaN combines, cotangents or forward outputs h over one
    whole block of 1,024 nodes or over the user side's last, partial
    block. The amax is NaN only where K9's or K10's is."""
    m, qu, su, qi, si, post, pre, e0 = _sweep_inputs(cuda, quant, 34, 2560, 6144)
    h0 = _tanh_h(cuda, 34, 2560, 6144)
    su, si = su.clone(), si.clone()
    e0, h0 = tuple(t.clone() for t in e0), tuple(t.clone() for t in h0)
    if case == "inf_scale":
        si[5] = float("inf")
        su[9] = float("inf")
    elif case == "nan_scale":
        si[3] = float("nan")
    elif case == "nan_block":
        e0[0][7, 1024:2048] = float("nan")
        e0[1][11, :1024] = float("nan")
        h0[1][17, 2048:3072] = float("nan")
    else:
        e0[0][13, 2048:] = float("nan")
        h0[0][19, 2048:] = float("nan")
    e_f, e_s = [t.clone() for t in e0], [t.clone() for t in e0]
    if inject:
        got = chainmm.dual_sweep_tanh_inject(quant, m, qu, su, qi, si, post, pre, e_f, True, True,
                                             h0)
        sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, e_s, h0, True, True, True)
        outs = list(got) + e_f, sep + e_s
    else:
        h_f, h_s = ([torch.empty_like(t) for t in e0] for _ in range(2))
        got = chainmm.dual_sweep_tanh(quant, m, qu, su, qi, si, post, pre, e_f,
                                      chainmm.COMBINE_ADD, True, h_f)
        sep = _separate_tanh_sweep(quant, m, qu, su, qi, si, post, pre, e_s, h_s,
                                   chainmm.COMBINE_ADD, True, False)
        outs = list(got) + e_f + h_f, sep + e_s + h_s
    for a, b in zip(*outs):
        assert _same(a, b)
    # tanh bounds the forward's z; the backward's store is unbounded
    if case == "nan_scale" or (inject and case in ("inf_scale", "nan_block")):
        assert not bool(torch.isfinite(torch.cat([got[1], got[3]])).all())


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tanh_chain_forward_and_backward_do_not_synchronise(cuda, quant):
    """One tanh + seed chain forward and backward issues no
    synchronisation with the host; no K9 runs, K10 only in the
    backward's two prologue calls, no K3, every sweep fused. The sweeps'
    sides are as many as the separate route's K9 and K10 launches: the
    seed sweeps run one side. The turn-ins round 7 inputs each way: the
    seed sweeps take a zero input, and the forward's sweep 1 rounds the
    seed's item input again."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype=quant, emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(4)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5)
    x[: data.num_users] = 0.0
    x = x.to(cuda)
    cot = (torch.randn(data.num_nodes, 64, generator=g) / 512).to(cuda)

    def run(xx):
        return chainmm.fused_chain_resident(adj, xx, 3, False, "sum", torch.tanh, True)

    xx = x.clone().requires_grad_(True)
    run(xx).backward(cot)  # built and loaded outside the check
    counters = (chainmm.chain_sweep_tanh, chainmm.chain_sweep_tanh_inject,
                chainmm.dual_sweep_tanh, chainmm.dual_sweep_tanh_inject)
    before = [fn.launches for fn in counters]
    sides_before = [fn.sides_run for fn in counters[2:]]
    rounded = [fn.quantized_in_sweep for fn in counters[2:]]
    k3_before = propagate.quantize_rows.launches
    xk = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run(xk)
        forward = [fn.launches - b for fn, b in zip(counters, before)]
        out.backward(cot)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert forward == [0, 0, 4, 0]
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 2, 4, 4]
    assert [fn.sides_run - b for fn, b in zip(counters[2:], sides_before)] == [7, 7]
    assert [fn.quantized_in_sweep - b for fn, b in zip(counters[2:], rounded)] == [7, 7]
    assert propagate.quantize_rows.launches == k3_before
    assert torch.equal(xk.grad, xx.grad)


# ---------------------------------------------------------------------------
# the sweeps on the previous sweep's (z, amax): K3's rounding in the turn-in

_KINDS = {"forward": (chainmm.dual_sweep, (chainmm.COMBINE_NONE, chainmm.COMBINE_SET,
                                           chainmm.COMBINE_ADD)),
          "inject": (chainmm.dual_sweep_inject, (False, True)),
          "tanh": (chainmm.dual_sweep_tanh, (chainmm.COMBINE_NONE, chainmm.COMBINE_SET,
                                             chainmm.COMBINE_ADD)),
          "tanh_inject": (chainmm.dual_sweep_tanh_inject, (False, True))}


def _z_inputs(cuda, quant, seed, u_pad=3072, i_pad=4096):
    """A sweep's operands with float32 inputs: the stored matrix, each
    side's z [64, n] (zero past the real nodes, as the chain pads it)
    with its amax, (user, item) post and pre vectors, [64, n] combines or
    cotangents, and tanh outputs for the backward's h."""
    rng = np.random.default_rng(seed)
    m = _counts(rng, u_pad, i_pad, 0.02, 3).to(cuda)
    stored = fusedmm.pack_nibbles(m) if quant == "int4" else m
    g = torch.Generator(device="cpu").manual_seed(seed)
    zs, post, pre, ext = [], [], [], []
    for n, real in ((u_pad, u_pad - 100), (i_pad, i_pad - 1100)):
        z = torch.randn(64, n, generator=g) * 0.3
        z[:, real:] = 0.0
        zs.append((z.to(cuda), z.abs().amax(dim=1).to(cuda)))
        vec = torch.rand(2, n, generator=g)
        vec[:, real:] = 0.0
        post.append(vec[0].to(cuda))
        pre.append(vec[1].to(cuda))
        ext.append((torch.randn(64, n, generator=g) * 1e-2).to(cuda))
    return stored, zs, tuple(post), tuple(pre), tuple(ext), _tanh_h(cuda, seed, u_pad, i_pad)


def _quantizing_routes(kind, quant, m, inputs, post, pre, ext0, h0, flag, want_next,
                       sides=(True, True), plain=True):
    """One sweep on (z, amax) inputs (None for a zero input) three ways,
    bit for bit: fused (the rounding in the dual's turn-in), separate
    (K3 on each z input, then the sweep on (q, s)) and, where ``plain``,
    its plain version. The fused call launches no K3 and counts its z
    inputs in ``quantized_in_sweep``; the separate route launches K3 once
    per z input. Returns the fused outputs, then the combines or
    cotangents, then (tanh) the h slices."""
    sweep = _KINDS[kind][0]
    n_z = sum(x is not None for x, _ in inputs)
    runs = {}
    for route in ("fused", "separate") + (("plain",) if plain else ()):
        ext = [t.clone() if t is not None else None for t in ext0]
        hs = ([torch.full((64, p.shape[0]), float("nan"), device=p.device) for p in post]
              if kind == "tanh" else list(h0))
        fn = {"fused": sweep, "separate": sweep.separate, "plain": sweep.plain}[route]
        before = (propagate.quantize_rows.launches, sweep.quantized_in_sweep, sweep.launches)
        out = list(fn(quant, m, *inputs[0], *inputs[1], post, pre, ext, flag, want_next, hs,
                      sides))
        after = (propagate.quantize_rows.launches, sweep.quantized_in_sweep, sweep.launches)
        want = {"fused": (0, n_z, 1), "separate": (n_z, 0, 1), "plain": (0, 0, 0)}[route]
        assert tuple(a - b for a, b in zip(after, before)) == want, route
        runs[route] = out + ext + (hs if kind == "tanh" else [])
    for route, got in runs.items():
        for a, b in zip(runs["fused"], got):
            assert _same(a, b), route
    return runs["fused"]


@pytest.mark.parametrize("kind,flag", [(k, f) for k, (_, flags) in _KINDS.items() for f in flags])
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("want_next", [True, False])
def test_quantizing_sweep_equals_separate_route(cuda, kind, flag, quant, want_next):
    """Each of the four sweeps on (z, amax) equals K3 twice followed by
    the sweep on (q, s), and its plain version, bit for bit."""
    m, zs, post, pre, ext, h = _z_inputs(cuda, quant, 41)
    if kind in ("inject", "tanh_inject"):
        post, pre = pre, post  # the backward binds (post, pre) to (r, l)
    h0 = h if (kind == "tanh_inject" and want_next) else (None, None)
    got = _quantizing_routes(kind, quant, m, zs, post, pre, ext, h0, flag, want_next)
    if want_next:
        assert bool(got[1].gt(0).all()) and bool(got[3].gt(0).all())


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["forward_seed", "forward_reuse", "backward_users_next",
                                  "backward_seed", "zero_users", "zero_items"])
def test_quantizing_sweep_side_cases_equal_separate_route(cuda, quant, case):
    """EGCF's seed sweeps on the turn-in's inputs: the forward's seed
    sweep (a zero user input, the users alone), sweep 1 rounding the
    seed's item input again, the backward's sweep K − 1 (the users' next
    input alone) and sweep K (a zero item input, the items alone); a zero
    input on either side of a linear sweep. Each equals the separate
    route (K3 on the z inputs, int8 zeros with scale 1 for a zero input,
    then the sweep on (q, s)) and its plain version, bit for bit."""
    m, zs, post, pre, ext, h = _z_inputs(cuda, quant, 42, 2560, 6144)
    none = (None, None)
    if case == "forward_seed":
        got = _quantizing_routes("tanh", quant, m, [none, zs[1]], post, pre, ext, none,
                                 chainmm.COMBINE_NONE, True, (True, False))
        assert got[2] is None and bool(got[7].isnan().all())
    elif case == "forward_reuse":
        _quantizing_routes("tanh", quant, m, zs, post, pre, ext, none, chainmm.COMBINE_SET, True)
    elif case == "backward_users_next":
        got = _quantizing_routes("tanh_inject", quant, m, zs, pre, post, ext, (h[0], None),
                                 False, (True, False))
        assert got[1] is not None and got[3] is None
    elif case == "backward_seed":
        got = _quantizing_routes("tanh_inject", quant, m, [zs[0], none], pre, post,
                                 (None, ext[1]), none, True, False, (False, True))
        assert got[0] is None and got[2] is not None
    else:
        inputs = [none, zs[1]] if case == "zero_users" else [zs[0], none]
        got = _quantizing_routes("forward", quant, m, inputs, post, pre, ext, none,
                                 chainmm.COMBINE_ADD, True)
        assert not bool(got[2 if case == "zero_users" else 0].any())


@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("case", ["inf_amax", "nan_amax", "nan_z_block", "nan_ext_block"])
def test_quantizing_sweep_non_finite_equals_separate_route(cuda, kind, quant, case):
    """Non-finite inputs give the separate route's bits: an infinite
    amax (scale inf: the feature rounds to 0, its products turn NaN), a
    NaN amax (scale 1, as K3 takes it), NaN z over a whole K2 block of
    1,024 nodes of one feature (K3's __float2int_rn of NaN), and NaN
    combines or cotangents over a whole K2 block. The plain version is
    held where all stays finite (the NaN amax): PyTorch's float-to-int8
    cast is not K3's outside int8's range, and the plain amax takes any
    NaN where the kernels' take a whole block's."""
    m, zs, post, pre, ext, h = _z_inputs(cuda, quant, 43, 2560, 6144)
    (zu, au), (zi, ai) = ((z.clone(), a.clone()) for z, a in zs)
    ext = tuple(t.clone() for t in ext)
    if case == "inf_amax":
        au[9] = float("inf")
        ai[5] = float("inf")
    elif case == "nan_amax":
        ai[3] = float("nan")
    elif case == "nan_z_block":
        zi[11, 1024:2048] = float("nan")
    else:
        ext[0][7, 1024:2048] = float("nan")
        ext[1][11, :1024] = float("nan")
    if kind in ("inject", "tanh_inject"):
        post, pre = pre, post
    h0 = h if kind == "tanh_inject" else (None, None)
    got = _quantizing_routes(kind, quant, m, [(zu, au), (zi, ai)], post, pre, ext, h0,
                             _KINDS[kind][1][-1], True, plain=case == "nan_amax")
    if case == "inf_amax" and kind in ("inject", "tanh_inject"):
        assert not bool(torch.isfinite(torch.cat([got[1], got[3]])).all())


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


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256])
def test_k7_widths_equal_plain_and_repeat(cuda, d):
    """Every feature group (32, 64, 128 and mixed counts of them): equal to
    the plain version, the same bits on a second launch, one read of M at
    d = 128, K1 transposed at d = 64."""
    rng = np.random.default_rng(9)
    u_pad, i_pad = 2048, 1536
    m = _counts(rng, u_pad, i_pad, 0.04, 3).to(cuda)
    qu, qi = _int8(rng, (u_pad, d)).to(cuda), _int8(rng, (i_pad, d)).to(cuda)
    before = fusedmm.fused_adj_matmul_int8.launches
    got = fusedmm.fused_adj_matmul_int8(m, qu, qi)
    again = fusedmm.fused_adj_matmul_int8(m, qu, qi)
    assert fusedmm.fused_adj_matmul_int8.launches == before + 2
    for a, b, c in zip(got, again, fusedmm.fused_adj_matmul_int8_plain(m, qu, qi)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(a, c)
    assert fusedmm.scan_passes(d) == {128: 1, 256: 2}.get(d, d // (64 if d % 64 == 0 else 32))
    assert fusedmm.fused_adj_matmul_int8.passes == fusedmm.scan_passes(d)  # as launched
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


def _pack15(m: torch.Tensor) -> torch.Tensor:
    """`pack_nibbles` for counts up to 15 (it refuses counts above
    `NIBBLE_MAX`; the kernel takes any nibble)."""
    u, i = m.shape
    t = m.view(torch.uint8).reshape(u, i // fusedmm.PACK_TILE, 2, fusedmm.PACK_TILE // 2)
    return (t[:, :, 0, :] | (t[:, :, 1, :] << 4)).view(torch.int8).reshape(u, i // 2)


@pytest.mark.parametrize("kind", ["random", "dense15", "high_only"])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_k8_widths_equal_plain_k7_and_repeat(cuda, d, kind):
    """K8 (K7's scan on the packed bytes) at every feature group: equal to
    its plain version and to K7 on the unpacked matrix, the same bits on
    a second launch, one scan of m4 per `scan_feature_group`. The
    matrices: random counts 1..15, every entry 15 (a byte's two nibbles
    fill the warp's entry buffer mid-byte), and counts 8..15 in the high
    nibbles only (the byte's top bit set)."""
    rng = np.random.default_rng(11)
    u_pad, i_pad = 1024, 4096
    if kind == "random":
        m = _counts(rng, u_pad, i_pad, 0.05, 15)
    elif kind == "dense15":
        m = torch.full((u_pad, i_pad), 15, dtype=torch.int8)
    else:
        m = _counts(rng, u_pad, i_pad, 0.2, 8) + 7
        m = m * (m > 7)
        m.view(u_pad, 2, 2, fusedmm.PACK_TILE // 2)[:, :, 0, :] = 0
    m = m.to(cuda)
    m4 = _pack15(m)
    assert torch.equal(fusedmm.unpack_nibbles(m4), m)
    qu, qi = _int8(rng, (u_pad, d)).to(cuda), _int8(rng, (i_pad, d)).to(cuda)
    before = fusedmm.fused_adj_matmul_int4.launches
    got = fusedmm.fused_adj_matmul_int4(m4, qu, qi)
    again = fusedmm.fused_adj_matmul_int4(m4, qu, qi)
    assert fusedmm.fused_adj_matmul_int4.launches == before + 2
    assert fusedmm.fused_adj_matmul_int4.passes == fusedmm.scan_passes(d)  # as launched
    for a, b, c, e in zip(got, again, fusedmm.fused_adj_matmul_int4_plain(m4, qu, qi),
                          fusedmm.fused_adj_matmul_int8(m, qu, qi)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, c) and torch.equal(a, e)


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


@pytest.mark.parametrize("d,passes", [(128, 1), (96, 3), (64, 1), (32, 1)])
def test_k6_reads_m_once_per_feature_group(cuda, d, passes):
    """K6 takes the shared scan: its launcher reports `scan_passes` (d)
    reads of M, and the result stays within the bar of the plain
    version and repeats bit for bit."""
    rng = np.random.default_rng(5)
    m = _counts(rng, 2048, 1024, 0.05, 2).to(cuda)
    zu = torch.from_numpy(rng.normal(size=(2040, d)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(1000, d)).astype(np.float32)).to(cuda)
    got = fusedmm.fused_adj_matmul(m, zu, zi)
    assert fusedmm.fused_adj_matmul.passes == fusedmm.scan_passes(d) == passes  # as launched
    again = fusedmm.fused_adj_matmul(m, zu, zi)
    for a, b, c in zip(got, again, fusedmm.fused_adj_matmul_plain(m, zu, zi)):
        assert torch.equal(a, b)
        _close(a, c)


@pytest.mark.parametrize("case", ["span", "long_rows"])
def test_k6_scan_edges(cuda, case):
    """Counts of both signs with activations from 2**-20 to 2**10 in one
    call (the fixed-point shift taken from the largest); rows of M longer
    than a warp's share of the scan, so that two warps or more flush the
    same row's yu partials."""
    rng = np.random.default_rng(6)
    if case == "span":
        u_pad, i_pad, d = 1024, 768, 64
        mask = rng.random((u_pad, i_pad)) < 0.1
        m = torch.from_numpy(np.where(mask, rng.integers(-127, 128, (u_pad, i_pad)), 0)
                             .astype(np.int8)).to(cuda)

        def acts(n):
            mag = 2.0 ** rng.uniform(-20, 10, (n, d))
            return torch.from_numpy(np.where(rng.random((n, d)) < 0.5, -mag, mag)
                                    .astype(np.float32)).to(cuda)
    else:
        u_pad, i_pad, d = 64, 16384, 128
        m = _counts(rng, u_pad, i_pad, 0.5, 3).to(cuda)

        def acts(n):
            return torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    zu, zi = acts(u_pad - 3), acts(i_pad - 7)
    got = fusedmm.fused_adj_matmul(m, zu, zi)
    again = fusedmm.fused_adj_matmul(m, zu, zi)
    for a, b, c in zip(got, again, fusedmm.fused_adj_matmul_plain(m, zu, zi)):
        assert torch.equal(a, b)
        _close(a, c)


def test_k6_takes_bfloat16_activations(cuda):
    """bfloat16 activations give the bits of their float32 values: the
    kernel's rounding leaves bfloat16 values as they are."""
    rng = np.random.default_rng(12)
    m = _counts(rng, 2048, 1024, 0.05, 3).to(cuda)
    zu = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda)
    zu16, zi16 = zu.to(torch.bfloat16), zi.to(torch.bfloat16)
    for a, b in zip(fusedmm.fused_adj_matmul(m, zu16, zi16),
                    fusedmm.fused_adj_matmul(m, zu16.float(), zi16.float())):
        assert torch.equal(a, b)


def test_k6_does_not_synchronise(cuda):
    """A K6 call (checks, allocations, three launches) issues no
    synchronisation with the host."""
    rng = np.random.default_rng(8)
    m = _counts(rng, 2048, 1024, 0.05, 3).to(cuda)
    zu = torch.from_numpy(rng.normal(size=(2048, 64)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(1024, 64)).astype(np.float32)).to(cuda)
    want = fusedmm.fused_adj_matmul(m, zu, zi)  # built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fusedmm.fused_adj_matmul(m, zu, zi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


# ---------------------------------------------------------------------------
# K9 and K10, the tanh chain's epilogues, and the tanh + seed chain (EGCF)


@pytest.mark.parametrize("d,n", [(64, 4096), (64, 38912), (16, 1028), (3, 4)])
@pytest.mark.parametrize("combine", [chainmm.COMBINE_NONE, chainmm.COMBINE_SET,
                                     chainmm.COMBINE_ADD])
@pytest.mark.parametrize("want_next", [True, False])
def test_k9_equals_plain(cuda, d, n, combine, want_next):
    g = torch.Generator(device="cpu").manual_seed(6)
    y = (torch.randn(d, n, generator=g) * 200).to(cuda)
    s = (torch.rand(d, generator=g) * 1e-2).to(cuda)
    post, pre = torch.rand(n, generator=g).to(cuda), torch.rand(n, generator=g).to(cuda)
    c = torch.randn(d, n, generator=g).to(cuda)
    c1, c2 = c.clone(), c.clone()
    h1, h2 = torch.full_like(c, float("nan")), torch.full_like(c, float("nan"))
    before = chainmm.chain_sweep_tanh.launches
    z1, a1 = chainmm.chain_sweep_tanh(y, s, post, pre, c1, h1, combine, want_next)
    assert chainmm.chain_sweep_tanh.launches == before + 1
    z2, a2 = chainmm.chain_sweep_tanh_plain(y, s, post, pre, c2, h2, combine, want_next)
    assert torch.equal(h1, h2) and torch.equal(c1, c2)
    assert torch.equal(h1, torch.tanh(post[None, :] * (y * s[:, None])))
    if want_next:
        assert torch.equal(z1, z2) and torch.equal(a1, a2)
    else:
        assert z1 is None and a1 is None


@pytest.mark.parametrize("d,n", [(64, 4096), (16, 1028), (3, 4)])
@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("want_next", [True, False])
def test_k10_equals_plain(cuda, d, n, inject, want_next):
    g = torch.Generator(device="cpu").manual_seed(7)
    y = (torch.randn(d, n, generator=g) * 200).to(cuda)
    s = (torch.rand(d, generator=g) * 1e-2).to(cuda)
    post, pre = torch.rand(n, generator=g).to(cuda), torch.rand(n, generator=g).to(cuda)
    cot = (torch.randn(d, n, generator=g) * 1e-3).to(cuda)
    h = torch.tanh(torch.randn(d, n, generator=g)).to(cuda)
    cot0 = cot.clone()
    h_arg = h if want_next else None
    out1, a1 = chainmm.chain_sweep_tanh_inject(y, s, post, pre, cot, h_arg, inject, want_next)
    out2, a2 = chainmm.chain_sweep_tanh_inject_plain(y, s, post, pre, cot, h_arg, inject,
                                                     want_next)
    assert torch.equal(out1, out2) and torch.equal(cot, cot0)
    assert (a1 is None and a2 is None) if not want_next else torch.equal(a1, a2)


def test_k9_k10_reject_what_they_do_not_take(cuda):
    y = torch.zeros(4, 8, device=cuda)
    ones4, ones8 = torch.ones(4, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="h_out"):
        chainmm.chain_sweep_tanh(y, ones4, ones8, ones8, y.clone(), torch.zeros(4, 6, device=cuda),
                                 chainmm.COMBINE_NONE, True)
    with pytest.raises(ValueError, match="N % 4"):
        z = torch.zeros(4, 6, device=cuda)
        chainmm.chain_sweep_tanh(z, ones4, torch.ones(6, device=cuda), torch.ones(6, device=cuda),
                                 z.clone(), z.clone(), chainmm.COMBINE_NONE, True)
    with pytest.raises(ValueError, match="h"):
        chainmm.chain_sweep_tanh_inject(y, ones4, ones8, ones8, y, torch.zeros(4, 6, device=cuda),
                                        False, True)


@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tanh_chain_equals_plain_chain(cuda, seed, layers, quant):
    """Forward and backward of the tanh chain through K3, K1 or K5, K9
    and K10 against the plain versions' chain, and int4 against int8."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, compute_dtype=quant, emb_size=64, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(2)
    x = (torch.rand(data.num_nodes, 64, generator=g) - 0.5)
    if seed:
        x[: data.num_users] = 0.0
    x = x.to(cuda)
    cot = torch.zeros(data.num_nodes, 64)
    rows = torch.randint(0, data.num_nodes, (512,), generator=g)
    cot[rows] = torch.randn(512, 64, generator=g) / 512
    cot = cot.to(cuda)
    outs, grads = [], []
    for fn in (chainmm.fused_chain_resident, chainmm.fused_chain_resident_plain):
        xx = x.clone().requires_grad_(True)
        out = fn(adj, xx, layers, False, "sum", torch.tanh, seed)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(xx.grad)
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])
    assert bool(grads[0].abs().sum() > 0)
    if seed:
        assert not bool(grads[0][: data.num_users].any())
    # the per-sweep route on the card: the same forward bits
    assert torch.equal(outs[0], propagate.fused_chain_t(adj, x, layers, False, "sum",
                                                        torch.tanh, seed))


def test_egcf_step_equals_plain_path(cuda, monkeypatch):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = Config({"dataset": "t", "embedding_size": "64", "reg_lambda": "0.0001",
                  "GCN_layer": "3", "compute_dtype": "int8", "ssl_lambda": "0.1",
                  "temperature": "0.1", "mode": "parallel"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    model = get_model("EGCF")(cfg, data, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device="cpu").manual_seed(5)
    pick = torch.randint(0, data.num_train, (2048,), generator=g).numpy()
    batch = {"user": torch.from_numpy(data.train_user[pick]).to(cuda),
             "pos": torch.from_numpy(data.train_item[pick]).to(cuda),
             "neg": torch.randint(0, data.num_items, (2048,), generator=g).to(cuda)}

    def step():
        model.zero_grad(set_to_none=True)
        terms = model.loss_terms(batch)
        sum(terms).backward()
        return (model.item_emb.grad.clone(), *(t.detach() for t in terms))

    counters = (chainmm.chain_sweep_tanh, chainmm.chain_sweep_tanh_inject,
                chainmm.dual_sweep_tanh, chainmm.dual_sweep_tanh_inject, propagate.quantize_rows)
    before = [fn.launches for fn in counters]
    got = step()
    # the forward's 4 sweeps (the seed's included) and the backward's 4 run
    # K9's and K10's epilogue in the dual's turn-out and round their inputs
    # in its turn-in; K10 standalone only in the backward's prologue (users,
    # items); no K3
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 2, 4, 4, 0]
    monkeypatch.setattr(chainmm, "KERNELS", chainmm.PLAIN)
    monkeypatch.setattr(scatter, "scatter_add_rows", scatter.scatter_add_rows_plain)
    monkeypatch.setattr(scatter, "scatter_add_rows_unchecked", scatter.scatter_add_rows_plain)
    want = step()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _close(got, want):
    """Within rtol 3e-5 and 3e-6 of the largest entry of ``want``."""
    top = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-6 * max(top, 1e-30))


@pytest.mark.parametrize("r,c,density,d", [
    (3000, 2000, 0.02, 64),     # several row blocks and column chunks
    (1000, 500, 1.0, 32),       # all ones: the longest sums
    (200, 700, 0.3, 16),
    (100, 100, 0.1, 8),         # one row block, the narrowest width
    (2048, 1024, 0.0, 64),      # all zero
    (1000, 1000, 0.05, 136),    # 17 feature groups of 8
])
def test_k11_equals_plain_and_repeats_bit_equal(cuda, r, c, density, d):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(0)
    m = torch.from_numpy((rng.random((r, c)) < density).astype(np.int8)).to(cuda)
    packed = bitmm.pack_rows(m)
    assert torch.equal(bitmm.unpack_rows(packed)[:r, :c], m.to(torch.uint8))
    x = torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(cuda)
    before = bitmm.bit_matmul.launches
    got = bitmm.bit_matmul(packed, x, r)
    assert bitmm.bit_matmul.launches == before + 1
    assert got.shape == (r, d) and got.dtype == torch.float32
    assert torch.equal(got, bitmm.bit_matmul(packed, x, r))
    _close(got, bitmm.bit_matmul_plain(packed, x, r))


def test_k11_matches_k6_on_a_binary_matrix(cuda):
    rng = np.random.default_rng(1)
    m = torch.from_numpy((rng.random((3000, 2000)) < 0.02).astype(np.int8)).to(cuda)
    xu = torch.from_numpy(rng.normal(size=(3000, 64)).astype(np.float32)).to(cuda)
    xi = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    packed, packed_t = bitmm.pack_pair(m)
    got = bitmm.bit_adj_matmul(packed, packed_t, xu, xi)
    want = fusedmm.fused_adj_matmul(fusedmm.pad_matrix(m), xu, xi)
    for a, b in zip(got, want):
        _close(a, b)


def test_bit_adj_backward_is_the_swapped_product(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(2)
    m = torch.from_numpy((rng.random((2000, 1000)) < 0.03).astype(np.int8)).to(cuda)
    packed, packed_t = bitmm.pack_pair(m)
    xu, xi, g_yu, g_yi = (torch.from_numpy(rng.normal(size=s_).astype(np.float32)).to(cuda)
                          for s_ in ((2000, 64), (1000, 64), (2000, 64), (1000, 64)))
    a, b = xu.clone().requires_grad_(True), xi.clone().requires_grad_(True)
    torch.autograd.backward(list(bitmm.bit_adj_matmul(packed, packed_t, a, b)), [g_yu, g_yi])
    swapped = bitmm.bit_adj_matmul(packed, packed_t, g_yu, g_yi)
    pa, pb = xu.clone().requires_grad_(True), xi.clone().requires_grad_(True)
    torch.autograd.backward([bitmm.bit_matmul_plain(packed, pb, 2000),
                             bitmm.bit_matmul_plain(packed_t, pa, 1000)], [g_yu, g_yi])
    for got, same, ref in zip((a.grad, b.grad), swapped, (pa.grad, pb.grad)):
        assert torch.equal(got, same)
        # the kernel rounds the cotangent to bfloat16 going in, autograd
        # through the plain version rounds the gradient coming out
        assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@pytest.mark.parametrize("d", [8, 64, 136])
@pytest.mark.parametrize("case", ["full_group", "last_column"])
def test_k11_scan_edges(cuda, case, d):
    """A row group whose every bit is set (each byte of its packed row
    non-zero: every warp's run is its whole share), and set bits only in
    the last real column before the padding; equal across two launches
    and within the bar of the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(9)
    r, c = 1000, 2000 if case == "full_group" else 700
    m = torch.zeros((r, c), dtype=torch.int8)
    if case == "full_group":
        m[8:16] = 1
    else:
        m[torch.from_numpy(rng.random(r) < 0.3), c - 1] = 1
    packed = bitmm.pack_rows(m.to(cuda))
    if case == "full_group":
        assert bool((packed[1, :c] == -1).all()) and not bool(packed[1, c:].any())
    x = torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(cuda)
    before = bitmm.bit_matmul.launches
    got = bitmm.bit_matmul(packed, x, r)
    assert bitmm.bit_matmul.launches == before + 1
    assert torch.equal(got, bitmm.bit_matmul(packed, x, r))
    _close(got, bitmm.bit_matmul_plain(packed, x, r))


def test_k11_takes_bfloat16_and_short_x(cuda):
    """bfloat16 activations go in as they are; rows of x past its end
    count as zeros, as the plain version pads them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(10)
    m = torch.from_numpy((rng.random((1000, 1500)) < 0.05).astype(np.int8)).to(cuda)
    packed = bitmm.pack_rows(m)
    x = torch.from_numpy(rng.normal(size=(1200, 64)).astype(np.float32)).to(cuda)
    got = bitmm.bit_matmul(packed, x.to(torch.bfloat16), 1000)
    assert torch.equal(got, bitmm.bit_matmul(packed, x, 1000))
    _close(got, bitmm.bit_matmul_plain(packed, x, 1000))


def test_k11_does_not_synchronise(cuda):
    """A K11 call (checks, one allocation, one launch) issues no
    synchronisation with the host."""
    rng = np.random.default_rng(11)
    m = torch.from_numpy((rng.random((3000, 2000)) < 0.02).astype(np.int8)).to(cuda)
    packed = bitmm.pack_rows(m)
    x = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(cuda)
    want = bitmm.bit_matmul(packed, x, 3000)  # built and loaded outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bitmm.bit_matmul(packed, x, 3000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["width", "dtype", "rows"])
def test_k11_rejects_what_it_does_not_take(cuda, case):
    packed = torch.zeros((128, 512), dtype=torch.int8, device=cuda)
    x = torch.zeros((512, 64), device=cuda)
    if case == "width":
        x = torch.zeros((512, 12), device=cuda)
    elif case == "dtype":
        packed = packed.to(torch.uint8)
    else:
        packed = torch.zeros((4, 512), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        bitmm.bit_matmul(packed, x, 8 * packed.shape[0])


def _rows_case(rng, r, c, b, density=0.02, top=1):
    m = _counts(rng, r, c, density, top)
    # repeats, as the sampler draws them: half the batch from 40 rows
    rows = np.concatenate([rng.integers(0, r, b - b // 2), rng.integers(0, min(r, 40), b // 2)])
    return m, torch.from_numpy(rng.permutation(rows).astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r,c,b,d,top,kind", [
    (3000, 2048, 2048, 64, 1, "sampled"),    # the step's shape, smaller matrix
    (500, 384, 100, 32, 127, "sampled"),     # a ragged batch, the largest counts
    (300, 128, 1, 8, 3, "sampled"),          # one row
    (1000, 1280, 300, 24, 2, "sampled"),     # three feature groups of 8
    (900, 1024, 200, 64, 2, "sampled"),      # fewer rows than one K12 block
    (1000, 1280, 257, 64, 3, "sampled"),     # one row past a K12 block and a K13 share
    (700, 1536, 513, 64, 4, "one_row"),      # every row the same row
    (300, 128, 2048, 64, 1, "sampled"),      # C = 128: fewer column chunks than shares
    (2000, 2048, 600, 8, 5, "sampled"),      # d = 8
    (600, 896, 513, 24, 4, "sampled"),       # d = 24
    (1000, 1024, 700, 96, 3, "sampled"),     # two feature groups, the second half full
    (3800, 3200, 4096, 64, 1, "sampled"),    # the item side's ratio: R > C, twice the rows
    (800, 1024, 333, 64, 127, "signed"),     # counts of either sign, -128 included
])
def test_k12_k13_equal_plain_and_repeat(cuda, dtype, r, c, b, d, top, kind):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(3)
    m, rows = _rows_case(rng, r, c, b, 0.05, top)
    if kind == "one_row":
        rows = torch.full_like(rows, int(rows[0]))
    elif kind == "signed":
        m = torch.where(m != 0, _int8(rng, (r, c), -128, 128), m)
    m, rows = m.to(cuda), rows.to(cuda)
    z = torch.from_numpy(rng.normal(size=(c - 5, d)).astype(np.float32)).to(cuda).to(dtype)
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(cuda).to(dtype)
    before = gathermm.gather_rows_matmul.launches, gathermm.gather_rows_matmul_t.launches
    out = gathermm.gather_rows_matmul(m, rows, z)
    dz = gathermm.gather_rows_matmul_t(m, rows, g)
    assert (gathermm.gather_rows_matmul.launches - before[0],
            gathermm.gather_rows_matmul_t.launches - before[1]) == (1, 1)
    assert out.shape == (b, d) and dz.shape == (c, d)
    assert torch.equal(out, gathermm.gather_rows_matmul(m, rows, z))
    assert torch.equal(dz, gathermm.gather_rows_matmul_t(m, rows, g))
    _close(out, gathermm.gather_rows_matmul_plain(m, rows, z))
    _close(dz, gathermm.gather_rows_matmul_t_plain(m, rows, g))


def test_k12_k13_do_not_synchronise(cuda):
    """K12, K13 and one `gather_matmul` backward (plans, allocations,
    checks, launches) issue no synchronisation with the host."""
    rng = np.random.default_rng(5)
    m, rows = _rows_case(rng, 2000, 1024, 700)
    m, rows = m.to(cuda), rows.to(cuda)
    z = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(700, 64)).astype(np.float32)).to(cuda)
    zb, gb = z.to(torch.bfloat16), g.to(torch.bfloat16)
    zz = zb.clone().requires_grad_(True)
    for v in (z, zb):  # built and loaded, the plans' card queries made, outside the check
        gathermm.gather_rows_matmul(m, rows, v)
        gathermm.gather_rows_matmul_t(m, rows, g.to(v.dtype))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [gathermm.gather_rows_matmul(m, rows, v) for v in (z, zb)]
        got += [gathermm.gather_rows_matmul_t(m, rows, v) for v in (g, gb)]
        gathermm.gather_matmul(m, rows, zz).backward(g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [gathermm.gather_rows_matmul_plain(m, rows, v) for v in (z, zb)]
    want += [gathermm.gather_rows_matmul_t_plain(m, rows, v) for v in (g, gb)]
    for a, b in zip(got, want):
        _close(a, b)
    assert torch.equal(zz.grad, gathermm.gather_rows_matmul_t(m, rows, gb)[:1000].to(torch.bfloat16))


def test_k12_row_out_of_range_gives_nan(cuda):
    m = torch.ones((256, 128), dtype=torch.int8, device=cuda)
    z = torch.ones((128, 64), device=cuda)
    rows = torch.tensor([0, 256, 5, -1], device=cuda)
    out = gathermm.gather_rows_matmul(m, rows, z)
    assert bool(torch.isnan(out[1]).all() and torch.isnan(out[3]).all())
    assert bool((out[[0, 2]] == 128.0).all())
    dz = gathermm.gather_rows_matmul_t(m, rows, torch.ones((4, 64), device=cuda))
    assert bool((dz == 2.0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_matmul_backward_rounds_as_jax(cuda, dtype):
    """dz = (M[rows]ᵀ @ g rounded to z's type) in float32, returned in
    z's type: within one ulp of that type of the plain version's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(4)
    m, rows = _rows_case(rng, 2000, 1024, 700)
    m, rows = m.to(cuda), rows.to(cuda)
    z = torch.from_numpy(rng.normal(size=(1000, 64)).astype(np.float32)).to(cuda).to(dtype)
    g = torch.from_numpy(rng.normal(size=(700, 64)).astype(np.float32)).to(cuda)
    zz = z.clone().requires_grad_(True)
    gathermm.gather_matmul(m, rows, zz).backward(g)
    want = gathermm.gather_rows_matmul_t_plain(m, rows, g.to(dtype))[:1000]
    assert zz.grad.dtype == dtype
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    torch.testing.assert_close(zz.grad.float(), want, rtol=ulp, atol=3e-6 * float(want.abs().max()))


def test_bitpack_and_batch_rows_train_through_their_kernels(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    g = torch.Generator(device="cpu").manual_seed(5)
    n = 4 * 1024
    pick = torch.randint(0, data.num_train, (n,), generator=g).numpy()
    triple = (torch.from_numpy(data.train_user[pick]).to(cuda),
              torch.from_numpy(data.train_item[pick]).to(cuda),
              torch.randint(0, data.num_items, (n,), generator=g).to(cuda))
    counters = (bitmm.bit_matmul, gathermm.gather_rows_matmul, gathermm.gather_rows_matmul_t)
    for extra, want in (({"propagation_backend": "bitpack"}, (4 * 12, 0, 0)),
                        ({"propagation_backend": "dense", "batch_rows_propagation": "1"},
                         (0, 4 * 2, 4 * 2))):
        cfg = Config({"dataset": "t", "embedding_size": "64", "reg_lambda": "0.0001",
                      "GCN_layer": "3", "compute_dtype": "bfloat16", **extra})
        model = get_model("LightGCN")(cfg, data, device=cuda,
                                      generator=torch.Generator().manual_seed(0))
        before = [f.launches for f in counters]
        terms = EpochRunner(model, 0.001, 1024, n).run_epoch(*triple).cpu().numpy()
        assert tuple(f.launches - b for f, b in zip(counters, before)) == want
        assert terms.shape == (2,) and np.isfinite(terms).all()


# ---------------------------------------------------------------------------
# the rectangular adjacency: K11 one direction a call, the int8 product


@pytest.mark.parametrize("r,c,density,d", [
    (3000, 2000, 0.02, 64),
    (200, 700, 0.3, 16),
])
def test_bit_rect_matmul_is_k11_both_ways_and_repeats(cuda, r, c, density, d):
    """K11's differentiable single direction: the forward is one K11 call
    on the packing, the backward one on the other packing, each bit-equal
    to the wrapper, across two launches, and within TIGHT of the plain
    version."""
    rng = np.random.default_rng(3)
    m = torch.from_numpy((rng.random((r, c)) < density).astype(np.int8)).to(cuda)
    packed, packed_t = bitmm.pack_pair(m)
    plans = (bitmm.plan_rows(packed), bitmm.plan_rows(packed_t))
    x = torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32)).to(cuda)
    grads = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        before = bitmm.bit_matmul.launches
        y = bitmm.bit_rect_matmul(packed, packed_t, xx, r, plans)
        y.backward(g)
        assert bitmm.bit_matmul.launches == before + 2
        assert torch.equal(y, bitmm.bit_matmul(packed, x, r, plans[0]))
        assert torch.equal(xx.grad, bitmm.bit_matmul(packed_t, g, c, plans[1]))
        _close(y, bitmm.bit_matmul_plain(packed, x, r))
        _close(xx.grad, bitmm.bit_matmul_plain(packed_t, g, c))
        grads.append((y.detach(), xx.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("r,c,d,top", [
    (200, 296, 64, 1),      # no side a multiple of 128
    (1000, 1032, 16, 127),  # the largest counts
    (136, 24, 8, 3),
])
@pytest.mark.parametrize("transpose", [False, True])
def test_int8_matmul_equals_the_int32_product(cuda, r, c, d, top, transpose):
    """`torch._int_mm` (M row-major, q column-major; Mᵀ stored for the
    transposed direction) gives the exact int32 sums of its plain
    version in both directions."""
    rng = np.random.default_rng(4)
    m_np = (rng.integers(0, top + 1, (r, c)) * (rng.random((r, c)) < 0.3)).astype(np.int8)
    q_np = rng.integers(-127, 128, (r if transpose else c, d)).astype(np.int8)
    m, q = torch.from_numpy(m_np).to(cuda), torch.from_numpy(q_np).to(cuda)
    got = propagate.int8_matmul(m, m.T.contiguous(), q, transpose)
    want = (m_np.T if transpose else m_np).astype(np.int64) @ q_np.astype(np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, propagate.int8_matmul_plain(m, q, transpose))


@pytest.mark.parametrize("backend,dtype", [
    ("dense", "float32"), ("dense", "bfloat16"), ("dense", "int8"), ("gather", "float32"),
    ("bitpack", "bfloat16"),
])
def test_rect_adjacency_on_the_card_matches_the_cpu(cuda, backend, dtype):
    """Both directions and their gradients on the card against the same
    adjacency on the CPU (the plain versions): int8 bit-equal (exact
    int32 sums, the same float32 operations), the others within TIGHT of
    the largest entry (float32 sums in another order); one call of each
    direction issues no synchronisation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    data = make_synthetic_dataset(300, 500, 6000, 500, seed=2)
    rng = np.random.default_rng(5)
    xi, xu = (torch.from_numpy(rng.normal(size=s_).astype(np.float32))
              for s_ in ((500, 64), (300, 64)))
    outs = []
    for dev in (cuda, torch.device("cpu")):
        adj = propagate.build_rect_adjacency(data, backend, dtype, device=dev)
        a, b = xi.to(dev).requires_grad_(True), xu.to(dev).requires_grad_(True)
        ya, yb = adj.matmul(a), adj.t_matmul(b)
        (ya.sum() + (yb * yb).sum()).backward()
        outs.append([t.detach().cpu() for t in (ya, yb, a.grad, b.grad)])
        if dev.type == "cuda":
            xi_d, xu_d = xi.to(dev), xu.to(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                adj.matmul(xi_d)
                adj.t_matmul(xu_d)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    for got, want in zip(*outs):
        if dtype == "int8":
            assert torch.equal(got, want)
        else:
            _close(got, want)


def test_egcf_alternating_trains_through_its_kernels(cuda):
    """EGCF mode = alternating: int8 on dense runs K4 in the backward (two
    calls a step), bitpack one K11 call a direction forward and backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    g = torch.Generator(device="cpu").manual_seed(6)
    n = 4 * 1024
    pick = torch.randint(0, data.num_train, (n,), generator=g).numpy()
    triple = (torch.from_numpy(data.train_user[pick]).to(cuda),
              torch.from_numpy(data.train_item[pick]).to(cuda),
              torch.randint(0, data.num_items, (n,), generator=g).to(cuda))
    counters = (scatter.scatter_add_rows, bitmm.bit_matmul)
    for dtype, backend, want in (("int8", "dense", (4 * 2, 0)),
                                 ("bfloat16", "bitpack", (0, 4 * 12))):
        cfg = Config({"dataset": "t", "embedding_size": "64", "reg_lambda": "0.0001",
                      "GCN_layer": "3", "ssl_lambda": "0.1", "temperature": "0.1",
                      "mode": "alternating", "compute_dtype": dtype,
                      "propagation_backend": backend})
        model = get_model("EGCF")(cfg, data, device=cuda,
                                  generator=torch.Generator().manual_seed(0))
        before = [f.launches for f in counters]
        terms = EpochRunner(model, 0.001, 1024, n).run_epoch(*triple).cpu().numpy()
        assert tuple(f.launches - b for f, b in zip(counters, before)) == want
        assert terms.shape == (3,) and np.isfinite(terms).all()


# ---------------------------------------------------------------------------
# the dense backend on K6 (bfloat16) and K7 (int8); the zoo's steps


def _dense_inputs(adj, cuda, seed, d=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(adj.shape[0], d, generator=g).to(cuda),
            torch.randn(adj.shape[0], d, generator=g).to(cuda))


def _value_and_grad(adj, x, w):
    xt = x.clone().requires_grad_(True)
    y = adj.matmul(xt)
    (y * w).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("variant", ["sym", "self"])
def test_dense_bf16_equals_fused_bf16(cuda, variant):
    """Dense bfloat16 runs K6 on its own padding (columns to 256), one
    launch forward and one backward; both backends sum the same integers
    at the same scale, so they agree bit for bit."""
    # 4,700 items: 4,864 columns on dense, 5,120 on fused
    data = make_synthetic_dataset(3000, 4700, 60_000, 1000, seed=1)
    dense, fused = (propagate.build_adjacency(data, variant, backend, compute_dtype="bfloat16",
                                              device=cuda) for backend in ("dense", "fused"))
    assert dense.runs_kernel(64) and dense.m.shape[1] == 4864 and fused.m8.shape[1] == 5120
    x, w = _dense_inputs(dense, cuda, 4)
    outs = []
    for adj in (dense, fused):
        before = fusedmm.fused_adj_matmul.launches
        outs.append(_value_and_grad(adj, x, w))
        assert fusedmm.fused_adj_matmul.launches == before + 2
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_dense_int8_equals_its_plain_raw_sums(cuda):
    """Dense int8 runs K7, one launch forward and one backward: its raw
    sums equal K7's plain version's, and the product and its gradient
    equal the route it replaced (`quant_dual_matmul`, exact integer sums
    in float32)."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, "sym", "dense", compute_dtype="int8", device=cuda)
    assert adj.quant == "int8" and adj.runs_kernel(64)
    x, w = _dense_inputs(adj, cuda, 5)
    before = fusedmm.fused_adj_matmul_int8.launches
    got = _value_and_grad(adj, x, w)
    assert fusedmm.fused_adj_matmul_int8.launches == before + 2
    nu = adj.num_users
    u_pad, i_pad = adj.m.shape
    zi = propagate._pad_rows(adj.right_i[:, None] * x[nu:], i_pad)
    zu = propagate._pad_rows(adj.right_u[:, None] * x[:nu], u_pad)
    (qi, _), (qu, _) = propagate._quantize_cols(zi), propagate._quantize_cols(zu)
    for a, b in zip(fusedmm.fused_adj_matmul_int8(adj.m, qu, qi),
                    fusedmm.fused_adj_matmul_int8_plain(adj.m, qu, qi)):
        assert torch.equal(a, b)
    old = propagate.quant_fused_dual
    try:
        propagate.quant_fused_dual = propagate.quant_dual_matmul
        want = _value_and_grad(adj, x, w)
    finally:
        propagate.quant_fused_dual = old
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_dense_float32_and_other_widths_run_no_kernel(cuda):
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    counters = (fusedmm.fused_adj_matmul, fusedmm.fused_adj_matmul_int8)
    for dtype, d in (("float32", 64), ("bfloat16", 48), ("int8", 40)):
        adj = propagate.build_adjacency(data, "sym", "dense", compute_dtype=dtype, device=cuda)
        assert not adj.runs_kernel(d)
        x, w = _dense_inputs(adj, cuda, 6, d)
        before = [f.launches for f in counters]
        y, grad = _value_and_grad(adj, x, w)
        assert [f.launches for f in counters] == before
        assert torch.isfinite(y).all() and torch.isfinite(grad).all()


_ZOO = ("MFBPR", "DirectAU", "MAWU", "SCCF", "LightCCF", "LightCSCF", "SimGCL", "XSimGCL",
        "LightGCN_pp", "BIGCF", "MixRec", "CGCL", "NCL", "HCCF", "IMPGCN")
_GROUPING = ("fc_w", "fc_b", "fc_group_w", "fc_group_b")


def _zoo_k6_launches(name, layers=3):
    """K6 launches of one zoo step: none under MF, a layer each way
    elsewhere; IMPGCN's Â·E feeds only its gates (no backward), its
    groups' layers 1 .. L - 1 run each way."""
    if name == "MFBPR":
        return 0
    return 1 + 2 * (layers - 1) if name == "IMPGCN" else 2 * layers


@pytest.mark.parametrize("name", _ZOO)
def test_zoo_step_does_not_synchronise(cuda, name):
    """One training step of each zoo model at d = 64 (the LightGCN encoder
    where the model has one, and every propagation of the others: dense
    bfloat16, K6 a layer each way; SimGCL's chains and IMPGCN's groups at
    d = 192) under sync debug mode "error", after a first step has made
    Adam's state; the noise drawn from a CUDA generator. NCL steps past
    its warm-up, after its k-means (on K4) has run under the same mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch.config import load_model_config
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = load_model_config(name).updated(dataset="t", embedding_size=64, batch_size=1024)
    if name != "MFBPR":
        cfg = cfg.updated(encoder="LightGCN", GCN_layer=3)
    model = get_model(name)(cfg, data, device=cuda, generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device="cpu").manual_seed(7)
    pick = torch.randint(0, data.num_train, (1024,), generator=g).numpy()
    triple = (torch.from_numpy(data.train_user[pick]).to(cuda),
              torch.from_numpy(data.train_item[pick]).to(cuda),
              torch.randint(0, data.num_items, (1024,), generator=g).to(cuda))
    runner = EpochRunner(model, 0.001, 1024, 1024)
    gen = torch.Generator(device=cuda).manual_seed(3)
    epoch = cfg.int("warmup_epochs") if name == "NCL" else 0
    runner.run_epoch(*triple, generator=gen, epoch=epoch)
    before = fusedmm.fused_adj_matmul.launches
    k4_before = scatter.scatter_add_rows.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.epoch_context(epoch, np.random.default_rng(4))
        terms = runner.run_epoch(*triple, generator=gen, epoch=epoch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fusedmm.fused_adj_matmul.launches - before == _zoo_k6_launches(name)
    # NCL's k-means: 20 iterations a table, one K4 launch each
    assert scatter.scatter_add_rows.launches - k4_before == (40 if name == "NCL" else 0)
    if name in ("SimGCL", "IMPGCN"):
        assert fusedmm.fused_adj_matmul.passes == 3  # the chains or groups at d = 192
    terms = terms.cpu().numpy()
    assert terms.shape == (len(model.loss_names),) and np.isfinite(terms).all()
    if name == "NCL":
        assert terms[3] > 0  # the prototype term, past the warm-up
    for k, p in model.named_parameters():
        if name == "IMPGCN" and k in _GROUPING:
            assert p.grad is None  # the gates take no gradient
        else:
            assert bool(torch.isfinite(p.grad).all()), k


def test_noise_draws_on_a_cuda_generator_do_not_synchronise(cuda):
    """MixRec's draws (two Beta(0.1, 0.1), a Dirichlet over a batch of
    2,048, two permutations) and SimGCL's and BIGCF's on a CUDA generator:
    no synchronisation, no NaN, on the generator's device, the same seed
    the same draws."""
    from idgrec_torch.ops import noise

    def draws(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return (noise.beta(0.1, 0.1, g), noise.beta(0.1, 0.1, g),
                noise.dirichlet(torch.full((2048,), 0.1, device=cuda), g),
                noise.permutation(2048, g), noise.permutation(2048, g),
                noise.uniform((1000, 64), g), noise.normal((1000, 64), g),
                noise.beta(0.1, 0.1, g, shape=(1_000_000,)))

    draws(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = draws(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(t.device.type == "cuda" for t in got)
    ub, ib, w, up, ip, _, _, many = got
    assert 0.0 <= float(ub) <= 1.0 and 0.0 <= float(ib) <= 1.0
    assert not bool(torch.isnan(many).any()) and abs(float(many.mean()) - 0.5) < 5e-3
    assert not bool(torch.isnan(w).any()) and abs(float(w.sum()) - 1.0) < 1e-5
    for p in (up, ip):
        assert torch.equal(torch.sort(p).values, torch.arange(2048, device=cuda))
    for a, b in zip(got, draws(1)):
        assert torch.equal(a, b)


def test_bernoulli_and_choice_on_a_cuda_generator_do_not_synchronise(cuda):
    """HCCF's and IMPGCN's masks and NCL's initial rows (k = 2,000 of
    yelp2018's 38,048 items) on a CUDA generator: no synchronisation, on
    the generator's device, the same seed the same draws."""
    from idgrec_torch.ops import noise

    def draws(seed):
        g = torch.Generator(device=cuda).manual_seed(seed)
        return (noise.bernoulli(0.6, (69_716, 64), g), noise.choice(38_048, 2000, g),
                noise.choice(31_668, 2000, g))

    draws(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = draws(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mask, items, users = got
    assert all(t.device.type == "cuda" for t in got)
    assert mask.dtype == torch.bool and abs(float(mask.float().mean()) - 0.6) < 1e-3
    for rows, n in ((items, 38_048), (users, 31_668)):
        assert rows.dtype == torch.int64 and len(torch.unique(rows)) == 2000
        assert 0 <= int(rows.min()) and int(rows.max()) < n
    for a, b in zip(got, draws(1)):
        assert torch.equal(a, b)


def test_kmeans_on_k4_equals_its_plain_route_without_a_sync(cuda):
    """NCL's clustering at yelp2018's shapes (38,048 rows of 64 into k =
    2,000, 20 iterations): the centroid sums on K4 (one launch an
    iteration, nothing read back, under sync debug mode "error") against
    the same clustering with K4's plain version, assignments and
    centroids bit for bit; the same seed the same clustering."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch.ops import kmeans

    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.normal(size=(38_048, 64)) * 0.1).astype(np.float32)).to(cuda)

    def cluster():
        return kmeans.kmeans(x, 2000, torch.Generator(device=cuda).manual_seed(5))

    cluster()
    before = scatter.scatter_add_rows.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cluster()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert scatter.scatter_add_rows.launches - before == 20
    old = scatter.scatter_add_rows_unchecked
    try:
        scatter.scatter_add_rows_unchecked = scatter.scatter_add_rows_plain
        want = cluster()
    finally:
        scatter.scatter_add_rows_unchecked = old
    for a, b, c in zip(got, want, cluster()):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert got[1].dtype == torch.int64 and len(torch.unique(got[1])) > 1000


def test_k6_at_d192_equals_its_plain_version(cuda):
    """SimGCL's width: three reads of M a launch (64 features each), the
    sums within K6's bar of the plain version, two launches bit-equal."""
    data = make_synthetic_dataset(3000, 4700, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, "sym", "dense", compute_dtype="bfloat16", device=cuda)
    assert adj.runs_kernel(192)
    rng = np.random.default_rng(9)
    nu, ni = data.num_users, data.num_items
    zu = torch.from_numpy(rng.normal(size=(nu, 192)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(ni, 192)).astype(np.float32)).to(cuda)
    got = fusedmm.fused_adj_matmul(adj.m, zu, zi)
    assert fusedmm.fused_adj_matmul.passes == fusedmm.scan_passes(192) == 3
    again = fusedmm.fused_adj_matmul(adj.m, zu, zi)
    for a, b, c in zip(got, again, fusedmm.fused_adj_matmul_plain(adj.m, zu, zi)):
        assert torch.equal(a, b)
        _close(a, c)


# the models of this round: their K6 launches a step at 3 layers (GCMC and
# LightGODE's one application: 1, RecDCL 2 layers at d = 2,048)
_ROUND = {"NGCF": 6, "GCMC": 2, "GCCF": 6, "LightGODE": 2, "RecDCL": 4}


def _plain_k6(m8, zu, zi):
    """K6's plain version with K6's backward rule (chip_smoke.py's
    `plain_duals`); a one-sided call through `propagate.exact_matmul`, the
    route K6 replaced on the rectangular adjacency."""
    if zu is None or zi is None:
        transpose = zi is None
        z = zu if transpose else zi
        y = propagate.exact_matmul(transpose, m8, propagate._pad_rows(
            z, m8.shape[0] if transpose else m8.shape[1]), torch.bfloat16)
        return (None, y) if transpose else (y, None)
    nu, ni = zu.shape[0], zi.shape[0]
    yu, yi = propagate.exact_dual_matmul(m8, propagate._pad_rows(zi, m8.shape[1]),
                                         propagate._pad_rows(zu, m8.shape[0]), torch.bfloat16)
    return yu[:nu], yi[:ni]


@pytest.mark.parametrize("name", list(_ROUND))
def test_zoo_step_of_this_round_on_k6(cuda, name):
    """One step at the published config's depth (d = 64, RecDCL 2,048) on
    K6 against the same step on K6's plain version from the same tables,
    state and generator seed: loss terms within rtol 3e-5 / atol 3e-6,
    gradients within 2**-7 of the largest entry, RecDCL's histories
    after the step within the same rtol; then a step under sync debug
    mode "error" with its K6 launches counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch import convert
    from idgrec_torch.config import load_model_config
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = load_model_config(name).updated(dataset="t", batch_size=1024)
    model = get_model(name)(cfg, data, device=cuda, generator=torch.Generator().manual_seed(0))
    assert isinstance(model.graph, propagate.DenseSquareAdj)
    assert model.graph.runs_kernel(model.embedding_size)
    g = torch.Generator(device="cpu").manual_seed(7)
    pick = torch.randint(0, data.num_train, (1024,), generator=g).numpy()
    batch = {"user": torch.from_numpy(data.train_user[pick]).to(cuda),
             "pos": torch.from_numpy(data.train_item[pick]).to(cuda),
             "neg": torch.randint(0, data.num_items, (1024,), generator=g).to(cuda)}
    start = {k: v.clone() for k, v in model.model_state().items()}

    def step():
        model.load_model_state(start)
        model.zero_grad(set_to_none=True)
        terms = model.loss_terms(batch, torch.Generator(device=cuda).manual_seed(5))
        sum(terms).backward()
        grads = [getattr(model, k).grad.clone() for k in convert.table_names(model)]
        return ([t.detach() for t in terms], grads,
                [v.clone() for v in model.model_state().values()])

    before = fusedmm.fused_adj_matmul.launches
    got = step()
    assert fusedmm.fused_adj_matmul.launches - before == _ROUND[name]
    if name == "RecDCL":
        assert fusedmm.fused_adj_matmul.passes == fusedmm.scan_passes(2048) == 16
    old = fusedmm.fused_adj_matmul
    try:
        fusedmm.fused_adj_matmul = _plain_k6
        want = step()
    finally:
        fusedmm.fused_adj_matmul = old
    for a, b in zip(got[0], want[0]):
        assert bool(torch.isfinite(a))
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-6)
    for a, b in zip(got[1], want[1]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2.0 ** -7 * float(b.abs().max())
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-6)
    runner = EpochRunner(model, cfg.float("learn_rate"), 1024, 1024)
    gen = torch.Generator(device=cuda).manual_seed(3)
    runner.run_epoch(batch["user"], batch["pos"], batch["neg"], generator=gen)
    before = fusedmm.fused_adj_matmul.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        terms = runner.run_epoch(batch["user"], batch["pos"], batch["neg"], generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fusedmm.fused_adj_matmul.launches - before == _ROUND[name]
    assert np.isfinite(terms.cpu().numpy()).all()


def test_node_dropout_step_does_not_synchronise(cuda):
    """NGCF with node dropout, which forces the gather backend: the edge
    mask on a CUDA generator, the dropped values and their transpose
    through the graph's permutation, the sparse products forward and
    backward, all under sync debug mode "error"; the product equals the
    dense matrix of the same dropped values, its backward the transpose."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch.config import load_model_config
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = load_model_config("NGCF").updated(dataset="t", batch_size=1024, node_dropout=True)
    model = get_model("NGCF")(cfg, data, device=cuda, generator=torch.Generator().manual_seed(0))
    adj = model.graph
    assert isinstance(adj, propagate.GatherSquareAdj) and adj.t_perm.device.type == "cuda"
    g = torch.Generator(device="cpu").manual_seed(7)
    pick = torch.randint(0, data.num_train, (1024,), generator=g).numpy()
    triple = (torch.from_numpy(data.train_user[pick]).to(cuda),
              torch.from_numpy(data.train_item[pick]).to(cuda),
              torch.randint(0, data.num_items, (1024,), generator=g).to(cuda))
    runner = EpochRunner(model, 0.001, 1024, 1024)
    gen = torch.Generator(device=cuda).manual_seed(3)
    runner.run_epoch(*triple, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        terms = runner.run_epoch(*triple, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(terms.cpu().numpy()).all()
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    x = torch.randn(adj.graph.n_cols, 64, device=cuda, requires_grad=True)
    cot = torch.randn(adj.graph.n_rows, 64, device=cuda)
    state = gen.get_state()
    y = adj.edge_dropout_matmul(x, 0.9, gen)
    (y * cot).sum().backward()
    gen.set_state(state)
    gr = adj.graph
    vals = torch.where(torch.rand(gr.vals.shape, generator=gen, device=cuda) < 0.9,
                       gr.vals / torch.tensor(0.9, device=cuda), 0.0)
    dense = torch.zeros(gr.n_rows, gr.n_cols, device=cuda).index_put_(
        (gr.rows, gr.cols), vals, accumulate=True)
    _close(y, dense @ x.detach())
    _close(x.grad, dense.T @ cot)


def test_k6_at_d2048_equals_its_plain_version(cuda):
    """RecDCL's width: sixteen reads of M a launch (128 features each),
    the sums within K6's bar of the plain version, two launches
    bit-equal."""
    data = make_synthetic_dataset(3000, 4700, 60_000, 1000, seed=1)
    adj = propagate.build_adjacency(data, "sym", "dense", compute_dtype="bfloat16", device=cuda)
    assert adj.runs_kernel(2048)
    rng = np.random.default_rng(9)
    nu, ni = data.num_users, data.num_items
    zu = torch.from_numpy(rng.normal(size=(nu, 2048)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(ni, 2048)).astype(np.float32)).to(cuda)
    got = fusedmm.fused_adj_matmul(adj.m, zu, zi)
    assert fusedmm.fused_adj_matmul.passes == fusedmm.scan_passes(2048) == 16
    again = fusedmm.fused_adj_matmul(adj.m, zu, zi)
    for a, b, c in zip(got, again, fusedmm.fused_adj_matmul_plain(adj.m, zu, zi)):
        assert torch.equal(a, b)
        _close(a, c)


# ---------------------------------------------------------------------------
# the rectangular dense route on K6 (LightGCL, CVGA, EGCF alternating in
# bfloat16)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", [(3000, 5000), (300, 500)])
def test_k6_one_sided_equals_plain_and_the_dual(cuda, shape, d):
    """K6 with one side left out (the rectangular adjacency's direction):
    within K6's bar of its plain version, bit-equal to the same side of
    the two-sided launch (each side scaled by its own input's largest
    activation) and across two launches; the backward of a one-sided call
    bit-equal to the one-sided launch on the cotangent, the absent side
    without a gradient; no synchronisation."""
    nu, ni = shape
    data = make_synthetic_dataset(nu, ni, 20 * nu, 100, seed=4)
    adj = propagate.build_rect_adjacency(data, "dense", "bfloat16", device=cuda)
    assert adj.runs_kernel(d) and adj.m.shape[1] % propagate.DENSE_COL_PAD == 0
    m = adj.m
    rng = np.random.default_rng(d)
    zu = torch.from_numpy(rng.normal(size=(nu, d)).astype(np.float32)).to(cuda)
    zi = torch.from_numpy(rng.normal(size=(ni, d)).astype(np.float32)).to(cuda)
    before = fusedmm.fused_adj_matmul.launches
    yu, none_i = fusedmm.fused_adj_matmul(m, None, zi)
    none_u, yi = fusedmm.fused_adj_matmul(m, zu, None)
    assert fusedmm.fused_adj_matmul.launches - before == 2
    assert none_i is None and none_u is None
    assert yu.shape == (m.shape[0], d) and yi.shape == (m.shape[1], d)
    both = fusedmm.fused_adj_matmul(m, zu, zi)
    assert torch.equal(both[0], yu[:nu]) and torch.equal(both[1], yi[:ni])
    assert torch.equal(fusedmm.fused_adj_matmul(m, None, zi)[0], yu)
    assert torch.equal(fusedmm.fused_adj_matmul(m, zu, None)[1], yi)
    _close(yu, fusedmm.fused_adj_matmul_plain(m, None, zi)[0])
    _close(yi, fusedmm.fused_adj_matmul_plain(m, zu, None)[1])
    x = zi.clone().requires_grad_(True)
    y = fusedmm.fused_adj_matmul(m, None, x)[0]
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32)).to(cuda)
    y.backward(g)
    assert torch.equal(x.grad, fusedmm.fused_adj_matmul(m, g, None)[1][:ni])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fusedmm.fused_adj_matmul(m, None, zi)
        fusedmm.fused_adj_matmul(m, zu, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_rect_matmul_both_is_one_launch_of_two_one_sided_ones(cuda):
    """`DenseRectAdj.matmul_both` runs one K6 launch and gives the bits of
    `matmul` and `t_matmul` (one launch each), forward and backward; a
    non-finite input on one side leaves the other side's result finite."""
    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    adj = propagate.build_rect_adjacency(data, "dense", "bfloat16", device=cuda)
    rng = np.random.default_rng(3)
    xi = torch.from_numpy(rng.normal(size=(5000, 64)).astype(np.float32)).to(cuda)
    xu = torch.from_numpy(rng.normal(size=(3000, 64)).astype(np.float32)).to(cuda)
    wu, wi = torch.randn(3000, 64, device=cuda), torch.randn(5000, 64, device=cuda)
    outs = []
    for both in (True, False):
        a, b = xi.clone().requires_grad_(True), xu.clone().requires_grad_(True)
        before = fusedmm.fused_adj_matmul.launches
        ya, yb = adj.matmul_both(a, b) if both else (adj.matmul(a), adj.t_matmul(b))
        ((ya * wu).sum() + (yb * wi).sum()).backward()
        assert fusedmm.fused_adj_matmul.launches - before == (2 if both else 4)
        outs.append((ya.detach(), yb.detach(), a.grad, b.grad))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    bad = xu.clone()
    bad[7, 3] = float("nan")
    ya, yb = adj.matmul_both(xi, bad)
    assert torch.equal(ya, outs[1][0]) and bool(torch.isnan(yb).all())


@pytest.mark.parametrize("name", ["LightGCL", "CVGA"])
def test_rect_model_step_on_k6(cuda, name):
    """LightGCL and CVGA at their published configs (d = 64; CVGA's
    encoder at 128) on the rectangular K6 route: one step against the
    same step on K6's plain version (`_plain_k6`, one-sided calls through
    `propagate.exact_matmul`) from the same tables and generator seed,
    loss terms within rtol 3e-5 / atol 3e-6 and gradients within 2**-7 of
    the largest entry; then a step under sync debug mode "error", its K6
    launches counted (LightGCL 4: two layers, one launch each way; CVGA
    2), and the evaluation representation (2 and 1)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from idgrec_torch import convert
    from idgrec_torch.config import load_model_config
    from idgrec_torch.engine.trainer import EpochRunner

    data = make_synthetic_dataset(3000, 5000, 60_000, 1000, seed=1)
    cfg = load_model_config(name).updated(dataset="t", batch_size=1024)
    model = get_model(name)(cfg, data, device=cuda, generator=torch.Generator().manual_seed(0))
    assert isinstance(model.graph, propagate.DenseRectAdj)
    want_step, want_repr = {"LightGCL": (4, 2), "CVGA": (2, 1)}[name]
    g = torch.Generator(device="cpu").manual_seed(7)
    if name == "CVGA":
        users = torch.randperm(data.num_users, generator=g)[:1024].to(cuda)
        batch = {"user": users, "pos": users, "neg": users}
    else:
        pick = torch.randint(0, data.num_train, (1024,), generator=g).numpy()
        batch = {"user": torch.from_numpy(data.train_user[pick]).to(cuda),
                 "pos": torch.from_numpy(data.train_item[pick]).to(cuda),
                 "neg": torch.randint(0, data.num_items, (1024,), generator=g).to(cuda)}

    def step():
        model.zero_grad(set_to_none=True)
        terms = model.loss_terms(batch, torch.Generator(device=cuda).manual_seed(5))
        sum(terms).backward()
        return ([t.detach() for t in terms],
                [getattr(model, k).grad.clone() for k in convert.table_names(model)])

    before = fusedmm.fused_adj_matmul.launches
    got = step()
    assert fusedmm.fused_adj_matmul.launches - before == want_step
    old = fusedmm.fused_adj_matmul
    try:
        fusedmm.fused_adj_matmul = _plain_k6
        want = step()
    finally:
        fusedmm.fused_adj_matmul = old
    for a, b in zip(got[0], want[0]):
        assert bool(torch.isfinite(a))
        torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-6)
    for a, b in zip(got[1], want[1]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 2.0 ** -7 * float(b.abs().max())
    runner = EpochRunner(model, cfg.float("learn_rate"), 1024, 1024)
    gen = torch.Generator(device=cuda).manual_seed(3)
    runner.run_epoch(batch["user"], batch["pos"], batch["neg"], generator=gen)
    before = fusedmm.fused_adj_matmul.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        terms = runner.run_epoch(batch["user"], batch["pos"], batch["neg"], generator=gen)
        rep = model.eval_embeddings(gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fusedmm.fused_adj_matmul.launches - before == want_step + want_repr
    assert np.isfinite(terms.cpu().numpy()).all()
    assert isinstance(rep, dict) == (name == "CVGA")
