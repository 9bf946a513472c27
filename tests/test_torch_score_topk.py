"""The evaluator's fused score-mask-rank op (`ops.score_topk`) on the CPU,
where it runs its plain version: against the chain it replaces
(`RecModel.score_batch`, the pad-and-mask, ``torch.topk``) on tie-free
scores, and on planted ties against a scalar transcription of the card's
``torch.topk`` (its gather pass, then its 32-wide bitonic sort for k ≤ 32);
the evaluator's route by what it can observe. The kernel itself is held
to this plain version on the card (`tests/test_torch_cuda.py`).

No tolerances: indices and metric sums are compared for equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idgrec_torch.config import Config, load_model_config
from idgrec_torch.data.dataset import make_synthetic_dataset
from idgrec_torch.engine.evaluator import Evaluator, build_eval_plan
from idgrec_torch.models import get_model
from idgrec_torch.ops import score_topk as st
from idgrec_torch.parallel.mesh import Mesh


def _exclusions(rng, b, n_items, per_user):
    """(ptr [b + 1], cols, rows): sorted distinct positives a row."""
    lists = [np.sort(rng.choice(n_items, size=min(n, n_items), replace=False))
             for n in rng.integers(0, per_user + 1, b)]
    ptr = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    cols = np.concatenate(lists) if ptr[-1] else np.zeros(0, np.int64)
    rows = np.repeat(np.arange(b), np.diff(ptr))
    return (torch.from_numpy(ptr.astype(np.int64)), torch.from_numpy(cols.astype(np.int64)),
            torch.from_numpy(rows.astype(np.int64)))


def _chain(users, ut, it, rows, cols, k):
    """The evaluator's chain before the fused route: score_batch's
    product and sigmoid, the pad with its spare column, the mask,
    ``torch.topk``."""
    ratings = torch.sigmoid(torch.matmul(ut[users], it.T))
    ratings = F.pad(ratings, (0, 1))
    ratings[rows, cols] = st.MASK_VALUE
    return torch.topk(ratings[:, :it.shape[0]], k, dim=1)


def _bitonic_scalar(keys, vals):
    """PyTorch's `bitonicSort<32>` over 16 threads of two items each, with
    `bitonicSwap` and the descending comparator, one compare-exchange at a
    time; invalid places past the keys sort last."""
    n = len(keys)
    k = list(keys) + [0.0] * (32 - n)
    v = list(vals) + [0] * (32 - n)
    ok = [True] * n + [False] * (32 - n)

    def swap(a, b, direction):
        s = (k[a] > k[b] and ok[a]) or not ok[b]
        if s == direction:
            k[a], k[b] = k[b], k[a]
            v[a], v[b] = v[b], v[a]
            ok[a], ok[b] = ok[b], ok[a]

    size = 2
    while size < 32:
        stride = size // 2
        while stride > 0:
            for t in range(16):
                swap(2 * t - (t & (stride - 1)), 2 * t - (t & (stride - 1)) + stride,
                     (t & (size // 2)) != 0)
            stride //= 2
        size *= 2
    stride = 16
    while stride > 0:
        for t in range(16):
            swap(2 * t - (t & (stride - 1)), 2 * t - (t & (stride - 1)) + stride, False)
        stride //= 2
    return v[:n]


def _card_topk(scores: torch.Tensor, k: int) -> list[list[int]]:
    """The card's ``torch.topk(scores, k).indices``, row by row in Python:
    the k-th value; the scores above it, then those equal to it up to k,
    each in ascending index (its gather pass); then its sort (the bitonic
    network for 1 < k ≤ 32, a stable sort above)."""
    out = []
    for row in scores.tolist():
        kth = sorted(row, reverse=True)[k - 1]
        above = [i for i, s in enumerate(row) if s > kth]
        equal = [i for i, s in enumerate(row) if s == kth][:k - len(above)]
        lay = above + equal
        if 1 < k <= 32:
            out.append(_bitonic_scalar([row[i] for i in lay], lay))
        else:
            out.append(sorted(lay, key=lambda i: -row[i]))
    return out


@pytest.mark.parametrize("k", [1, 20, 40])
@pytest.mark.parametrize("d", [48, 64, 256])
def test_plain_equals_chain_on_tie_free_scores(k, d):
    """Tie-free scores (products of unit normals, 1,037 items: not a tile
    multiple; 70 users: not a block multiple; up to 30 positives a user):
    the op's indices are the chain's."""
    rng = np.random.default_rng(d + k)
    g = torch.Generator().manual_seed(d * 1000 + k)
    n_users, n_items, b = 300, 1037, 70
    ut = torch.randn((n_users, d), generator=g) / d ** 0.25
    it = torch.randn((n_items, d), generator=g) / d ** 0.25
    users = torch.from_numpy(rng.choice(n_users, b, replace=False).astype(np.int64))
    ptr, cols, rows = _exclusions(rng, b, n_items, 30)
    want = _chain(users, ut, it, rows, cols, k)
    top = want.values
    assert (top[:, 1:] != top[:, :-1]).all(), "the case must be tie-free"
    got = st.score_topk(users, ut, it, ptr, cols, k)
    assert got.dtype == torch.int64 and got.shape == (b, k)
    assert torch.equal(got, want.indices)


@pytest.mark.parametrize("k", [1, 10, 20, 32, 33, 40])
def test_planted_ties_follow_the_cards_topk(k):
    """Items in groups of identical rows tie for every user: the set takes
    the lowest indices among the ties at the k-th, in the card's
    ``torch.topk`` order (a scalar transcription of its passes); for
    1 < k ≤ 32 that order differs from ascending index in most rows."""
    rng = np.random.default_rng(k)
    g = torch.Generator().manual_seed(k)
    d, n_items, b = 16, 600, 40
    distinct = torch.randn((60, d), generator=g)
    it = distinct[torch.from_numpy(rng.integers(0, 60, n_items))]
    ut = torch.randn((50, d), generator=g)
    users = torch.arange(b, dtype=torch.int64)
    ptr, cols, rows = _exclusions(rng, b, n_items, 12)
    scores = torch.sigmoid(ut[users] @ it.T)
    scores[rows, cols] = st.MASK_VALUE
    got = st.score_topk(users, ut, it, ptr, cols, k)
    assert got.tolist() == _card_topk(scores, k)
    lowest = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    assert torch.equal(torch.sort(got, 1).values, torch.sort(lowest, 1).values)
    if 2 < k <= 32:
        assert (got != lowest).any(1).float().mean() > 0.5
    else:
        assert torch.equal(got, lowest)


def test_sigmoid_rounding_ties():
    """Products of ~1e-5, as a LightGCN representation at amazon-book
    scale gives: the sigmoid rounds them onto a grid of 6e-8, so most top
    20s hold ties, and the op follows the card's ``torch.topk``."""
    g = torch.Generator().manual_seed(5)
    ut = torch.randn((64, 64), generator=g) * 1e-3
    it = torch.randn((3000, 64), generator=g) * 4e-4
    users = torch.arange(64, dtype=torch.int64)
    ptr = torch.zeros(65, dtype=torch.int64)
    scores = torch.sigmoid(ut @ it.T)
    top = torch.sort(scores, 1, descending=True).values[:, :21]
    assert (top[:, 1:] == top[:, :-1]).any(1).float().mean() > 0.9
    got = st.score_topk(users, ut, it, ptr, torch.zeros(0, dtype=torch.int64), 20)
    assert got.tolist() == _card_topk(scores, 20)


@pytest.mark.parametrize("k", [20, 40])
def test_fewer_unmasked_items_than_k(k):
    """A user with 3 unmasked items of 100: those 3 lead the set, which
    fills up with masked items (tied at -1e9), lowest index first, in the
    card's order."""
    g = torch.Generator().manual_seed(k)
    ut, it = torch.randn((4, 8), generator=g), torch.randn((100, 8), generator=g)
    users = torch.tensor([0, 1, 2, 3])
    keep = {5, 50, 97}
    masked = [i for i in range(100) if i not in keep]
    ptr = torch.tensor([0, 0, len(masked), len(masked), len(masked)])
    cols = torch.tensor(masked)
    got = st.score_topk(users, ut, it, ptr, cols, k)
    scores = torch.sigmoid(ut @ it.T)
    scores[1, cols] = st.MASK_VALUE
    assert got.tolist() == _card_topk(scores, k)
    assert set(got[1].tolist()) == keep | set(masked[:k - 3])


def test_order_helpers_agree():
    """`bitonic_order` (vectorised, the plain version's) equals the
    scalar transcription on rows with ties, k from 2 to 32."""
    g = torch.Generator().manual_seed(0)
    scores = torch.randint(0, 6, (30, 200), generator=g).float()
    for k in (2, 3, 7, 16, 20, 31, 32):
        assert st.topk_order(scores, k).tolist() == _card_topk(scores, k)


def test_rejects_bad_arguments():
    ut, it = torch.zeros((4, 8)), torch.zeros((10, 8))
    users, ptr, cols = torch.arange(2), torch.zeros(3, dtype=torch.int64), torch.zeros(0).long()
    with pytest.raises(ValueError):
        st.score_topk(users, ut, it, ptr, cols, 0)
    with pytest.raises(ValueError):
        st.score_topk(users, ut, it, ptr, cols, 11)
    with pytest.raises(ValueError):
        st.score_topk(users, ut.double(), it, ptr, cols, 2)
    with pytest.raises(ValueError):
        st.score_topk(users, ut, it, torch.zeros(2, dtype=torch.int64), cols, 2)
    assert st.supports(64, 20) and st.supports(64, 128) and st.supports(256, 64)
    assert not st.supports(2048, 20) and not st.supports(62, 20) and not st.supports(64, 129)


def _lightgcn(num_users=150, num_items=230, scale=1.0, **extra):
    data = make_synthetic_dataset(num_users, num_items, 2500, 600, seed=3)
    cfg = Config({"dataset": "t", "top_K": "[10, 20]", "embedding_size": "32",
                  "batch_size": "256", "test_batch_size": "64", "learn_rate": "0.01",
                  "reg_lambda": "0.0001", "GCN_layer": "2", "compute_dtype": "float32",
                  "propagation_backend": "dense", **extra})
    model = get_model("LightGCN")(cfg, data, device="cpu", generator=torch.Generator())
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        model.user_emb.copy_(torch.randn(model.user_emb.shape, generator=g) * scale)
        model.item_emb.copy_(torch.randn(model.item_emb.shape, generator=g) * scale)
    return cfg, data, model


def test_plan_offsets_index_the_exclusion_lists():
    """`EvalPlan.excl_ptr` gives each batch row its run of excl_cols: the
    row's train positives, sorted; padding rows have none."""
    cfg, data, _ = _lightgcn()
    plan = build_eval_plan(data, 64, device="cpu")
    users = plan.users.numpy()
    for b in range(users.shape[0]):
        ptr = plan.excl_ptr[b].numpy()
        assert ptr[0] == 0 and (np.diff(ptr) >= 0).all()
        for r in range(users.shape[1]):
            got = plan.excl_cols[b, ptr[r]:ptr[r + 1]].numpy()
            want = data.positive_items(users[b, r]) if plan.valid[b, r] else []
            assert np.array_equal(got, np.sort(want))
            assert (plan.excl_rows[b, ptr[r]:ptr[r + 1]].numpy() == r).all()


def test_lightgcn_evaluator_takes_the_fused_route(monkeypatch):
    """LightGCN's evaluator scores every batch on the op (the last batch
    with padding rows), and its metrics equal the chain's on the same
    representation, bit for bit."""
    cfg, data, model = _lightgcn()
    ev = Evaluator(model, data, cfg)
    rep = ev.compute_repr()
    assert ev.fused_factors(rep) is not None
    nb = ev.plan.users.shape[0]
    assert not ev.plan.valid[-1].all(), "the case needs padding rows"
    fused = ev.evaluate(rep)
    assert ev.route_batches == {"fused": nb, "chained": 0}
    monkeypatch.setattr(ev, "fused_factors", lambda r: None)
    chained = ev.evaluate(rep)
    assert ev.route_batches == {"fused": nb, "chained": nb}
    for m in ("recall", "precision", "ndcg"):
        assert np.array_equal(fused[m], chained[m])


def test_cvga_and_a_model_axis_keep_the_chain():
    """CVGA scores by its decoder: no factors, the chained route. On a
    mesh whose model axis shards the items, the chain (`sharded_topk`).
    A width or k the kernel does not take, or an item table of other than
    num_items rows, keeps the chain too."""
    data = make_synthetic_dataset(120, 200, 2000, 400, seed=4)
    cfg = load_model_config("CVGA")
    cfg = Config({**dict(cfg), "dataset": "t",
                  "embedding_size": "16", "test_batch_size": "64"})
    cvga = get_model("CVGA")(cfg, data, device="cpu", generator=torch.Generator())
    ev = Evaluator(cvga, data, cfg)
    rep = ev.compute_repr(torch.Generator().manual_seed(0))
    assert cvga.score_factors(rep) is None and ev.fused_factors(rep) is None
    ev.evaluate(rep)
    assert ev.route_batches == {"fused": 0, "chained": ev.plan.users.shape[0]}

    cfg, data, model = _lightgcn()
    rep = model.eval_embeddings()
    assert Evaluator(model, data, cfg, mesh=Mesh(1, 2)).fused_factors(rep) is None
    assert Evaluator(model, data, cfg, mesh=Mesh(2, 1)).fused_factors(rep) is not None
    assert Evaluator(model, data, cfg).fused_factors(
        tuple(t.to(torch.bfloat16) for t in rep)) is None
    # an item table with rows past num_items: the op would rank them
    assert Evaluator(model, data, cfg).fused_factors((rep[0], F.pad(rep[1], (0, 0, 0, 3)))) is None
    wide = Config({**dict(cfg), "top_K": "[20, 129]"})
    assert Evaluator(model, data, wide).fused_factors(rep) is None
