"""The port's ranking metrics on the cases of tests/test_metrics.py,
against an independent numpy recomputation and the JAX package.

Tolerances: rtol 1e-5 against numpy (float64 there), rtol 1e-6 against
the JAX functions (the same f32 operations)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from idgrec_torch.ops.metrics import f1, hit_matrix, topk_metric_sums, truth_sizes
from idgrec_tpu.ops import metrics as j_metrics


def _np_metrics(topk, truths, ks):
    B, K = topk.shape
    r = np.zeros((B, K))
    for b in range(B):
        for k in range(K):
            r[b, k] = 1.0 if topk[b, k] in truths[b] else 0.0
    out = {"recall": [], "precision": [], "ndcg": []}
    for k in ks:
        rec = sum(r[b, :k].sum() / len(truths[b]) for b in range(B))
        prec = r[:, :k].sum() / k
        disc = 1.0 / np.log2(np.arange(2, k + 2))
        ndcg = 0.0
        for b in range(B):
            idcg = disc[: min(k, len(truths[b]))].sum() or 1.0
            ndcg += (r[b, :k] * disc).sum() / idcg
        out["recall"].append(rec)
        out["precision"].append(prec)
        out["ndcg"].append(ndcg)
    return {k: np.array(v) for k, v in out.items()}


def _pad(truths, width):
    out = np.full((len(truths), width), -1, dtype=np.int64)
    for i, t in enumerate(truths):
        out[i, : len(t)] = t
    return out


def test_hit_matrix_and_truth_sizes():
    topk = torch.tensor([[3, 1, 7], [0, 2, 9]])
    truth = torch.from_numpy(_pad([[1, 3], [9]], 2))
    assert hit_matrix(topk, truth).tolist() == [[1, 1, 0], [0, 0, 1]]
    assert truth_sizes(truth).tolist() == [2, 1]


def test_metric_sums_match_reference_math_and_jax():
    rng = np.random.default_rng(2024)
    B, K, num_items = 16, 10, 50
    topk = np.stack([rng.permutation(num_items)[:K] for _ in range(B)]).astype(np.int64)
    truths = [list(rng.choice(num_items, size=rng.integers(1, 8), replace=False)) for _ in range(B)]
    ks = (3, 5, 10)
    truth = _pad(truths, 8)
    got = topk_metric_sums(torch.from_numpy(topk), torch.from_numpy(truth), ks)
    want = _np_metrics(topk, truths, ks)
    ref = j_metrics.topk_metric_sums(jnp.asarray(topk, jnp.int32),
                                     jnp.asarray(truth, jnp.int32), ks)
    for name in ("recall", "precision", "ndcg"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-5)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-6)
    assert float(got["count"]) == B


def test_valid_mask_excludes_padding():
    topk = torch.tensor([[0, 1], [2, 3], [4, 5]])
    truth = torch.from_numpy(_pad([[0], [2], [4]], 1))
    got = topk_metric_sums(topk, truth, (2,), valid=torch.tensor([True, True, False]))
    assert float(got["recall"][0]) == 2.0  # third row ignored
    assert float(got["count"]) == 2.0


def test_rows_without_truth_count_nothing():
    topk = torch.tensor([[0, 1], [2, 3]])
    truth = torch.from_numpy(_pad([[0], []], 1))
    got = topk_metric_sums(topk, truth, (2,))
    assert float(got["recall"][0]) == 1.0 and float(got["ndcg"][0]) == 1.0


def test_perfect_ranking():
    topk = torch.tensor([[7, 3, 0, 1]])
    truth = torch.from_numpy(_pad([[7, 3]], 2))
    got = topk_metric_sums(topk, truth, (2, 4))
    assert float(got["recall"][0]) == 1.0
    assert float(got["ndcg"][0]) == 1.0
    assert float(got["recall"][1]) == 1.0


def test_f1_matches_reference_semantics():
    pre = np.array([0.5, 0.0, 0.2], np.float32)
    rec = np.array([0.25, 0.0, 0.3], np.float32)
    out = f1(pre, rec).numpy()
    exp = [(2 * p * r / (p + r)) if p + r > 0 else 0.0 for p, r in zip(pre, rec)]
    np.testing.assert_allclose(out, exp, rtol=1e-6)
    np.testing.assert_allclose(out, np.asarray(j_metrics.f1(pre, rec)), rtol=1e-6)
