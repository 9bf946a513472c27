"""Top-K ranking metrics, computed on the model's device (counterpart
of idgrec_tpu/ops/metrics.py).

Binary hit labels from the recommended top-K list, then

* Recall@k    = Σ_u hits_u(k) / |test(u)|
* Precision@k = Σ_u hits_u(k) / k
* NDCG@k with binary gains and IDCG over min(k, |test(u)|)

All functions return per-batch sums (the caller divides by the total
number of test users), so accumulating over user batches is an add.
"""

from __future__ import annotations

import torch


def hit_matrix(topk_items: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Binary [B, K] labels: topk_items[b, k] ∈ truth[b]. truth is
    padded with -1 (never a valid item id)."""
    eq = topk_items[:, :, None] == truth[:, None, :]
    return eq.any(dim=-1).to(torch.float32)


def truth_sizes(truth: torch.Tensor) -> torch.Tensor:
    return (truth >= 0).sum(dim=1)


def topk_metric_sums(topk_items: torch.Tensor, truth: torch.Tensor, ks: tuple[int, ...],
                     valid: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Batch-summed recall/precision/ndcg at each k.

    topk_items: [B, K_max] recommended ids (K_max >= max(ks))
    truth:      [B, T] ground-truth ids padded with -1
    valid:      [B] bool, the rows to count (padding users excluded)

    Returns {"recall": [len(ks)], "precision": ..., "ndcg": ...,
    "count": scalar}, sums over valid rows."""
    r = hit_matrix(topk_items, truth)
    dev = r.device
    sizes = truth_sizes(truth).to(torch.float32)
    if valid is None:
        valid_f = torch.ones(r.shape[0], dtype=torch.float32, device=dev)
    else:
        valid_f = valid.to(torch.float32)
    safe_sizes = torch.clamp(sizes, min=1.0)  # no 0/0 on padded rows

    positions = torch.arange(r.shape[1], dtype=torch.float32, device=dev)
    discounts = 1.0 / torch.log2(positions + 2.0)

    recalls, precisions, ndcgs = [], [], []
    for k in ks:
        hits_k = r[:, :k].sum(dim=1)
        recalls.append(torch.sum(valid_f * hits_k / safe_sizes))
        precisions.append(torch.sum(valid_f * hits_k) / k)

        dcg = torch.sum(r[:, :k] * discounts[:k], dim=1)
        # ideal DCG: the first min(k, |test(u)|) positions are hits
        ideal_hits = torch.clamp(sizes, max=float(k))
        cum_discount = torch.cumsum(discounts[:k], dim=0)
        idx = torch.clamp(ideal_hits.to(torch.int64) - 1, 0, k - 1)
        idcg = torch.where(ideal_hits > 0, cum_discount[idx], torch.ones_like(ideal_hits))
        ndcg = torch.where(idcg > 0, dcg / idcg, torch.zeros_like(dcg))
        ndcgs.append(torch.sum(valid_f * ndcg))

    return {
        "recall": torch.stack(recalls),
        "precision": torch.stack(precisions),
        "ndcg": torch.stack(ndcgs),
        "count": torch.sum(valid_f),
    }


def f1(precision, recall) -> torch.Tensor:
    """Element-wise F1 from per-k precision/recall arrays (0 where
    precision + recall == 0)."""
    precision = torch.as_tensor(precision, dtype=torch.float32)
    recall = torch.as_tensor(recall, dtype=torch.float32)
    denom = precision + recall
    return torch.where(denom > 0, 2.0 * precision * recall / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(denom))
