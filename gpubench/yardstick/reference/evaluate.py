"""Full-catalog top-K metrics of a representation, as the reference
framework defines them: every test user's scores sigmoid(u·i) over all
items in float32, the user's train items masked out, the exact top
max(K) items, and the sums over test users of Recall@k = hits / |test|,
Precision@k = hits / k and NDCG@k with binary gains (IDCG over
min(k, |test|) hits), each divided by the number of test users."""

from __future__ import annotations

import numpy as np
import torch


def _csr(users: np.ndarray, items: np.ndarray, n: int):
    order = np.lexsort((items, users))
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, users + 1, 1)
    return np.cumsum(ptr), items[order]


def _rows(ptr, items, users):
    """(row in the block, slot in the row, item) of every listed item of
    ``users``."""
    counts = ptr[users + 1] - ptr[users]
    rows = np.repeat(np.arange(users.size), counts)
    slot = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    return rows, slot, items[np.repeat(ptr[users], counts) + slot]


@torch.no_grad()
def metrics(user_f: torch.Tensor, item_f: torch.Tensor, train_user, train_item, test_user,
            test_item, top_ks, block: int = 2048) -> dict[str, np.ndarray]:
    dev = user_f.device
    nu = user_f.shape[0]
    tr_ptr, tr_items = _csr(np.asarray(train_user), np.asarray(train_item), nu)
    te_ptr, te_items = _csr(np.asarray(test_user), np.asarray(test_item), nu)
    test_users = np.nonzero(np.diff(te_ptr))[0]
    ks = list(top_ks)
    k_max = max(ks)
    discounts = 1.0 / torch.log2(torch.arange(k_max, dtype=torch.float64, device=dev) + 2.0)
    cum = torch.cumsum(discounts, 0)
    sums = {m: torch.zeros(len(ks), dtype=torch.float64, device=dev)
            for m in ("recall", "precision", "ndcg")}
    for s in range(0, test_users.size, block):
        users = test_users[s: s + block]
        scores = torch.sigmoid(user_f[torch.as_tensor(users, device=dev)] @ item_f.T)
        rows, _, cols = _rows(tr_ptr, tr_items, users)
        scores[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)] = -np.inf
        top = torch.topk(scores, k_max, dim=1).indices
        rows, slot, truth = _rows(te_ptr, te_items, users)
        sizes = torch.as_tensor(te_ptr[users + 1] - te_ptr[users], dtype=torch.float64,
                                device=dev)
        padded = torch.full((users.size, int(sizes.max())), -1, dtype=torch.int64, device=dev)
        padded[torch.as_tensor(rows, device=dev), torch.as_tensor(slot, device=dev)] = \
            torch.as_tensor(truth, device=dev)
        hit = (top[:, :, None] == padded[:, None, :]).any(-1).to(torch.float64)
        for j, k in enumerate(ks):
            h = hit[:, :k].sum(1)
            sums["recall"][j] += (h / sizes).sum()
            sums["precision"][j] += h.sum() / k
            idcg = cum[torch.clamp(sizes, max=k).long() - 1]
            sums["ndcg"][j] += ((hit[:, :k] * discounts[:k]).sum(1) / idcg).sum()
    return {m: (v / test_users.size).cpu().numpy() for m, v in sums.items()}
