"""On-device k-means (Lloyd's iterations) for NCL's prototype step
(counterpart of idgrec_tpu/ops/kmeans.py).

Init: k distinct random rows (`noise.choice`). Each iteration assigns
every row to its nearest centroid by the expansion
``x² − 2·x·c + c²`` (a float32 [N, k] product, in full float32 on the
card; the same expansion as the JAX package, not `torch.cdist`), then
moves each centroid to the mean of its rows. An empty cluster keeps its
previous centroid.

The centroid sums go through kernel K4
(`scatter.scatter_add_rows_unchecked`): rows added in index order with
no float atomics, so the clustering repeats bit for bit on the card,
where ``index_add_``'s atomics would not (and a resumed NCL run equals
a straight one). The counts are a float32 ``index_add_`` of ones, exact
below 2**24 whatever the order; `torch.bincount` would read the largest
index back to the host. The number of iterations is fixed and nothing
is read back, so a clustering runs under sync debug mode "error".
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import noise, scatter


def _assign(x: torch.Tensor, x_sq: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """int64 [N]: the nearest centroid of each row of x (the first on a
    tie), by x² − 2·x·c + c²; ``x_sq`` is x² summed per row, [N, 1]."""
    c_sq = torch.sum(centroids * centroids, dim=1)
    logits = 2.0 * torch.matmul(x, centroids.T)
    return torch.argmin(x_sq - logits + c_sq[None, :], dim=1)


def kmeans(x: torch.Tensor, k: int, generator: torch.Generator,
           iters: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """Cluster the rows of x [N, d] into k: (centroids float32 [k, d],
    assignment int64 [N]) after ``iters`` Lloyd iterations from k distinct
    rows drawn from ``generator`` (on x's device)."""
    check_exact_matmul(x.device)
    x = x.detach().to(torch.float32).contiguous()
    n = x.shape[0]
    centroids = x[noise.choice(n, k, generator)]
    x_sq = torch.sum(x * x, dim=1, keepdim=True)
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = _assign(x, x_sq, centroids)
        sums = scatter.scatter_add_rows_unchecked(a, x, k)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(0, a, ones)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, means, centroids)
    return centroids, _assign(x, x_sq, centroids)
