"""Top-k with the items sharded over the model axis (counterpart of
idgrec_tpu/parallel/topk.py; ROADMAP A.9).

Model rank m scores only its column slice [m·I_pad/n, (m+1)·I_pad/n) of
the catalog (`item_slice`; the model's ``score_batch(..., items=)``),
masks the train positives that fall in it (`local_columns`), takes a
local top-k, and one all-gather of the [B, k] (value, global index)
candidates over the model group feeds the merge: the distributed
counterpart of ``torch.topk(rating, max(topK))`` that the evaluator and
`serving.Recommender` run on one card, with 1/n of its scoring product
a rank.

Pad columns sit at -2e9, below the evaluator's and the server's -1e9
mask, so a pad never wins. Among tied scores the lowest global item
index wins: the local ranking and the merge are stable sorts over
candidates in ascending index order. One card's `torch.topk` promises
no order among ties, so a run whose scores tie may pick other tied
items there. The JAX package's ``approx`` ranking is exact here, as on
one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from idgrec_torch.parallel.mesh import Mesh, all_gather_rows, model_width

PAD_VALUE = -2e9


def items_sharded(mesh: Mesh | None) -> bool:
    return model_width(mesh) > 1


def item_slice(num_items: int, mesh: Mesh) -> tuple[slice, int]:
    """(the rank's real columns [lo, hi) of the catalog, the slice width
    I_pad/n it ranks, its columns past ``num_items`` being pads)."""
    width = -(-num_items // mesh.model)
    lo = min(mesh.model_index * width, num_items)
    return slice(lo, min(lo + width, num_items)), width


def local_columns(cols: torch.Tensor, items: slice) -> torch.Tensor:
    """Global item ids ``cols`` as columns of the slice ``items``; an id
    outside it goes to the spare column ``items.stop - items.start``."""
    local = cols - items.start
    n = items.stop - items.start
    return torch.where((local >= 0) & (local < n), local, n)


def _stable_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The k largest of ``vals`` [B, n] by row, ties to the candidate
    that comes first; (values, the matching entries of ``idx``)."""
    top, order = torch.sort(vals, dim=1, descending=True, stable=True)
    order = order[:, :k]
    return top[:, :k], torch.gather(idx, 1, order)


def sharded_topk(local: torch.Tensor, items: slice, width: int, mesh: Mesh, k: int):
    """(values [B, k], indices [B, k] int64) of the row-wise top-k of the
    whole catalog, from ``local`` [B, items.stop - items.start], this
    rank's scores of its slice (`item_slice`), every rank of the model
    group given the same rows."""
    n = mesh.model
    b = local.shape[0]
    local = F.pad(local, (0, width - local.shape[1]), value=PAD_VALUE)
    kk = min(k, width)
    cols = torch.arange(items.start, items.start + width, device=local.device).expand(b, width)
    vals, idx = _stable_topk(local, cols, kk)
    # [n·B, kk] in rank order -> [B, n·kk], candidates in ascending index order
    vals_c = all_gather_rows(vals, mesh.model_group, n).reshape(n, b, kk)
    idx_c = all_gather_rows(idx, mesh.model_group, n).reshape(n, b, kk)
    vals_c = vals_c.permute(1, 0, 2).reshape(b, n * kk)
    idx_c = idx_c.permute(1, 0, 2).reshape(b, n * kk)
    idx_c, order = torch.sort(idx_c, dim=1)
    vals_c = torch.gather(vals_c, 1, order)
    return _stable_topk(vals_c, idx_c, k)
