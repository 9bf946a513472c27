"""Loss library of the ported models, always computed in float32
(counterpart of idgrec_tpu/ops/losses.py; the other loss heads come
with their models, ROADMAP A.7).

The literal epsilons of the reference (``10e-8`` = 1e-7 in the BPR loss,
``10e-6`` = 1e-5 in InfoNCE) are kept so training-loss traces stay
comparable. The JAX package computes these outside any Pallas kernel,
so they are stock PyTorch.
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops.propagate import true_divide

_BPR_EPS = 10e-8  # sic (== 1e-7)
_INFONCE_EPS = 10e-6  # sic (== 1e-5)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def bpr_loss(user_e: torch.Tensor, pos_e: torch.Tensor, neg_e: torch.Tensor) -> torch.Tensor:
    """Bayesian personalized ranking loss."""
    user_e, pos_e, neg_e = _f32(user_e), _f32(pos_e), _f32(neg_e)
    pos_score = torch.sum(user_e * pos_e, dim=1)
    neg_score = torch.sum(user_e * neg_e, dim=1)
    loss = -torch.log(torch.sigmoid(pos_score - neg_score) + _BPR_EPS)
    return torch.mean(loss)


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize the rows, the norm clamped below by eps
    (torch.nn.functional.normalize semantics)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def infonce_loss(emb_1: torch.Tensor, emb_2: torch.Tensor, temperature: float) -> torch.Tensor:
    """In-batch InfoNCE with both views L2-normalized; the denominator
    runs over emb_2's batch (emb_1 @ emb_2ᵀ, in full float32 on the
    card)."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    pos_score = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), temperature))
    ttl_score = torch.sum(torch.exp(true_divide(torch.matmul(emb_1, emb_2.T), temperature)),
                          dim=1)
    return torch.mean(-torch.log(pos_score / ttl_score + _INFONCE_EPS))


def reg_loss(*embeddings: torch.Tensor) -> torch.Tensor:
    """L2 regularization: sum over args of ½‖E‖²_F / rows(E)."""
    total = torch.zeros((), dtype=torch.float32, device=embeddings[0].device)
    for e in embeddings:
        e = _f32(e)
        total = total + 0.5 * torch.sum(e * e) / e.shape[0]
    return total


class _RegLossIndexed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_table, item_table, u, p, n):
        ctx.save_for_backward(user_table, item_table, u, p, n)
        return reg_loss(user_table[u], item_table[p], item_table[n])

    @staticmethod
    def backward(ctx, g):
        user_table, item_table, u, p, n = ctx.saved_tensors
        # integer counts are order-free, so the result repeats run to run
        cu = torch.bincount(u, minlength=user_table.shape[0]).to(torch.float32)
        ci = (torch.bincount(p, minlength=item_table.shape[0]).to(torch.float32) / p.shape[0]
              + torch.bincount(n, minlength=item_table.shape[0]).to(torch.float32) / n.shape[0])
        du = (g * cu / u.shape[0])[:, None] * _f32(user_table)
        di = (g * ci)[:, None] * _f32(item_table)
        return du.to(user_table.dtype), di.to(item_table.dtype), None, None, None


def reg_loss_indexed(user_table: torch.Tensor, item_table: torch.Tensor, u: torch.Tensor,
                     p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """reg_loss(user_table[u], item_table[p], item_table[n]) with a
    scatter-free backward.

    The L2 term's gradient scatters identical rows: every occurrence of
    table row r contributes table[r]/B, so the row scatter collapses to
    a per-row count times an elementwise table scale,
    d(table) = g · (count/B) ⊙ table. Values equal reg_loss(...) (same
    forward operations); the backward differs from autograd's sequential
    duplicate adds by f32 ulps, and from the JAX backward (which adds
    1/B per occurrence) only when B is not a power of two."""
    return _RegLossIndexed.apply(user_table, item_table, u, p, n)


class _RegLossCounted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, *idxs):
        ctx.save_for_backward(table, *idxs)
        return reg_loss(*(table[i] for i in idxs))

    @staticmethod
    def backward(ctx, g):
        table, *idxs = ctx.saved_tensors
        c = torch.zeros(table.shape[0], dtype=torch.float32, device=table.device)
        for i in idxs:
            c = c + true_divide(torch.bincount(i, minlength=table.shape[0]).to(torch.float32),
                                float(i.shape[0]))
        d = (g * c)[:, None] * _f32(table)
        return (d.to(table.dtype),) + (None,) * len(idxs)


def reg_loss_counted(table: torch.Tensor, *idxs: torch.Tensor) -> torch.Tensor:
    """reg_loss(table[i] for i in idxs) for one table with the
    scatter-free backward of `reg_loss_indexed`: d(table) =
    g · (Σ_i count_i / len(i)) ⊙ table. Values equal reg_loss(...); the
    backward equals the JAX one (which adds 1/len(i) per occurrence)
    when every len(i) is a power of two."""
    return _RegLossCounted.apply(table, *idxs)
