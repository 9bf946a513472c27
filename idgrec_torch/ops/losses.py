"""Loss library of the ported models, always computed in float32
(counterpart of idgrec_tpu/ops/losses.py; the other loss heads come
with their models, ROADMAP A.7).

The literal epsilons of the reference (``10e-8`` = 1e-7 in the BPR loss
and in InfoNCE against an explicit pool, ``10e-6`` = 1e-5 in InfoNCE)
are kept so training-loss traces stay comparable. The JAX package
computes these outside any Pallas kernel, so they are stock PyTorch, in
the JAX functions' operation order; every matrix product runs in full
float32 on the card (the JAX package pins them to
``Precision.HIGHEST``), and a division by a Python number is a true
division (`propagate.true_divide`). Nothing here reads a value
back to the host: the L2 terms' backward counts rows by `index_add_`,
not `torch.bincount` (which reads the largest index on the card).

Under a data split (parallel/mesh.py `split_batch`) a batch tensor given
here is the rank's rows of the batch, and each function returns the
rank's share of the batch's loss: a mean over the batch divides by the
whole batch's rows (`batch_mean`); an in-batch denominator takes the
rank's rows against the all-gathered batch (`mesh.gather_batch`); a log
of a mean over all of the batch's pairs all-reduces the pair sum, takes
the log and keeps 1/D of it (`mesh.all_reduce`, `mesh.share`); a full
table enters through the data-sum boundary (`mesh.data_sum`). Without a
split those collectives are identities, so the same body computes one
process's loss in the JAX functions' operations.
"""

from __future__ import annotations

import math

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops.propagate import true_divide
from idgrec_torch.parallel import mesh as mesh_lib

_BPR_EPS = 10e-8  # sic (== 1e-7)
_INFONCE_EPS = 10e-6  # sic (== 1e-5)
_INFONCE_ALL_EPS = 10e-8  # sic (== 1e-7), InfoNCE against an explicit pool
_LIGHTGCL_EPS = 1e-8  # inside the log of LightGCL's full-table contrast


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the whole batch's entries: ``torch.mean``;
    under a data split, where ``x`` holds the rank's rows, their sum over
    the whole batch's count (the rank's share of the mean)."""
    split = mesh_lib.active_split()
    if split is None:
        return torch.mean(x)
    return true_divide(torch.sum(x), float(x.numel() * split.parts))


def bpr_loss(user_e: torch.Tensor, pos_e: torch.Tensor, neg_e: torch.Tensor) -> torch.Tensor:
    """Bayesian personalized ranking loss."""
    user_e, pos_e, neg_e = _f32(user_e), _f32(pos_e), _f32(neg_e)
    pos_score = torch.sum(user_e * pos_e, dim=1)
    neg_score = torch.sum(user_e * neg_e, dim=1)
    loss = -torch.log(torch.sigmoid(pos_score - neg_score) + _BPR_EPS)
    return batch_mean(loss)


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize the rows, the norm clamped below by eps
    (torch.nn.functional.normalize semantics)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: max, then min, against
    float32 bounds, so a value exactly on a bound passes half the
    cotangent, as JAX's max and min split a tie (`torch.clamp` passes
    all of it)."""
    lo_t, hi_t = (torch.full((), v, dtype=x.dtype, device=x.device) for v in (lo, hi))
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def align_loss(emb_1: torch.Tensor, emb_2: torch.Tensor) -> torch.Tensor:
    """DirectAU alignment: the mean squared distance of the normalized
    pairs."""
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    return batch_mean(torch.sum((emb_1 - emb_2) ** 2, dim=1))


def uniform_loss(embedding: torch.Tensor) -> torch.Tensor:
    """DirectAU uniformity: log of the mean of exp(-2‖e_i − e_j‖²) over
    the pairs i < j, as the JAX package sums it: (Σ_all − n) / 2, the
    diagonal's n terms exp(0) = 1 taken out of the full [n, n] sum."""
    check_exact_matmul(embedding.device)
    e = _normalize(_f32(embedding))
    # the rank's rows against the whole batch; the pair sum all-reduced
    e_all = mesh_lib.gather_batch(e)
    d2 = (torch.sum(e * e, dim=1)[:, None] + torch.sum(e_all * e_all, dim=1)[None, :]
          - 2.0 * torch.matmul(e, e_all.T))
    n = e_all.shape[0]
    total = (mesh_lib.all_reduce(torch.sum(torch.exp(-2.0 * d2))) - n) / 2.0
    return mesh_lib.share(torch.log(true_divide(total, n * (n - 1) / 2.0)))


def neighbor_aggregate_loss(emb_1: torch.Tensor, emb_2: torch.Tensor,
                            tau: float) -> torch.Tensor:
    """LightCCF's neighborhood-aggregation loss: the positive u·i⁺
    against a denominator over the sum of the two similarity matrices
    u·I_batchᵀ + u·U_batchᵀ."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    pos_score = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), tau))
    total = (torch.matmul(emb_1, mesh_lib.gather_batch(emb_2).T)
             + torch.matmul(emb_1, mesh_lib.gather_batch(emb_1).T))
    ttl_score = torch.sum(torch.exp(true_divide(total, tau)), dim=1)
    return batch_mean(-torch.log(pos_score / ttl_score + _INFONCE_EPS))


def lightcscf_loss(emb_1: torch.Tensor, emb_2: torch.Tensor, temperature: float,
                   margin: float) -> torch.Tensor:
    """LightCSCF's dual-filter contrastive loss: each score is
    exp(s/τ) + exp(relu(s − margin)/τ), over the sum of the two
    similarity matrices as in `neighbor_aggregate_loss`."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    sim = torch.sum(emb_1 * emb_2, dim=-1)
    pos_score = (torch.exp(true_divide(sim, temperature))
                 + torch.exp(true_divide(torch.relu(sim - margin), temperature)))
    total = (torch.matmul(emb_1, mesh_lib.gather_batch(emb_2).T)
             + torch.matmul(emb_1, mesh_lib.gather_batch(emb_1).T))
    total_score = (torch.exp(true_divide(total, temperature))
                   + torch.exp(true_divide(torch.relu(total - margin), temperature)))
    ttl = torch.sum(total_score, dim=1)
    return batch_mean(-torch.log(pos_score / ttl + _INFONCE_EPS))


def margin_alignment_loss(emb_1: torch.Tensor, emb_2: torch.Tensor,
                          margin: torch.Tensor) -> torch.Tensor:
    """MAWU's margin-aware alignment, with the reference's broadcast:
    the angle is [B] and the margin [B, 1], so angle + (1 − σ(margin))
    is [B, B] and the mean runs over all B² entries. Both clips are
    `_clip` (JAX's gradient on a bound); 1 − 1e-7 is 0.99999988 in
    float32 in both packages. Under a data split the rank's margin rows
    take the whole batch's angles."""
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    cos = torch.sum(emb_1 * emb_2, dim=-1)
    angle = mesh_lib.gather_batch(torch.arccos(_clip(cos, -1 + 1e-7, 1 - 1e-7)))
    angle = _clip(angle + (1.0 - torch.sigmoid(_f32(margin))), 0.0, math.pi)
    return -batch_mean(torch.cos(angle))


def dot_uniformity_loss(embeddings: torch.Tensor, t: float = 2.0) -> torch.Tensor:
    """MAWU's weighted dot-uniformity, with the reference's quirk: the
    entries that ``tril(·, -1)`` masks become 0 and still contribute
    exp(-2·t) after the 2 − 2·cos shift."""
    check_exact_matmul(embeddings.device)
    e = _normalize(_f32(embeddings))
    # the rank's rows (from row lo of the batch) against the whole batch;
    # the rank's share of the mean all-reduced
    split = mesh_lib.active_split()
    lo = 0 if split is None else split.lo
    cos = torch.tril(torch.matmul(e, mesh_lib.gather_batch(e).T), diagonal=lo - 1)
    cos = 2.0 - 2.0 * cos
    return mesh_lib.share(torch.log(mesh_lib.all_reduce(batch_mean(torch.exp(-t * cos)))))


def infonce_loss(emb_1: torch.Tensor, emb_2: torch.Tensor, temperature: float) -> torch.Tensor:
    """In-batch InfoNCE with both views L2-normalized; the denominator
    runs over emb_2's batch (emb_1 @ emb_2ᵀ, in full float32 on the
    card)."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    pos_score = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), temperature))
    pool = mesh_lib.gather_batch(emb_2)
    ttl_score = torch.sum(torch.exp(true_divide(torch.matmul(emb_1, pool.T), temperature)),
                          dim=1)
    return batch_mean(-torch.log(pos_score / ttl_score + _INFONCE_EPS))


def infonce_loss_all(emb_1: torch.Tensor, emb_2: torch.Tensor, emb_2_all: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """`infonce_loss` against an explicit pool of negatives: the
    denominator runs over ``emb_2_all`` (emb_1 @ emb_2_allᵀ), with its
    own epsilon. Under a data split ``emb_2_all`` is whole on every rank
    and built from gathered rows (MixRec's pools), so its backward sums
    over the data axis already."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    emb_2_all = _normalize(_f32(emb_2_all))
    pos_score = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), temperature))
    ttl_score = torch.sum(
        torch.exp(true_divide(torch.matmul(emb_1, emb_2_all.T), temperature)), dim=1)
    return batch_mean(-torch.log(pos_score / ttl_score + _INFONCE_ALL_EPS))


def infonce_loss_sum(emb_1: torch.Tensor, emb_2: torch.Tensor, emb_all: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """`infonce_loss_all` reduced by sum, not mean: the contrast against a
    full table (NCL's structural term, CGCL's three heads), which enters
    through the data-sum boundary. The step keeps one float32
    [B, rows(emb_all)] score matrix for the backward (the output of
    ``exp``); under a data split [B/D, rows(emb_all)]."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    emb_all = _normalize(_f32(mesh_lib.data_sum(emb_all)))
    pos_score = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), temperature))
    ttl_score = torch.sum(
        torch.exp(true_divide(torch.matmul(emb_1, emb_all.T), temperature)), dim=1)
    return torch.sum(-torch.log(pos_score / ttl_score + _INFONCE_ALL_EPS))


def _log_total(emb_b: torch.Tensor, table: torch.Tensor, temperature: float) -> torch.Tensor:
    """mean over the batch of log(Σ_rows exp(emb_b · tableᵀ / t) + 1e-8):
    the contrast against a full table, keeping one float32
    [B, rows(table)] score matrix for the backward."""
    scores = torch.exp(true_divide(torch.matmul(emb_b, _f32(mesh_lib.data_sum(table)).T),
                                   temperature))
    return batch_mean(torch.log(torch.sum(scores, dim=1) + _LIGHTGCL_EPS))


def lightgcl_ssl_loss(user_e: torch.Tensor, pos_e: torch.Tensor, g_user_b: torch.Tensor,
                      g_item_b: torch.Tensor, user_all: torch.Tensor, item_all: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """LightGCL's contrast between its SVD branch and its main branch,
    unnormalized (the JAX model's operation order, lightgcl.py:77-92):
    each side's batch rows of the SVD branch (``g_user_b``, ``g_item_b``)
    against the main branch's full table (log of the summed exp, + 1e-8
    inside the log), less the positive pairs' scores with the main
    branch's batch rows clipped to [-5, 5] (`_clip`, JAX's gradient on a
    bound). Returns −pos + neg; the model weighs it by ``ssl_lambda``."""
    check_exact_matmul(user_e.device)
    gu, gi = _f32(g_user_b), _f32(g_item_b)
    neg = _log_total(gu, user_all, temperature) + _log_total(gi, item_all, temperature)
    pos = batch_mean(_clip(true_divide(torch.sum(_f32(user_e) * gu, dim=1), temperature),
                           -5.0, 5.0))
    pos = pos + batch_mean(_clip(true_divide(torch.sum(_f32(pos_e) * gi, dim=1), temperature),
                                 -5.0, 5.0))
    return -pos + neg


def elbo_loss(recon_x: torch.Tensor, x: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
              anneal: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The VAE's ELBO terms (CVGA): the softmax cross-entropy of the
    decoder's rows ``recon_x`` [B, I] against the target rows ``x``, and
    the KL term times ``anneal``, with the reference's double
    normalisation (both / B and a mean over the batch)."""
    recon_x, x, mu, logvar = _f32(recon_x), _f32(x), _f32(mu), _f32(logvar)
    bce = -batch_mean(torch.sum(torch.log_softmax(recon_x, dim=1) * x, dim=-1))
    kld = (-0.5 / mesh_lib.batch_rows(recon_x.shape[0])) * batch_mean(
        torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1))
    return bce, anneal * kld


def reg_loss(*embeddings: torch.Tensor) -> torch.Tensor:
    """L2 regularization: sum over args of ½‖E‖²_F / rows(E), each E
    whole (a table, or one process's batch rows)."""
    return _reg_rows(embeddings, [e.shape[0] for e in embeddings])


def _reg_rows(embeddings, rows) -> torch.Tensor:
    """Σ ½‖E‖²_F / rows for each E and its row count."""
    total = torch.zeros((), dtype=torch.float32, device=embeddings[0].device)
    for e, n in zip(embeddings, rows):
        e = _f32(e)
        total = total + 0.5 * torch.sum(e * e) / n
    return total


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 [n]: how often each row occurs in ``idx``, the values of
    ``torch.bincount(idx, minlength=n)``. Summed by `index_add_` (exact:
    every partial sum is an integer below 2**24), so the card reads
    nothing back."""
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return torch.zeros(n, dtype=torch.float32, device=idx.device).index_add_(0, idx, ones)


def _whole_indices(*idxs):
    """The whole batch's indices (`mesh.whole_index`) and the rank's rows'
    L2 over the whole batch's row counts: the L2 terms' forward is the
    rank's share and their backward the whole batch's gradient, on every
    data rank alike (the counts are the whole batch's), so the tables
    they read enter the step without a data sum."""
    whole = tuple(mesh_lib.whole_index(i) for i in idxs)
    return whole, [w.shape[0] for w in whole]


class _RegLossIndexed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_table, item_table, u, p, n):
        (wu, wp, wn), rows = _whole_indices(u, p, n)
        ctx.save_for_backward(user_table, item_table, wu, wp, wn)
        return _reg_rows((user_table[u], item_table[p], item_table[n]), rows)

    @staticmethod
    def backward(ctx, g):
        user_table, item_table, u, p, n = ctx.saved_tensors
        # integer counts are order-free, so the result repeats run to run
        cu = _counts(u, user_table.shape[0])
        ci = (_counts(p, item_table.shape[0]) / p.shape[0]
              + _counts(n, item_table.shape[0]) / n.shape[0])
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
    1/B per occurrence) only when B is not a power of two. Under a data
    split the value is the rank's rows' share and the backward the whole
    batch's gradient (`_whole_indices`)."""
    return _RegLossIndexed.apply(user_table, item_table, u, p, n)


class _RegLossCounted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, *idxs):
        whole, rows = _whole_indices(*idxs)
        ctx.save_for_backward(table, *whole)
        return _reg_rows([table[i] for i in idxs], rows)

    @staticmethod
    def backward(ctx, g):
        table, *idxs = ctx.saved_tensors
        c = torch.zeros(table.shape[0], dtype=torch.float32, device=table.device)
        for i in idxs:
            c = c + true_divide(_counts(i, table.shape[0]), float(i.shape[0]))
        d = (g * c)[:, None] * _f32(table)
        return (d.to(table.dtype),) + (None,) * len(idxs)


def reg_loss_counted(table: torch.Tensor, *idxs: torch.Tensor) -> torch.Tensor:
    """reg_loss(table[i] for i in idxs) for one table with the
    scatter-free backward of `reg_loss_indexed`: d(table) =
    g · (Σ_i count_i / len(i)) ⊙ table. Values equal reg_loss(...); the
    backward equals the JAX one (which adds 1/len(i) per occurrence)
    when every len(i) is a power of two. Under a data split as
    `reg_loss_indexed`."""
    return _RegLossCounted.apply(table, *idxs)
