"""SimGCL (Yu et al., SIGIR'22): noise-perturbed contrastive views
(counterpart of idgrec_tpu/models/simgcl.py).

LightGCN aggregation without layer 0 in the mean; each perturbed view
adds sign(e)·ε·normalize(U(0, 1)) to every layer; three chains a step
(the clean one and two views); InfoNCE between the views over the
batch's distinct users and items.

The three chains run as one: concatenated along the features, each
layer is one ``graph.matmul`` at 3d (on the card one launch of K6 each
way, at d = 192), as in the JAX package. The views' noise is drawn
layer by layer, view 1 before view 2, from the step's generator
(ops/noise.py). The distinct rows are a static-shape mask of first
occurrences, not `torch.unique`, whose output's shape the host would
have to read.
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    lightgcn_propagate,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.losses import _INFONCE_EPS, _f32, _normalize
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup
from idgrec_torch.ops.propagate import build_adjacency, true_divide


def first_occurrence_mask(ids: torch.Tensor) -> torch.Tensor:
    """[B] bool, True at the first occurrence of each distinct id: a
    stable sort, the changes between neighbours, scattered back."""
    sorted_ids, order = torch.sort(ids, stable=True)
    is_first = torch.ones_like(ids, dtype=torch.bool)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    return torch.zeros_like(is_first).scatter(0, order, is_first)


def masked_infonce_loss(emb_1: torch.Tensor, emb_2: torch.Tensor, mask: torch.Tensor,
                        temperature: float) -> torch.Tensor:
    """InfoNCE over the masked rows: the denominator runs over the masked
    rows of emb_2 and the mean over the masked rows, which equals
    ``infonce_loss(emb_1[mask], emb_2[mask], temperature)``. ``mask`` is
    the whole batch's; under a data split the embeddings are the rank's
    rows, the denominator runs over the gathered emb_2, and the loss is
    the rank's share of the mean."""
    check_exact_matmul(emb_1.device)
    emb_1 = _normalize(_f32(emb_1))
    emb_2 = _normalize(_f32(emb_2))
    m_all = mask.to(torch.float32)
    m = mesh_lib.own_rows(m_all)
    pos = torch.exp(true_divide(torch.sum(emb_1 * emb_2, dim=-1), temperature))
    sims = torch.exp(true_divide(torch.matmul(emb_1, mesh_lib.gather_batch(emb_2).T),
                                 temperature))
    ttl = torch.sum(sims * m_all[None, :], dim=1)
    per_row = -torch.log(pos / ttl + _INFONCE_EPS)
    return torch.sum(per_row * m) / torch.clamp(torch.sum(m_all), min=1.0)


def perturb(h: torch.Tensor, epsilon: float, generator: torch.Generator) -> torch.Tensor:
    """h + sign(h)·ε·normalize(U(0, 1)): the noise drawn from ``generator``
    in h's shape and type, each row normalized."""
    n = noise.uniform(h.shape, generator, dtype=h.dtype)
    return h + torch.sign(h) * _normalize(n) * epsilon


def perturbed_propagate(graph, emb0: torch.Tensor, num_layers: int, epsilon: float,
                        generator: torch.Generator) -> torch.Tensor:
    """One noisy chain: the mean of the perturbed layers 1..K."""
    h, acc = emb0, None
    for _ in range(num_layers):
        h = perturb(graph.matmul(h), epsilon, generator)
        acc = h if acc is None else acc + h
    return true_divide(acc, float(num_layers))


@register("SimGCL")
class SimGCL(RecModel):
    aggregates_per_step = 3  # the clean chain and two views
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.epsilon = config.float("epsilon")
        self.temperature = config.float("temperature")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def _train_propagate(self, generator: torch.Generator):
        """(clean, view 1, view 2), each [U+I, d], from one chain at 3d."""
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        d = emb0.shape[1]
        h, acc = torch.cat([emb0, emb0, emb0], dim=1), None
        for _ in range(self.num_layers):
            h = self.graph.matmul(h)
            hc, h1, h2 = h[:, :d], h[:, d: 2 * d], h[:, 2 * d:]
            h1 = perturb(h1, self.epsilon, generator)
            h2 = perturb(h2, self.epsilon, generator)
            h = torch.cat([hc, h1, h2], dim=1)
            acc = h if acc is None else acc + h
        acc = true_divide(acc, float(self.num_layers))
        return acc[:, :d], acc[:, d: 2 * d], acc[:, 2 * d:]

    def loss_terms(self, batch, generator=None, epoch=0):
        generator = noise.require_generator(generator, "SimGCL.loss_terms")
        clean, view1, view2 = self._train_propagate(generator)
        user_all, item_all = split_user_item(clean, self.num_users)
        u1, i1 = split_user_item(view1, self.num_users)
        u2, i2 = split_user_item(view2, self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        users, pos = batch["user"], batch["pos"]
        user_mask = first_occurrence_mask(mesh_lib.whole_index(users))
        item_mask = first_occurrence_mask(mesh_lib.whole_index(pos))
        user_ssl = masked_infonce_loss(lookup(u1, users), lookup(u2, users), user_mask,
                                       self.temperature)
        item_ssl = masked_infonce_loss(lookup(i1, pos), lookup(i2, pos), item_mask,
                                       self.temperature)
        return bpr, reg, self.ssl_lambda * (user_ssl + item_ssl)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The clean chain: the mean of layers 1..K."""
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        final = lightgcn_propagate(self.graph, emb0, self.num_layers, include_layer0=False)
        return split_user_item(final, self.num_users)
