"""LightGCN++ (Lee et al., RecSys'24) (counterpart of
idgrec_tpu/models/lightgcn_pp.py).

The generalized normalization Ã = D^-α A D^-β (the ``gen`` adjacency:
on the card's default route the dense matrix, whose products run K6);
each layer's input rows L2-normalized before the product; final =
γ·e⁰ + (1 − γ)·mean(layers 1..K); BPR and L2 on the ego rows.

A node with no train edge has a zero row after the first layer. The
norm's gradient there is PyTorch's, 0, so the step stays finite; the
JAX package's norm has a NaN gradient at a zero row, which its fused
and dense products carry into every row (ROADMAP C).
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops.propagate import build_adjacency, true_divide


@register("LightGCN_pp")
class LightGCNPP(RecModel):
    loss_names = ("bpr", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.gamma = config.float("gamma")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "gen", self.backend, alpha=config.float("alpha"), beta=config.float("beta"),
            compute_dtype=self.compute_dtype, emb_size=self.embedding_size, device=self.device,
        )

    def propagate(self) -> tuple[torch.Tensor, torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        h, acc = emb0, None
        for _ in range(self.num_layers):
            norm = torch.linalg.vector_norm(h, dim=1) + 1e-12
            h = self.graph.matmul(h / norm[:, None])
            acc = h if acc is None else acc + h
        prop = true_divide(acc, float(self.num_layers))
        final = self.gamma * emb0 + (1.0 - self.gamma) * prop
        return split_user_item(final, self.num_users)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.propagate()
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        return bpr, reg

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.propagate()
