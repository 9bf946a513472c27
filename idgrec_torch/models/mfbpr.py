"""MF-BPR: matrix factorization with the BPR pairwise loss
(counterpart of idgrec_tpu/models/mfbpr.py): the raw tables, BPR plus
λ·L2 on the batch's rows, sigmoid dot-product scoring."""

from __future__ import annotations

import torch

from idgrec_torch.models.base import RecModel
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses


@register("MFBPR")
class MFBPR(RecModel):
    loss_names = ("bpr", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")

    def loss_terms(self, batch, generator=None, epoch=0):
        user_e = self.user_emb[batch["user"]]
        pos_e = self.item_emb[batch["pos"]]
        neg_e = self.item_emb[batch["neg"]]
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        return bpr, reg

    @torch.no_grad()
    def eval_embeddings(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.user_emb.detach().clone(), self.item_emb.detach().clone()
