"""MAWU (Park et al., CIKM'23): margin-aware alignment and weighted
uniformity (counterpart of idgrec_tpu/models/mawu.py). The MF or
LightGCN encoder, a learned one-entry margin per user and per item
(four tables), the margin alignment through arccos with the reference's
[B, B] broadcast, and γ_u/γ_i-weighted dot-uniformity."""

from __future__ import annotations

import torch

from idgrec_torch.models.base import RecModel, batch_user_pos_embeddings, xavier_uniform
from idgrec_torch.models.encoders import EncoderSwitchMixin
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses


@register("MAWU")
class MAWU(EncoderSwitchMixin, RecModel):
    loss_names = ("align", "uniform", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.gamma_user = config.float("gamma_user")
        self.gamma_item = config.float("gamma_item")
        self.reg_lambda = config.float("reg_lambda")
        self._init_encoder(config, data)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The two tables Xavier-uniform, then the margins [U, 1] and
        [I, 1] standard normal (the reference's embedding default), drawn
        in that order from ``generator``."""
        d = self.embedding_size
        tables = {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                  "item_emb": xavier_uniform(generator, (self.num_items, d))}
        for name, rows in (("user_margin", self.num_users), ("item_margin", self.num_items)):
            tables[name] = torch.randn((rows, 1), generator=generator,
                                       device=generator.device)
        return tables

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.encode()
        user_e, item_e = batch_user_pos_embeddings(user_all, item_all, batch, self.compute_dtype)
        margin = self.user_margin[batch["user"]] + self.item_margin[batch["pos"]]
        align = losses.margin_alignment_loss(user_e, item_e, margin)
        uniform = (self.gamma_user * losses.dot_uniformity_loss(user_e)
                   + self.gamma_item * losses.dot_uniformity_loss(item_e))
        reg = self.reg_lambda * (losses.reg_loss_counted(self.user_emb, batch["user"])
                                 + losses.reg_loss_counted(self.item_emb, batch["pos"]))
        return align, uniform, reg
