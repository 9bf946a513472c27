"""LightCSCF (Kai et al., AAAI'26): parallel graph-filter contrast
(counterpart of idgrec_tpu/models/lightcscf.py). Under MF the terms are
(bpr, reg, cscf), under LightGCN (reg, cscf): ``loss_names`` is set per
instance. The loss is `losses.lightcscf_loss` (a dual-filter InfoNCE
with a margin-ReLU second channel). The reference reads ``lambda_reg``,
not ``reg_lambda``."""

from __future__ import annotations

from idgrec_torch.models.base import RecModel, batch_final_embeddings
from idgrec_torch.models.encoders import EncoderSwitchMixin
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses


@register("LightCSCF")
class LightCSCF(EncoderSwitchMixin, RecModel):
    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.temperature = config.float("temperature")
        self.lambda_gamma = config.float("lambda_gamma")
        self.lambda_reg = config.float("lambda_reg")
        self.lambda_margin = config.float("lambda_margin")
        self._init_encoder(config, data)
        self.loss_names = ("bpr", "reg", "cscf") if self.encoder == "MF" else ("reg", "cscf")

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.encode()
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        reg = self.lambda_reg * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        cscf = self.lambda_gamma * losses.lightcscf_loss(user_e, pos_e, self.temperature,
                                                         self.lambda_margin)
        if self.encoder == "MF":
            return losses.bpr_loss(user_e, pos_e, neg_e), reg, cscf
        return reg, cscf
