"""LightCCF (Zhang et al., SIGIR'25): neighborhood-aggregation contrast
(counterpart of idgrec_tpu/models/lightccf.py). The MF or LightGCN
encoder; BPR + λ_reg·L2 + λ_ssl·`losses.neighbor_aggregate_loss` on the
batch's final embeddings."""

from __future__ import annotations

from idgrec_torch.models.base import RecModel, batch_final_embeddings
from idgrec_torch.models.encoders import EncoderSwitchMixin
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses


@register("LightCCF")
class LightCCF(EncoderSwitchMixin, RecModel):
    loss_names = ("bpr", "reg", "na")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.temperature = config.float("temperature")
        self._init_encoder(config, data)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.encode()
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        na = self.ssl_lambda * losses.neighbor_aggregate_loss(user_e, pos_e, self.temperature)
        return bpr, reg, na
