"""DirectAU (Wang et al., KDD'22): alignment and uniformity, no
negatives (counterpart of idgrec_tpu/models/directau.py). The MF or
LightGCN encoder; align + γ·(uniform_u + uniform_i)/2 + λ·L2 on the
ego rows of the batch's users and positives."""

from __future__ import annotations

from idgrec_torch.models.base import RecModel, batch_user_pos_embeddings
from idgrec_torch.models.encoders import EncoderSwitchMixin
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses


@register("DirectAU")
class DirectAU(EncoderSwitchMixin, RecModel):
    loss_names = ("align", "uniform", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.gamma = config.float("gamma")
        self.reg_lambda = config.float("reg_lambda")
        self._init_encoder(config, data)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.encode()
        user_e, item_e = batch_user_pos_embeddings(user_all, item_all, batch, self.compute_dtype)
        align = losses.align_loss(user_e, item_e)
        uniform = self.gamma * (losses.uniform_loss(user_e) + losses.uniform_loss(item_e)) / 2.0
        reg = self.reg_lambda * (losses.reg_loss_counted(self.user_emb, batch["user"])
                                 + losses.reg_loss_counted(self.item_emb, batch["pos"]))
        return align, uniform, reg
