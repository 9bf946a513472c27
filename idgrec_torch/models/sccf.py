"""SCCF (Wu et al., KDD'24): one contrastive objective unifying graph
convolution and contrast (counterpart of idgrec_tpu/models/sccf.py).
The MF or LightGCN encoder; the positive term
−E log(exp(s/τ) + exp(s²/τ)) over the batch's interactions and a
count-weighted denominator over all B × B batch pairs, divided by the
numbers of distinct users and items in the batch (the reference's
unique-count trick with static shapes). No BPR and no L2 term:
``reg_lambda`` is read and left unused, as in the reference."""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import RecModel
from idgrec_torch.models.encoders import EncoderSwitchMixin
from idgrec_torch.models.registry import register
from idgrec_torch.ops.losses import _f32, _normalize, batch_mean
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup
from idgrec_torch.ops.propagate import true_divide


def _count_unique(x: torch.Tensor) -> torch.Tensor:
    """The number of distinct values in ``x`` as a 0-d tensor on its
    device: a sort, then one plus the changes between neighbours. Not
    `torch.unique`, whose output's shape the host would have to read."""
    s = torch.sort(x).values
    return 1 + torch.sum(s[1:] != s[:-1])


@register("SCCF")
class SCCF(EncoderSwitchMixin, RecModel):
    loss_names = ("up", "down")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.temperature = config.float("temperature")
        self.reg_lambda = config.float("reg_lambda")  # read as the reference does; unused
        self._init_encoder(config, data)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.encode()
        tau = self.temperature
        check_exact_matmul(user_all.device)
        user_e = _normalize(_f32(lookup(user_all, batch["user"])))
        pos_e = _normalize(_f32(lookup(item_all, batch["pos"])))
        ip = torch.sum(user_e * pos_e, dim=1)
        up = batch_mean(torch.log(torch.exp(true_divide(ip, tau))
                                  + torch.exp(true_divide(ip ** 2, tau))))
        # under a data split the rank's users against the whole batch's
        # positives, the sum over all pairs all-reduced
        sim = torch.matmul(user_e, mesh_lib.gather_batch(pos_e).T)
        score = torch.exp(true_divide(sim, tau)) + torch.exp(true_divide(sim ** 2, tau))
        n_uu = _count_unique(mesh_lib.whole_index(batch["user"])).to(torch.float32)
        n_ui = _count_unique(mesh_lib.whole_index(batch["pos"])).to(torch.float32)
        down = torch.log(mesh_lib.all_reduce(torch.sum(score)) / (n_uu * n_ui))
        return -up, mesh_lib.share(down)
