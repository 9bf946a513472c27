"""MixRec (Zhang et al., WWW'25): individual and collective mixing
(counterpart of idgrec_tpu/models/mixrec.py).

LightGCN sum aggregation without layer 0. Each step draws, in this
order, user_beta and item_beta ~ Beta(α, β), a Dirichlet(γ) weight per
batch row, and a permutation of the batch for the users and one for the
items (ops/noise.py, from the step's generator). The individual views
blend each row with a shuffled row; the collective view is the
Dirichlet-weighted batch average, one [1, d] row appended to the
negative pools. Losses: item_beta·BPR, (1 − item_beta)·InfoNCE against
the mixed negatives, L2 on the ego rows, and λ times the beta-blended
InfoNCE terms of the mixed views.
Under a data split the draws are one process's (the whole batch's, on
every rank alike), the views and pools are built from the all-gathered
batch rows, and each rank's terms take its own rows against them.
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    lightgcn_propagate,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_adjacency
from idgrec_torch.parallel import mesh as mesh_lib


@register("MixRec")
class MixRec(RecModel):
    loss_names = ("bpr", "bpr_mix", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.alpha = config.float("alpha")
        self.beta = config.float("beta")
        self.gamma = config.float("gamma")
        self.temperature = config.float("temperature")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def propagate(self) -> tuple[torch.Tensor, torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        final = lightgcn_propagate(self.graph, emb0, self.num_layers, include_layer0=False,
                                   reduce="sum")
        return split_user_item(final, self.num_users)

    def loss_terms(self, batch, generator=None, epoch=0):
        generator = noise.require_generator(generator, "MixRec.loss_terms")
        user_all, item_all = self.propagate()
        b = mesh_lib.batch_rows(batch["user"].shape[0])
        user_beta = noise.beta(self.alpha, self.beta, generator)
        item_beta = noise.beta(self.alpha, self.beta, generator)
        neg_beta = noise.dirichlet(
            torch.full((b,), self.gamma, dtype=torch.float32, device=generator.device),
            generator)
        user_e, pos_e, neg_e = (e.to(torch.float32) for e in batch_final_embeddings(
            user_all, item_all, batch, self.compute_dtype))
        # the whole batch's rows (the rank's own without a data split)
        user_a, pos_a, neg_a = (mesh_lib.gather_batch(e) for e in (user_e, pos_e, neg_e))
        own = mesh_lib.own_rows

        # the collective (Dirichlet) mix: one row a side
        mix_user = torch.sum(neg_beta[:, None] * user_a, dim=0, keepdim=True)
        mix_pos = torch.sum(neg_beta[:, None] * pos_a, dim=0, keepdim=True)

        user_perm = noise.permutation(b, generator)
        item_perm = noise.permutation(b, generator)
        user_e2, pos_e2, neg_e2 = user_a[user_perm], pos_a[item_perm], neg_a[item_perm]
        cl_user = user_beta * user_a + (1.0 - user_beta) * user_e2
        cl_item = item_beta * pos_a + (1.0 - item_beta) * pos_e2
        mix_neg2 = item_beta * neg_a + (1.0 - item_beta) * neg_e2

        bpr = item_beta * losses.bpr_loss(user_e, pos_e, neg_e)
        bpr_mix = (1.0 - item_beta) * losses.infonce_loss_all(user_e, pos_e, mix_neg2, 1.0)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])

        cl_user_2 = torch.cat([user_e2, mix_user], dim=0)
        cl_item_2 = torch.cat([pos_e2, mix_pos], dim=0)
        cl_user_3 = torch.cat([user_a, mix_user], dim=0)
        cl_item_3 = torch.cat([pos_a, mix_pos], dim=0)
        t = self.temperature
        user_ssl = (user_beta * losses.infonce_loss_all(user_e, own(cl_user), cl_user_2, t)
                    + (1.0 - user_beta) * losses.infonce_loss_all(own(user_e2), own(cl_user),
                                                                  cl_user_3, t))
        item_ssl = (item_beta * losses.infonce_loss_all(pos_e, own(cl_item), cl_item_2, t)
                    + (1.0 - item_beta) * losses.infonce_loss_all(own(pos_e2), own(cl_item),
                                                                  cl_item_3, t))
        return bpr, bpr_mix, reg, self.ssl_lambda * (user_ssl + item_ssl)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.propagate()
