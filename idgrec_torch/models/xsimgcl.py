"""XSimGCL (Yu et al., arXiv'22): single-pass cross-layer contrast
(counterpart of idgrec_tpu/models/xsimgcl.py).

One noisy propagation in training (SimGCL's perturbation at every
layer, drawn from the step's generator); the layer ``cl_layer`` is
contrasted with the final mean over layers 1..K, over the batch's
distinct users and items. Evaluation runs the clean pass.
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
from idgrec_torch.models.simgcl import first_occurrence_mask, masked_infonce_loss, perturb
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_adjacency, true_divide
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup


@register("XSimGCL")
class XSimGCL(RecModel):
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.epsilon = config.float("epsilon")
        self.temperature = config.float("temperature")
        self.cl_layer = config.int("cl_layer")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def _propagate(self, generator: torch.Generator | None = None):
        """(the mean over layers 1..K, the layer ``cl_layer``), noisy when
        ``generator`` is given."""
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        h, acc, cl = emb0, None, emb0
        for layer in range(self.num_layers):
            h = self.graph.matmul(h)
            if generator is not None:
                h = perturb(h, self.epsilon, generator)
            acc = h if acc is None else acc + h
            if layer == self.cl_layer - 1:
                cl = h
        return true_divide(acc, float(self.num_layers)), cl

    def loss_terms(self, batch, generator=None, epoch=0):
        generator = noise.require_generator(generator, "XSimGCL.loss_terms")
        final, cl = self._propagate(generator)
        user_all, item_all = split_user_item(final, self.num_users)
        user_cl, item_cl = split_user_item(cl, self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        users, pos = batch["user"], batch["pos"]
        user_ssl = masked_infonce_loss(lookup(user_cl, users), user_e,
                                       first_occurrence_mask(mesh_lib.whole_index(users)),
                                       self.temperature)
        item_ssl = masked_infonce_loss(lookup(item_cl, pos), pos_e,
                                       first_occurrence_mask(mesh_lib.whole_index(pos)),
                                       self.temperature)
        return bpr, reg, self.ssl_lambda * (user_ssl + item_ssl)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        final, _ = self._propagate()
        return split_user_item(final, self.num_users)
