"""CGCL (He et al., SIGIR'23): candidate-aware graph contrastive learning
(counterpart of idgrec_tpu/models/cgcl.py).

LightGCN aggregation keeping the per-layer list; the final embedding is
the mean of layers 0..K. Besides BPR and L2, three sum-reduced
cross-layer InfoNCE heads, each an α-weighted blend of a user-side and
an item-side contrast against the FULL table of the partner layer
(`losses.infonce_loss_sum`):

* layer loss:     layer 2 (context) against layer 0 (center);
* candidate loss: layer 1 (candidate) against layer 0;
* struct loss:    layer 2 (neighbour) against layer 1 (center).

In each head the user side contrasts the partner layer's ITEM rows (at
the batch positives) against the current layer's user table, and the
item side the reverse: that cross-wiring is the model's
candidate-awareness and is kept exactly. Each contrast keeps one float32
[B, rows] score matrix for the backward: at yelp2018 scale and batch
2,048, 571 MB a head, 1.71 GB a step.
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    layer_mean,
    lightgcn_layer_outputs,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops.propagate import build_adjacency
from idgrec_torch.parallel.mesh import lookup


@register("CGCL")
class CGCL(RecModel):
    loss_names = ("bpr", "reg", "layer_ssl", "candidate_ssl", "struct_ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.l_alpha = config.float("ssl_lambda_alpha")
        self.l_beta = config.float("ssl_lambda_beta")
        self.l_gamma = config.float("ssl_lambda_gamma")
        self.alpha = config.float("alpha")
        self.beta = config.float("beta")
        self.gamma = config.float("gamma")
        self.temperature = config.float("temperature")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def _layers(self) -> list[torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        return lightgcn_layer_outputs(self.graph, emb0, self.num_layers)

    def _pair_loss(self, cur_emb, pre_emb, users, items, lam, blend):
        """One head: lam·(blend·user side + (1 − blend)·item side), cur
        and pre the full [U+I, d] outputs of two layers."""
        cur_u, cur_i = split_user_item(cur_emb, self.num_users)
        pre_u, pre_i = split_user_item(pre_emb, self.num_users)
        user_loss = losses.infonce_loss_sum(lookup(cur_i, items), lookup(pre_u, users),
                                            pre_u, self.temperature)
        item_loss = losses.infonce_loss_sum(lookup(cur_u, users), lookup(pre_i, items),
                                            pre_i, self.temperature)
        return lam * (blend * user_loss + (1.0 - blend) * item_loss)

    def loss_terms(self, batch, generator=None, epoch=0):
        layers = self._layers()
        user_all, item_all = split_user_item(layer_mean(layers), self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        center, candidate, context = layers[0], layers[1], layers[2]
        users, items = batch["user"], batch["pos"]
        layer_ssl = self._pair_loss(context, center, users, items, self.l_alpha, self.alpha)
        candidate_ssl = self._pair_loss(candidate, center, users, items, self.l_beta, self.beta)
        struct_ssl = self._pair_loss(context, candidate, users, items, self.l_gamma, self.gamma)
        return bpr, reg, layer_ssl, candidate_ssl, struct_ssl

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return split_user_item(layer_mean(self._layers()), self.num_users)
