"""BIGCF (Zhang et al., SIGIR'24): individual and collective intents
(counterpart of idgrec_tpu/models/bigcf.py).

LightGCN sum aggregation without layer 0; the intent projection
softmax(E @ W) @ Wᵀ with a [d, intent_size] table W per side; final =
gnn + intent ⊙ N(0, 1), the noise drawn in training and in evaluation
(so `eval_embeddings` needs a generator: the evaluator, the training
loop and the server pass one). Losses: BPR, L2 on the batch's ego rows
and on both intent tables, and λ times five InfoNCE terms (users with
themselves, items with themselves, users with items, and each side's
intents with themselves).
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    lightgcn_propagate,
    split_user_item,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_adjacency
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup


@register("BIGCF")
class BIGCF(RecModel):
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.ssl_temperature = config.float("ssl_temperature")
        self.int_temperature = config.float("int_temperature")  # read as the reference does; unused
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Four Xavier-uniform tables, drawn in this order from
        ``generator``: users [U, d], items [I, d], then the user and the
        item intents [d, intent_size]."""
        d, k = self.embedding_size, self.config.int("intent_size")
        return {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                "item_emb": xavier_uniform(generator, (self.num_items, d)),
                "user_intent": xavier_uniform(generator, (d, k)),
                "item_intent": xavier_uniform(generator, (d, k))}

    def aggregate(self, generator: torch.Generator):
        """(final users, final items, user intents, item intents)."""
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        gnn = lightgcn_propagate(self.graph, emb0, self.num_layers, include_layer0=False,
                                 reduce="sum")
        gnn_u, gnn_i = split_user_item(gnn, self.num_users)
        check_exact_matmul(gnn.device)
        user_intent = torch.softmax(gnn_u @ self.user_intent, dim=1) @ self.user_intent.T
        item_intent = torch.softmax(gnn_i @ self.item_intent, dim=1) @ self.item_intent.T
        intent = torch.cat([user_intent, item_intent], dim=0)
        eps = noise.normal(gnn.shape, generator, dtype=torch.float32).to(gnn.dtype)
        users, items = split_user_item(gnn + intent * eps, self.num_users)
        return users, items, user_intent, item_intent

    def loss_terms(self, batch, generator=None, epoch=0):
        generator = noise.require_generator(generator, "BIGCF.loss_terms")
        user_all, item_all, intent_u, intent_i = self.aggregate(generator)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * (
            losses.reg_loss_indexed(self.user_emb, self.item_emb, batch["user"], batch["pos"],
                                    batch["neg"])
            + mesh_lib.share(losses.reg_loss(mesh_lib.data_sum(self.user_intent),
                                             mesh_lib.data_sum(self.item_intent))))
        t = self.ssl_temperature
        iu, ip = lookup(intent_u, batch["user"]), lookup(intent_i, batch["pos"])
        ssl = (losses.infonce_loss(user_e, user_e, t)
               + losses.infonce_loss(pos_e, pos_e, t)
               + losses.infonce_loss(user_e, pos_e, t)
               + losses.infonce_loss(iu, iu, t)
               + losses.infonce_loss(ip, ip, t))
        return bpr, reg, self.ssl_lambda * ssl

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        generator = noise.require_generator(generator, "BIGCF.eval_embeddings")
        user_all, item_all, _, _ = self.aggregate(generator)
        return user_all, item_all
