"""HCCF (Xia et al., SIGIR'22): hypergraph contrastive collaborative
filtering (counterpart of idgrec_tpu/models/hccf.py).

Four tables: users and items [·, d], and a user and an item hyperedge
table [d, hyper_size]. Per layer, a GCN branch ``Â·E_prev`` (on the card
one K6 launch each way) plus a hypergraph branch ``H·(Hᵀ·E_prev)`` per
side, with H = E_table @ hyper_table, and in training, when ``keeprate
< 1``, dropout on H (the user side's mask, then the item side's, drawn
layer by layer from the step's generator). The layer's input is the sum
of the two branches; the final embedding is the sum over every layer's
input, layer 0 included. Losses: BPR, L2 on the batch's rows and on both
hyper tables, and ssl_lambda times an in-batch InfoNCE per layer and
side between the detached GCN branch and the hypergraph branch.

The published ``keeprate = 1.0`` draws nothing: `loss_terms` raises
without a generator only where it would draw.
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    keep_dropout,
    split_user_item,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_adjacency
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup


@register("HCCF")
class HCCF(RecModel):
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.keeprate = config.float("keeprate")
        self.temperature = config.float("temperature")
        self.hyper_size = config.int("hyper_size")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Four Xavier-uniform tables, drawn in this order from
        ``generator``: users [U, d], items [I, d], then the user and the
        item hyperedges [d, hyper_size]."""
        d, h = self.embedding_size, self.config.int("hyper_size")
        return {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                "item_emb": xavier_uniform(generator, (self.num_items, d)),
                "user_hyper": xavier_uniform(generator, (d, h)),
                "item_hyper": xavier_uniform(generator, (d, h))}

    def aggregate(self, generator: torch.Generator | None, training: bool):
        """(final [U+I, d], the GCN branch of each layer, the hypergraph
        branch of each layer)."""
        check_exact_matmul(self.device)
        nu = self.num_users
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        uu_hyper = self.user_emb @ self.user_hyper
        ii_hyper = self.item_emb @ self.item_hyper
        drop = training and self.keeprate < 1.0
        if drop:
            generator = noise.require_generator(generator, "HCCF.loss_terms")
        embeddings, gnn_layers, hyper_layers = [emb0], [], []
        for _ in range(self.num_layers):
            prev = embeddings[-1]
            gnn = self.graph.matmul(prev)
            if drop:
                uu = keep_dropout(uu_hyper, self.keeprate, generator)
                ii = keep_dropout(ii_hyper, self.keeprate, generator)
            else:
                uu, ii = uu_hyper, ii_hyper
            prev_u, prev_i = split_user_item(prev, nu)
            hyper = torch.cat([uu @ (uu.T @ prev_u), ii @ (ii.T @ prev_i)], dim=0)
            gnn_layers.append(gnn)
            hyper_layers.append(hyper)
            embeddings.append(gnn + hyper)
        final = embeddings[0]
        for e in embeddings[1:]:
            final = final + e
        return final, gnn_layers, hyper_layers

    def loss_terms(self, batch, generator=None, epoch=0):
        final, gnn_layers, hyper_layers = self.aggregate(generator, training=True)
        user_all, item_all = split_user_item(final, self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * (
            losses.reg_loss_indexed(self.user_emb, self.item_emb, batch["user"], batch["pos"],
                                    batch["neg"])
            + mesh_lib.share(losses.reg_loss(mesh_lib.data_sum(self.user_hyper),
                                             mesh_lib.data_sum(self.item_hyper))))
        users, pos = batch["user"], batch["pos"]
        ssl = torch.zeros((), dtype=torch.float32, device=bpr.device)
        for gnn, hyper in zip(gnn_layers, hyper_layers):
            g_u, g_i = split_user_item(gnn.detach(), self.num_users)
            h_u, h_i = split_user_item(hyper, self.num_users)
            ssl = ssl + losses.infonce_loss(lookup(g_u, users), lookup(h_u, users),
                                            self.temperature)
            ssl = ssl + losses.infonce_loss(lookup(g_i, pos), lookup(h_i, pos),
                                            self.temperature)
        return bpr, reg, self.ssl_lambda * ssl

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        final, _, _ = self.aggregate(None, training=False)
        return split_user_item(final, self.num_users)
