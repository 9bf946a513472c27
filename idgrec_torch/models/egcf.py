"""EGCF (Zhang et al., TOIS'24): embedding-less graph collaborative
filtering (counterpart of idgrec_tpu/models/egcf.py).

Only an item table exists; the user embeddings are seeded as
tanh(R̃·E_item). Two modes, both summing the layer outputs:

* ``parallel`` seeds the users through the square adjacency
  (Â·[0; E_i] = [R̃·E_i; 0]), then runs K tanh layers over Â. Routes, in
  the JAX package's order: the resident tanh chain with the seed sweep
  (ops/chainmm.py, kernels K1 or K5 with K9's and K10's epilogues), then
  the per-sweep chain `fused_chain_t`, then one ``tanh(graph.matmul(·))``
  per layer (bfloat16 and float32 on every backend, and widths the
  chain's kernels decline: K6, K7 or K8, dense, gather).
* ``alternating`` ping-pongs over the rectangular R̃
  (`build_rect_adjacency`): users tanh(R̃·h_i), then items tanh(R̃ᵀ·h_u),
  K times (dense: float32 sums or the int8 product; gather; bitpack: one
  K11 launch a direction).

Loss: BPR + reg(items) + λ·(InfoNCE(u, u) + InfoNCE(i, i) + InfoNCE(u, i)).
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    split_user_item,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import chainmm, losses
from idgrec_torch.ops import propagate as prop


@register("EGCF")
class EGCF(RecModel):
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.temperature = config.float("temperature")
        self.mode = config.str("mode")
        self.num_layers = config.int("GCN_layer")
        if self.mode == "parallel":
            # the user seed goes through the same square Â as the layer chain
            self.graph = prop.build_adjacency(
                data, "sym", self.backend, compute_dtype=self.compute_dtype,
                emb_size=self.embedding_size, device=self.device)
        else:
            self.user_graph = prop.build_rect_adjacency(
                data, self.backend, compute_dtype=self.compute_dtype, device=self.device)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        return {"item_emb": xavier_uniform(generator, (self.num_items, self.embedding_size))}

    def propagate(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.mode != "parallel":
            return self._propagate_alternating()
        item_emb = self.item_emb
        d = item_emb.shape[1]
        x0 = torch.cat([torch.zeros((self.num_users, d), dtype=item_emb.dtype,
                                    device=item_emb.device), item_emb], dim=0)
        if chainmm.supports_chain_resident(self.graph, d, self.num_layers, "sum", torch.tanh,
                                           include_layer0=False, seed=True):
            acc = chainmm.fused_chain_resident(self.graph, x0, self.num_layers,
                                               include_layer0=False, reduce="sum",
                                               activation=torch.tanh, seed_users_from_items=True)
            return split_user_item(acc, self.num_users)
        if self.num_layers > 0 and prop.supports_chain_t(self.graph, d):
            acc = prop.fused_chain_t(self.graph, x0, self.num_layers, include_layer0=False,
                                     reduce="sum", activation=torch.tanh,
                                     seed_users_from_items=True)
            return split_user_item(acc, self.num_users)
        # tanh(Â·x0) + x0 seeds the users and keeps the items (tanh(0) = 0)
        h = torch.tanh(self.graph.matmul(x0)) + x0
        acc = torch.zeros_like(h)
        for _ in range(self.num_layers):
            h = torch.tanh(self.graph.matmul(h))
            acc = acc + h
        return split_user_item(acc, self.num_users)

    def _propagate_alternating(self) -> tuple[torch.Tensor, torch.Tensor]:
        item_h = self.item_emb
        user_acc = torch.zeros((self.num_users, item_h.shape[1]), dtype=item_h.dtype,
                               device=item_h.device)
        item_acc = torch.zeros_like(item_h)
        for _ in range(self.num_layers):
            user_h = torch.tanh(self.user_graph.matmul(item_h))
            item_h = torch.tanh(self.user_graph.t_matmul(user_h))
            user_acc = user_acc + user_h
            item_acc = item_acc + item_h
        return user_acc, item_acc

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.propagate()
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_counted(self.item_emb, batch["pos"], batch["neg"])
        t = self.temperature
        ssl = self.ssl_lambda * (losses.infonce_loss(user_e, user_e, t)
                                 + losses.infonce_loss(pos_e, pos_e, t)
                                 + losses.infonce_loss(user_e, pos_e, t))
        return bpr, reg, ssl

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.propagate()
