"""LightGCN (He et al., SIGIR'20): K layers of Â·E over the symmetric
normalized bipartite adjacency, mean layer combination including layer
0; BPR on the propagated embeddings plus L2 on the ego (layer-0)
embeddings (counterpart of idgrec_tpu/models/lightgcn.py)."""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    lightgcn_propagate,
    lightgcn_propagate_rows,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops.propagate import build_adjacency


@register("LightGCN")
class LightGCN(RecModel):
    loss_names = ("bpr", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.num_layers = config.int("GCN_layer")
        # batch-row partial propagation of the last layer (ops/gathermm.py),
        # opt-in as in the JAX package
        self.batch_rows = config.int("batch_rows_propagation", 0) == 1
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            with_transpose=self.batch_rows, emb_size=self.embedding_size,
            device=self.device,
        )

    def propagate(self) -> tuple[torch.Tensor, torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        final = lightgcn_propagate(self.graph, emb0, self.num_layers)
        return split_user_item(final, self.num_users)

    def _batch_final(self, batch):
        """Final embeddings of exactly the batch rows. With batch-row
        propagation on a graph that supports it, the last layer (and,
        through autograd, the first backward application) is the partial
        product over the batch rows; otherwise one full propagation, as
        in the JAX package."""
        if self.batch_rows and getattr(self.graph, "supports_rows", False):
            emb0 = concat_user_item(self.user_emb, self.item_emb)
            rows_i = torch.cat([batch["pos"], batch["neg"]])
            u_final, i_final = lightgcn_propagate_rows(
                self.graph, emb0, self.num_layers, batch["user"], rows_i, self.num_users)
            pos_e, neg_e = i_final.chunk(2)
            return u_final, pos_e, neg_e
        user_all, item_all = self.propagate()
        return batch_final_embeddings(user_all, item_all, batch, self.compute_dtype)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_e, pos_e, neg_e = self._batch_final(batch)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        # scatter-free ego-L2 backward (losses.reg_loss_indexed): the
        # value of reg_loss on the gathered ego rows
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        return bpr, reg

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.propagate()
