"""IMP-GCN (Liu et al., WWW'21): interest-aware message passing
(counterpart of idgrec_tpu/models/impgcn.py).

A grouping network assigns each user to one of G interest groups: h =
LeakyReLU((E + Â·E) @ W_fc + b_fc), dropout 0.4, scores = h @ W_group +
b_group, dropout 0.4, and the top-1 mask of the scores (ties keep every
tied group). Items belong to every group. The mask is compared for
equality, so it has no gradient: the gates are computed without one,
and the grouping tables ``fc_w``, ``fc_b``, ``fc_group_w`` and
``fc_group_b`` get a gradient of None (Adam then leaves them as they
are, as optax's Adam leaves them under JAX's zero gradient).

Each group propagates over its subgraph, the edges gated on both ends:
g ⊙ (Â (g ⊙ x)) with 0/1 gates. The G groups run as one product at width
G·d, the gate one number per node per group (the columns of group g are
g·d .. g·d + d − 1): ``graph.matmul(h * gate_cols) * gate_cols``, on the
card one K6 launch at d = 192 each way. ``Â·E`` feeds only the gates, so
it has no backward: a step at L layers runs K6 1 + (L − 1) times forward
and L − 1 times backward. Layer 0 is counted G times (the reference's
quirk), each deeper layer is the sum over the groups, and the final
embedding is the mean over the layers.

In training the step draws its two dropout masks from its generator
(the hidden layer's [N, d], then the scores' [N, G]); `loss_terms`
raises without one.
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    dropout,
    split_user_item,
    torch_linear_init,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_adjacency, true_divide

GROUP_DROPOUT = 0.4


@register("IMPGCN")
class IMPGCN(RecModel):
    loss_names = ("bpr", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.num_groups = config.int("group")
        self.num_layers = config.int("GCN_layer")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Drawn in this order from ``generator``: users [U, d] and items
        [I, d] (Xavier uniform), then ``fc`` [d, d] + [d] and ``fc_group``
        [d, G] + [G] (`torch_linear_init`)."""
        d, g = self.embedding_size, self.config.int("group")
        user = xavier_uniform(generator, (self.num_users, d))
        item = xavier_uniform(generator, (self.num_items, d))
        fc_w, fc_b = torch_linear_init(generator, d, d)
        fg_w, fg_b = torch_linear_init(generator, d, g)
        return {"user_emb": user, "item_emb": item, "fc_w": fc_w, "fc_b": fc_b,
                "fc_group_w": fg_w, "fc_group_b": fg_b}

    @torch.no_grad()
    def group_scores(self, ego: torch.Tensor, side: torch.Tensor,
                     generator: torch.Generator | None, training: bool) -> torch.Tensor:
        """float32 [U+I, G]: the grouping network's scores, after its two
        dropouts in training."""
        check_exact_matmul(ego.device)
        h = torch.nn.functional.leaky_relu((ego + side) @ self.fc_w + self.fc_b, 0.01)
        if training:
            h = dropout(h, GROUP_DROPOUT, generator)
        scores = h @ self.fc_group_w + self.fc_group_b
        if training:
            scores = dropout(scores, GROUP_DROPOUT, generator)
        return scores

    def group_gates(self, scores: torch.Tensor) -> torch.Tensor:
        """float32 [U+I, G] 0/1: a user's best-scoring groups (every tied
        one), every group for an item."""
        top = torch.max(scores, dim=1, keepdim=True).values
        gates = (scores == top).to(torch.float32)
        gates[self.num_users:] = 1.0
        return gates

    def aggregate(self, generator: torch.Generator | None, training: bool):
        """(final users [U, d], final items [I, d])."""
        if training:
            generator = noise.require_generator(generator, "IMPGCN.loss_terms")
        ego = concat_user_item(self.user_emb, self.item_emb)
        with torch.no_grad():
            side = self.graph.matmul(ego)
        gates = self.group_gates(self.group_scores(ego, side, generator, training))
        g, d = self.num_groups, ego.shape[1]
        gate_cols = gates.repeat_interleave(d, dim=1)  # [N, G·d], group-major
        h = ego.repeat(1, g)
        total = g * ego
        for _ in range(1, self.num_layers):
            h = self.graph.matmul(h * gate_cols) * gate_cols
            layer = h[:, :d]
            for j in range(1, g):
                layer = layer + h[:, j * d: (j + 1) * d]
            total = total + layer
        return split_user_item(true_divide(total, float(self.num_layers)), self.num_users)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.aggregate(generator, training=True)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        return bpr, reg

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.aggregate(None, training=False)
