"""NGCF (Wang et al., SIGIR'19), GCMC and LR-GCCF: graph convolutions
with per-layer weight matrices (counterpart of idgrec_tpu/models/ngcf.py).

Per layer l: side = Â·ego (on the card, with the published configs'
bfloat16 on ``auto``, one K6 launch each way; the `self` adjacency's
diagonal is added after the kernel), then the model's transform of
(ego, side) with its tables ``W_{name}_{l}`` [d_l, d_{l+1}] and
``b_{name}_{l}`` [1, d_{l+1}], message dropout in training, and the
layer's output. The layer outputs are concatenated after the tables
(served embeddings (L + 1)·d wide); the next layer takes the dropped-out
activations, not the normalized output.

* NGCF (`self`): the sum term side·W_gcn + b_gcn and the bi-interaction
  term (ego ⊙ side)·W_bi + b_bi, LeakyReLU(0.2), dropout, L2-normalized
  output; L2 on the item table's batch rows only (a reference quirk kept).
* GCMC (`sym`): side·W_gcn + b_gcn, LeakyReLU(0.2), then the MLP
  ·W_mlp + b_mlp, dropout, L2-normalized output; L2 on the batch's user,
  positive and negative rows.
* GCCF (`self`): side·W_gcn + b_gcn, dropout, the output as it is; L2 on
  the items.

The weight products are ordinary float32 products (full float32 on the
card: `check_exact_matmul`). Node dropout (``node_dropout = True``, off
in every published config) drops the adjacency's stored edge values in
training and forces the gather backend, as in the JAX package; the
port's backward multiplies by the transpose of the dropped matrix
(`GatherSquareAdj.edge_dropout_matmul`), which the JAX package's does
not. A layer draws its node mask, then its message mask, from the
step's generator; evaluation draws nothing (the reference's eval-time
dropout is not copied, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    dropout,
    split_user_item,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.losses import _normalize
from idgrec_torch.ops.propagate import build_adjacency


class _WeightedGCNBase(RecModel):
    """Shared machinery of NGCF, GCMC and GCCF: per-layer weight tables,
    node and message dropout, concatenated layer outputs."""

    loss_names = ("bpr", "reg")
    adjacency_variant = "self"
    weight_names: tuple[str, ...] = ()

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.num_layers = config.int("GCN_layer")
        self.mess_dropout = (config.float_list("mess_drop_prob")
                             if config.bool("mess_dropout", False)
                             else [0.0] * self.num_layers)
        self.node_dropout = config.bool("node_dropout", False)
        self.node_drop_prob = config.float("node_drop_prob", 0.0)
        backend = "gather" if self.node_dropout else self.backend
        self.graph = build_adjacency(
            data, self.adjacency_variant, backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )
        if self.node_dropout:
            self.graph = self.graph.with_edge_dropout()

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Xavier-uniform tables, drawn in this order from ``generator``:
        users [U, d], items [I, d], then per layer and per weight name
        W [d_l, d_{l+1}] and b [1, d_{l+1}]."""
        d = self.embedding_size
        sizes = [d] + self.config.int_list("layer_size")
        params = {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                  "item_emb": xavier_uniform(generator, (self.num_items, d))}
        for layer in range(self.config.int("GCN_layer")):
            d_in, d_out = sizes[layer], sizes[layer + 1]
            for name in self.weight_names:
                params[f"W_{name}_{layer}"] = xavier_uniform(generator, (d_in, d_out))
                params[f"b_{name}_{layer}"] = xavier_uniform(generator, (1, d_out))
        return params

    def _linear(self, x: torch.Tensor, name: str, layer: int) -> torch.Tensor:
        return x @ getattr(self, f"W_{name}_{layer}") + getattr(self, f"b_{name}_{layer}")

    def layer_transform(self, layer: int, ego: torch.Tensor, side: torch.Tensor,
                        generator: torch.Generator | None, training: bool):
        """(the next layer's input, this layer's output)."""
        raise NotImplementedError

    def aggregate(self, generator: torch.Generator | None, training: bool):
        """(user rows, item rows) of the concatenated layer outputs,
        [·, sum of the layer widths]."""
        check_exact_matmul(self.device)
        drop_nodes = training and self.node_dropout and self.node_drop_prob > 0.0
        if drop_nodes or (training and any(p > 0.0 for p in self.mess_dropout[:self.num_layers])):
            generator = noise.require_generator(generator, f"{self.model_name}.loss_terms")
        ego = concat_user_item(self.user_emb, self.item_emb)
        outputs = [ego]
        for layer in range(self.num_layers):
            if drop_nodes:
                side = self.graph.edge_dropout_matmul(ego, 1.0 - self.node_drop_prob, generator)
            else:
                side = self.graph.matmul(ego)
            ego, out = self.layer_transform(layer, ego, side, generator, training)
            outputs.append(out)
        return split_user_item(torch.cat(outputs, dim=1), self.num_users)

    def _dropout(self, h: torch.Tensor, layer: int, generator, training: bool) -> torch.Tensor:
        return dropout(h, self.mess_dropout[layer], generator) if training else h

    def _reg(self, batch) -> torch.Tensor:
        """L2 on the item table's positive and negative rows (NGCF, GCCF)."""
        return losses.reg_loss_counted(self.item_emb, batch["pos"], batch["neg"])

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.aggregate(generator, training=True)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        return losses.bpr_loss(user_e, pos_e, neg_e), self.reg_lambda * self._reg(batch)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self.aggregate(None, training=False)


@register("NGCF")
class NGCF(_WeightedGCNBase):
    adjacency_variant = "self"
    weight_names = ("gcn", "bi")

    def layer_transform(self, layer, ego, side, generator, training):
        sum_emb = self._linear(side, "gcn", layer)
        bi_emb = self._linear(ego * side, "bi", layer)
        h = F.leaky_relu(sum_emb + bi_emb, negative_slope=0.2)
        h = self._dropout(h, layer, generator, training)
        return h, _normalize(h)


@register("GCMC")
class GCMC(_WeightedGCNBase):
    adjacency_variant = "sym"
    weight_names = ("gcn", "mlp")

    def layer_transform(self, layer, ego, side, generator, training):
        gcn = F.leaky_relu(self._linear(side, "gcn", layer), negative_slope=0.2)
        mlp = self._dropout(self._linear(gcn, "mlp", layer), layer, generator, training)
        return mlp, _normalize(mlp)

    def _reg(self, batch) -> torch.Tensor:
        return losses.reg_loss_indexed(self.user_emb, self.item_emb, batch["user"],
                                       batch["pos"], batch["neg"])


@register("GCCF")
class GCCF(_WeightedGCNBase):
    adjacency_variant = "self"
    weight_names = ("gcn",)

    def layer_transform(self, layer, ego, side, generator, training):
        h = self._dropout(self._linear(side, "gcn", layer), layer, generator, training)
        return h, h
