"""NCL (Lin et al., WWW'22): neighbourhood-enriched contrastive learning
(counterpart of idgrec_tpu/models/ncl.py).

* LightGCN aggregation keeping the per-layer list; the final embedding
  is the mean of layers 0..K.
* Structural contrast: sum-reduced InfoNCE between layer ``2·cl_layer``
  and layer 0 against the full layer-0 table
  (`losses.infonce_loss_sum`), combined as ``ssl_lambda·(user +
  alpha·item)``.
* Prototype contrast from epoch ``warmup_epochs`` on: `epoch_context`
  clusters the user and the item table every epoch (`ops.kmeans`, on
  the device, its sums on kernel K4), and each sample's layer-0 row is
  contrasted in-batch with its centroid, scaled by ``proto_lambda ·
  batch_size``.

The loss list always has four entries; ``proto`` is exactly 0 before the
warm-up, as in the JAX package. The centroids and assignments are plain
attributes, not buffers: they are rebuilt every epoch and stay out of
the state dict, so a JAX checkpoint (tables and Adam only) loads as it
is.
"""

from __future__ import annotations

import numpy as np
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
from idgrec_torch.ops.kmeans import kmeans
from idgrec_torch.ops.propagate import build_adjacency
from idgrec_torch.parallel.mesh import lookup


@register("NCL")
class NCL(RecModel):
    loss_names = ("bpr", "reg", "ssl", "proto")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.proto_lambda = config.float("proto_lambda")
        self.k = config.int("k")
        self.alpha = config.float("alpha")
        self.temperature = config.float("temperature")
        self.cl_layer = config.int("cl_layer")
        self.num_layers = config.int("GCN_layer")
        self.batch_size = config.int("batch_size")
        self.warmup_epochs = config.int("warmup_epochs", 20)
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )
        self._set_clusters(None)

    def _set_clusters(self, clusters) -> None:
        """(user centroids [k, d], user assignment [U], item centroids,
        item assignment [I]); None: zeros, as before the warm-up."""
        if clusters is None:
            dev, k, d = self.device, self.k, self.embedding_size
            clusters = (torch.zeros((k, d), dtype=torch.float32, device=dev),
                        torch.zeros(self.num_users, dtype=torch.int64, device=dev),
                        torch.zeros((k, d), dtype=torch.float32, device=dev),
                        torch.zeros(self.num_items, dtype=torch.int64, device=dev))
        (self.user_centroids, self.user_2cluster,
         self.item_centroids, self.item_2cluster) = clusters

    def epoch_context(self, epoch: int, np_rng: np.random.Generator):
        """From the warm-up on, one seed drawn from ``np_rng`` (as the JAX
        package draws it, so the host stream stays aligned) seeds a
        generator on the model's device, which clusters the user table,
        then the item table; before it, zero centroids and assignments."""
        if epoch < self.warmup_epochs:
            self._set_clusters(None)
            return ()
        seed = int(np_rng.integers(0, 2**31 - 1))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        user_c, user_a = kmeans(self.user_emb, self.k, gen)
        item_c, item_a = kmeans(self.item_emb, self.k, gen)
        self._set_clusters((user_c, user_a, item_c, item_a))
        return ()

    def _layers(self) -> list[torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        return lightgcn_layer_outputs(self.graph, emb0, self.num_layers)

    def loss_terms(self, batch, generator=None, epoch=0):
        layers = self._layers()
        user_all, item_all = split_user_item(layer_mean(layers), self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        users, pos = batch["user"], batch["pos"]
        init_u, init_i = split_user_item(layers[0], self.num_users)
        layer_u, layer_i = split_user_item(layers[self.cl_layer * 2], self.num_users)
        init_ub, init_ib = lookup(init_u, users), lookup(init_i, pos)
        user_ssl = losses.infonce_loss_sum(lookup(layer_u, users), init_ub, init_u,
                                           self.temperature)
        item_ssl = losses.infonce_loss_sum(lookup(layer_i, pos), init_ib, init_i,
                                           self.temperature)
        ssl = self.ssl_lambda * (user_ssl + self.alpha * item_ssl)
        if epoch < self.warmup_epochs:
            proto = torch.zeros((), dtype=torch.float32, device=bpr.device)
        else:
            user_proto = losses.infonce_loss(
                init_ub, self.user_centroids[self.user_2cluster[users]], self.temperature)
            item_proto = losses.infonce_loss(
                init_ib, self.item_centroids[self.item_2cluster[pos]], self.temperature)
            proto = self.proto_lambda * (user_proto + item_proto) * self.batch_size
        return bpr, reg, ssl, proto

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return split_user_item(layer_mean(self._layers()), self.num_users)
