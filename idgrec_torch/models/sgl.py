"""SGL (Wu et al., SIGIR'21): self-supervised graph learning
(counterpart of idgrec_tpu/models/sgl.py).

LightGCN aggregation over the full graph for BPR, and over two per-epoch
augmented graphs for the contrastive views (reference SGL.py:60-89):

* 'ed' (edge dropout): one view graph a view, shared across layers;
* 'rw' (random walk): one view graph a layer a view;
* 'nd' raises `NotImplementedError`, as in the reference (tools.py:72-73).

`epoch_context` draws the views from the host's numpy generator
(ops/propagate.py `build_dropout_adjacency`), view 1 before view 2, layer
by layer for 'rw', so the JAX package and the port draw the same edges
from one generator state. They are plain attributes, outside the state
dict, as NCL's clusters are. The InfoNCE contrast runs over the raw batch
indices, not the distinct ones (SGL.py:79-83). The reference's SGL trainer
never stops early and evaluates once more after the last epoch
(``respects_early_stop = False``).

The three chains (the clean one and the two views) take one of three
routes, as in the JAX package:

* dense, exact modes, binary counts: one `shared_chain_matmul` a layer,
  the chains side by side at 3d over the model's own binary matrix (on
  the card one K6 launch at d = 192 each way), each view's dropped edges
  subtracted on K4;
* fused int8 / int4, binary counts, where the JAX package's rule takes
  them (`propagate.ref_views_fit`): `fused_chain_views_t`, one quantized
  dual a layer at 3d (K7 / K8 on the card);
* otherwise (fused bfloat16, dense int8, bitpack, gather, non-binary
  counts, a quantized catalog above that rule) three passes: the clean
  chain through the model's adjacency, each view through its own (`DenseDropSquareAdj` on K6 in bfloat16,
  `BitDropSquareAdj` on K11, a `GatherSquareAdj`).
"""

from __future__ import annotations

import numpy as np
import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_final_embeddings,
    concat_user_item,
    layer_mean,
    lightgcn_propagate,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops import propagate as prop
from idgrec_torch.parallel.mesh import lookup


@register("SGL")
class SGL(RecModel):
    aggregates_per_step = 3  # the clean chain and two views
    loss_names = ("bpr", "reg", "ssl")
    respects_early_stop = False

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.temperature = config.float("temperature")
        self.ssl_ratio = config.float("ssl_ratio")
        self.aug_type = config.str("aug_type")
        if self.aug_type == "nd":
            raise NotImplementedError("aug_type 'nd' is not implemented (reference tools.py:72-73)")
        if self.aug_type not in ("ed", "rw"):
            raise ValueError(f"unknown aug_type {self.aug_type!r}")
        self.num_layers = config.int("GCN_layer")
        # 'auto' resolved once with two copies of M counted (the JAX package
        # keeps the views' binary matrix beside the model's), so the model's
        # adjacency and its views never resolve to two backends
        self.backend = prop.resolve_backend(data, self.backend, copies=2,
                                            compute_dtype=self.compute_dtype, device=self.device)
        self.graph = prop.build_adjacency(data, "sym", self.backend,
                                          compute_dtype=self.compute_dtype,
                                          emb_size=self.embedding_size, device=self.device)
        binary = bool(np.all(data.csr_vals == 1))
        g = self.graph
        self._batched = (isinstance(g, prop.DenseSquareAdj) and not g.has_diag
                         and g.quant == "none" and binary)
        self._batched_quant = (isinstance(g, prop.FusedSquareAdj) and g.quant in ("int8", "int4")
                               and not g.has_diag and binary)
        # the quantized views route where the JAX package's rule takes it
        # and no model axis shards M, else three passes
        self._views_route = (self._batched_quant and prop.supports_chain_t(g)
                             and prop.ref_views_fit(g, 3, self.embedding_size))
        # the views' shared matrix: the model's own where it is the binary
        # matrix, none on the quantized views route, which reads only the
        # views' scales and dropped edges
        self._shared = (None if self._views_route else
                        prop.build_dropout_shared(data, self.backend, self.device, g))
        # the shared matrix's plan, which K6 walks: the model's own where it
        # shares the model's matrix
        self._shared_plan = prop.shared_plan(self._shared, g, self.compute_dtype)
        self.views = None

    def epoch_context(self, epoch: int, np_rng: np.random.Generator):
        """The epoch's two views from ``np_rng`` (SGL.py:130-143): view 1,
        then view 2; for 'rw' each a graph a layer."""
        def make():
            return prop.build_dropout_adjacency(
                self.data, self.ssl_ratio, np_rng, self.backend,
                compute_dtype=self.compute_dtype, shared=self._shared, device=self.device,
                plan=self._shared_plan)

        count = 1 if self.aug_type == "ed" else self.num_layers
        view_1 = tuple(make() for _ in range(count))
        view_2 = tuple(make() for _ in range(count))
        self.views = (view_1, view_2)
        return ()

    def _aggregate_multi(self, graphs, emb0: torch.Tensor) -> torch.Tensor:
        """LightGCN aggregation where layer l runs graphs[l % len]."""
        outs, h = [emb0], emb0
        for layer in range(self.num_layers):
            h = graphs[layer % len(graphs)].matmul(h)
            outs.append(h)
        return layer_mean(outs)

    def _propagate_chains(self, emb0: torch.Tensor):
        """(clean, view 1, view 2), each [U+I, d]."""
        if self.views is None:
            raise RuntimeError("SGL draws its views in epoch_context: call it before a step")
        graphs_1, graphs_2 = self.views
        if self._views_route:
            return prop.fused_chain_views_t(self.graph, (graphs_1, graphs_2), emb0,
                                            self.num_layers)
        if not self._batched:
            return (lightgcn_propagate(self.graph, emb0, self.num_layers),
                    self._aggregate_multi(graphs_1, emb0), self._aggregate_multi(graphs_2, emb0))
        hs = accs = (emb0, emb0, emb0)
        for layer in range(self.num_layers):
            g1 = graphs_1[layer % len(graphs_1)]
            g2 = graphs_2[layer % len(graphs_2)]
            hs = prop.shared_chain_matmul(self._shared, [self.graph, g1, g2], list(hs),
                                          compute_dtype=self.graph.compute_dtype_name,
                                          plan=self._shared_plan)
            accs = tuple(a + h for a, h in zip(accs, hs))
        return tuple(prop.true_divide(a, float(self.num_layers + 1)) for a in accs)

    def loss_terms(self, batch, generator=None, epoch=0):
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        final, view_1, view_2 = self._propagate_chains(emb0)
        user_all, item_all = split_user_item(final, self.num_users)
        u1, i1 = split_user_item(view_1, self.num_users)
        u2, i2 = split_user_item(view_2, self.num_users)
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        users, pos = batch["user"], batch["pos"]
        user_ssl = losses.infonce_loss(lookup(u1, users), lookup(u2, users),
                                       self.temperature)
        item_ssl = losses.infonce_loss(lookup(i1, pos), lookup(i2, pos), self.temperature)
        return bpr, reg, self.ssl_lambda * (user_ssl + item_ssl)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        """The clean chain alone."""
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        return split_user_item(lightgcn_propagate(self.graph, emb0, self.num_layers),
                               self.num_users)
