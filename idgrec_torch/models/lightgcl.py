"""LightGCL (Cai et al., ICLR'23): SVD-guided graph contrastive learning
(counterpart of idgrec_tpu/models/lightgcl.py).

Two branches over the rectangular R̃ (`build_rect_adjacency`), each
summed over its layers, layer 0 included:

* the main branch, per layer ``z_u = R̃·E_i`` and ``z_i = R̃ᵀ·E_u``: on
  the dense route in bfloat16 both directions of a layer are one K6
  launch (`DenseRectAdj.matmul_both`), two a step with the backward's;
* the SVD branch ``g_u = (U·S)·(Vᵀ·E_i)``, ``g_i = (V·S)·(Uᵀ·E_u)`` from
  a rank-q SVD of R̃ taken once on the host when the model is built
  (ops/svd.py), float32 products (the JAX package computes them outside
  any Pallas kernel).

Losses: BPR, the indexed L2, and λ times the contrast of the SVD branch
against the main branch's full tables (`losses.lightgcl_ssl_loss`, which
keeps two float32 [B, U] and [B, I] score matrices for the backward).
The evaluation uses the main branch alone, so serving does not depend on
the SVD. The factors are constants outside the parameters and the state
dict (`load_factors` replaces them, as the tests do with JAX's).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from idgrec_torch.data.graph import normalized_rectangular
from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import RecModel, batch_final_embeddings
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops.propagate import build_rect_adjacency
from idgrec_torch.ops.svd import lowrank_svd
from idgrec_torch.parallel.mesh import lookup


def _layer_sum(layers: list[torch.Tensor]) -> torch.Tensor:
    total = layers[0]
    for h in layers[1:]:
        total = total + h
    return total


@register("LightGCL")
class LightGCL(RecModel):
    loss_names = ("bpr", "reg", "ssl")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.reg_lambda = config.float("reg_lambda")
        self.ssl_lambda = config.float("ssl_lambda")
        self.temperature = config.float("temperature")
        self.num_layers = config.int("GCN_layer")
        self.svd_q = config.int("svd_q")
        self.graph = build_rect_adjacency(data, self.backend, compute_dtype=self.compute_dtype,
                                          device=self.device)
        start = time.perf_counter()
        u, s, v = lowrank_svd(normalized_rectangular(data).to_scipy(), self.svd_q,
                              seed=config.int("seed", 2024))
        self.svd_seconds = time.perf_counter() - start  # host seconds of the factorisation
        self.load_factors(u * s[None, :], v * s[None, :], u.T, v.T)

    def load_factors(self, u_mul_s: np.ndarray, v_mul_s: np.ndarray, u_t: np.ndarray,
                     v_t: np.ndarray) -> None:
        """Set the SVD branch's constants, float32 numpy: U·S [U, q],
        V·S [I, q], Uᵀ [q, U] and Vᵀ [q, I] (the JAX model's
        ``u_mul_s``, ``v_mul_s``, ``u_t``, ``v_t``)."""
        def put(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        self.u_mul_s, self.v_mul_s, self.u_t, self.v_t = map(put, (u_mul_s, v_mul_s, u_t, v_t))

    def aggregate(self, svd: bool = True):
        """(main users, main items, SVD users, SVD items), each the sum
        of its layers 0..K; without ``svd`` the SVD branch is left out
        (the evaluation's)."""
        check_exact_matmul(self.device)
        both = getattr(self.graph, "matmul_both", None)
        user_layers, item_layers = [self.user_emb], [self.item_emb]
        g_user_layers, g_item_layers = [self.user_emb], [self.item_emb]
        for _ in range(self.num_layers):
            prev_u, prev_i = user_layers[-1], item_layers[-1]
            if both is not None:
                next_u, next_i = both(prev_i, prev_u)
            else:
                next_u, next_i = self.graph.matmul(prev_i), self.graph.t_matmul(prev_u)
            user_layers.append(next_u)
            item_layers.append(next_i)
            if svd:
                g_user_layers.append(self.u_mul_s @ (self.v_t @ prev_i))
                g_item_layers.append(self.v_mul_s @ (self.u_t @ prev_u))
        return tuple(map(_layer_sum, (user_layers, item_layers, g_user_layers, g_item_layers)))

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all, g_user, g_item = self.aggregate()
        user_e, pos_e, neg_e = batch_final_embeddings(user_all, item_all, batch,
                                                      self.compute_dtype)
        bpr = losses.bpr_loss(user_e, pos_e, neg_e)
        reg = self.reg_lambda * losses.reg_loss_indexed(
            self.user_emb, self.item_emb, batch["user"], batch["pos"], batch["neg"])
        ssl = self.ssl_lambda * losses.lightgcl_ssl_loss(
            user_e, pos_e, lookup(g_user, batch["user"]), lookup(g_item, batch["pos"]),
            user_all, item_all, self.temperature)
        return bpr, reg, ssl

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        user_all, item_all, _, _ = self.aggregate(svd=False)
        return user_all, item_all
