"""RecDCL (Zhang et al., WWW'24): dual contrastive learning (counterpart
of idgrec_tpu/models/recdcl.py).

* LightGCN mean aggregation over the `sym` adjacency; at the published
  embedding_size = 2,048 on the card one K6 launch a layer each way,
  which reads M once per 128 features (16 times a launch).
* Barlow Twins through a projector (Linear → BN → ReLU twice, then
  Linear; no bias; the hidden BNs affine) and the cross-correlation of
  the affine-free batch norms of the two sides.
* Polynomial uniformity over the projected features,
  log(mean((a·XᵀX + c) ** degree)), the power a float one as in the JAX
  package.
* A BYOL-style momentum term: a predictor Linear against targets mixed
  from per-user and per-item histories, which are the model's state
  (`init_state`: standard normal draws after the tables). The step reads
  the old histories at the batch's rows, then, last, writes the batch's
  detached final embeddings into them under ``no_grad``. A batch repeats
  rows; each write to a row writes the same gathered values, so the
  result does not depend on the order of the writes.
* Loss terms (bt, poly, mom) times their coefficients; a coefficient of
  0 gives exactly 0.

Under a data split (parallel/mesh.py) each rank takes its rows of the
batch: the batch norms' statistics and the [d, d] cross-correlation and
polynomial products are sums over the batch, all-reduced over the data
axis; the projector's and the predictor's weights enter through the
data-sum boundary; the histories stay replicated and take the whole
batch's writes, as in one process.
Batch norms use the batch's statistics with the population variance
(`base.batch_norm`); the cross-correlation and polynomial products are
full float32 (`check_exact_matmul`: TF32 off on the card), as the JAX
package's ``Precision.HIGHEST``. Evaluation runs the propagation alone.
"""

from __future__ import annotations

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import (
    RecModel,
    batch_norm,
    concat_user_item,
    lightgcn_propagate,
    split_user_item,
    torch_linear_init,
    xavier_uniform,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops.losses import _f32, _normalize, batch_mean
from idgrec_torch.ops.propagate import build_adjacency, true_divide
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel.mesh import lookup


@register("RecDCL")
class RecDCL(RecModel):
    loss_names = ("bt", "poly", "mom")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.num_layers = config.int("GCN_layer")
        self.a = config.float("a")
        self.polyc = config.float("polyc")
        self.degree = config.float("degree")
        self.poly_coeff = config.float("poly_coeff")
        self.bt_coeff = config.float("bt_coeff")
        self.all_bt_coeff = config.float("all_bt_coeff")
        self.mom_coeff = config.float("mom_coeff")
        self.momentum = config.float("momentum")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Drawn in this order from ``generator``: the Xavier-uniform user
        and item tables [·, d], then `torch_linear_init`'s W [d, d] of the
        projector's three layers (their biases drawn and left out, as in
        the JAX package) and the predictor's W and b; the hidden batch
        norms' gamma = 1 and beta = 0 [d]."""
        d = self.embedding_size
        params = {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                  "item_emb": xavier_uniform(generator, (self.num_items, d))}
        for k in (1, 2, 3):
            params[f"proj_w{k}"] = torch_linear_init(generator, d, d)[0]
        params["pred_w"], params["pred_b"] = torch_linear_init(generator, d, d)
        for k in (1, 2):
            params[f"proj_bn{k}_gamma"] = torch.ones(d)
            params[f"proj_bn{k}_beta"] = torch.zeros(d)
        return params

    def init_state(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The momentum targets' histories, standard normal: users [U, d],
        then items [I, d]."""
        d = self.embedding_size
        return {"u_target_his": torch.randn((self.num_users, d), generator=generator),
                "i_target_his": torch.randn((self.num_items, d), generator=generator)}

    def _projector(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        h = _f32(x) @ w["proj_w1"]
        h = torch.relu(batch_norm(h, w["proj_bn1_gamma"], w["proj_bn1_beta"]))
        h = h @ w["proj_w2"]
        h = torch.relu(batch_norm(h, w["proj_bn2_gamma"], w["proj_bn2_beta"]))
        return h @ w["proj_w3"]

    def _bt(self, w: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        d = float(self.embedding_size)
        c = mesh_lib.all_reduce(batch_norm(self._projector(w, x)).T
                                @ batch_norm(self._projector(w, y)))
        c = true_divide(c, float(mesh_lib.batch_rows(x.shape[0])))
        diag = torch.diagonal(c)
        on_diag = true_divide(torch.sum((diag - 1.0) ** 2), d)
        off_diag = true_divide(torch.sum(c ** 2) - torch.sum(diag ** 2), d)
        return mesh_lib.share(on_diag + self.bt_coeff * off_diag)

    def _poly_feature(self, w: dict, x: torch.Tensor) -> torch.Tensor:
        bn = batch_norm(self._projector(w, x))
        poly = torch.pow(self.a * mesh_lib.all_reduce(bn.T @ bn) + self.polyc, self.degree)
        return mesh_lib.share(torch.log(torch.mean(poly)))

    def _final(self) -> tuple[torch.Tensor, torch.Tensor]:
        emb0 = concat_user_item(self.user_emb, self.item_emb)
        return split_user_item(lightgcn_propagate(self.graph, emb0, self.num_layers),
                               self.num_users)

    def loss_terms(self, batch, generator=None, epoch=0):
        check_exact_matmul(self.device)
        users, pos = batch["user"], batch["pos"]
        user_all, item_all = self._final()
        w = {name: mesh_lib.data_sum(getattr(self, name)) for name in (
            "proj_w1", "proj_w2", "proj_w3", "proj_bn1_gamma", "proj_bn1_beta",
            "proj_bn2_gamma", "proj_bn2_beta", "pred_w", "pred_b")}
        user_g, pos_g = _f32(lookup(user_all, users)), _f32(lookup(item_all, pos))
        m = self.momentum
        u_target = self.u_target_his[users] * m + user_g.detach() * (1.0 - m)
        i_target = self.i_target_his[pos] * m + pos_g.detach() * (1.0 - m)
        user_n, pos_n = _normalize(user_g), _normalize(pos_g)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        bt = self._bt(w, user_n, pos_n) if self.all_bt_coeff != 0 else zero
        poly = (self._poly_feature(w, user_n) / 2 + self._poly_feature(w, pos_n) / 2
                if self.poly_coeff != 0 else zero)
        if self.mom_coeff != 0:
            user_p = user_g @ w["pred_w"] + w["pred_b"]
            pos_p = pos_g @ w["pred_w"] + w["pred_b"]
            cos_u = torch.sum(_normalize(user_p) * _normalize(i_target), dim=-1)
            cos_i = torch.sum(_normalize(pos_p) * _normalize(u_target), dim=-1)
            mom = -batch_mean(cos_u) / 2 - batch_mean(cos_i) / 2
        else:
            mom = zero
        with torch.no_grad():
            # the whole batch's rows, as one process writes them
            self.u_target_his.index_copy_(0, mesh_lib.whole_index(users),
                                          mesh_lib.gather_batch(user_g.detach()))
            self.i_target_his.index_copy_(0, mesh_lib.whole_index(pos),
                                          mesh_lib.gather_batch(pos_g.detach()))
        return self.all_bt_coeff * bt, self.poly_coeff * poly, self.mom_coeff * mom

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        return self._final()
