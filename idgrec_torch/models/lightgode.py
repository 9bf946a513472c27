"""LightGODE (Zhang et al., CIKM'24): a graph ODE over MF tables
(counterpart of idgrec_tpu/models/lightgode.py).

Training is alignment + γ·uniformity (DirectAU's losses) + L2 on the
batch's user and positive rows. The embeddings depend on
``train_strategy``:

* ``MF``: the tables, in training and evaluation (no propagation);
* ``GODE`` and ``MF_init``: the tables integrated through
  ``dx/dt = Â·x + e₀`` over [0, t] by one Euler step (ops/ode.py), in
  training and evaluation alike. ``MF_init`` runs the ODE in training
  too: the reference never switches it to MF (see the JAX module's
  docstring).

e₀ is float32; Â is the `sym` adjacency, on the card with the published
config (bfloat16 on ``auto``) one K6 launch an application, which
rounds e₀ to bfloat16 as the JAX package's products do.
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import (
    RecModel,
    batch_user_pos_embeddings,
    concat_user_item,
    split_user_item,
)
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses
from idgrec_torch.ops.ode import odeint_euler
from idgrec_torch.ops.propagate import build_adjacency


@register("LightGODE")
class LightGODE(RecModel):
    loss_names = ("align", "uniform", "reg")

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.gamma = config.float("gamma")
        self.reg_lambda = config.float("reg_lambda")
        self.t = config.float("t")
        self.train_strategy = config.str("train_strategy")
        if self.train_strategy not in ("MF", "GODE", "MF_init"):
            raise ValueError(f"unknown train_strategy {self.train_strategy!r}")
        self.graph = build_adjacency(
            data, "sym", self.backend, compute_dtype=self.compute_dtype,
            emb_size=self.embedding_size, device=self.device,
        )

    def embeddings(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(all user embeddings, all item embeddings): the tables under
        MF, else the ODE's solution at t."""
        if self.train_strategy == "MF":
            return self.user_emb, self.item_emb
        e0 = concat_user_item(self.user_emb, self.item_emb).to(torch.float32)
        z = odeint_euler(lambda t, x: self.graph.matmul(x) + e0, e0, [0.0, self.t])
        return split_user_item(z, self.num_users)

    def loss_terms(self, batch, generator=None, epoch=0):
        user_all, item_all = self.embeddings()
        user_e, item_e = batch_user_pos_embeddings(user_all, item_all, batch, self.compute_dtype)
        align = losses.align_loss(user_e, item_e)
        uniform = self.gamma * (losses.uniform_loss(user_e) + losses.uniform_loss(item_e)) / 2.0
        reg = self.reg_lambda * (losses.reg_loss_counted(self.user_emb, batch["user"])
                                 + losses.reg_loss_counted(self.item_emb, batch["pos"]))
        return align, uniform, reg

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        """`embeddings` without the graph of the backward; under MF copies
        of the tables, so that what a server holds does not move with
        later training steps."""
        user_all, item_all = self.embeddings()
        if self.train_strategy == "MF":
            return user_all.clone(), item_all.clone()
        return user_all, item_all
