"""CVGA (Zhang et al., TOIS'23): collaborative variational graph
auto-encoder (counterpart of idgrec_tpu/models/cvga.py).

The encoder applies a linear layer to the normalized rectangular graph
R̃ itself: h = R̃ @ q_w + q_b [U, 2d] (on the dense route in bfloat16
one K6 launch at width 2d with the user side left out, its backward one
launch the other way), dropout while training, split into (μ, log σ²);
z = μ + σ·ε with ε ~ N(0, 1) drawn over the whole user table, in
training and in evaluation alike (the reference's ``randn_like`` runs in
eval mode too); the decoder z @ p_w + p_b scores every item. Loss: the
ELBO (`losses.elbo_loss`, anneal 1.0) of the decoder's rows against the
batch users' interaction rows.

Training batches over users (``batching = "user_rows"``): the run
harness feeds a shuffled permutation of the user ids, and the model
builds the batch's dense target rows [B, I] on the device from padded
per-user positives made once with numpy.

The evaluation representation is the dict {"z", "p_w", "p_b"}, and
`score_batch` returns the decoder's raw output (no sigmoid).
"""

from __future__ import annotations

import numpy as np
import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.models.base import RecModel, dropout, torch_linear_init
from idgrec_torch.models.registry import register
from idgrec_torch.ops import losses, noise
from idgrec_torch.ops.propagate import build_rect_adjacency


@register("CVGA")
class CVGA(RecModel):
    loss_names = ("recon", "kl")
    batching = "user_rows"

    def __init__(self, config, data, *, device=None, generator=None):
        super().__init__(config, data, device=device, generator=generator)
        self.dropout_rate = config.float("dropout")
        self.graph = build_rect_adjacency(data, self.backend, compute_dtype=self.compute_dtype,
                                          device=self.device)
        # each user's positives and counts, padded to the largest degree
        # with the column num_items, which `_dense_rows` drops
        deg = np.diff(data.row_ptr)
        width = max(1, int(deg.max()) if deg.size else 1)
        pos = np.full((data.num_users, width), data.num_items, np.int64)
        vals = np.zeros((data.num_users, width), np.float32)
        rows = np.repeat(np.arange(data.num_users), deg)
        slots = np.arange(data.nnz) - np.repeat(data.row_ptr[:-1], deg)
        pos[rows, slots] = data.col_idx
        vals[rows, slots] = data.csr_vals
        self._padded_pos = torch.from_numpy(pos).to(self.device)
        self._padded_vals = torch.from_numpy(vals).to(self.device)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The encoder's q_w [I, 2d] and q_b [2d], then the decoder's p_w
        [d, I] and p_b [I], each drawn as `torch.nn.Linear` draws its
        weights (`torch_linear_init`), in the JAX layout y = x @ W + b."""
        d = self.embedding_size
        q_w, q_b = torch_linear_init(generator, self.num_items, 2 * d)
        p_w, p_b = torch_linear_init(generator, d, self.num_items)
        return {"q_w": q_w, "q_b": q_b, "p_w": p_w, "p_b": p_b}

    def _dense_rows(self, users: torch.Tensor) -> torch.Tensor:
        """The batch users' interaction rows [B, I], float32."""
        rows = torch.zeros((users.shape[0], self.num_items + 1), dtype=torch.float32,
                           device=self.device)
        rows.scatter_add_(1, self._padded_pos[users], self._padded_vals[users])
        return rows[:, : self.num_items]

    def encode(self, generator: torch.Generator | None,
               training: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """(μ, log σ²) [U, d] each: R̃ @ q_w + q_b, dropped out while
        training."""
        h = self.graph.matmul(self.q_w) + self.q_b[None, :]
        if training:
            h = dropout(h, self.dropout_rate, generator)
        d = self.embedding_size
        return h[:, :d], h[:, d:]

    def decode(self, p_w: torch.Tensor, p_b: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        check_exact_matmul(z.device)
        return torch.matmul(z, p_w) + p_b

    @staticmethod
    def reparameterize(generator: torch.Generator, mu: torch.Tensor,
                       logvar: torch.Tensor) -> torch.Tensor:
        std = torch.exp(0.5 * logvar)
        eps = noise.normal(std.shape, generator, dtype=std.dtype)
        return eps * std + mu

    def loss_terms(self, batch, generator=None, epoch=0):
        generator = noise.require_generator(generator, "CVGA.loss_terms")
        users = batch["user"]
        x = self._dense_rows(users)
        mu, logvar = self.encode(generator, training=True)
        z = self.reparameterize(generator, mu, logvar)
        recon = self.decode(self.p_w, self.p_b, z[users])
        return losses.elbo_loss(recon, x, mu[users], logvar[users], 1.0)

    @torch.no_grad()
    def eval_embeddings(self, generator=None) -> dict[str, torch.Tensor]:
        generator = noise.require_generator(generator, "CVGA.eval_embeddings")
        mu, logvar = self.encode(generator, training=False)
        return {"z": self.reparameterize(generator, mu, logvar), "p_w": self.p_w.detach(),
                "p_b": self.p_b.detach()}

    def score_batch(self, eval_repr, users: torch.Tensor) -> torch.Tensor:
        """The decoder's raw scores [B, I] of the users' z rows."""
        return self.decode(eval_repr["p_w"], eval_repr["p_b"], eval_repr["z"][users])
