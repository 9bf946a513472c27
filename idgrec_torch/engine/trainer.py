"""The training engine (counterpart of idgrec_tpu/engine/trainer.py).

An epoch is a Python loop of steps over the epoch's sampled triples,
each step eager PyTorch around the hand-written kernels:

    loss_terms -> total.backward() -> Adam

* the model owns its parameters (`nn.Parameter`s) and the optimizer its
  moments: nothing is threaded through `run_epoch` but the triples;
* per-term losses accumulate on the device and the step loop reads
  nothing back, so the host runs ahead of the card;
* `torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)` in its
  single-tensor form (``foreach=False``, ``fused=False``), the same
  update as ``optax.adam`` and the same arithmetic on the CPU and the
  card.

The JAX engine's ``max_steps_per_call`` and scan segments bound the
wall time of one TPU program; eager PyTorch has no such program, so the
port has no counterpart. A short run is a small ``num_train``.

The trailing partial batch is wrapped (padded with samples from the
epoch's start) to keep every step at ``batch_size``, as the JAX engine
does.
"""

from __future__ import annotations

import torch

from idgrec_torch.models.base import RecModel


class EpochRunner:
    """Runs one-epoch training for a model."""

    def __init__(self, model: RecModel, learn_rate: float, batch_size: int, num_train: int,
                 optimizer: torch.optim.Optimizer | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError("sharded training over a mesh is ROADMAP A.9")
        self.model = model
        self.batch_size = int(batch_size)
        self.num_train = int(num_train)
        self.num_batches = max(1, -(-self.num_train // self.batch_size))
        self.opt = optimizer or torch.optim.Adam(
            model.parameters(), lr=learn_rate, betas=(0.9, 0.999), eps=1e-8,
            foreach=False, fused=False)

    def _prepare(self, users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor):
        nb, bs = self.num_batches, self.batch_size
        total = nb * bs

        def wrap(x):
            x = x.to(self.model.device, torch.int64)
            reps = -(-total // x.shape[0])
            return x.repeat(reps)[:total].reshape(nb, bs)

        return {"user": wrap(users), "pos": wrap(pos), "neg": wrap(neg)}

    def run_epoch(self, users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                  generator: torch.Generator | None = None, epoch: int = 0) -> torch.Tensor:
        """Run one epoch over the sampled triples. Returns the per-term
        loss sums, float32 [len(model.loss_names)] on the model's
        device: the one value that crosses to the host per epoch."""
        model = self.model
        model.train()
        batches = self._prepare(users, pos, neg)
        term_total = None
        for step in range(self.num_batches):
            batch = {k: v[step] for k, v in batches.items()}
            self.opt.zero_grad(set_to_none=True)
            terms = model.loss_terms(batch, generator, epoch)
            total = terms[0]
            for t in terms[1:]:
                total = total + t
            total.backward()
            self.opt.step()
            stacked = torch.stack([t.detach().to(torch.float32) for t in terms])
            term_total = stacked if term_total is None else term_total + stacked
        return term_total
