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

On a mesh (``mesh=``, parallel/mesh.py) the runner stores the model's
tables row-sharded (`ShardedTables`, written by hand rather than with
FSDP2, whose hooks wrap ``forward``, which the port's models do not
use): every 2-D table of at least 2·width rows is zero-padded to a
128-row multiple (parallel/padding.py) and each rank keeps its rows of
it and Adam's moments of those rows, 1/width of each. A step gathers
the tables whole over the model axis (the backward keeps the rank's own
rows of the cotangent), runs the model's ``loss_terms`` under the
active mesh (the adjacency's products sharded over the model axis) on
the rank's rows of the batch (`mesh.split_batch`: data rank r takes rows
[r·B/D, (r+1)·B/D), and its loss is its share of the batch's) and steps
Adam on the shards. The data-sum boundaries of parallel/mesh.py give
every data rank the same whole gradient, so the step equals the
single-process step up to the order of float32 additions, and there is
no gradient all-reduce after ``backward()``. Every rank is given the
same triples (the run's generators are seeded alike on every rank, so a
step's noise is drawn as in one process); the reported terms are summed
over the data axis.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from idgrec_torch.engine import profiling
from idgrec_torch.models.base import RecModel
from idgrec_torch.parallel import mesh as mesh_lib
from idgrec_torch.parallel import padding


class ShardedTables:
    """The model's tables row-sharded over a mesh's model axis.

    On a model axis wider than 1, the tables that `mesh.placement`
    row-shards once padded (every 2-D parameter of at least 2·width rows)
    leave the model's parameters:
    each becomes a shard `nn.Parameter` [N_pad/width, d] here, and the
    model's attribute of that name becomes a plain tensor, the table
    gathered whole at its true rows (`gather`). Other parameters stay the
    model's, replicated on every rank."""

    def __init__(self, model: RecModel, mesh: mesh_lib.Mesh):
        self.model, self.mesh = model, mesh
        self.names = tuple(sorted(name for name, _ in model.named_parameters()))
        width = mesh.model
        node_rows = {model.num_users, model.num_items, model.num_users + model.num_items}
        tables = {k: getattr(model, k).detach() for k in self.names}
        self.meta = padding.build_meta(tables, width, node_rows)
        padded = padding.pad_tree(tables, self.meta)
        self.shards: dict[str, nn.Parameter] = {}
        self.rows: dict[str, int] = {}
        for k in self.names:
            if width == 1 or mesh_lib.placement(padded[k], width) != mesh_lib.ROWS:
                continue
            grad = getattr(model, k).requires_grad
            self.rows[k] = tables[k].shape[0]
            self.shards[k] = nn.Parameter(self._own_rows(padded[k]).clone(), requires_grad=grad)
            del model._parameters[k]
        self.gather(requires_grad=False)

    def _own_rows(self, x):
        r = x.shape[0] // self.mesh.model
        lo = self.mesh.model_index * r
        return x[lo: lo + r]

    def parameters(self) -> list[nn.Parameter]:
        """What Adam steps, in the tables' name order: the shards and the
        model's replicated parameters."""
        return [self.shards[k] if k in self.shards else getattr(self.model, k)
                for k in self.names]

    def gather(self, requires_grad: bool) -> None:
        """Set each sharded table on the model, gathered whole over the
        model axis at its true rows; differentiable into the shard with
        ``requires_grad``."""
        for k, shard in self.shards.items():
            if requires_grad and shard.requires_grad:
                full = mesh_lib.gather_model_rows(shard, self.mesh)
            else:
                full = mesh_lib.all_gather_rows(shard.detach(), self.mesh.model_group,
                                                self.mesh.model)
            setattr(self.model, k, full[: self.rows[k]])

    def _whole(self, k: str, shard_value: torch.Tensor) -> np.ndarray:
        full = mesh_lib.all_gather_rows(shard_value.detach(), self.mesh.model_group,
                                        self.mesh.model)
        return full[: self.rows[k]].cpu().numpy().copy()

    def params_numpy(self) -> dict[str, np.ndarray]:
        """The tables at their true shapes, numpy (a collective)."""
        return {k: getattr(self.model, k).detach().cpu().numpy().copy() for k in self.names}

    def adam_numpy(self, optimizer: torch.optim.Adam) -> dict:
        """Adam's state for the tables at their true shapes (a
        collective), in `convert.adam_state_to_numpy`'s layout."""
        out = {"count": 0, "mu": {}, "nu": {}}
        for k, p in zip(self.names, self.parameters()):
            st = optimizer.state.get(p, {})
            for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                value = st[key] if st else torch.zeros_like(p)
                out[name][k] = (self._whole(k, value) if k in self.shards
                                else value.detach().cpu().numpy().copy())
            if st:
                out["count"] = max(out["count"], int(st["step"]))
        return out

    @torch.no_grad()
    def load(self, params, optimizer: torch.optim.Adam | None = None, count: int = 0,
             mu=None, nu=None) -> None:
        """Set the tables (numpy or tensors at their true shapes) and, with
        ``optimizer``, Adam's state: each rank keeps its padded rows."""
        def rows_of(k, a):
            t = torch.as_tensor(np.asarray(a, np.float32))
            return self._own_rows(padding.pad_tree({k: t}, {k: self.meta[k]})[k])

        for k, p in zip(self.names, self.parameters()):
            value = rows_of(k, params[k]) if k in self.shards else torch.as_tensor(
                np.asarray(params[k], np.float32))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{k}: shape {tuple(value.shape)} != {tuple(p.shape)}")
            p.copy_(value.to(p.device))
            if optimizer is not None:
                moments = [rows_of(k, t[k]) if k in self.shards else torch.as_tensor(
                    np.asarray(t[k], np.float32)) for t in (mu, nu)]
                optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": moments[0].to(p.device).clone(),
                    "exp_avg_sq": moments[1].to(p.device).clone(),
                }
        self.gather(requires_grad=False)


class EpochRunner:
    """Runs one-epoch training for a model, on one device or on a mesh."""

    def __init__(self, model: RecModel, learn_rate: float, batch_size: int, num_train: int,
                 optimizer: torch.optim.Optimizer | None = None, mesh=None):
        self.model = model
        self.mesh = mesh
        self.batch_size = int(batch_size)
        if mesh is not None and self.batch_size % mesh.shape["data"] != 0:
            raise ValueError(
                f"batch_size ({self.batch_size}) must be divisible by the mesh's data axis "
                f"({mesh.shape['data']}) — pick a divisible batch_size or a different "
                "--data_parallel")
        self.num_train = int(num_train)
        self.num_batches = max(1, -(-self.num_train // self.batch_size))
        self.tables = None if mesh is None else ShardedTables(model, mesh)
        params = model.parameters() if mesh is None else self.tables.parameters()
        self.opt = optimizer or torch.optim.Adam(
            params, lr=learn_rate, betas=(0.9, 0.999), eps=1e-8,
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
        device: the one value that crosses to the host per epoch. On a
        mesh every rank is given the same triples, each data rank runs
        its rows of every batch, and every rank returns the sums over the
        data axis; the model's tables are left gathered (no gradient) for
        evaluation."""
        model = self.model
        model.train()
        batches = self._prepare(users, pos, neg)
        term_total = None
        with mesh_lib.use_mesh(self.mesh):
            for step in range(self.num_batches):
                with profiling.span("engine.trainer.step"):
                    self.opt.zero_grad(set_to_none=True)
                    if self.tables is not None:
                        self.tables.gather(requires_grad=True)
                    with mesh_lib.split_batch(self.mesh, {k: v[step] for k, v in
                                                          batches.items()}) as batch:
                        with profiling.span("engine.trainer.forward"):
                            terms = model.loss_terms(batch, generator, epoch)
                            total = terms[0]
                            for t in terms[1:]:
                                total = total + t
                        with profiling.span("engine.trainer.backward"):
                            total.backward()
                    with profiling.span("engine.trainer.adam"):
                        self.opt.step()
                    stacked = torch.stack([t.detach().to(torch.float32) for t in terms])
                    term_total = stacked if term_total is None else term_total + stacked
        if self.tables is not None:
            self.tables.gather(requires_grad=False)
        if self.mesh is not None:
            term_total = mesh_lib.all_reduce_sum(term_total, self.mesh.data_group,
                                                 self.mesh.data)
        return term_total
