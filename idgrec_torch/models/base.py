"""Model base contract and shared propagation helpers (counterpart of
idgrec_tpu/models/base.py).

A model is an `nn.Module` that owns its embedding tables and its graph
on one device. Each model names and draws its own tables
(`RecModel.init_params`, the counterpart of the JAX ``init_params``):
LightGCN a user and an item table, EGCF an item table alone. Training
needs `loss_terms`, the per-term losses of a sampled (user, pos, neg)
batch; serving and evaluation need `eval_embeddings`, the
representation computed once per sweep, and `score_batch`, the
full-catalog scores of a user batch against it.

A model may carry state from step to step (RecDCL's target histories):
`RecModel.init_state` draws it after the tables, the tensors are
buffers outside the parameters and the state dict, and `loss_terms`
rewrites them in place.

A model whose step draws random numbers (ops/noise.py) draws them from
the `torch.Generator` that `loss_terms` is given, on the model's device,
and raises `ValueError` without one; a model whose representation draws
(BIGCF) takes one in `eval_embeddings` too. The others ignore it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from idgrec_torch.config import Config
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.device import check_exact_matmul, resolve_device
from idgrec_torch.ops import noise
from idgrec_torch.parallel import mesh as mesh_lib


def xavier_uniform(generator: torch.Generator, shape: tuple[int, ...],
                   dtype=torch.float32) -> torch.Tensor:
    """Xavier/Glorot uniform with gain 1 (fan_out = rows, fan_in =
    cols), drawn on the generator's device."""
    fan_out, fan_in = shape[0], shape[1] if len(shape) > 1 else 1
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


def torch_linear_init(generator: torch.Generator, fan_in: int,
                      fan_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`torch.nn.Linear`'s default initialisation for y = x @ W + b: W
    [fan_in, fan_out], then b [fan_out], each drawn from U(-k, k) with
    k = 1/sqrt(fan_in), on the generator's device."""
    k = float(1.0 / np.sqrt(fan_in))
    w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=generator.device)
    w.uniform_(-k, k, generator=generator)
    b = torch.empty((fan_out,), dtype=torch.float32, device=generator.device)
    return w, b.uniform_(-k, k, generator=generator)


def keep_dropout(x: torch.Tensor, keep_prob: float,
                 generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout by keep probability: each entry kept with
    probability ``keep_prob`` (`noise.bernoulli`) and divided by it, the
    others 0. At ``keep_prob >= 1`` nothing is drawn and x returned."""
    from idgrec_torch.ops.propagate import true_divide

    if keep_prob >= 1.0:
        return x
    mask = noise.bernoulli(keep_prob, x.shape, generator)
    return torch.where(mask, true_divide(x, keep_prob), 0.0)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout by rate (torch's): `keep_dropout` at keep = 1 -
    ``rate``, in x's dtype. A rate of 0 draws nothing and returns x."""
    if rate <= 0.0:
        return x
    return keep_dropout(x, 1.0 - rate, generator).to(x.dtype)


def batch_norm(x: torch.Tensor, gamma: torch.Tensor | None = None,
               beta: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Batch normalization over dim 0 with the batch's statistics, in
    float32 (torch's BatchNorm1d in training mode): the population
    variance (``correction=0``, as ``jnp.var``), then ``gamma`` and
    ``beta`` [d] when given. Under a data split ``x`` is the rank's rows
    and the statistics are the whole batch's: the sums all-reduced over
    the data axis."""
    from idgrec_torch.ops.propagate import true_divide

    x = x.to(torch.float32)
    n = float(mesh_lib.batch_rows(x.shape[0]))
    mean = true_divide(mesh_lib.all_reduce(torch.sum(x, dim=0, keepdim=True)), n)
    var = true_divide(mesh_lib.all_reduce(torch.sum((x - mean) ** 2, dim=0, keepdim=True)), n)
    y = (x - mean) / torch.sqrt(var + eps)
    if gamma is not None:
        y = y * gamma[None, :] + beta[None, :]
    return y


class RecModel(nn.Module):
    """Base class: embedding-table recommender over a fixed graph.

    ``device`` defaults to the card; ``generator`` (a CPU
    `torch.Generator`) draws the initial tables (`init_params`), then the
    initial state (`init_state`), seeded from the config's ``seed`` when
    not given. Each table becomes an `nn.Parameter` of the model under
    its name. Each state tensor becomes a buffer under its name, on the
    model's device and outside the state dict: no gradient, no Adam
    state, and `load_state_dict` of the tables alone stays strict."""

    model_name: str = "RecModel"
    loss_names: Sequence[str] = ("loss",)
    # run-harness contract (engine/loop.py): whether early stopping ends
    # the run, how an epoch is batched ("bpr_triples" or "user_rows"),
    # and how many graph aggregations a step makes (throughput model)
    respects_early_stop: bool = True
    batching: str = "bpr_triples"
    aggregates_per_step: int = 1

    def __init__(self, config: Config, data: Dataset, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        self.data = data
        self.device = resolve_device(device)
        self.num_users = data.num_users
        self.num_items = data.num_items
        self.embedding_size = config.int("embedding_size")
        self.backend = config.str("propagation_backend", "auto")
        self.compute_dtype = config.str("compute_dtype", "bfloat16")
        if generator is None:
            generator = torch.Generator().manual_seed(config.int("seed"))
        for name, table in self.init_params(generator).items():
            setattr(self, name, nn.Parameter(table.to(self.device)))
        state = self.init_state(generator)
        self.state_names = tuple(sorted(state))
        for name in self.state_names:
            self.register_buffer(name, state[name].to(self.device), persistent=False)

    def init_params(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The model's initial tables by name, drawn from ``generator``
        in order: here a user table, then an item table."""
        d = self.embedding_size
        return {"user_emb": xavier_uniform(generator, (self.num_users, d)),
                "item_emb": xavier_uniform(generator, (self.num_items, d))}

    def init_state(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """The model's initial state by name (the JAX ``init_state``),
        drawn from ``generator`` after the tables: tensors a step reads
        and rewrites that are not parameters. Empty here."""
        return {}

    def model_state(self) -> dict[str, torch.Tensor]:
        """The state tensors by name (the model's own, not copies)."""
        return {name: getattr(self, name) for name in self.state_names}

    @torch.no_grad()
    def load_model_state(self, state) -> None:
        """Copy ``state`` (name -> array or tensor, every state name, the
        same shapes) into the model's state tensors."""
        missing = [k for k in self.state_names if k not in state]
        if missing:
            raise KeyError(f"state lacks {missing}")
        for name in self.state_names:
            have = getattr(self, name)
            value = state[name]
            value = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
            if tuple(value.shape) != tuple(have.shape):
                raise ValueError(f"state {name}: shape {tuple(value.shape)} != "
                                 f"{tuple(have.shape)}")
            have.copy_(value.to(have.device, have.dtype))

    def loss_terms(self, batch: dict[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   epoch: int = 0) -> tuple[torch.Tensor, ...]:
        """The per-term scalar losses of one batch, in the order of
        ``loss_names``; their sum is what the trainer differentiates.
        ``batch`` holds int64 [B] tensors "user", "pos", "neg" on the
        model's device; ``generator`` (on that device) draws whatever
        the step draws. Fixed arity. A model with state rewrites it in
        place under ``no_grad``, as the last thing the step does to it
        (the JAX ``loss_terms`` returns the new state)."""
        raise NotImplementedError

    def epoch_context(self, epoch: int, np_rng: np.random.Generator) -> Any:
        """Per-epoch host-side setup before the epoch's steps (nothing
        for a model with a fixed graph)."""
        return ()

    def eval_embeddings(self, generator: torch.Generator | None = None) -> Any:
        """Representation used for full-catalog scoring, computed once
        per sweep. Default contract: (user_emb, item_emb). ``generator``
        (on the model's device) draws whatever the representation draws;
        a model that draws nothing ignores it."""
        raise NotImplementedError

    def score_batch(self, eval_repr: Any, users: torch.Tensor,
                    items: slice = slice(None)) -> torch.Tensor:
        """[B, num_items] scores sigmoid(U[users] @ Iᵀ) in full float32
        (sigmoid is monotonic: kept for score-value parity); with
        ``items``, only those columns (a rank's slice of the catalog)."""
        user_emb, item_emb = eval_repr
        check_exact_matmul(user_emb.device)
        return torch.sigmoid(torch.matmul(user_emb[users], item_emb[items].T))

    def score_factors(self, eval_repr: Any) -> tuple[torch.Tensor, torch.Tensor] | None:
        """(user table, item table) of ``eval_repr`` where the model scores
        by this class's `score_batch`, the sigmoid of their product, so
        that the evaluator may score, mask and rank a batch in one op
        (`ops.score_topk`); None where a model scores otherwise (CVGA's
        decoder)."""
        if type(self).score_batch is not RecModel.score_batch:
            return None
        user_emb, item_emb = eval_repr
        return user_emb, item_emb


# ---------------------------------------------------------------------------
# Shared propagation rules


def concat_user_item(user_emb: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
    return torch.cat([user_emb, item_emb], dim=0)


def split_user_item(emb: torch.Tensor, num_users: int) -> tuple[torch.Tensor, torch.Tensor]:
    return emb[:num_users], emb[num_users:]


def lightgcn_propagate(graph, emb0: torch.Tensor, num_layers: int,
                       include_layer0: bool = True, reduce: str = "mean") -> torch.Tensor:
    """K-layer linear propagation with layer combination,
    differentiable in ``emb0``.

    reduce='mean' + include_layer0 is canonical LightGCN. The quantized
    fused backend runs the chain through kernels K1-K3 or K5
    (ops/chainmm.py) where they take the shapes; every other adjacency,
    and a width the chain's kernels do not take, runs one
    ``graph.matmul`` per layer and combines the layers here. With no
    layer, the combine is emb0 alone."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if num_layers == 0:
        if not include_layer0:
            raise ValueError(
                "num_layers=0 with include_layer0=False leaves no embeddings "
                "to combine (GCN_layer must be >= 1 for this model)")
        return emb0
    from idgrec_torch.ops import chainmm as _chainmm
    from idgrec_torch.ops.propagate import true_divide

    if _chainmm.supports_chain_resident(graph, emb0.shape[1], num_layers, reduce, None):
        return _chainmm.fused_chain_resident(graph, emb0, num_layers, include_layer0, reduce)
    h = emb0
    total, terms = (emb0, 1) if include_layer0 else (None, 0)
    for _ in range(num_layers):
        h = graph.matmul(h)
        # the stack's sum in layer order: ((h0 + h1) + h2) + ...
        total = h if total is None else total + h
        terms += 1
    # divide, not multiply by the reciprocal (inexact for 3 layers)
    return true_divide(total, float(terms)) if reduce == "mean" else total


def lightgcn_propagate_rows(graph, emb0: torch.Tensor, num_layers: int, rows_u: torch.Tensor,
                            rows_i: torch.Tensor, num_users: int, include_layer0: bool = True,
                            reduce: str = "mean") -> tuple[torch.Tensor, torch.Tensor]:
    """`lightgcn_propagate` restricted to selected output rows: K - 1
    full ``graph.matmul`` layers, then the last layer as the batch-row
    partial product ``graph.matmul_rows`` (so one full forward
    application, and through autograd one full backward application, per
    step become O(B·N·d) partials). Returns (user rows, item rows) of the
    final embeddings, equal to the full path's rows up to the order of
    the partial's float32 additions. Needs ``graph.supports_rows``."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if num_layers == 0:
        full = lightgcn_propagate(graph, emb0, 0, include_layer0, reduce)
        return full[rows_u], full[num_users + rows_i]
    from idgrec_torch.ops.propagate import true_divide

    h = emb0
    items = num_users + rows_i
    tot_u, tot_i, terms = ((mesh_lib.lookup(emb0, rows_u), mesh_lib.lookup(emb0, items), 1)
                           if include_layer0 else (None, None, 0))

    def add(total, part):
        return part if total is None else total + part

    for _ in range(num_layers - 1):
        h = graph.matmul(h)
        tot_u, tot_i = add(tot_u, mesh_lib.lookup(h, rows_u)), add(tot_i, mesh_lib.lookup(h, items))
        terms += 1
    # under a data split the partial product reads the rank's rows: its
    # input's cotangent is summed over the data axis
    yu, yi = graph.matmul_rows(mesh_lib.data_sum(h), rows_u, rows_i)
    tot_u, tot_i = add(tot_u, yu), add(tot_i, yi)
    terms += 1
    if reduce == "sum":
        return tot_u, tot_i
    return true_divide(tot_u, float(terms)), true_divide(tot_i, float(terms))


def layer_mean(layers: list[torch.Tensor]) -> torch.Tensor:
    """The mean of a per-layer list (`lightgcn_layer_outputs`), summed in
    layer order and divided, not multiplied by the reciprocal."""
    from idgrec_torch.ops.propagate import true_divide

    total = layers[0]
    for h in layers[1:]:
        total = total + h
    return true_divide(total, float(len(layers)))


def lightgcn_layer_outputs(graph, emb0: torch.Tensor, num_layers: int) -> list[torch.Tensor]:
    """[emb0, Â·emb0, Â²·emb0, ...]: the per-layer list some
    self-supervised models contrast across."""
    from idgrec_torch.ops import propagate as _prop

    if (num_layers > 0 and _prop.supports_chain_t(graph, emb0.shape[1])
            and not graph.has_diag):
        return _prop.fused_chain_t(graph, emb0, num_layers, include_layer0=True, reduce=None)
    outs = [emb0]
    h = emb0
    for _ in range(num_layers):
        h = graph.matmul(h)
        outs.append(h)
    return outs


def batch_final_embeddings(user_all: torch.Tensor, item_all: torch.Tensor,
                           batch: dict[str, torch.Tensor], compute_dtype: str = "bfloat16"):
    """(user_all[u], item_all[pos], item_all[neg]) with the backward's
    batch-cotangent row scatters on kernel K4 in the quantized compute
    modes (ops/scatter.py); plain indexing otherwise. Under a data split
    the batch is the rank's rows and the backward scatters the whole
    batch's cotangent, all-gathered over the data axis (`mesh.lookup`)."""
    from idgrec_torch.ops import scatter as _scatter

    u, p, n = batch["user"], batch["pos"], batch["neg"]
    if _scatter.supports_fast_scatter(user_all.shape[0] + item_all.shape[0],
                                      user_all.shape[1], compute_dtype):
        return _scatter.gather_batch_embeddings(user_all, item_all, u, p, n)
    return mesh_lib.lookup(user_all, u), mesh_lib.lookup(item_all, p), mesh_lib.lookup(item_all, n)


def batch_user_pos_embeddings(user_all: torch.Tensor, item_all: torch.Tensor,
                              batch: dict[str, torch.Tensor], compute_dtype: str = "bfloat16"):
    """Two-gather twin of `batch_final_embeddings` (align/uniform models)."""
    from idgrec_torch.ops import scatter as _scatter

    u, p = batch["user"], batch["pos"]
    if _scatter.supports_fast_scatter(user_all.shape[0] + item_all.shape[0],
                                      user_all.shape[1], compute_dtype):
        return _scatter.gather_user_pos(user_all, item_all, u, p)
    return mesh_lib.lookup(user_all, u), mesh_lib.lookup(item_all, p)
