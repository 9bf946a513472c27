"""Model base contract and shared propagation helpers (counterpart of
idgrec_tpu/models/base.py).

A model is an `nn.Module` that owns its embedding tables and its graph
on one device. Training needs `loss_terms`, the per-term losses of a
sampled (user, pos, neg) batch; serving and evaluation need
`eval_embeddings`, the representation computed once per sweep, and
`score_batch`, the full-catalog scores of a user batch against it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from idgrec_torch.config import Config
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.device import check_exact_matmul, resolve_device


def xavier_uniform(generator: torch.Generator, shape: tuple[int, ...],
                   dtype=torch.float32) -> torch.Tensor:
    """Xavier/Glorot uniform with gain 1 (fan_out = rows, fan_in =
    cols), drawn on the generator's device."""
    fan_out, fan_in = shape[0], shape[1] if len(shape) > 1 else 1
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-limit, limit, generator=generator)


class RecModel(nn.Module):
    """Base class: embedding-table recommender over a fixed graph.

    ``device`` defaults to the card; ``generator`` (a CPU
    `torch.Generator`) draws the initial tables, seeded from the
    config's ``seed`` when not given."""

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
        d = self.embedding_size
        self.user_emb = nn.Parameter(
            xavier_uniform(generator, (self.num_users, d)).to(self.device))
        self.item_emb = nn.Parameter(
            xavier_uniform(generator, (self.num_items, d)).to(self.device))

    def loss_terms(self, batch: dict[str, torch.Tensor],
                   generator: torch.Generator | None = None,
                   epoch: int = 0) -> tuple[torch.Tensor, ...]:
        """The per-term scalar losses of one batch, in the order of
        ``loss_names``; their sum is what the trainer differentiates.
        ``batch`` holds int64 [B] tensors "user", "pos", "neg" on the
        model's device. Fixed arity."""
        raise NotImplementedError

    def epoch_context(self, epoch: int, np_rng: np.random.Generator) -> Any:
        """Per-epoch host-side setup before the epoch's steps (nothing
        for a model with a fixed graph)."""
        return ()

    def eval_embeddings(self) -> Any:
        """Representation used for full-catalog scoring, computed once
        per sweep. Default contract: (user_emb, item_emb)."""
        raise NotImplementedError

    def score_batch(self, eval_repr: Any, users: torch.Tensor) -> torch.Tensor:
        """[B, num_items] scores sigmoid(U[users] @ Iᵀ) in full float32
        (sigmoid is monotonic: kept for score-value parity)."""
        user_emb, item_emb = eval_repr
        check_exact_matmul(user_emb.device)
        return torch.sigmoid(torch.matmul(user_emb[users], item_emb.T))


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
    modes (ops/scatter.py); plain indexing otherwise."""
    from idgrec_torch.ops import scatter as _scatter

    if _scatter.supports_fast_scatter(user_all.shape[0] + item_all.shape[0],
                                      user_all.shape[1], compute_dtype):
        return _scatter.gather_batch_embeddings(user_all, item_all, batch["user"],
                                                batch["pos"], batch["neg"])
    return user_all[batch["user"]], item_all[batch["pos"]], item_all[batch["neg"]]


def batch_user_pos_embeddings(user_all: torch.Tensor, item_all: torch.Tensor,
                              batch: dict[str, torch.Tensor], compute_dtype: str = "bfloat16"):
    """Two-gather twin of `batch_final_embeddings` (align/uniform models)."""
    from idgrec_torch.ops import scatter as _scatter

    if _scatter.supports_fast_scatter(user_all.shape[0] + item_all.shape[0],
                                      user_all.shape[1], compute_dtype):
        return _scatter.gather_user_pos(user_all, item_all, batch["user"], batch["pos"])
    return user_all[batch["user"]], item_all[batch["pos"]]
