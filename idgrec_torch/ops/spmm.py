"""Sparse matrix @ dense matrix for the gather backend (counterpart of
idgrec_tpu/ops/spmm.py).

The edge list is row-sorted COO (`SparseGraph`), so a product is one
gather of source rows, a scale by the edge weights and one sorted
segment sum into the destination rows. The JAX package computes this
outside any Pallas kernel, so stock PyTorch operations do it here too:
`index_select` and `torch.segment_reduce` over the per-row entry counts.
The backward runs the same function over the pre-sorted transpose
arrays, which for a symmetric adjacency are the same arrays.

Accumulation is float32 whatever the type of ``x``.

Determinism: a segment is summed by one thread in index order, on the
CPU and on the card, so the result has the same bits on every call
(`index_add_` would add with float atomics on the card, in an order
that changes from run to run).
"""

from __future__ import annotations

import torch

from idgrec_torch.data.graph import SparseGraph


def _segment_spmm(row_counts: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum over the entries (r, c, v) of v * x[c], in f32; the
    entries are sorted by r and ``row_counts`` holds their number per
    row."""
    weighted = x.index_select(0, cols).to(torch.float32) * vals[:, None]
    y = torch.segment_reduce(weighted, "sum", lengths=row_counts, unsafe=True)
    return y.to(x.dtype)


class _Spmm(torch.autograd.Function):
    """graph @ x; the graph is a constant, the cotangent of ``x`` is
    graphᵀ @ g over the transpose arrays."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return _segment_spmm(graph.row_counts, graph.cols, graph.vals, x)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        return _segment_spmm(graph.t_row_counts, graph.t_cols, graph.t_vals, g.contiguous()), None


def spmm(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """``graph @ x``: graph of logical shape [n_rows, n_cols], x
    [n_cols, dim] on the graph's device; returns [n_rows, dim] in
    x.dtype. Differentiable in ``x``."""
    if x.shape[0] != graph.n_cols:
        raise ValueError(f"spmm shape mismatch: graph {graph.shape} @ x {tuple(x.shape)}")
    if x.device != graph.device:
        raise ValueError(f"spmm: x on {x.device}, graph on {graph.device}")
    return _Spmm.apply(x, graph)


def spmm_transpose(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """``graphᵀ @ x`` without building a transposed graph."""
    return spmm(graph.transpose(), x)
