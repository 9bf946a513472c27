"""Normalized sparse graphs and degree math (the port's copy of
idgrec_tpu/data/graph.py, without its on-disk cache).

`SparseGraph` is a sparse matrix in row-sorted COO with its transpose
ordering carried alongside, so that the backward of the sparse product
(ops/spmm.py) is a forward product over pre-sorted arrays. The functions
below give the reference's normalizations of the bipartite adjacency: `sym`
(`normalized_adjacency`), `self` (`normalized_adjacency_with_self`) and
the generalized D^-alpha A D^-beta (`generalized_normalized_adjacency`),
and the rectangular user-item matrix R̃ = Du^-1/2 · R · Di^-1/2
(`normalized_rectangular`). The arrays are built with numpy and live on the graph's device, the
indices as int64 (what `index_select` takes).

`edge_dropout_adjacency` is SGL's per-epoch view for the gather
backend: a random subset of the interaction edges, renormalized.

Not copied: the ``.npz`` cache beside the dataset (a graph is rebuilt
from the CSR at every construction; at yelp2018 scale that is a sort of
2.5 million edges). `SparseGraph.transpose_permutation` serves the dropout of a graph's
edge values (NGCF's node dropout, ops/propagate.py); `SparseGraph.to_scipy`
gives LightGCL's SVD its matrix (ops/svd.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from idgrec_torch.data.dataset import Dataset

_PAD_MULTIPLE = 1024


def _pad_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class SparseGraph:
    """A sparse matrix in row-sorted COO with its transpose ordering.

    ``rows`` is non-decreasing; padding entries have ``val == 0`` and
    point at the last row and column (which keeps ``rows`` sorted), so
    they add nothing to a segment sum. ``row_counts[r]`` is the number
    of entries of row r, padding included: the segment lengths of the
    sorted reduction. Indices and counts are int64, values float32, all
    on one device."""

    rows: torch.Tensor    # int64 [nnz_padded], sorted ascending
    cols: torch.Tensor    # int64 [nnz_padded]
    vals: torch.Tensor    # float32 [nnz_padded]
    row_counts: torch.Tensor  # int64 [n_rows]
    t_rows: torch.Tensor  # the transpose, sorted by (transposed) row
    t_cols: torch.Tensor
    t_vals: torch.Tensor
    t_row_counts: torch.Tensor  # int64 [n_cols]
    n_rows: int
    n_cols: int
    nnz: int  # true (unpadded) edge count
    symmetric: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int], symmetric: bool = False,
                 pad_multiple: int = _PAD_MULTIPLE, device="cpu") -> "SparseGraph":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        nnz = int(rows.size)
        order = np.lexsort((cols, rows))
        r, c, v = rows[order], cols[order], vals[order]
        pad = _pad_to(max(nnz, 1), pad_multiple) - nnz
        dev = torch.device(device)

        def padded(a: np.ndarray, fill) -> torch.Tensor:
            return torch.from_numpy(np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])).to(dev)

        def counts(sorted_rows: np.ndarray, n: int) -> torch.Tensor:
            out = np.bincount(sorted_rows, minlength=n).astype(np.int64)
            out[n - 1] += pad
            return torch.from_numpy(out).to(dev)

        if symmetric:
            tr, tc, tv = r, c, v
        else:
            t_order = np.lexsort((rows, cols))
            tr, tc, tv = cols[t_order], rows[t_order], vals[t_order]
        return cls(
            rows=padded(r, shape[0] - 1), cols=padded(c, shape[1] - 1), vals=padded(v, 0.0),
            row_counts=counts(r, shape[0]),
            t_rows=padded(tr, shape[1] - 1), t_cols=padded(tc, shape[0] - 1),
            t_vals=padded(tv, 0.0), t_row_counts=counts(tr, shape[1]),
            n_rows=int(shape[0]), n_cols=int(shape[1]), nnz=nnz, symmetric=symmetric)

    def transpose(self) -> "SparseGraph":
        return SparseGraph(
            rows=self.t_rows, cols=self.t_cols, vals=self.t_vals, row_counts=self.t_row_counts,
            t_rows=self.rows, t_cols=self.cols, t_vals=self.vals, t_row_counts=self.row_counts,
            n_rows=self.n_cols, n_cols=self.n_rows, nnz=self.nnz, symmetric=self.symmetric)

    def transpose_permutation(self) -> torch.Tensor:
        """int64 [nnz_padded] on the graph's device: entry k of the
        transpose arrays is the transpose of entry ``t_perm[k]`` of the
        forward arrays, so ``vals[t_perm]`` are the transpose values of
        any ``vals`` on this pattern. A symmetric graph's self loops and
        the padding entries map to themselves. Built on the host from the
        index arrays (one read of them); raises `ValueError` when the
        pattern lacks an entry's transpose."""
        n = self.nnz
        rows, cols = self.rows[:n].cpu().numpy(), self.cols[:n].cpu().numpy()
        t_rows, t_cols = self.t_rows[:n].cpu().numpy(), self.t_cols[:n].cpu().numpy()
        keys = rows * self.n_cols + cols  # ascending: rows sorted, then columns
        want = t_cols * self.n_cols + t_rows
        perm = np.minimum(np.searchsorted(keys, want), max(n - 1, 0))
        if n and not np.array_equal(keys[perm], want):
            raise ValueError("the graph's pattern lacks the transpose of an entry")
        pad = np.arange(n, self.rows.numel(), dtype=np.int64)
        return torch.from_numpy(np.concatenate([perm.astype(np.int64), pad])).to(self.device)

    def to_scipy(self):
        """The matrix as a scipy CSR on the host (its true entries,
        float32), as the JAX package's ``to_scipy`` gives it: the
        operand of LightGCL's low-rank SVD (ops/svd.py)."""
        import scipy.sparse as sp

        n = self.nnz
        return sp.coo_matrix(
            (self.vals[:n].cpu().numpy(), (self.rows[:n].cpu().numpy(),
                                            self.cols[:n].cpu().numpy())),
            shape=self.shape).tocsr()

    def with_values(self, vals: torch.Tensor, t_vals: torch.Tensor) -> "SparseGraph":
        """The same sparsity pattern with other edge values."""
        return SparseGraph(
            rows=self.rows, cols=self.cols, vals=vals, row_counts=self.row_counts,
            t_rows=self.t_rows, t_cols=self.t_cols, t_vals=t_vals,
            t_row_counts=self.t_row_counts, n_rows=self.n_rows, n_cols=self.n_cols,
            nnz=self.nnz, symmetric=self.symmetric)


# ---------------------------------------------------------------------------
# Edge extraction and degree math


def _interaction_edges(data: Dataset) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique (user, item, multiplicity) training pairs from the CSR."""
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    return users, data.col_idx.astype(np.int64), data.csr_vals.astype(np.float64)


def _degrees(data: Dataset) -> tuple[np.ndarray, np.ndarray]:
    """(user degree, item degree) as float64, counting interaction
    multiplicities (the scipy row/col sums the reference normalizes
    with)."""
    u, i, v = _interaction_edges(data)
    du = np.bincount(u, weights=v, minlength=data.num_users)
    di = np.bincount(i, weights=v, minlength=data.num_items)
    return du, di


def _inv_pow(x: np.ndarray, p: float) -> np.ndarray:
    """x**-p with the non-finite entries (zero degree) set to 0."""
    with np.errstate(divide="ignore"):
        out = np.power(x, -p)
    out[~np.isfinite(out)] = 0.0
    return out


# ---------------------------------------------------------------------------
# The normalizations


def normalized_adjacency(data: Dataset, device="cpu") -> SparseGraph:
    """Symmetric normalization of the bipartite adjacency (no
    self-loop): D^-1/2 · A · D^-1/2 with A = [[0, R], [Rᵀ, 0]]."""
    u, i, v = _interaction_edges(data)
    du, di = _degrees(data)
    nu = data.num_users
    w = v * _inv_pow(du, 0.5)[u] * _inv_pow(di, 0.5)[i]
    rows = np.concatenate([u, i + nu])
    cols = np.concatenate([i + nu, u])
    vals = np.concatenate([w, w]).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, (data.num_nodes, data.num_nodes),
                                symmetric=True, device=device)


def normalized_adjacency_with_self(data: Dataset, device="cpu") -> SparseGraph:
    """Symmetric normalization of A + I."""
    u, i, v = _interaction_edges(data)
    du, di = _degrees(data)
    nu, nn = data.num_users, data.num_nodes
    d = np.concatenate([du, di]) + 1.0  # the self-loop adds 1 to every degree
    dinv = _inv_pow(d, 0.5)
    w = v * dinv[u] * dinv[i + nu]
    diag = dinv[np.arange(nn)] ** 2  # 1/d for the self edge
    rows = np.concatenate([u, i + nu, np.arange(nn)])
    cols = np.concatenate([i + nu, u, np.arange(nn)])
    vals = np.concatenate([w, w, diag]).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, (nn, nn), symmetric=True, device=device)


def generalized_normalized_adjacency(data: Dataset, alpha: float, beta: float,
                                     device="cpu") -> SparseGraph:
    """Generalized norm D^-alpha · A · D^-beta (no self-loop), the
    LightGCN++ graph. Not symmetric as a matrix unless alpha == beta."""
    u, i, v = _interaction_edges(data)
    du, di = _degrees(data)
    nu = data.num_users
    d = np.concatenate([du, di])
    d_left = _inv_pow(d, alpha)
    d_right = _inv_pow(d, beta)
    w_ui = v * d_left[u] * d_right[i + nu]
    w_iu = v * d_left[i + nu] * d_right[u]
    rows = np.concatenate([u, i + nu])
    cols = np.concatenate([i + nu, u])
    vals = np.concatenate([w_ui, w_iu]).astype(np.float32)
    return SparseGraph.from_coo(rows, cols, vals, (data.num_nodes, data.num_nodes),
                                symmetric=(alpha == beta), device=device)


def normalized_rectangular(data: Dataset, device="cpu") -> SparseGraph:
    """Rectangular normalization R̃ = Du^-1/2 · R · Di^-1/2 of shape
    [U, I] (not symmetric): the weights v · du^-1/2[u] · di^-1/2[i] in
    float32."""
    u, i, v = _interaction_edges(data)
    du, di = _degrees(data)
    w = (v * _inv_pow(du, 0.5)[u] * _inv_pow(di, 0.5)[i]).astype(np.float32)
    return SparseGraph.from_coo(u, i, w, (data.num_users, data.num_items), device=device)


def edge_dropout_adjacency(data: Dataset, drop_ratio: float, rng: np.random.Generator,
                           device="cpu") -> SparseGraph:
    """SGL's edge-dropout view: ``int(round((1 - drop_ratio) · E))`` of the
    E interaction edges kept, the first entries of ``rng.permutation(E)``,
    with binary values and the degrees recounted on the kept edges, then
    normalized symmetrically. ``rng`` draws exactly what the dense and
    bitpack views draw (ops/propagate.py `build_dropout_adjacency`), so
    one generator state selects the same edges on every backend. Padded
    to the full graph's padded size, whatever the number kept."""
    u_all, i_all, _ = _interaction_edges(data)
    nnz = u_all.size
    keep = rng.permutation(nnz)[: int(round((1.0 - drop_ratio) * nnz))]
    u, i = u_all[keep], i_all[keep]
    du = np.bincount(u, minlength=data.num_users).astype(np.float64)
    di = np.bincount(i, minlength=data.num_items).astype(np.float64)
    w = (_inv_pow(du, 0.5)[u] * _inv_pow(di, 0.5)[i]).astype(np.float32)
    nu = data.num_users
    rows = np.concatenate([u, i + nu])
    cols = np.concatenate([i + nu, u])
    vals = np.concatenate([w, w])
    full_padded = _pad_to(max(2 * nnz, 1), _PAD_MULTIPLE)
    return SparseGraph.from_coo(rows, cols, vals, (data.num_nodes, data.num_nodes),
                                symmetric=True, pad_multiple=full_padded, device=device)
