"""The symmetric normalised bipartite adjacency Â = D^-1/2 A D^-1/2, A =
[[0, R], [Rᵀ, 0]], built from the train pairs alone, and the layer mean
of LightGCN-style propagation over it.

By default a product Â x is float32 throughout. With ``operand`` (a
configuration's stated compute dtype, e.g. bfloat16) each product holds
its degree-scaled input D^-1/2 x in that dtype, as a product whose
operands are stated in it does, sums the counts times those values
exactly (float64, exact for bfloat16 operands of these degrees), and
scales the float32 sums by D^-1/2; its backward does the same to the
cotangent."""

from __future__ import annotations

import numpy as np
import torch


class Adjacency:
    def __init__(self, train_user, train_item, num_users: int, num_items: int,
                 device: torch.device, operand: torch.dtype | None = None):
        u = torch.as_tensor(np.asarray(train_user), dtype=torch.int64, device=device)
        i = torch.as_tensor(np.asarray(train_item), dtype=torch.int64, device=device)
        ones = torch.ones(u.shape, dtype=torch.float64, device=device)
        # degrees count a repeated pair as often as it occurs
        du = torch.zeros(num_users, dtype=torch.float64, device=device).index_add_(0, u, ones)
        di = torch.zeros(num_items, dtype=torch.float64, device=device).index_add_(0, i, ones)
        deg = torch.cat([du, di])
        inv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
        rows = torch.cat([u, num_users + i])
        cols = torch.cat([num_users + i, u])
        n = num_users + num_items
        if operand is None:
            vals = (inv[rows] * inv[cols]).to(torch.float32)
        else:
            vals = torch.ones(rows.shape, dtype=torch.float64, device=device)
        self.matrix = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                              check_invariants=False).coalesce()
        self.scale = inv.to(torch.float32)[:, None]
        self.operand = operand
        self.num_users, self.num_items = num_users, num_items

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if self.operand is None:
            return torch.sparse.mm(self.matrix, x)
        return _StatedProduct.apply(x, self)

    def stated(self, x: torch.Tensor) -> torch.Tensor:
        """D^-1/2 (A (D^-1/2 x held in the operand dtype)), the sums exact."""
        z = (self.scale * x).to(self.operand).to(torch.float64)
        return self.scale * torch.sparse.mm(self.matrix, z).to(torch.float32)


class _StatedProduct(torch.autograd.Function):
    """Â x with the operand held in the stated dtype both ways: Â is
    symmetric, so the backward is the same product on the cotangent,
    whose degree-scaled rows are held in that dtype too."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return adj.stated(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.adj.stated(g), None


def propagate_mean(adj: Adjacency, emb0: torch.Tensor, layers: int,
                   include_layer0: bool) -> torch.Tensor:
    """The mean of the layers (0 or 1)..K of h_{k+1} = Â h_k, summed in
    layer order and divided (IEEE division, not a reciprocal)."""
    h, total, terms = emb0, (emb0 if include_layer0 else None), int(include_layer0)
    for _ in range(layers):
        h = adj.matmul(h)
        total = h if total is None else total + h
        terms += 1
    return divide(total, terms)


def divide(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n by IEEE division (a Python divisor multiplies by its
    reciprocal on the card)."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)
