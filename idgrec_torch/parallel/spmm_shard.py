"""Sharded propagation over the mesh's model axis (counterpart of
idgrec_tpu/parallel/spmm_shard.py; ROADMAP A.9).

The square adjacency Â = diag(L)·[[0, M], [Mᵀ, 0]]·diag(R) (+ diag) is
partitioned by the rows of the int8 count matrix M [U_pad, I_pad]: model
rank k holds M_k = M[k·U_pad/n : (k+1)·U_pad/n] on its card and nothing
else of M (`propagate.build_adjacency` builds M on the host and uploads
the rank's rows), so each rank reads 1/n of M an application. Between
the collectives each rank runs the kernel the single-card route runs,
on its shard (`shard_dual`), K6, K7 and K8 walking the shard's own plan
(`fusedmm.dual_plan` of M_k, made at build beside it; K8's of the
unpacked shard, before packing):

* bfloat16 on ``fused``, and on ``dense`` where K6 takes the width: K6
  (`fusedmm.fused_adj_matmul`);
* int8: K7 (`fused_adj_matmul_int8`; ``dense`` off K7's widths: the
  float32 products of the integers, as on one card);
* int4: K8 (`fused_adj_matmul_int4`) on the nibble-packed shard's plan;
* float32: `fusedmm.dual_matmul_f32`, as on one card.

On the CPU the wrappers run their plain versions; on CUDA tensors they
launch their kernels or raise.

Activations stay replicated within the model group, not sharded as in
the JAX package: every rank holds the whole right-scaled [U_pad, d] and
[I_pad, d] inputs, computes (M_k @ zi, M_kᵀ @ zu_k) with zu_k its own
rows, and one all-gather of the yu blocks and one all-reduce of the yi
partials give every rank the whole output. The model code thus runs
unchanged on every rank. The backward is the same sharded product on
the swapped cotangents (`propagate._SwappedDual`), straight-through in
the quantized modes; there the scales come from the column maxima of
the whole (replicated) activations, so the sharded and single-card
scales agree and the raw integer sums match bit for bit.

SGL's shared binary matrix is row-sharded the same way, and its clean
chain and edge-dropout views run the dense product over the shard
(`sharded_dense_dual`), the dropped edges' corrections replicated.

The resident chain declines under a model axis wider than 1
(`propagate.supports_chain_t`), so a quantized LightGCN runs one
sharded dual an application.

The gather backend splits its edges instead (`maybe_sharded_spmm`):
rank k takes the contiguous chunk [k·E/n, (k+1)·E/n) of the row-sorted,
padded edge list, segment-sums it into the full row space, and one
all-reduce adds the chunks; the backward does the same on the
pre-sorted transpose arrays. The edge arrays stay whole on every rank.
"""

from __future__ import annotations

import functools

import torch

from idgrec_torch.ops import fusedmm
from idgrec_torch.ops import propagate as prop
from idgrec_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    get_active_mesh,
    model_width,
)


def row_multiple(width: int, multiple: int) -> int:
    """The row padding of a matrix sharded over ``width`` ranks: its own
    ``multiple`` and 64 rows a shard (the row chunk of K6, K7 and K8);
    both powers of two, so the larger."""
    return max(multiple, 64 * width)


# ---------------------------------------------------------------------------
# the per-shard products


def shard_route(adj, d: int) -> str:
    """The product a rank runs on its shard of ``adj`` at width ``d``:
    'k6', 'k7', 'k8' (the kernels), 'int8_f32' or 'exact' (float32
    products), by the single-card route's rule on the shard's shape."""
    if isinstance(adj, prop.FusedSquareAdj):
        return {"none": "k6", "int8": "k7", "int4": "k8"}[adj.quant]
    rows, cols = adj.m.shape
    if adj.quant == "int8":
        return "k7" if fusedmm.kernel_accepts_n(rows, cols, d, "int8") else "int8_f32"
    return _dense_route(rows, cols, d, adj.compute_dtype_name)


def _dense_route(rows: int, cols: int, d: int, dtype_name: str) -> str:
    """`propagate._dense_dual`'s rule on a shard [rows, cols]: 'k6' or
    'exact'."""
    if dtype_name == "bfloat16" and fusedmm.kernel_accepts_n(rows, cols, d, "bf16"):
        return "k6"
    return "exact"


def shard_dual(route: str, m_k: torch.Tensor, zu_k: torch.Tensor, zi: torch.Tensor,
               dtype: torch.dtype = torch.float32, plan: fusedmm.DualPlan | None = None):
    """(M_k @ zi, M_kᵀ @ zu_k): the rank's [U_pad/n, d] rows of yu and its
    [I_pad, d] partial of yi, float32, by ``route`` (`shard_route`).
    zu_k [U_pad/n, d] and zi [I_pad, d] are float activations ('k6',
    'exact' rounds them to ``dtype``) or int8 ('k7', 'k8', 'int8_f32',
    whose results are the raw integer sums). K6, K7 and K8 walk ``plan``,
    M_k's (K8's: of the unpacked shard), where given. Not differentiable."""
    if route == "k6":
        return fusedmm.fused_adj_matmul(m_k, zu_k, zi, plan)
    if route == "k7":
        return fusedmm.fused_adj_matmul_int8(m_k, zu_k, zi, plan)
    if route == "k8":
        return fusedmm.fused_adj_matmul_int4(m_k, zu_k, zi, plan)
    if route == "int8_f32":
        return fusedmm.dual_matmul_f32(m_k, zu_k, zi)
    if route == "exact":
        return fusedmm.dual_matmul_f32(m_k, zu_k.to(dtype), zi.to(dtype))
    raise ValueError(f"unknown shard route {route!r}")


def _sharded(route: str, dtype: torch.dtype, mesh: Mesh, m_k: torch.Tensor,
             a_users: torch.Tensor, a_items: torch.Tensor,
             plan: fusedmm.DualPlan | None = None):
    """(M @ a_items, Mᵀ @ a_users), whole on every rank of the model
    group: the rank's shard product (on M_k's ``plan``) between one
    all-gather (yu) and one all-reduce (yi)."""
    r = m_k.shape[0]
    lo = mesh.model_index * r
    yu_k, yi_part = shard_dual(route, m_k, a_users[lo: lo + r], a_items, dtype, plan)
    return (all_gather_rows(yu_k, mesh.model_group, mesh.model),
            all_reduce_sum(yi_part, mesh.model_group, mesh.model))


def _exact(sharded, m, zi, zu):
    return sharded(m, zu, zi)


def sharded_square_matmul(adj, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    """Â @ x with ``adj``'s matrix row-sharded over its mesh's model axis
    (``adj.shard``): the scales, gate and diag of the single-card
    ``matmul``, the same result to float32 round-off (quantized: the same
    raw integer sums). Differentiable in ``x``."""
    mesh = adj.shard
    nu, ni = adj.num_users, adj.num_items
    u_pad, i_pad = adj.padded_shape
    right_u, right_i, left_u, left_i = prop._gated(adj, gate)
    zu = prop._pad_rows(right_u[:, None] * x[:nu].to(torch.float32), u_pad)
    zi = prop._pad_rows(right_i[:, None] * x[nu:].to(torch.float32), i_pad)
    m_k = adj.m8 if isinstance(adj, prop.FusedSquareAdj) else adj.m
    route = shard_route(adj, x.shape[1])
    dtype = prop._DTYPES.get(getattr(adj, "compute_dtype_name", "bfloat16"), torch.bfloat16)
    sharded = functools.partial(_sharded, route, dtype, mesh, plan=adj.plan)
    if route in ("k7", "k8", "int8_f32"):
        impl = functools.partial(prop._quant_impl, sharded)
    else:
        impl = functools.partial(_exact, sharded)
    yu, yi = prop._SwappedDual.apply(impl, m_k, zi, zu)
    return prop._finish(adj, x, left_u[:, None] * yu[:nu], left_i[:, None] * yi[:ni])


def sharded_dense_dual(mesh: Mesh, m_k: torch.Tensor, zu: torch.Tensor, zi: torch.Tensor,
                       dtype_name: str, plan: fusedmm.DualPlan | None = None):
    """`propagate._dense_dual` with ``m_k`` this rank's row shard of the
    matrix (``plan`` its plan): (M @ zi [U, d], Mᵀ @ zu [I, d]) float32,
    whole on every rank of the model group, differentiable in zu and zi.
    SGL's shared chain and its edge-dropout views run it over the shard
    of their binary matrix."""
    rows, cols = m_k.shape
    route = _dense_route(rows, cols, zu.shape[1], dtype_name)
    sharded = functools.partial(_sharded, route, prop._DTYPES[dtype_name], mesh, plan=plan)
    yu, yi = prop._SwappedDual.apply(functools.partial(_exact, sharded), m_k,
                                     prop._pad_rows(zi, cols), prop._pad_rows(zu, rows * mesh.model))
    return yu[: zu.shape[0]], yi[: zi.shape[0]]


# ---------------------------------------------------------------------------
# the gather backend by edge chunks


def can_shard_edges(nnz_padded: int, mesh: Mesh | None) -> bool:
    n = model_width(mesh)
    return n > 1 and nnz_padded % n == 0


def _chunk_spmm(row_counts: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's edge chunk segment-summed into the full row space
    (float32), then summed over the model group."""
    e = cols.shape[0] // mesh.model
    lo, hi = mesh.model_index * e, (mesh.model_index + 1) * e
    ends = torch.cumsum(row_counts, 0)
    starts = ends - row_counts
    counts = ends.clamp(lo, hi) - starts.clamp(lo, hi)
    weighted = x.index_select(0, cols[lo:hi]).to(torch.float32) * vals[lo:hi, None]
    part = torch.segment_reduce(weighted, "sum", lengths=counts, unsafe=True)
    return all_reduce_sum(part, mesh.model_group, mesh.model)


class _ShardedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, mesh):
        ctx.graph, ctx.mesh = graph, mesh
        return _chunk_spmm(graph.row_counts, graph.cols, graph.vals, x, mesh).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        dx = _chunk_spmm(graph.t_row_counts, graph.t_cols, graph.t_vals, g.contiguous(), ctx.mesh)
        return dx.to(g.dtype), None, None


def maybe_sharded_spmm(graph, x: torch.Tensor) -> torch.Tensor | None:
    """``graph @ x`` by edge chunks over the active mesh's model axis, or
    None where no model axis wider than 1 is active or the padded edge
    count does not divide it (the caller then runs one card's product).
    Square and rectangular graphs; the padding entries (value 0, at the
    last row and column) add nothing."""
    mesh = get_active_mesh()
    if mesh is None or not can_shard_edges(graph.cols.shape[0], mesh):
        return None
    return _ShardedSpmm.apply(x, graph, mesh)
