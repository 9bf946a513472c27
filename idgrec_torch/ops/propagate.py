"""Graph propagation backends (the port's counterpart of
idgrec_tpu/ops/propagate.py).

Every normalization factors as Â = diag(L) · [[0, M], [Mᵀ, 0]] · diag(R)
(plus a self-loop diagonal for the `self` variant) with M the integer
interaction-count matrix. Four backends apply it behind one facade
(``matmul(x, gate=None)``):

* **fused** (`FusedSquareAdj`): M as dense int8 [U_pad, I_pad] on the
  device, both directions from one read of M per application. In the
  exact mode (``quant`` 'none') the activations are rounded to bfloat16
  and accumulated in float32 (kernel K6, ops/fusedmm.py). In the
  quantized modes each application quantizes the right-scaled
  activations per feature to int8, runs both directions as int8 products
  and dequantizes: kernels K7 (int8) and K8 (int4, M nibble-packed as
  [U_pad, I_pad // 2]) per application in [N, d] layout, or K1 and K5 in
  the transposed [d, N] layout that the whole chain keeps
  (`fused_chain_t`, ops/chainmm.py). int4 changes the storage only: its
  results equal int8's bit for bit.
* **dense** (`DenseSquareAdj`): the same int8 M with its columns padded
  to 256, both products of an application, which the JAX package leaves
  to XLA. On bfloat16 and int8 activations the port runs them as the
  fused backend does, through kernel K6 (bfloat16) or K7 (int8) where the
  width allows (`DenseSquareAdj.runs_kernel`: d % 32 == 0); float32, and
  a width the kernels do not take, multiply in float32 by
  `fusedmm.dual_matmul_f32`. With ``with_transpose`` it also stores Mᵀ,
  and `matmul_rows` gives the rows of one application that a batch
  needs as partial products over those rows alone (kernels K12 and K13,
  ops/gathermm.py).
* **bitpack** (`BitSquareAdj`): binary M stored bit-packed, M and Mᵀ
  apart (ops/bitmm.py), one kernel K11 launch per direction on bfloat16
  activations with float32 sums, whatever the compute dtype.
* **gather** (`GatherSquareAdj`): row-sorted COO gather and sorted
  segment sum (ops/spmm.py), for graphs whose dense matrix does not fit,
  and for NGCF's node dropout (`edge_dropout_matmul`: the stored edge
  values dropped out, the transpose's values taken through the graph's
  transpose permutation).

The rectangular R̃ = diag(left) · M · diag(right) [U, I] (EGCF's
alternating mode, LightGCL, CVGA) has `matmul` (R̃ @ xi) and `t_matmul`
(R̃ᵀ @ xu), one direction a call, on three backends
(`build_rect_adjacency`): dense (`DenseRectAdj`, M's columns padded to
256: bfloat16 through K6 with the other side left out, and `matmul_both`,
both directions in one K6 launch; float32 accumulation of float32
operands; or `quant_matmul`'s int8 product with int32 sums), gather
(`GatherRectAdj`) and bitpack (`BitRectAdj`: one K11 launch a
direction).

This module also holds kernel K3 (`quantize_rows`,
csrc/quantize_rows.cu) beside its plain version, and `build_adjacency`.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from idgrec_torch.data import graph as graph_lib
from idgrec_torch.data.dataset import Dataset
from idgrec_torch.device import resolve_device
from idgrec_torch.ops import _build, bitmm, fusedmm, gathermm, noise
from idgrec_torch.ops.spmm import spmm, spmm_transpose

# Dense-backend memory budget: the int8 count matrix (and its copies)
# may use at most this fraction of the device's memory.
DENSE_BUDGET_FRACTION = 0.375

_logger = logging.getLogger("idgrec_torch.propagate")


def device_memory_bytes(device: torch.device) -> int:
    """Total memory of the device: `torch.cuda.mem_get_info` for a card,
    the host's physical memory for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def dense_budget(device: torch.device) -> int:
    return int(device_memory_bytes(device) * DENSE_BUDGET_FRACTION)


def _dense_fits(data: Dataset, device: torch.device, copies: int = 1,
                col_multiple: int | None = None) -> bool:
    """Would `copies` padded int8 count matrices fit in the budget? The
    columns pad to ``col_multiple`` (default `_PAD`), as the matrix that
    would be built does."""
    budget = dense_budget(device)
    need = _pad_up(data.num_users) * _pad_up(data.num_items, col_multiple or _PAD) * copies
    if need > budget:
        _logger.info("dense adjacency (%d bytes x%d copies) exceeds budget %d; "
                     "auto backend selects gather", need // copies, copies, budget)
        return False
    return True


# dense matrices are zero-padded to this row/col multiple
_PAD = 128
# the square dense matrix pads its columns further, to the column strip of
# kernels K6 and K7 (`fusedmm.kernel_accepts_n`), so that its products run
# them at every width d % 32 == 0 (`DenseSquareAdj.runs_kernel`)
DENSE_COL_PAD = 256


def _pad_up(x: int, m: int = _PAD) -> int:
    return -(-x // m) * m


def _count_matrix_int8(data: Dataset, device: torch.device,
                       col_multiple: int = _PAD) -> torch.Tensor:
    """Int8 interaction-count matrix [pad(U), pad(I)], built on the
    device from the CSR, zero-padded to 128-multiples (the columns to
    ``col_multiple``); counts saturate at 127."""
    up, ip = _pad_up(data.num_users), _pad_up(data.num_items, col_multiple)
    m = torch.zeros((up, ip), dtype=torch.int8, device=device)
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    vals = np.minimum(data.csr_vals, 127).astype(np.int8)
    m[torch.from_numpy(users).to(device),
      torch.from_numpy(data.col_idx.astype(np.int64)).to(device)] = torch.from_numpy(vals).to(device)
    return m


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, rows - x.shape[0]))


def _f32_vec(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float64).astype(np.float32)).to(device)


def _inv_pow_vec(x: np.ndarray, p: float, device: torch.device) -> torch.Tensor:
    return _f32_vec(graph_lib._inv_pow(x.astype(np.float64), p), device)


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor, correctly rounded on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal, which
    differs in the last bit from IEEE division (and from XLA's)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# K3: per-feature int8 quantization in [d, N] layout

_K3 = "quantize_rows"


def quantize_rows_plain(z: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: s = where(amax > 0, amax / 127, 1) and
    q = round-half-even(z / s) as int8. z f32 [d, N], amax f32 [d]
    (the per-feature max of |z|). Returns (q, s [d, 1])."""
    s = torch.where(amax > 0.0, true_divide(amax, 127.0), torch.ones_like(amax))[:, None]
    return torch.round(z / s).to(torch.int8), s


@functools.cache
def _k3_lib() -> ctypes.CDLL:
    lib = _build.library(_K3)
    lib.quantize_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.quantize_rows.restype = ctypes.c_int
    return lib


def quantize_rows(z: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper (see `quantize_rows_plain`). CPU tensors take the
    plain version; CUDA tensors launch csrc/quantize_rows.cu or raise."""
    if z.device.type == "cpu":
        return quantize_rows_plain(z, amax)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    d, n = z.shape
    fusedmm._check_operand("z", z, torch.float32, (d, n), z.device)
    if amax.dtype != torch.float32 or tuple(amax.shape) != (d,) or amax.device != z.device:
        raise ValueError(f"amax: expected float32 ({d},) on {z.device}")
    if n % 4:
        raise ValueError(f"quantize_rows takes N % 4 == 0, got N={n}")
    amax = amax.contiguous()
    q = torch.empty((d, n), dtype=torch.int8, device=z.device)
    s = torch.empty((d, 1), dtype=torch.float32, device=z.device)
    lib = _k3_lib()
    code = lib.quantize_rows(z.data_ptr(), amax.data_ptr(), q.data_ptr(), s.data_ptr(), d, n,
                             torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, _K3, code)
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0


def _quantize_rows(zT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (= per-feature in [d, N] layout) symmetric int8
    quantization: (q int8 [d, N], scale f32 [d, 1])."""
    return quantize_rows(zT, zT.abs().amax(dim=1))


_DUALS = {"int8": fusedmm.fused_adj_matmul_int8_t, "int4": fusedmm.fused_adj_matmul_int4_t}


def _qfdt_impl(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor, quant: str):
    qi, si = _quantize_rows(ziT.contiguous())
    qu, su = _quantize_rows(zuT.contiguous())
    yuT, yiT = _DUALS[quant](m, qu, qi)
    return yuT * si, yiT * su


class _QuantFusedDualT(torch.autograd.Function):
    """`_qfdt_impl` with the straight-through fully-quantized backward:
    the same function on the swapped cotangents."""

    @staticmethod
    def forward(ctx, m, ziT, zuT, quant):
        ctx.m, ctx.quant = m, quant
        return _qfdt_impl(m, ziT, zuT, quant)

    @staticmethod
    def backward(ctx, g_yuT, g_yiT):
        dzuT, dziT = _qfdt_impl(ctx.m, g_yiT, g_yuT, ctx.quant)
        return None, dziT, dzuT, None


def quant_fused_dual_t(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor,
                       quant: str = "int8") -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ q8(zi), Mᵀ @ q8(zu)) in transposed layout: ziT [d, I_pad],
    zuT [d, U_pad] -> (yuT [d, U_pad], yiT [d, I_pad]) f32, with the
    straight-through quantized backward. ``quant`` 'int4' takes the
    nibble-packed matrix [U_pad, I_pad // 2] and gives the same values."""
    if quant not in _DUALS:
        raise ValueError(f"unknown quant mode {quant!r}")
    return _QuantFusedDualT.apply(m, ziT, zuT, quant)


# ---------------------------------------------------------------------------
# the per-application duals in [N, d] layout


def _quantize_cols(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column (= per-feature in [N, d] layout) symmetric int8
    quantization, z ≈ q · diag(scale): the transpose of
    `_quantize_rows`, the same scales and the same integers."""
    amax = z.abs().amax(dim=0)
    scale = torch.where(amax > 0.0, true_divide(amax, 127.0), torch.ones_like(amax))
    return torch.round(z / scale).to(torch.int8), scale


def _quant_impl(dual, m: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor):
    """Quantize both sides per feature, run ``dual(m, qu, qi)`` on the
    integers, dequantize each product by its input's scales."""
    qi, si = _quantize_cols(zi)
    qu, su = _quantize_cols(zu)
    yu, yi = dual(m, qu, qi)
    return yu * si, yi * su


def _exact_impl(dtype: torch.dtype, m: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor):
    """(M @ zi, Mᵀ @ zu) on operands rounded to ``dtype``, keeping the
    float32 accumulator's value as the JAX product does
    (`preferred_element_type`): a bfloat16 `torch.matmul` would round
    its result to bfloat16, so the rounded operands are multiplied in
    float32 (exact products, TF32 off)."""
    return fusedmm.dual_matmul_f32(m, zu.to(dtype), zi.to(dtype))


class _SwappedDual(torch.autograd.Function):
    """``impl(m, zi, zu) -> (yu, yi)`` with the backward of a symmetric
    operator: the same function on the swapped cotangents,
    (dzu, dzi) = impl(m, g_yi, g_yu). Straight-through for the quantized
    impls. Saves only the matrix, so no float copy of M outlives a
    call."""

    @staticmethod
    def forward(ctx, impl, m, zi, zu):
        ctx.impl, ctx.m = impl, m
        return impl(m, zi, zu)

    @staticmethod
    def backward(ctx, g_yu, g_yi):
        dzu, dzi = ctx.impl(ctx.m, g_yi, g_yu)
        return None, None, dzi, dzu


def quant_dual_matmul(m: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor):
    """(M @ q8(zi), Mᵀ @ q8(zu)) as two plain int8 products, f32 out
    (the dense backend's quantized mode). m int8 [U_pad, I_pad]; zi
    [I_pad, d]; zu [U_pad, d] f32. Differentiable in zi and zu,
    straight-through with a quantized backward."""
    # integer operands in float32: exact while every sum stays below 2**24
    return _SwappedDual.apply(functools.partial(_quant_impl, fusedmm.dual_matmul_f32), m, zi, zu)


def quant_fused_dual(m8: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor):
    """`quant_dual_matmul` through kernel K7: one read of M feeds both
    int8 products."""
    return _SwappedDual.apply(functools.partial(_quant_impl, fusedmm.fused_adj_matmul_int8),
                              m8, zi, zu)


def quant_fused_dual4(m4: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor):
    """int4 twin of `quant_fused_dual` on the nibble-packed matrix
    (kernel K8): the same activations and the same values."""
    return _SwappedDual.apply(functools.partial(_quant_impl, fusedmm.fused_adj_matmul_int4),
                              m4, zi, zu)


def exact_dual_matmul(m: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor,
                      dtype: torch.dtype):
    """(M @ zi, Mᵀ @ zu) in the exact mode of the dense backend:
    operands rounded to ``dtype`` (bfloat16 or float32), float32 result.
    The backward is the same product on the swapped cotangents, rounded
    to ``dtype`` like any operand."""
    return _SwappedDual.apply(functools.partial(_exact_impl, dtype), m, zi, zu)


def _gated(adj, gate: torch.Tensor | None):
    """(right_u, right_i, left_u, left_i) of ``adj`` with the optional
    per-node multiplicative gate applied on both sides."""
    right_u, right_i, left_u, left_i = adj.right_u, adj.right_i, adj.left_u, adj.left_i
    if gate is not None:
        gu, gi = gate[: adj.num_users], gate[adj.num_users:]
        right_u, right_i = right_u * gu, right_i * gi
        left_u, left_i = left_u * gu, left_i * gi
    return right_u, right_i, left_u, left_i


def _finish(adj, x: torch.Tensor, yu: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """The self-loop diagonal, the concatenation and the cast back."""
    if adj.has_diag:
        xu, xi = x[: adj.num_users], x[adj.num_users:]
        yu = yu + adj.diag_u[:, None] * xu.to(torch.float32)
        yi = yi + adj.diag_i[:, None] * xi.to(torch.float32)
    return torch.cat([yu, yi], dim=0).to(x.dtype)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class DenseSquareAdj:
    """Square normalized adjacency diag(L)·[[0,M],[Mᵀ,0]]·diag(R)
    (+ diag) over the int8 count matrix, both products of an application
    through kernel K6 (bfloat16) or K7 (int8) where `runs_kernel` says
    so, else through `fusedmm.dual_matmul_f32`. With the transposed copy
    ``m_t`` stored, `matmul_rows` computes selected rows of one
    application."""

    m: torch.Tensor        # int8 [pad(U), pad(I, DENSE_COL_PAD)]
    left_u: torch.Tensor   # f32 [U]
    left_i: torch.Tensor   # f32 [I]
    right_u: torch.Tensor  # f32 [U]
    right_i: torch.Tensor  # f32 [I]
    diag_u: torch.Tensor   # f32 [U] (zeros when no self loop)
    diag_i: torch.Tensor   # f32 [I]
    num_users: int
    num_items: int
    compute_dtype_name: str = "bfloat16"
    has_diag: bool = False
    # "int8": both directions quantize the activations per feature and
    # run as int8 products; "none": exact bfloat16 or float32 operands
    quant: str = "none"
    # Mᵀ as its own int8 [pad(I, DENSE_COL_PAD), pad(U)] copy, the operand of the item
    # rows of `matmul_rows`; built with build_adjacency(...,
    # with_transpose=True)
    m_t: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.m.device

    @property
    def supports_rows(self) -> bool:
        return self.m_t is not None

    def matmul_rows(self, x: torch.Tensor, rows_u: torch.Tensor,
                    rows_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Selected rows of Â @ x: (yu[rows_u], yi[rows_i]), each the
        row-gathered partial product over the rows alone (kernels K12
        forward, K13 backward), O(B·N·d) instead of O(U·I·d). Used for the
        last layer of the batch-row losses. The right-scaled activations
        are rounded to the compute dtype's name (bfloat16 in the int8
        mode, which quantizes nothing here, as in the JAX package)."""
        if self.m_t is None:
            raise ValueError("matmul_rows needs the adjacency built with with_transpose=True")
        nu = self.num_users
        cdt = _DTYPES[self.compute_dtype_name]
        xu, xi = x[:nu], x[nu:]
        zi = (self.right_i[:, None] * xi.to(torch.float32)).to(cdt)
        zu = (self.right_u[:, None] * xu.to(torch.float32)).to(cdt)
        yu = self.left_u[rows_u, None] * gathermm.gather_matmul(self.m, rows_u, zi)
        yi = self.left_i[rows_i, None] * gathermm.gather_matmul(self.m_t, rows_i, zu)
        if self.has_diag:
            yu = yu + self.diag_u[rows_u, None] * xu[rows_u].to(torch.float32)
            yi = yi + self.diag_i[rows_i, None] * xi[rows_i].to(torch.float32)
        return yu.to(x.dtype), yi.to(x.dtype)

    def runs_kernel(self, d: int) -> bool:
        """Whether `matmul` at width ``d`` runs a kernel of the port: K6
        (`fusedmm.fused_adj_matmul`) on bfloat16 activations, K7 (through
        `quant_fused_dual`) in the int8 mode, where
        `fusedmm.kernel_accepts_n` takes M's padded shape at ``d``. The
        padding (rows to 128, columns to `DENSE_COL_PAD`) meets the
        kernels' geometry, so within their sides' limit the rule is
        d % 32 == 0. float32 runs none: K6 rounds its operands to
        bfloat16. Where this is False, `fusedmm.dual_matmul_f32` runs
        (`exact_dual_matmul`, `quant_dual_matmul`); where it is True a
        CUDA tensor launches the kernel or raises."""
        if self.quant == "none" and self.compute_dtype_name != "bfloat16":
            return False
        u_pad, i_pad = self.m.shape
        return fusedmm.kernel_accepts_n(u_pad, i_pad, d, "int8" if self.quant == "int8" else "bf16")

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        """Â @ x for x [U+I, d]; optional per-node multiplicative gate
        applied on both sides. On the CPU each route runs its kernel's
        plain version, which computes what `exact_dual_matmul` and
        `quant_dual_matmul` compute, bit for bit."""
        nu, ni = self.num_users, self.num_items
        right_u, right_i, left_u, left_i = _gated(self, gate)
        u_pad, i_pad = self.m.shape
        zi = right_i[:, None] * x[nu:].to(torch.float32)
        zu = right_u[:, None] * x[:nu].to(torch.float32)
        kernel = self.runs_kernel(x.shape[1])
        if kernel and self.quant == "none":
            yu, yi = fusedmm.fused_adj_matmul(self.m, zu, zi)
        else:
            zi, zu = _pad_rows(zi, i_pad), _pad_rows(zu, u_pad)
            if self.quant == "int8":
                dual = quant_fused_dual if kernel else quant_dual_matmul
                yu, yi = dual(self.m, zi, zu)
            else:
                yu, yi = exact_dual_matmul(self.m, zi, zu, _DTYPES[self.compute_dtype_name])
            yu, yi = yu[:nu], yi[:ni]
        return _finish(self, x, left_u[:, None] * yu, left_i[:, None] * yi)


@dataclass(frozen=True)
class GatherSquareAdj:
    """Square normalized adjacency as a sparse graph (ops/spmm.py). With
    ``t_perm`` (`with_edge_dropout`) it also takes `edge_dropout_matmul`,
    the product with the edge values dropped out."""

    graph: graph_lib.SparseGraph
    # `SparseGraph.transpose_permutation` of ``graph``, on its device
    t_perm: torch.Tensor | None = None

    def with_edge_dropout(self) -> "GatherSquareAdj":
        """This adjacency with its transpose permutation built (once, on
        the host), so that `edge_dropout_matmul` runs."""
        return GatherSquareAdj(self.graph, self.graph.transpose_permutation())

    def edge_dropout_matmul(self, x: torch.Tensor, keep: float,
                            generator: torch.Generator) -> torch.Tensor:
        """Â_drop @ x: each stored edge value (padding included, as the
        JAX package draws) kept with probability ``keep``
        (`noise.bernoulli`) and divided by it, the others 0. The backward
        multiplies by Â_dropᵀ, whose values are the dropped values taken
        through ``t_perm``: the JAX package reuses the forward values for
        the transpose of a symmetric graph, where entries (u, i) and
        (i, u) are dropped independently, so its gradient is that of
        another matrix. Nothing is read back to the host."""
        if self.t_perm is None:
            raise ValueError("edge_dropout_matmul needs the adjacency's transpose "
                             "permutation: GatherSquareAdj.with_edge_dropout()")
        g = self.graph
        mask = noise.bernoulli(keep, g.vals.shape, generator)
        vals = torch.where(mask, true_divide(g.vals, keep), 0.0)
        return spmm(g.with_values(vals, vals[self.t_perm]), x)

    @property
    def shape(self) -> tuple[int, int]:
        return self.graph.shape

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        g = self.graph
        if gate is None:
            return spmm(g, x)
        vals = g.vals * gate[g.rows] * gate[g.cols]
        t_vals = vals if g.symmetric else g.t_vals * gate[g.t_rows] * gate[g.t_cols]
        return spmm(g.with_values(vals, t_vals), x)


@dataclass(frozen=True)
class FusedSquareAdj:
    """Square normalized adjacency over int8 M [U_pad, I_pad], both
    directions from one sweep of M per application: kernel K6 in the
    exact mode (``quant`` 'none'), K7 in int8, K8 in int4 (M stored
    nibble-packed); the transposed chain runs K1 and K5."""

    m8: torch.Tensor       # int8 [U_pad, I_pad] from fusedmm.pad_matrix, or packed [U_pad, I_pad // 2]
    left_u: torch.Tensor   # f32 [U]
    left_i: torch.Tensor   # f32 [I]
    right_u: torch.Tensor  # f32 [U]
    right_i: torch.Tensor  # f32 [I]
    diag_u: torch.Tensor   # f32 [U]
    diag_i: torch.Tensor   # f32 [I]
    num_users: int
    num_items: int
    has_diag: bool = False
    quant: str = "none"

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def padded_shape(self) -> tuple[int, int]:
        """Logical padded [U_pad, I_pad]: the int4 matrix is stored at
        half the column width."""
        u_pad, cols = self.m8.shape
        return (u_pad, 2 * cols if self.quant == "int4" else cols)

    @property
    def device(self) -> torch.device:
        return self.m8.device

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        """Â @ x for x [U+I, d], one launch of the mode's kernel;
        optional per-node multiplicative gate applied on both sides. In
        the quantized modes the result equals one layer of the
        transposed chain bit for bit. A width or shape the kernel does
        not take raises ValueError (the TPU's VMEM-driven choice between
        kernel bodies and library products has no counterpart here)."""
        nu, ni = self.num_users, self.num_items
        right_u, right_i, left_u, left_i = _gated(self, gate)
        zu = right_u[:, None] * x[:nu].to(torch.float32)
        zi = right_i[:, None] * x[nu:].to(torch.float32)
        if self.quant in _N_DUALS:
            u_pad, i_pad = self.padded_shape
            yu, yi = _N_DUALS[self.quant](self.m8, _pad_rows(zi, i_pad), _pad_rows(zu, u_pad))
            yu, yi = yu[:nu], yi[:ni]
        else:
            yu, yi = fusedmm.fused_adj_matmul(self.m8, zu, zi)
        return _finish(self, x, left_u[:, None] * yu, left_i[:, None] * yi)


_N_DUALS = {"int8": quant_fused_dual, "int4": quant_fused_dual4}


@dataclass(frozen=True)
class BitSquareAdj:
    """Square normalized adjacency diag(L)·[[0,M],[Mᵀ,0]]·diag(R)
    (+ diag) with binary M stored bit-packed, M and Mᵀ apart; each
    direction is one K11 launch on bfloat16 activations (float32 sums),
    and the backward runs the same launches on the swapped cotangents
    (ops/bitmm.py)."""

    packed: torch.Tensor    # int8 [U_pad / 8, I_pad] = bitmm.pack_rows(M)
    packed_t: torch.Tensor  # int8 [I_pad' / 8, U_pad'] = bitmm.pack_rows(Mᵀ)
    left_u: torch.Tensor    # f32 [U]
    left_i: torch.Tensor    # f32 [I]
    right_u: torch.Tensor   # f32 [U]
    right_i: torch.Tensor   # f32 [I]
    diag_u: torch.Tensor    # f32 [U] (zeros when no self loop)
    diag_i: torch.Tensor    # f32 [I]
    num_users: int
    num_items: int
    has_diag: bool = False
    # K11's split of each packing among its warps (bitmm.plan_rows), made
    # once on the card
    plans: tuple | None = None

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        """Â @ x for x [U+I, d]; optional per-node multiplicative gate
        applied on both sides. K11 takes d % 8 == 0 on the card."""
        nu = self.num_users
        right_u, right_i, left_u, left_i = _gated(self, gate)
        zu = right_u[:, None] * x[:nu].to(torch.float32)
        zi = right_i[:, None] * x[nu:].to(torch.float32)
        yu, yi = bitmm.bit_adj_matmul(self.packed, self.packed_t, zu, zi, self.plans)
        return _finish(self, x, left_u[:, None] * yu, left_i[:, None] * yi)


# ---------------------------------------------------------------------------
# the rectangular adjacency: one direction a product

# rows of M converted to float64 at a time by `int8_matmul_plain`
_F64_ROWS = 4096


def int8_matmul_plain(m: torch.Tensor, q: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Plain version of `int8_matmul`: the int32 sums of (Mᵀ if
    ``transpose`` else M) @ q, computed in float64 over row blocks of M
    (every product and partial sum an integer below 2**53, so exact);
    runs on every device."""
    q64 = q.to(torch.float64)
    parts, y = [], None
    for r in range(0, m.shape[0], _F64_ROWS):
        blk = m[r : r + _F64_ROWS].to(torch.float64)
        if transpose:
            part = blk.T @ q64[r : r + _F64_ROWS]
            y = part if y is None else y + part
        else:
            parts.append(blk @ q64)
    return (y if transpose else torch.cat(parts)).to(torch.int32)


def int8_matmul(m: torch.Tensor, m_t: torch.Tensor | None, q: torch.Tensor,
                transpose: bool = False) -> torch.Tensor:
    """int32 sums of (Mᵀ if ``transpose`` else M) @ q for int8 m [R, C],
    q int8 [C, d] (or [R, d] transposed): the raw product of
    `quant_matmul`, which the JAX package leaves to XLA.

    CPU tensors take the plain version. On the card one `torch._int_mm`
    (cuBLASLt's int8 product, int32 sums) with the matrix row-major as
    its first operand and q column-major as its second, the layout the
    library multiplies without a copy: the transposed product takes
    ``m_t``, Mᵀ stored contiguously. A shape `_int_mm` refuses (d % 8)
    raises."""
    if m.device.type == "cpu":
        return int8_matmul_plain(m, q, transpose)
    a = m_t if transpose else m
    if a is None:
        raise ValueError("the transposed int8 product on the card needs Mᵀ stored (m_t)")
    return torch._int_mm(a, q.T.contiguous().T)


class _RectProduct(torch.autograd.Function):
    """``impl(z, transpose)``, one direction of a fixed linear map, with
    its backward: the opposite direction on the cotangent (straight
    through for the quantized impl). Keeps no activation."""

    @staticmethod
    def forward(ctx, impl, z, transpose):
        ctx.impl, ctx.transpose = impl, transpose
        return impl(z, transpose)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.impl(g, not ctx.transpose), None


def _quant_rect_impl(m: torch.Tensor, m_t: torch.Tensor | None, z: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    q, s = _quantize_cols(z)
    return int8_matmul(m, m_t, q, transpose).to(torch.float32) * s


def _exact_rect_impl(m: torch.Tensor, dtype: torch.dtype, z: torch.Tensor,
                     transpose: bool) -> torch.Tensor:
    z = z.to(dtype)
    yu, yi = fusedmm.dual_matmul_f32(m, z if transpose else None, None if transpose else z)
    return yi if transpose else yu


def quant_matmul(transpose: bool, m: torch.Tensor, z: torch.Tensor,
                 m_t: torch.Tensor | None = None) -> torch.Tensor:
    """(Mᵀ if ``transpose`` else M) @ q8(z), float32: z quantized per
    feature (`_quantize_cols`), the int8 product's int32 sums
    (`int8_matmul`; ``m_t`` is Mᵀ stored, the card's operand of the
    transposed product), dequantized by z's scales. Straight-through
    backward: the opposite direction on the cotangent, also quantized."""
    return _RectProduct.apply(functools.partial(_quant_rect_impl, m, m_t), z, transpose)


def exact_matmul(transpose: bool, m: torch.Tensor, z: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(Mᵀ if ``transpose`` else M) @ z with z rounded to ``dtype``
    (bfloat16 or float32) and the float32 accumulator kept, as the JAX
    product's ``preferred_element_type`` keeps it: one direction of
    `fusedmm.dual_matmul_f32`. The backward is the opposite direction on
    the cotangent, rounded to ``dtype`` like any operand."""
    return _RectProduct.apply(functools.partial(_exact_rect_impl, m, dtype), z, transpose)


@dataclass(frozen=True)
class DenseRectAdj:
    """Rectangular R̃ = diag(left)·M·diag(right) [U, I] over the int8
    count matrix, its columns padded to `DENSE_COL_PAD` as the square
    matrix's are. Where `runs_kernel` says so (bfloat16 operands) each
    direction is one K6 launch with the other side left out
    (`fusedmm.fused_adj_matmul`), and `matmul_both` runs both directions
    in one; float32 runs `exact_matmul` (one side of
    `fusedmm.dual_matmul_f32`) and int8 `quant_matmul`
    (``torch._int_mm`` on the card)."""

    m: torch.Tensor      # int8 [pad(U), pad(I, DENSE_COL_PAD)]
    left: torch.Tensor   # f32 [U]
    right: torch.Tensor  # f32 [I]
    num_users: int
    num_items: int
    compute_dtype_name: str = "bfloat16"
    quant: str = "none"
    # Mᵀ as its own int8 [pad(I, DENSE_COL_PAD), pad(U)] copy in the int8
    # mode: the operand of the transposed product on the card (`int8_matmul`)
    m_t: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_users, self.num_items)

    @property
    def device(self) -> torch.device:
        return self.m.device

    def runs_kernel(self, d: int) -> bool:
        """Whether the products at width ``d`` run K6: bfloat16 operands
        (not float32, which K6 would round, and not the int8 mode) where
        `fusedmm.kernel_accepts_n` takes M's padded shape, so d % 32 == 0
        within the kernel's sides' limit. Where it is True a CUDA tensor
        launches K6 or raises; on the CPU K6's plain version computes
        what `exact_matmul` computes, bit for bit."""
        if self.quant != "none" or self.compute_dtype_name != "bfloat16":
            return False
        u_pad, i_pad = self.m.shape
        return fusedmm.kernel_accepts_n(u_pad, i_pad, d, "bf16")

    def _product(self, z: torch.Tensor, transpose: bool) -> torch.Tensor:
        """One direction on the right- or left-scaled z, rows up to M's
        padded side: (Mᵀ if ``transpose`` else M) @ z with M's padded rows
        on the output side."""
        if self.runs_kernel(z.shape[1]):
            yu, yi = fusedmm.fused_adj_matmul(self.m, z if transpose else None,
                                              None if transpose else z)
            return yi if transpose else yu
        z = _pad_rows(z, self.m.shape[0] if transpose else self.m.shape[1])
        if self.quant == "int8":
            return quant_matmul(transpose, self.m, z, self.m_t)
        return exact_matmul(transpose, self.m, z, _DTYPES[self.compute_dtype_name])

    def matmul(self, xi: torch.Tensor) -> torch.Tensor:
        """R̃ @ xi for xi [I, d] -> [U, d] in xi's type."""
        y = self._product(self.right[:, None] * xi.to(torch.float32), False)
        return (self.left[:, None] * y[: self.num_users]).to(xi.dtype)

    def t_matmul(self, xu: torch.Tensor) -> torch.Tensor:
        """R̃ᵀ @ xu for xu [U, d] -> [I, d] in xu's type."""
        y = self._product(self.left[:, None] * xu.to(torch.float32), True)
        return (self.right[:, None] * y[: self.num_items]).to(xu.dtype)

    def matmul_both(self, xi: torch.Tensor, xu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(R̃ @ xi, R̃ᵀ @ xu) of one width: one K6 launch for both
        directions where `runs_kernel` says so (each side's sums scaled by
        its own input's largest activation, so the bits of `matmul` and
        `t_matmul`), else those two calls."""
        d = xi.shape[1]
        if xu.shape[1] != d or not self.runs_kernel(d):
            return self.matmul(xi), self.t_matmul(xu)
        zi = self.right[:, None] * xi.to(torch.float32)
        zu = self.left[:, None] * xu.to(torch.float32)
        yu, yi = fusedmm.fused_adj_matmul(self.m, zu, zi)
        return (self.left[:, None] * yu).to(xi.dtype), (self.right[:, None] * yi).to(xu.dtype)


@dataclass(frozen=True)
class GatherRectAdj:
    """Rectangular R̃ as a sparse graph [U, I] (ops/spmm.py)."""

    graph: graph_lib.SparseGraph

    @property
    def shape(self) -> tuple[int, int]:
        return self.graph.shape

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def matmul(self, xi: torch.Tensor) -> torch.Tensor:
        return spmm(self.graph, xi)

    def t_matmul(self, xu: torch.Tensor) -> torch.Tensor:
        return spmm_transpose(self.graph, xu)


@dataclass(frozen=True)
class BitRectAdj:
    """Rectangular R̃ = diag(left)·M·diag(right) [U, I] with binary M
    bit-packed, M and Mᵀ apart: each direction one K11 launch on
    bfloat16 activations (float32 sums), its backward one launch on the
    other packing (`bitmm.bit_rect_matmul`)."""

    packed: torch.Tensor    # int8 [U_pad / 8, I_pad] = bitmm.pack_rows(M)
    packed_t: torch.Tensor  # int8 [I_pad' / 8, U_pad'] = bitmm.pack_rows(Mᵀ)
    left: torch.Tensor      # f32 [U]
    right: torch.Tensor     # f32 [I]
    num_users: int
    num_items: int
    # K11's split of each packing among its warps (bitmm.plan_rows), made
    # once on the card
    plans: tuple | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_users, self.num_items)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def matmul(self, xi: torch.Tensor) -> torch.Tensor:
        z = self.right[:, None] * xi.to(torch.float32)
        y = bitmm.bit_rect_matmul(self.packed, self.packed_t, z, self.num_users, self.plans)
        return (self.left[:, None] * y).to(xi.dtype)

    def t_matmul(self, xu: torch.Tensor) -> torch.Tensor:
        z = self.left[:, None] * xu.to(torch.float32)
        plans = self.plans[::-1] if self.plans else None
        y = bitmm.bit_rect_matmul(self.packed_t, self.packed, z, self.num_items, plans)
        return (self.right[:, None] * y).to(xu.dtype)


def supports_chain_t(graph, d: int | None = None) -> bool:
    """True when `fused_chain_t` applies: the quantized fused backend
    with a matrix and width the geometry of K1 (int8) or K5 (int4)
    covers."""
    if not isinstance(graph, FusedSquareAdj) or graph.quant not in _DUALS:
        return False
    u_pad, i_pad = graph.padded_shape
    col_mult = fusedmm.PACK_TILE if graph.quant == "int4" else fusedmm.TI
    if i_pad % col_mult != 0 or fusedmm.pick_row_tile(u_pad) is None:
        return False
    if d is not None and graph.device.type == "cuda":
        return fusedmm.kernel_accepts(u_pad, i_pad, d, graph.quant)
    return True


def _pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x, (0, n - x.shape[-1]))


def fused_chain_t(
    adj: FusedSquareAdj,
    emb0: torch.Tensor,
    num_layers: int,
    include_layer0: bool = True,
    reduce: str | None = "mean",
    activation=None,
    seed_users_from_items: bool = False,
):
    """K applications of Â in transposed [d, N] layout with one layout
    transpose at each end, each application one K1 sweep between two K3
    quantizations, the epilogue in PyTorch (counterpart of the JAX
    fused_chain_t). Differentiable in ``emb0`` by autograd through
    `quant_fused_dual_t`.

    reduce: 'mean' | 'sum' over the layer stack, or None for the
    per-layer list in [N, d] layout. activation: an elementwise function
    applied after each application (EGCF's tanh; the resident chain runs
    it on kernels K9 and K10, ROADMAP B.B4), after the self-loop diag
    when the adjacency has one. seed_users_from_items: EGCF's
    parallel-mode seeding (needs an activation and no diag; emb0's user
    rows must be zero): one dual application first sets
    hu = activation(l_u ⊙ (M @ (r_i ⊙ h_i))) and leaves the items at
    their embeddings."""
    nu, ni = adj.num_users, adj.num_items
    u_pad, i_pad = adj.padded_shape
    xT = emb0.to(torch.float32).T
    hu = _pad_cols(xT[:, :nu], u_pad)
    hi = _pad_cols(xT[:, nu:], i_pad)
    ru = _pad_cols(adj.right_u, u_pad)[None, :]
    ri = _pad_cols(adj.right_i, i_pad)[None, :]
    lu = _pad_cols(adj.left_u, u_pad)[None, :]
    li = _pad_cols(adj.left_i, i_pad)[None, :]
    if adj.has_diag:
        du = _pad_cols(adj.diag_u, u_pad)[None, :]
        di = _pad_cols(adj.diag_i, i_pad)[None, :]

    if seed_users_from_items:
        if activation is None or adj.has_diag:
            raise ValueError("the user seeding needs an activation and no self-loop diag")
        # the user input is zero: it quantizes to zeros (scale 1), and the
        # item direction of this application is dropped
        yuT, _ = quant_fused_dual_t(adj.m8, ri * hi, ru * hu, adj.quant)
        hu = activation(lu * yuT)

    layers = [(hu, hi)] if (include_layer0 or reduce is None) else []
    for _ in range(num_layers):
        yuT, yiT = quant_fused_dual_t(adj.m8, ri * hi, ru * hu, adj.quant)
        # left * (raw * s): the JAX chain's operation order
        nhu, nhi = lu * yuT, li * yiT
        if adj.has_diag:
            nhu = nhu + du * hu
            nhi = nhi + di * hi
        if activation is not None:
            nhu, nhi = activation(nhu), activation(nhi)
        hu, hi = nhu, nhi
        layers.append((hu, hi))

    def _back(pair):
        cu, ci = pair
        return torch.cat([cu[:, :nu], ci[:, :ni]], dim=1).T.contiguous()

    if reduce is None:
        outs = [_back(p) for p in layers]
        return outs if include_layer0 else outs[1:]
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    # summation order ((h0 + h1) + h2) + h3, as the JAX chain
    cu, ci = layers[0]
    for pu, pi in layers[1:]:
        cu = cu + pu
        ci = ci + pi
    if reduce == "mean":
        # divide, not multiply by the reciprocal (inexact for 3 layers)
        n = float(len(layers))
        cu, ci = true_divide(cu, n), true_divide(ci, n)
    return _back((cu, ci)).to(emb0.dtype)


# ---------------------------------------------------------------------------
# backend selection and build_adjacency


def _split_quant(compute_dtype: str) -> tuple[str, str]:
    """('int8'/'int4' policy) -> (matmul dtype for non-quant paths,
    quant mode)."""
    if compute_dtype in ("int8", "int4"):
        return "bfloat16", compute_dtype
    return compute_dtype, "none"


def _select_backend(data: Dataset, backend: str, device: torch.device, copies: int = 1,
                    col_multiple: int | None = None) -> str:
    """'auto' picks dense when `copies` int8 count matrices (columns
    padded to ``col_multiple``) fit in the device-memory-derived budget,
    else gather."""
    if backend == "auto":
        return ("dense" if _dense_fits(data, device, copies=copies, col_multiple=col_multiple)
                else "gather")
    if backend not in ("bitpack", "dense", "fused", "gather"):
        raise ValueError(f"unknown propagation backend {backend!r}")
    return backend


def resolve_backend(data: Dataset, backend: str, copies: int = 1,
                    compute_dtype: str | None = None, device=None) -> str:
    """Public 'auto' resolution of the square adjacency (the budget counts
    its dense matrix's padding, `DENSE_COL_PAD`): auto-selected dense
    upgrades to the fused backend in any quantized mode, and int4 always
    does."""
    requested = backend
    backend = _select_backend(data, backend, resolve_device(device), copies=copies,
                              col_multiple=DENSE_COL_PAD)
    if compute_dtype is not None:
        _, quant = _split_quant(compute_dtype)
        if quant != "none" and backend == "dense" and (requested == "auto" or quant == "int4"):
            backend = "fused"
    return backend


def build_adjacency(
    data: Dataset,
    variant: str = "sym",
    backend: str = "auto",
    alpha: float | None = None,
    beta: float | None = None,
    compute_dtype: str = "bfloat16",
    with_transpose: bool = False,
    emb_size: int | None = None,
    device=None,
):
    """Normalized square adjacency on ``device`` (default the card).

    variant: 'sym', 'self' (A + I) or 'gen' with (alpha, beta).
    backend: 'auto', 'dense', 'fused', 'gather' or 'bitpack' (binary
    counts only). compute_dtype: 'bfloat16' (default) or 'float32', exact
    on dense, fused and gather (bitpack rounds the activations to
    bfloat16 in both); 'int8' on dense or fused, 'int4' on fused.
    with_transpose: on dense, also store Mᵀ so that `matmul_rows` (the
    batch-row partial product) is available, one more int8 copy of the
    matrix.

    The dense matrix pads its rows to 128 and its columns to
    `DENSE_COL_PAD` (the JAX package pads both to 128): the column strip
    of kernels K6 and K7, which its products run.
    The fused matrix is padded to (TU, TI) multiples whatever
    ``emb_size``: the JAX package's wider PANEL padding exists only for
    its TPU panelized kernel. int4 pads the columns to
    `fusedmm.PACK_TILE`, refuses counts above `fusedmm.NIBBLE_MAX` and
    packs the matrix on the device; its rows keep the TU multiple (the
    JAX package pads them to 2,048, a tile preference of its TPU
    kernel), so an int4 and an int8 adjacency differ in stored columns
    only."""
    dev = resolve_device(device)
    dtype_name, quant = _split_quant(compute_dtype)
    if dtype_name not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}: expected one of "
                         f"{sorted(_DTYPES)} or int8, int4")
    backend = resolve_backend(data, backend, copies=3 if with_transpose else 1,
                              compute_dtype=compute_dtype, device=dev)
    if quant != "none":
        if backend not in ("dense", "fused"):
            raise ValueError(f"compute_dtype = {quant} requires the dense or fused backend")
        if backend == "fused" and with_transpose:
            logging.getLogger("idgrec_torch").warning(
                "with_transpose (batch-rows partial propagation) is not available "
                "on the quantized fused backend; full-width products will be used")
    if variant not in ("sym", "self", "gen"):
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "gen" and (alpha is None or beta is None):
        raise ValueError("variant 'gen' needs alpha and beta")

    if backend == "gather":
        if variant == "sym":
            return GatherSquareAdj(graph_lib.normalized_adjacency(data, device=dev))
        if variant == "self":
            return GatherSquareAdj(graph_lib.normalized_adjacency_with_self(data, device=dev))
        return GatherSquareAdj(
            graph_lib.generalized_normalized_adjacency(data, alpha, beta, device=dev))

    du, di = graph_lib._degrees(data)
    nu, ni = data.num_users, data.num_items
    diag_u = torch.zeros(nu, dtype=torch.float32, device=dev)
    diag_i = torch.zeros(ni, dtype=torch.float32, device=dev)
    has_diag = False
    if variant == "sym":
        lu, li = _inv_pow_vec(du, 0.5, dev), _inv_pow_vec(di, 0.5, dev)
        ru, ri = lu, li
    elif variant == "self":
        lu, li = _inv_pow_vec(du + 1.0, 0.5, dev), _inv_pow_vec(di + 1.0, 0.5, dev)
        ru, ri = lu, li
        diag_u, diag_i = _f32_vec(1.0 / (du + 1.0), dev), _f32_vec(1.0 / (di + 1.0), dev)
        has_diag = True
    else:
        lu, li = _inv_pow_vec(du, alpha, dev), _inv_pow_vec(di, alpha, dev)
        ru, ri = _inv_pow_vec(du, beta, dev), _inv_pow_vec(di, beta, dev)

    if backend == "bitpack":
        if not bool(np.all(data.csr_vals == 1)):
            raise ValueError("bitpack backend requires binary interaction counts")
        p, pt = bitmm.pack_pair(_count_matrix_int8(data, dev))
        plans = (bitmm.plan_rows(p), bitmm.plan_rows(pt)) if p.is_cuda else None
        return BitSquareAdj(p, pt, lu, li, ru, ri, diag_u, diag_i, nu, ni, has_diag, plans)
    if backend == "dense":
        m = _count_matrix_int8(data, dev, DENSE_COL_PAD)
        m_t = m.T.contiguous() if with_transpose else None
        return DenseSquareAdj(m, lu, li, ru, ri, diag_u, diag_i, nu, ni, dtype_name, has_diag,
                              quant, m_t)
    item_mult = fusedmm.PACK_TILE if quant == "int4" else fusedmm.TI
    m8 = fusedmm.pad_matrix(_count_matrix_int8(data, dev), item_mult,
                            row_multiple=fusedmm.TU)
    if quant == "int4":
        top = int(m8.max()) if m8.numel() else 0
        if top > fusedmm.NIBBLE_MAX:
            raise ValueError(
                "compute_dtype = int4 requires interaction counts "
                f"<= {fusedmm.NIBBLE_MAX} (got {top}); use int8")
        m8 = fusedmm.pack_nibbles(m8)
    return FusedSquareAdj(m8, lu, li, ru, ri, diag_u, diag_i, nu, ni, has_diag, quant)


def build_rect_adjacency(data: Dataset, backend: str = "auto", compute_dtype: str = "bfloat16",
                         device=None):
    """Rectangular R̃ = Du^-1/2 · R · Di^-1/2 on ``device`` (default the
    card): `DenseRectAdj`, `GatherRectAdj` or `BitRectAdj`.

    backend: 'auto' (dense when the matrix fits the budget, else gather;
    never fused), 'dense', 'gather' or 'bitpack' (binary counts). 'fused'
    raises: no single-sweep kernel exists for the rectangular shape.
    compute_dtype: 'bfloat16' or 'float32' (exact on dense and gather;
    bitpack rounds to bfloat16 in both), or 'int8' on dense; 'int4' runs
    the int8 path (nibble packing is a storage change, and this
    adjacency has no packed kernel). The int8 mode also stores Mᵀ, the
    card's operand of the transposed product."""
    dev = resolve_device(device)
    dtype_name, quant = _split_quant(compute_dtype)
    if dtype_name not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}: expected one of "
                         f"{sorted(_DTYPES)} or int8, int4")
    quant = "int8" if quant == "int4" else quant
    if backend == "fused":
        raise ValueError(
            "backend 'fused' applies to the square adjacency only; "
            "rectangular R̃ supports auto|dense|gather|bitpack"
        )
    backend = _select_backend(data, backend, dev, copies=2 if quant != "none" else 1,
                              col_multiple=DENSE_COL_PAD)
    if quant != "none" and backend != "dense":
        raise ValueError("compute_dtype = int8 requires the dense backend")
    if backend == "gather":
        return GatherRectAdj(graph_lib.normalized_rectangular(data, device=dev))
    du, di = graph_lib._degrees(data)
    left, right = _inv_pow_vec(du, 0.5, dev), _inv_pow_vec(di, 0.5, dev)
    nu, ni = data.num_users, data.num_items
    if backend == "bitpack":
        if not bool(np.all(data.csr_vals == 1)):
            raise ValueError("bitpack backend requires binary interaction counts")
        p, pt = bitmm.pack_pair(_count_matrix_int8(data, dev))
        plans = (bitmm.plan_rows(p), bitmm.plan_rows(pt)) if p.is_cuda else None
        return BitRectAdj(p, pt, left, right, nu, ni, plans)
    m = _count_matrix_int8(data, dev, DENSE_COL_PAD)
    m_t = m.T.contiguous() if quant == "int8" else None
    return DenseRectAdj(m, left, right, nu, ni, dtype_name, quant, m_t)
