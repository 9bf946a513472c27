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

SGL's per-epoch edge-dropout views (`build_dropout_adjacency`) share
the model's binary matrix, or packed pair, made once
(`build_dropout_shared`): a view is the full product less its dropped
edges' share, summed on kernel K4's sorted-segment entry
(`scatter.correction`, each list with its row offsets) in
`DenseDropSquareAdj` (K6), `BitDropSquareAdj` (K11),
`shared_chain_matmul` (the clean chain and the views side by side, one
K6 launch at k·d) and `fused_chain_views_t` (the quantized chains at
k·d, K7 / K8 through `dual_t_route`).

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
from idgrec_torch.ops import _build, bitmm, fusedmm, gathermm, noise, scatter
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


# the raw sums of the transposed dual by quant mode: K1 / K5 in the [d, N]
# layout at the width they take, K7 / K8 on the transposed integers at the
# others (looked up at call time)
_DUALS = {"int8": ("fused_adj_matmul_int8_t", "fused_adj_matmul_int8"),
          "int4": ("fused_adj_matmul_int4_t", "fused_adj_matmul_int4")}


def dual_t_route(m: torch.Tensor, d: int, quant: str) -> str | None:
    """Which kernel gives the raw sums of `quant_fused_dual_t` at width
    ``d`` on the stored matrix ``m``: 't' (K1 or K5, which take d = 64),
    'n' (K7 or K8 on the transposed integers, at any d: a width off 32
    runs on zero-padded features, `fusedmm.padded_features`), or None
    where M's padded shape fits neither. The CPU runs the plain versions,
    which take any width: 't' at d = 64, else 'n'."""
    u_pad, cols = m.shape
    i_pad = 2 * cols if quant == "int4" else cols
    if fusedmm.kernel_accepts(u_pad, i_pad, d, quant):
        return "t"
    if m.device.type == "cpu" or fusedmm.kernel_accepts_n(u_pad, i_pad,
                                                          fusedmm.feature_pad(d), quant):
        return "n"
    return None


def _raw_dual_t(m: torch.Tensor, quT: torch.Tensor, qiT: torch.Tensor, quant: str,
                plan: fusedmm.DualPlan | None = None):
    """(qiT · Mᵀ, quT · M) as float32 raw integer sums, [d, N] layout, on
    the kernel `dual_t_route` names (K7 or K8 walking ``plan``, M's, where
    given); a matrix neither takes raises."""
    d = quT.shape[0]
    route = dual_t_route(m, d, quant)
    t_name, n_name = _DUALS[quant]
    if route == "t":
        return getattr(fusedmm, t_name)(m, quT, qiT)
    if route is None:
        raise ValueError(f"the quantized dual in [d, N] layout: no kernel of the port takes "
                         f"M's padded shape {tuple(m.shape)}")
    yu, yi = getattr(fusedmm, n_name)(m, quT.T.contiguous(), qiT.T.contiguous(), plan)
    return yu.T, yi.T


def _qfdt_impl(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor, quant: str, plan=None):
    qi, si = _quantize_rows(ziT.contiguous())
    qu, su = _quantize_rows(zuT.contiguous())
    yuT, yiT = _raw_dual_t(m, qu, qi, quant, plan)
    return yuT * si, yiT * su


class _QuantFusedDualT(torch.autograd.Function):
    """`_qfdt_impl` with the straight-through fully-quantized backward:
    the same function on the swapped cotangents."""

    @staticmethod
    def forward(ctx, m, ziT, zuT, quant, plan):
        ctx.m, ctx.quant, ctx.plan = m, quant, plan
        return _qfdt_impl(m, ziT, zuT, quant, plan)

    @staticmethod
    def backward(ctx, g_yuT, g_yiT):
        dzuT, dziT = _qfdt_impl(ctx.m, g_yiT, g_yuT, ctx.quant, ctx.plan)
        return None, dziT, dzuT, None, None


def quant_fused_dual_t(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor,
                       quant: str = "int8", plan: fusedmm.DualPlan | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ q8(zi), Mᵀ @ q8(zu)) in transposed layout: ziT [d, I_pad],
    zuT [d, U_pad] -> (yuT [d, U_pad], yiT [d, I_pad]) f32, with the
    straight-through quantized backward. ``quant`` 'int4' takes the
    nibble-packed matrix [U_pad, I_pad // 2] and gives the same values.
    Each row (feature) is quantized on its own (K3), so rows stacked side
    by side (SGL's chains at k·d, `fused_chain_views_t`) give each block
    the bits it gets alone. The raw sums come from K1 / K5 at d = 64 and
    from K7 / K8 on the transposed integers at every other width
    (`dual_t_route`; the same integers in either layout; off 32 on
    zero-padded features). ``plan``: M's `fusedmm.DualPlan` (int4: the
    unpacked matrix's), which K7 and K8 walk."""
    if quant not in _DUALS:
        raise ValueError(f"unknown quant mode {quant!r}")
    return _QuantFusedDualT.apply(m, ziT, zuT, quant, plan)


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


def quant_dual_matmul(m: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor,
                      plan: fusedmm.DualPlan | None = None):
    """(M @ q8(zi), Mᵀ @ q8(zu)) as two plain int8 products, f32 out
    (the dense backend's quantized mode). m int8 [U_pad, I_pad]; zi
    [I_pad, d]; zu [U_pad, d] f32. Differentiable in zi and zu,
    straight-through with a quantized backward. ``plan`` is taken, as
    `quant_fused_dual` takes it, and not needed."""
    # integer operands in float32: exact while every sum stays below 2**24
    return _SwappedDual.apply(functools.partial(_quant_impl, fusedmm.dual_matmul_f32), m, zi, zu)


def quant_fused_dual(m8: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor,
                     plan: fusedmm.DualPlan | None = None):
    """`quant_dual_matmul` through kernel K7: one launch gives both int8
    products, walking ``plan`` (M's `fusedmm.DualPlan`) where given."""
    return _SwappedDual.apply(functools.partial(_quant_impl, functools.partial(_k7, plan)),
                              m8, zi, zu)


def _k7(plan, m8: torch.Tensor, qu: torch.Tensor, qi: torch.Tensor):
    """K7 on ``plan`` (looked up at call time)."""
    return fusedmm.fused_adj_matmul_int8(m8, qu, qi, plan)


def quant_fused_dual4(m4: torch.Tensor, zi: torch.Tensor, zu: torch.Tensor,
                      plan: fusedmm.DualPlan | None = None):
    """int4 twin of `quant_fused_dual` on the nibble-packed matrix
    (kernel K8, walking ``plan``, the unpacked matrix's, where given): the
    same activations and the same values."""
    return _SwappedDual.apply(functools.partial(_quant_impl, functools.partial(_k8, plan)),
                              m4, zi, zu)


def _k8(plan, m4: torch.Tensor, qu: torch.Tensor, qi: torch.Tensor):
    """K8 on ``plan`` (looked up at call time)."""
    return fusedmm.fused_adj_matmul_int4(m4, qu, qi, plan)


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


def _dense_dual(m: torch.Tensor, zu: torch.Tensor, zi: torch.Tensor,
                dtype_name: str, shard=None, plan: fusedmm.DualPlan | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ zi [U, d], Mᵀ @ zu [I, d]) float32 for the exact modes of the
    dense products, by `DenseSquareAdj.runs_kernel`'s rule from the
    shapes: one K6 launch on bfloat16 operands where the kernel takes the
    width (d % 32 == 0), walking ``plan`` (``m``'s) where given, else
    `exact_dual_matmul` (float32, or bfloat16 off the kernel's widths).
    With ``shard`` (a mesh), ``m`` is this rank's row shard, ``plan`` its
    plan, and the product runs sharded over the mesh's model axis
    (`spmm_shard.sharded_dense_dual`)."""
    if shard is not None:
        from idgrec_torch.parallel import spmm_shard

        return spmm_shard.sharded_dense_dual(shard, m, zu, zi, dtype_name, plan)
    u_pad, i_pad = m.shape
    if dtype_name == "bfloat16" and fusedmm.kernel_accepts_n(u_pad, i_pad, zu.shape[1], "bf16"):
        return fusedmm.fused_adj_matmul(m, zu, zi, plan)
    yu, yi = exact_dual_matmul(m, _pad_rows(zi, i_pad), _pad_rows(zu, u_pad), _DTYPES[dtype_name])
    return yu[: zu.shape[0]], yi[: zi.shape[0]]


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
    # the mesh whose model axis ``m`` is row-sharded over (``m`` then holds
    # this rank's rows only; parallel/spmm_shard.py), or None
    shard: object = None
    # ``m``'s plan (`fusedmm.dual_plan`), which K6 and K7 walk, where the
    # products run them (bfloat16 or int8)
    plan: fusedmm.DualPlan | None = None

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def padded_shape(self) -> tuple[int, int]:
        """M's padded [U_pad, I_pad], all shards together."""
        rows, cols = self.m.shape
        return (rows * (1 if self.shard is None else self.shard.model), cols)

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
        `quant_dual_matmul` compute, bit for bit. With ``shard`` set, the
        sharded product over the mesh (`spmm_shard.sharded_square_matmul`)."""
        if self.shard is not None:
            from idgrec_torch.parallel import spmm_shard

            return spmm_shard.sharded_square_matmul(self, x, gate)
        nu, ni = self.num_users, self.num_items
        right_u, right_i, left_u, left_i = _gated(self, gate)
        zi = right_i[:, None] * x[nu:].to(torch.float32)
        zu = right_u[:, None] * x[:nu].to(torch.float32)
        if self.quant == "int8":
            u_pad, i_pad = self.m.shape
            dual = quant_fused_dual if self.runs_kernel(x.shape[1]) else quant_dual_matmul
            yu, yi = dual(self.m, _pad_rows(zi, i_pad), _pad_rows(zu, u_pad), self.plan)
            yu, yi = yu[:nu], yi[:ni]
        else:
            yu, yi = _dense_dual(self.m, zu, zi, self.compute_dtype_name, plan=self.plan)
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
    # the mesh whose model axis ``m8`` is row-sharded over (``m8`` then
    # holds this rank's rows only; parallel/spmm_shard.py), or None
    shard: object = None
    # ``m8``'s plan (`fusedmm.dual_plan`), which K6, K7 and K8 walk (int4:
    # the plan of the unpacked matrix, made before packing)
    plan: fusedmm.DualPlan | None = None

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def padded_shape(self) -> tuple[int, int]:
        """Logical padded [U_pad, I_pad], all shards together: the int4
        matrix is stored at half the column width."""
        u_pad, cols = self.m8.shape
        u_pad *= 1 if self.shard is None else self.shard.model
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
        kernel bodies and library products has no counterpart here). With
        ``shard`` set, the sharded product over the mesh
        (`spmm_shard.sharded_square_matmul`)."""
        if self.shard is not None:
            from idgrec_torch.parallel import spmm_shard

            return spmm_shard.sharded_square_matmul(self, x, gate)
        nu, ni = self.num_users, self.num_items
        right_u, right_i, left_u, left_i = _gated(self, gate)
        zu = right_u[:, None] * x[:nu].to(torch.float32)
        zi = right_i[:, None] * x[nu:].to(torch.float32)
        if self.quant == "int8":
            u_pad, i_pad = self.padded_shape
            yu, yi = quant_fused_dual(self.m8, _pad_rows(zi, i_pad), _pad_rows(zu, u_pad),
                                      self.plan)
            yu, yi = yu[:nu], yi[:ni]
        elif self.quant == "int4":
            u_pad, i_pad = self.padded_shape
            yu, yi = quant_fused_dual4(self.m8, _pad_rows(zi, i_pad), _pad_rows(zu, u_pad),
                                       self.plan)
            yu, yi = yu[:nu], yi[:ni]
        else:
            yu, yi = fusedmm.fused_adj_matmul(self.m8, zu, zi, self.plan)
        return _finish(self, x, left_u[:, None] * yu, left_i[:, None] * yi)



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
# SGL's edge-dropout views over the shared binary matrix


def _drop_corrections(view, zu: torch.Tensor, zi: torch.Tensor):
    """(drop_u [U, d], drop_i [I, d]): the view's dropped edges' share of
    M @ zi and Mᵀ @ zu, summed on K4's sorted-segment entry
    (`scatter.correction`, the lists' row offsets made with the view) from
    the unrounded float32 right-scaled activations, as the JAX package
    sums them. zu [≥ U, d] and zi [≥ I, d] may be views of any strides.
    Each sum's backward runs on the other side's list, the same edges
    sorted the other way."""
    by_user = (view.du_rows, view.du_cols, view.du_ptr)
    by_item = (view.di_rows, view.di_cols, view.di_ptr)
    return (scatter.correction(zi, by_user, by_item, view.num_users),
            scatter.correction(zu, by_item, by_user, view.num_items))


def _view_matmul(view, x: torch.Tensor, gate, full_product) -> torch.Tensor:
    """Â' @ x for an edge-dropout view: ``full_product(zu, zi)`` over the
    full binary matrix on the view's right-scaled activations, the dropped
    edges' share subtracted, the view's left scales."""
    if gate is not None:
        raise ValueError("gates are not supported on a dropout adjacency")
    nu = view.num_users
    zu = view.right_u[:, None] * x[:nu].to(torch.float32)
    zi = view.right_i[:, None] * x[nu:].to(torch.float32)
    yu, yi = full_product(zu, zi)
    drop_u, drop_i = _drop_corrections(view, zu, zi)
    return torch.cat([view.left_u[:, None] * (yu - drop_u),
                      view.left_i[:, None] * (yi - drop_i)], dim=0).to(x.dtype)


@dataclass(frozen=True)
class DropLists:
    """An SGL edge-dropout view apart from any matrix: its scales and its
    dropped edges D (about ``ssl_ratio`` of the edges), Â' = L'·(M − D)·R'
    over the shared binary M. The quantized views route
    (`fused_chain_views_t`) reads this alone; `DenseDropSquareAdj` and
    `BitDropSquareAdj` add the matrix their product runs on."""

    left_u: torch.Tensor   # f32 [U] (the view's degrees ** -1/2, = right_u)
    left_i: torch.Tensor   # f32 [I]
    right_u: torch.Tensor  # f32 [U]
    right_i: torch.Tensor  # f32 [I]
    du_rows: torch.Tensor  # int64 [Dn] the dropped edges' users, sorted (stably)
    du_cols: torch.Tensor  # int64 [Dn] their items
    du_ptr: torch.Tensor   # int64 [U + 1] the offsets of du_rows' users
    di_rows: torch.Tensor  # int64 [Dn] the dropped edges' items, sorted (stably)
    di_cols: torch.Tensor  # int64 [Dn] their users
    di_ptr: torch.Tensor   # int64 [I + 1] the offsets of di_rows' items
    num_users: int
    num_items: int

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)


@dataclass(frozen=True)
class DenseDropSquareAdj(DropLists):
    """SGL's edge-dropout view on the dense backends without a matrix of
    its own: the full product over M_bin, the shared binary matrix (the
    model's own where its counts are binary, `build_dropout_shared`),
    then the dropped edges' share subtracted (`_drop_corrections`, on
    K4). The product runs K6 where `DenseSquareAdj.runs_kernel`'s rule
    says so (`_dense_dual`), else `exact_dual_matmul`."""

    m_bin: torch.Tensor  # int8 [U_pad, I_pad] binary, shared across epochs
    compute_dtype_name: str = "bfloat16"
    # the mesh whose model axis ``m_bin`` is row-sharded over (``m_bin``
    # then holds this rank's rows only), or None
    shard: object = None
    # ``m_bin``'s plan, shared with the model's adjacency and the other
    # views (`shared_plan`), which K6 walks
    plan: fusedmm.DualPlan | None = None

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        """Â' @ x for x [U+I, d]: the full product over M_bin, the dropped
        edges' share subtracted, the view's left scales."""
        return _view_matmul(self, x, gate, lambda zu, zi: _dense_dual(
            self.m_bin, zu, zi, self.compute_dtype_name, self.shard, self.plan))


@dataclass(frozen=True)
class BitDropSquareAdj(DropLists):
    """SGL's edge-dropout view over the shared bit-packed binary matrix:
    the full product one K11 call a direction on the packed pair (the
    model's own, `BitSquareAdj`'s, with its plans), then the dropped
    edges' share subtracted on K4 (`_drop_corrections`)."""

    packed: torch.Tensor
    packed_t: torch.Tensor
    plans: tuple | None = None

    def matmul(self, x: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
        return _view_matmul(self, x, gate, lambda zu, zi: bitmm.bit_adj_matmul(
            self.packed, self.packed_t, zu, zi, self.plans))


def shared_chain_matmul(m_bin: torch.Tensor, chains, xs, compute_dtype: str = "bfloat16",
                        plan: fusedmm.DualPlan | None = None):
    """One application of k chains whose operators all factor over the
    same binary matrix (SGL's clean graph and its edge-dropout views,
    Â_k = diag(L_k)·(M − D_k)·diag(R_k)): the chains' right-scaled inputs
    side by side at k·d, one product over ``m_bin`` (`_dense_dual`: on
    the card one K6 launch at k·d walking ``plan``, ``m_bin``'s),
    then each view's dropped edges subtracted (on K4) and each chain's
    left scales. chains: a `DenseSquareAdj` without a self-loop diag
    whose matrix is ``m_bin``, or `DenseDropSquareAdj` views over it; xs
    their [U+I, d] inputs. Returns [c.matmul(x) for c, x in ...] under
    the dtype rules. Differentiable: the backward is the same launch on
    the swapped cotangents and the corrections' K4 the other way. Where
    the chains' matrix is a row shard (their ``shard``), the product runs
    sharded over its mesh's model axis."""
    nu = chains[0].num_users
    d = xs[0].shape[1]
    zu_blocks = [c.right_u[:, None] * x[:nu].to(torch.float32) for c, x in zip(chains, xs)]
    zi_blocks = [c.right_i[:, None] * x[nu:].to(torch.float32) for c, x in zip(chains, xs)]
    yu_all, yi_all = _dense_dual(m_bin, torch.cat(zu_blocks, dim=1), torch.cat(zi_blocks, dim=1),
                                 compute_dtype, chains[0].shard, plan)
    outs = []
    for k, (c, x) in enumerate(zip(chains, xs)):
        yu = yu_all[:, k * d: (k + 1) * d]
        yi = yi_all[:, k * d: (k + 1) * d]
        if isinstance(c, DropLists):
            drop_u, drop_i = _drop_corrections(c, zu_blocks[k], zi_blocks[k])
            yu, yi = yu - drop_u, yi - drop_i
        outs.append(torch.cat([c.left_u[:, None] * yu, c.left_i[:, None] * yi], dim=0).to(x.dtype))
    return outs


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
    # ``m``'s plan (`fusedmm.dual_plan`), which K6 walks (bfloat16)
    plan: fusedmm.DualPlan | None = None

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
                                              None if transpose else z, self.plan)
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
        yu, yi = fusedmm.fused_adj_matmul(self.m, zu, zi, self.plan)
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
    covers, and no model axis wider than 1 (a sharded matrix, or an
    active mesh: the sharded duals run one application at a time, as in
    the JAX package)."""
    if not isinstance(graph, FusedSquareAdj) or graph.quant not in _DUALS:
        return False
    from idgrec_torch.parallel.mesh import get_active_mesh, model_width

    if graph.shard is not None or model_width(get_active_mesh()) > 1:
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
        yuT, _ = quant_fused_dual_t(adj.m8, ri * hi, ru * hu, adj.quant, adj.plan)
        hu = activation(lu * yuT)

    layers = [(hu, hi)] if (include_layer0 or reduce is None) else []
    for _ in range(num_layers):
        yuT, yiT = quant_fused_dual_t(adj.m8, ri * hi, ru * hu, adj.quant, adj.plan)
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


# The JAX package's allowance for the [n·d, I_pad] accumulator of its
# feature-batched quantized chains (its ``fusedmm.yi_budget``: 11 MiB up
# to a width of 64, 39 MiB above), and its padding of the fused matrix's
# columns (``fusedmm.TI`` or ``PACK_TILE``, ``PANEL`` where the
# single-panel accumulator of ``emb_size`` does not fit 11 MiB). They are
# the reference's rule, kept so that SGL takes its quantized views route
# where the JAX package takes it and three passes where it declines; the
# card has no such limit.
REF_YI_BUDGET = 11 * 1024 * 1024
REF_YI_BUDGET_WIDE = 39 * 1024 * 1024
_REF_PANEL = 4096


def ref_item_pad(num_items: int, emb_size: int, quant: str) -> int:
    """The padded item count of the JAX package's fused matrix
    (``graph.padded_shape[1]``) for ``num_items`` at ``emb_size``."""
    fine = _pad_up(num_items, fusedmm.PACK_TILE if quant == "int4" else fusedmm.TI)
    if quant == "none" or fine * emb_size * 4 <= REF_YI_BUDGET:
        return fine
    return _pad_up(num_items, _REF_PANEL)


def ref_views_fit(graph, n_chains: int, d: int) -> bool:
    """The JAX package's test for its quantized views route at ``n_chains``
    chains of width ``d`` (its ``supports_chain_views_t``):
    I_pad · n_chains · d · 4 <= budget(n_chains · d)."""
    wd = n_chains * d
    budget = REF_YI_BUDGET if wd <= 64 else REF_YI_BUDGET_WIDE
    return ref_item_pad(graph.num_items, d, graph.quant) * wd * 4 <= budget


def supports_chain_views_t(graph, n_chains: int, d: int) -> bool:
    """True when `fused_chain_views_t` applies: `supports_chain_t`'s
    conditions, no self-loop diag, the JAX package's rule (`ref_views_fit`)
    and a kernel that takes M's padded shape (`dual_t_route`: every width
    of the chains side by side, ``n_chains · d``)."""
    if not supports_chain_t(graph) or graph.has_diag or not ref_views_fit(graph, n_chains, d):
        return False
    return dual_t_route(graph.m8, n_chains * d, graph.quant) is not None


def fused_chain_views_t(adj: FusedSquareAdj, view_lists, emb0: torch.Tensor, num_layers: int):
    """SGL's quantized chains (counterpart of the JAX fused_chain_views_t):
    the clean chain and one chain per edge-dropout view, each layer one
    `quant_fused_dual_t` of ``adj.m8`` with the k chains side by side as
    [k·d, N] activations (on the card K7 or K8 at k·d = 192 for SGL's
    three chains at d = 64), then each view's dropped edges subtracted
    (on K4's sorted-segment entry, from the unquantized float32
    right-scaled activations: each [d, N] block passed as its [N, d]
    view, which the entry's wrapper copies, the sums turned back) and every
    chain's left scales; each chain's output is the mean of its layers,
    layer 0 included. ``adj.m8`` must be the binary matrix the views
    factor over (binary counts) and ``adj`` has no self-loop diag.

    view_lists: one tuple a view chain of its adjacency a layer (SGL's
    'ed': one shared across layers; 'rw': one a layer), each carrying its
    scales and drop lists (`DropLists`).
    Returns [clean, view_1, ...] in [N, d] layout; the clean output is
    `fused_chain_t`'s bit for bit. Differentiable in ``emb0``: the
    straight-through backward of `quant_fused_dual_t` at k·d and the
    corrections' K4 the other way."""
    if adj.has_diag:
        raise ValueError("the views route assumes no self-loop diag")
    nu, ni = adj.num_users, adj.num_items
    u_pad, i_pad = adj.padded_shape
    d = emb0.shape[1]
    k = 1 + len(view_lists)
    xT = emb0.to(torch.float32).T
    hus = [_pad_cols(xT[:, :nu], u_pad)] * k
    his = [_pad_cols(xT[:, nu:], i_pad)] * k
    layers = [[(hu, hi)] for hu, hi in zip(hus, his)]
    for layer in range(num_layers):
        chains = [adj] + [vl[layer % len(vl)] for vl in view_lists]
        zu = [_pad_cols(c.right_u, u_pad)[None, :] * hu for c, hu in zip(chains, hus)]
        zi = [_pad_cols(c.right_i, i_pad)[None, :] * hi for c, hi in zip(chains, his)]
        yuT, yiT = quant_fused_dual_t(adj.m8, torch.cat(zi, dim=0), torch.cat(zu, dim=0),
                                      adj.quant, adj.plan)
        hus, his = [], []
        for c, chain in enumerate(chains):
            yu = yuT[c * d: (c + 1) * d]
            yi = yiT[c * d: (c + 1) * d]
            if c > 0:
                drop_u, drop_i = _drop_corrections(chain, zu[c].T, zi[c].T)
                yu = yu - _pad_cols(drop_u.T, u_pad)
                yi = yi - _pad_cols(drop_i.T, i_pad)
            hus.append(_pad_cols(chain.left_u, u_pad)[None, :] * yu)
            his.append(_pad_cols(chain.left_i, i_pad)[None, :] * yi)
        for c in range(k):
            layers[c].append((hus[c], his[c]))
    outs = []
    for chain_layers in layers:
        # the sum in layer order and the division of `fused_chain_t`, so the
        # clean chain keeps its bits
        cu, ci = chain_layers[0]
        for pu, pi in chain_layers[1:]:
            cu = cu + pu
            ci = ci + pi
        n = float(len(chain_layers))
        cu, ci = true_divide(cu, n), true_divide(ci, n)
        outs.append(torch.cat([cu[:, :nu], ci[:, :ni]], dim=1).T.contiguous().to(emb0.dtype))
    return outs


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
    # under an active mesh with a model axis, M is built on the host and
    # only this rank's rows go to the card (parallel/spmm_shard.py); the
    # batch-row product (with_transpose) keeps the whole matrix
    from idgrec_torch.parallel import spmm_shard
    from idgrec_torch.parallel.mesh import get_active_mesh, model_width

    mesh = get_active_mesh()
    width = 1 if with_transpose else model_width(mesh)
    host = dev if width == 1 else torch.device("cpu")
    if backend == "dense":
        m = _count_matrix_int8(data, host, DENSE_COL_PAD)
        m_t = m.T.contiguous() if with_transpose else None
        if width > 1:
            m = _row_shard(m, spmm_shard.row_multiple(width, _PAD), mesh, dev)
        # the plan K6 and K7 walk, where the products run them
        plan = (fusedmm.dual_plan(m) if quant == "int8" or dtype_name == "bfloat16" else None)
        return DenseSquareAdj(m, lu, li, ru, ri, diag_u, diag_i, nu, ni, dtype_name, has_diag,
                              quant, m_t, mesh if width > 1 else None, plan)
    item_mult = fusedmm.PACK_TILE if quant == "int4" else fusedmm.TI
    m8 = fusedmm.pad_matrix(_count_matrix_int8(data, host), item_mult,
                            row_multiple=spmm_shard.row_multiple(width, fusedmm.TU))
    if quant == "int4":
        top = int(m8.max()) if m8.numel() else 0
        if top > fusedmm.NIBBLE_MAX:
            raise ValueError(
                "compute_dtype = int4 requires interaction counts "
                f"<= {fusedmm.NIBBLE_MAX} (got {top}); use int8")
    if width > 1:
        m8 = _row_shard(m8, 1, mesh, dev)
    # the plan K6, K7 and K8 walk; int4's from the unpacked matrix (or its
    # row shard), which packing then frees: only the packed copy stays
    plan = fusedmm.dual_plan(m8)
    if quant == "int4":
        m8 = fusedmm.pack_nibbles(m8)
    return FusedSquareAdj(m8, lu, li, ru, ri, diag_u, diag_i, nu, ni, has_diag, quant,
                          mesh if width > 1 else None, plan)


def _row_shard(m: torch.Tensor, row_multiple: int, mesh, dev: torch.device) -> torch.Tensor:
    """The mesh rank's rows of the host matrix ``m``, its rows first
    zero-padded to ``row_multiple``, on ``dev``."""
    rows = _pad_up(m.shape[0], row_multiple)
    r = rows // mesh.model
    lo = mesh.model_index * r
    part = m[lo: min(lo + r, m.shape[0])]
    return F.pad(part, (0, 0, 0, r - part.shape[0])).to(dev)


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
    plan = fusedmm.dual_plan(m) if quant == "none" and dtype_name == "bfloat16" else None
    return DenseRectAdj(m, left, right, nu, ni, dtype_name, quant, m_t, plan)


# ---------------------------------------------------------------------------
# SGL's per-epoch views: the shared state and the views


def _is_binary(data: Dataset) -> bool:
    return bool(np.all(data.csr_vals == 1))


def build_binary_count_matrix(data: Dataset, device=None) -> torch.Tensor:
    """The binary int8 matrix min(M, 1) [pad(U), pad(I, DENSE_COL_PAD)]
    on ``device``: the shared matrix of the dropout views where the
    model's own matrix is not binary (the reference's augmentation is
    binary)."""
    return _count_matrix_int8(data, resolve_device(device), DENSE_COL_PAD).clamp_(max=1)


def build_dropout_shared(data: Dataset, backend: str = "auto", device=None, graph=None):
    """The state every epoch's views share, made once: for 'dense' and
    'fused' the binary matrix, which is ``graph``'s own where the counts
    are binary and it has the padding K6 takes (`DenseSquareAdj.m`, the
    unpacked `FusedSquareAdj.m8`), so no second copy of M is made, and a
    `build_binary_count_matrix` otherwise; for 'bitpack' (packed,
    packed_t, plans), ``graph``'s own pair and K11 plans where it is a
    `BitSquareAdj`; None for 'gather'. 'auto' resolves with two copies of
    M counted, as the JAX package does, so that the model's adjacency and
    its views never resolve to two backends. Under an active mesh with a
    model axis the binary matrix is this rank's row shard, as the model's
    (``graph``'s own shard where the counts are binary; else built on the
    host and only the rank's rows uploaded), and `build_dropout_adjacency`
    under the same mesh gives views that run sharded over it."""
    dev = resolve_device(device)
    backend = _select_backend(data, backend, dev, copies=2, col_multiple=DENSE_COL_PAD)
    if backend == "bitpack":
        if isinstance(graph, BitSquareAdj):
            return graph.packed, graph.packed_t, graph.plans
        p, pt = bitmm.pack_pair(_count_matrix_int8(data, dev))
        return p, pt, (bitmm.plan_rows(p), bitmm.plan_rows(pt)) if p.is_cuda else None
    if backend in ("dense", "fused"):
        mesh = _shard_mesh()
        own = None
        if getattr(graph, "shard", None) is not mesh:
            pass  # sharded otherwise than the views
        elif isinstance(graph, DenseSquareAdj):
            own = graph.m
        elif isinstance(graph, FusedSquareAdj) and graph.quant != "int4":
            own = graph.m8
        if own is not None and _is_binary(data):
            return own
        if mesh is not None:
            from idgrec_torch.parallel import spmm_shard

            return _row_shard(build_binary_count_matrix(data, torch.device("cpu")),
                              spmm_shard.row_multiple(mesh.model, _PAD), mesh, dev)
        return build_binary_count_matrix(data, dev)
    return None


def shared_plan(shared, graph=None, compute_dtype: str = "bfloat16"):
    """The plan of SGL's shared binary matrix ``shared`` (a
    `build_dropout_shared` matrix), which K6 walks where the views'
    products run in bfloat16 (``compute_dtype`` bfloat16, int8 or int4):
    ``graph``'s own where ``shared`` is its matrix, else made here
    (`fusedmm.dual_plan`), once per model; None where ``shared`` is no
    matrix (bitpack's, or none) or the products run in float32."""
    if not isinstance(shared, torch.Tensor) or _split_quant(compute_dtype)[0] != "bfloat16":
        return None
    if graph is not None and getattr(graph, "plan", None) is not None and (
            shared is getattr(graph, "m", None) or shared is getattr(graph, "m8", None)):
        return graph.plan
    return fusedmm.dual_plan(shared)


def _shard_mesh():
    """The active mesh where its model axis is wider than 1, else None."""
    from idgrec_torch.parallel.mesh import get_active_mesh, model_width

    mesh = get_active_mesh()
    return mesh if model_width(mesh) > 1 else None


def build_dropout_adjacency(data: Dataset, drop_ratio: float, np_rng: np.random.Generator,
                            backend: str = "auto", compute_dtype: str = "bfloat16",
                            shared=None, device=None, plan: fusedmm.DualPlan | None = None):
    """SGL's per-epoch edge-dropout view (reference tools.py:67-92): keep
    ``int(round((1 − drop_ratio) · E))`` of the E edges, renormalized
    symmetrically on the kept degrees. Drawn from the host's ``np_rng``
    in the JAX package's order (one permutation; its tail is dropped),
    so one generator state gives the same view on every backend and in
    both packages.

    'gather' gives a `GatherSquareAdj` of the kept edges
    (`graph.edge_dropout_adjacency`). Elsewhere only the dropped edges
    (sorted stably by user and by item) and the view's scales
    (degree − dropped) ** -1/2 are made and moved to the device, about
    ``drop_ratio`` of the edges, with ``shared`` from
    `build_dropout_shared`: a `BitDropSquareAdj` on its packed pair
    ('bitpack'), or a `DenseDropSquareAdj` on its binary matrix ('dense',
    'fused'; ``shared`` None gives the bare `DropLists`, all the quantized
    views route reads) with ``plan``, the shared matrix's (`shared_plan`).
    The views' products run in bfloat16
    in the quantized modes, as the JAX package builds them."""
    dev = resolve_device(device)
    dtype_name, _ = _split_quant(compute_dtype)
    backend = _select_backend(data, backend, dev, copies=2, col_multiple=DENSE_COL_PAD)
    if backend == "gather":
        return GatherSquareAdj(graph_lib.edge_dropout_adjacency(data, drop_ratio, np_rng,
                                                                device=dev))
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    items = data.col_idx.astype(np.int64)
    nnz = users.size
    dropped = np_rng.permutation(nnz)[int(round((1.0 - drop_ratio) * nnz)):]
    d_users, d_items = users[dropped], items[dropped]
    du = np.diff(data.row_ptr).astype(np.float64) - np.bincount(d_users,
                                                                minlength=data.num_users)
    di = (np.bincount(items, minlength=data.num_items).astype(np.float64)
          - np.bincount(d_items, minlength=data.num_items))

    def by(rows, cols, n_rows):
        # the list sorted by row, and its row offsets (K4's sorted-segment entry)
        order = np.argsort(rows, kind="stable")
        ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_rows))])
        return (torch.from_numpy(rows[order]).to(dev), torch.from_numpy(cols[order]).to(dev),
                torch.from_numpy(ptr.astype(np.int64)).to(dev))

    scale_u, scale_i = _inv_pow_vec(du, 0.5, dev), _inv_pow_vec(di, 0.5, dev)
    fields = (scale_u, scale_i, scale_u, scale_i, *by(d_users, d_items, data.num_users),
              *by(d_items, d_users, data.num_items), data.num_users, data.num_items)
    if backend == "bitpack":
        return BitDropSquareAdj(*fields, *shared)
    if shared is None:
        return DropLists(*fields)
    # `build_dropout_shared` under the same mesh made ``shared`` its row shard
    return DenseDropSquareAdj(*fields, shared, dtype_name, _shard_mesh(), plan)
