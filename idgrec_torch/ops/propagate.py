"""Graph propagation: the quantized fused backend (the port's counterpart
of idgrec_tpu/ops/propagate.py, int8 only).

Every normalization factors as Â = diag(L) · [[0, M], [Mᵀ, 0]] · diag(R)
with M the integer interaction-count matrix, stored as dense int8
[U_pad, I_pad] on the device. In the quantized mode each application
quantizes the right-scaled activations per feature to int8, runs both
directions of M as int8 products (kernel K1, ops/fusedmm.py) and
dequantizes. Activations live in the transposed [d, N] layout for the
whole chain.

This module holds kernel K3 (`quantize_rows`, csrc/quantize_rows.cu)
beside its plain version, the per-sweep chain `fused_chain_t`, and
`build_adjacency`. Backends and variants the port does not have yet raise
`NotImplementedError` naming their ROADMAP item.
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
from idgrec_torch.ops import _build, fusedmm

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


def _dense_fits(data: Dataset, device: torch.device, copies: int = 1) -> bool:
    """Would `copies` padded int8 count matrices fit in the budget?"""
    budget = dense_budget(device)
    need = _pad_up(data.num_users) * _pad_up(data.num_items) * copies
    if need > budget:
        _logger.info("dense adjacency (%d bytes x%d copies) exceeds budget %d; "
                     "auto backend selects gather", need // copies, copies, budget)
        return False
    return True


# dense matrices are zero-padded to this row/col multiple
_PAD = 128


def _pad_up(x: int, m: int = _PAD) -> int:
    return -(-x // m) * m


def _count_matrix_int8(data: Dataset, device: torch.device) -> torch.Tensor:
    """Int8 interaction-count matrix [pad(U), pad(I)], built on the
    device from the CSR, zero-padded to 128-multiples; counts saturate
    at 127."""
    up, ip = _pad_up(data.num_users), _pad_up(data.num_items)
    m = torch.zeros((up, ip), dtype=torch.int8, device=device)
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    vals = np.minimum(data.csr_vals, 127).astype(np.int8)
    m[torch.from_numpy(users).to(device),
      torch.from_numpy(data.col_idx.astype(np.int64)).to(device)] = torch.from_numpy(vals).to(device)
    return m


def _inv_pow_vec(x: np.ndarray, p: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        graph_lib._inv_pow(x.astype(np.float64), p).astype(np.float32)).to(device)


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


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be a contiguous 16-byte-aligned tensor on {device}")


def quantize_rows(z: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper (see `quantize_rows_plain`). CPU tensors take the
    plain version; CUDA tensors launch csrc/quantize_rows.cu or raise."""
    if z.device.type == "cpu":
        return quantize_rows_plain(z, amax)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    d, n = z.shape
    _check_rows("z", z, torch.float32, (d, n), z.device)
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


def _qfdt_impl(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor):
    qi, si = _quantize_rows(ziT.contiguous())
    qu, su = _quantize_rows(zuT.contiguous())
    yuT, yiT = fusedmm.fused_adj_matmul_int8_t(m, qu, qi)
    return yuT * si, yiT * su


class _QuantFusedDualT(torch.autograd.Function):
    """`_qfdt_impl` with the straight-through fully-quantized backward:
    the same function on the swapped cotangents."""

    @staticmethod
    def forward(ctx, m, ziT, zuT):
        ctx.m = m
        return _qfdt_impl(m, ziT, zuT)

    @staticmethod
    def backward(ctx, g_yuT, g_yiT):
        dzuT, dziT = _qfdt_impl(ctx.m, g_yiT, g_yuT)
        return None, dziT, dzuT


def quant_fused_dual_t(m: torch.Tensor, ziT: torch.Tensor, zuT: torch.Tensor,
                       quant: str = "int8") -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ q8(zi), Mᵀ @ q8(zu)) in transposed layout: ziT [d, I_pad],
    zuT [d, U_pad] -> (yuT [d, U_pad], yiT [d, I_pad]) f32, with the
    straight-through quantized backward."""
    if quant != "int8":
        raise NotImplementedError(f"quant {quant!r}: the int4 kernels are ROADMAP B.B2")
    return _QuantFusedDualT.apply(m, ziT, zuT)


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FusedSquareAdj:
    """Square normalized adjacency over int8 M [U_pad, I_pad], both
    directions from one sweep of M per application (kernel K1)."""

    m8: torch.Tensor       # int8 [U_pad, I_pad] from fusedmm.pad_matrix
    left_u: torch.Tensor   # f32 [U]
    left_i: torch.Tensor   # f32 [I]
    right_u: torch.Tensor  # f32 [U]
    right_i: torch.Tensor  # f32 [I]
    diag_u: torch.Tensor   # f32 [U]
    diag_i: torch.Tensor   # f32 [I]
    num_users: int
    num_items: int
    has_diag: bool = False
    quant: str = "int8"

    @property
    def shape(self) -> tuple[int, int]:
        n = self.num_users + self.num_items
        return (n, n)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return tuple(self.m8.shape)

    @property
    def device(self) -> torch.device:
        return self.m8.device


def supports_chain_t(graph, d: int | None = None) -> bool:
    """True when `fused_chain_t` applies: the quantized fused backend
    with a matrix and width the K1 kernel's geometry covers."""
    if not isinstance(graph, FusedSquareAdj) or graph.quant != "int8":
        return False
    u_pad, i_pad = graph.padded_shape
    if i_pad % fusedmm.TI != 0 or fusedmm.pick_row_tile(u_pad) is None:
        return False
    if d is not None and graph.device.type == "cuda":
        return fusedmm.kernel_accepts(u_pad, i_pad, d)
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
):
    """K applications of Â in transposed [d, N] layout with one layout
    transpose at each end, each application one K1 sweep between two K3
    quantizations, the epilogue in PyTorch (counterpart of the JAX
    fused_chain_t). Differentiable in ``emb0`` by autograd through
    `quant_fused_dual_t`.

    reduce: 'mean' | 'sum' over the layer stack, or None for the
    per-layer list in [N, d] layout. The activation chains, the user
    seeding and the self-loop diag are ROADMAP B.B4."""
    if activation is not None or adj.has_diag:
        raise NotImplementedError("activation and self-loop chains are ROADMAP B.B4")
    nu, ni = adj.num_users, adj.num_items
    u_pad, i_pad = adj.padded_shape
    xT = emb0.to(torch.float32).T
    hu = _pad_cols(xT[:, :nu], u_pad)
    hi = _pad_cols(xT[:, nu:], i_pad)
    ru = _pad_cols(adj.right_u, u_pad)[None, :]
    ri = _pad_cols(adj.right_i, i_pad)[None, :]
    lu = _pad_cols(adj.left_u, u_pad)[None, :]
    li = _pad_cols(adj.left_i, i_pad)[None, :]

    layers = [(hu, hi)] if (include_layer0 or reduce is None) else []
    for _ in range(num_layers):
        yuT, yiT = quant_fused_dual_t(adj.m8, ri * hi, ru * hu, adj.quant)
        # left * (raw * s): the JAX chain's operation order
        hu, hi = lu * yuT, li * yiT
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


def _select_backend(data: Dataset, backend: str, device: torch.device, copies: int = 1) -> str:
    """'auto' picks dense when `copies` int8 count matrices fit in the
    device-memory-derived budget, else gather."""
    if backend == "auto":
        return "dense" if _dense_fits(data, device, copies=copies) else "gather"
    if backend not in ("bitpack", "dense", "fused", "gather"):
        raise ValueError(f"unknown propagation backend {backend!r}")
    return backend


def resolve_backend(data: Dataset, backend: str, copies: int = 1,
                    compute_dtype: str | None = None, device=None) -> str:
    """Public 'auto' resolution: auto-selected dense upgrades to the
    fused backend in any quantized mode, and int4 always does."""
    requested = backend
    backend = _select_backend(data, backend, resolve_device(device), copies=copies)
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
) -> FusedSquareAdj:
    """Normalized square adjacency on ``device`` (default the card).

    Ported: variant 'sym' in compute_dtype 'int8' on the fused backend.
    The matrix is padded to (TU, TI) multiples whatever ``emb_size``:
    the JAX package's wider PANEL padding exists only for its TPU
    panelized kernel."""
    dev = resolve_device(device)
    _, quant = _split_quant(compute_dtype)
    backend = resolve_backend(data, backend, copies=3 if with_transpose else 1,
                              compute_dtype=compute_dtype, device=dev)
    if quant == "none":
        raise NotImplementedError(
            f"compute_dtype = {compute_dtype}: exact-mode propagation "
            "(DenseSquareAdj, GatherSquareAdj) is ROADMAP A.3")
    if quant == "int4":
        raise NotImplementedError("compute_dtype = int4: the nibble-packed kernels are ROADMAP B.B2")
    if backend != "fused":
        raise NotImplementedError(
            f"backend {backend!r} with compute_dtype = int8: only the fused "
            "backend is ported (dense/gather: ROADMAP A.3, bitpack: A.10)")
    if variant != "sym":
        raise NotImplementedError(f"variant {variant!r}: only 'sym' is ported (ROADMAP A.3)")
    if with_transpose:
        logging.getLogger("idgrec_torch").warning(
            "with_transpose (batch-rows partial propagation) is not available "
            "on the quantized fused backend; full-width products will be used")

    du, di = graph_lib._degrees(data)
    nu, ni = data.num_users, data.num_items
    lu, li = _inv_pow_vec(du, 0.5, dev), _inv_pow_vec(di, 0.5, dev)
    zeros_u = torch.zeros(nu, dtype=torch.float32, device=dev)
    zeros_i = torch.zeros(ni, dtype=torch.float32, device=dev)
    m8 = fusedmm.pad_matrix(_count_matrix_int8(data, dev), fusedmm.TI,
                            row_multiple=fusedmm.TU)
    return FusedSquareAdj(m8, lu, li, lu, li, zeros_u, zeros_i, nu, ni, False, quant)
