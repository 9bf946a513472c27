"""Bit-packed binary adjacency products (kernel K11; counterpart of
idgrec_tpu/ops/bitmm.py).

With M the binary interaction matrix (each (user, item) pair listed
once), both propagation directions of the square adjacency are

    yu = M  @ xi        [U, d]
    yi = Mᵀ @ xu        [I, d]

Each direction runs over its own row-wise packing (M and Mᵀ packed
apart, 2 · U · I / 8 bytes together): `pack_rows` stores bit k of byte
[g, c] as M[8g + k, c], rows padded to `BU`, columns to `BI`, the bytes
of the JAX package's `pack_rows` exactly. `bit_matmul` is the wrapper of
the hand-written Hopper kernel ``csrc/bit_matmul.cu`` (K11): the bits
times bfloat16 activations, float32 sums, rows in natural order (the JAX
package's row-group layout is a TPU sublane convenience and has no
counterpart here). `bit_matmul_plain` is its plain version.

`bit_adj_matmul` applies both directions and is differentiable in the
activations: its backward is the same function on the swapped
cotangents, (dxu, dxi) = (M @ g_yi, Mᵀ @ g_yu), so both packings stay
resident. The activations enter as bfloat16 whatever their type, and so
do the cotangents on the way back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import _build
from idgrec_torch.ops.fusedmm import _aligned, _check_operand, _round_up

BU = 1024  # row padding multiple of a packing (128 packed rows)
BI = 512   # column padding multiple

_K11 = "bit_matmul"
# K11's block covers 128 rows and stages 128 columns at a time
_ROW_TILE, _COL_TILE = 128, 128
# rows of the unpacked matrix the plain version converts at a time
_PLAIN_ROWS = 4096


def pack_rows(m: torch.Tensor) -> torch.Tensor:
    """Pack a binary matrix [R, C] (any type; non-zero is a one) row-wise
    into int8 [R_pad / 8, C_pad], on its device: bit k of packed[g, c] is
    m[8g + k, c]. Padding rows and columns are zero."""
    r, c = m.shape
    r_pad, c_pad = _round_up(r, BU), _round_up(c, BI)
    bits = torch.zeros((r_pad, c_pad), dtype=torch.uint8, device=m.device)
    bits[:r, :c] = m != 0
    planes = bits.view(r_pad // 8, 8, c_pad)
    packed = planes[:, 0].clone()
    for k in range(1, 8):
        packed |= planes[:, k] << k
    return packed.view(torch.int8)


def pack_pair(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pack_rows(M), pack_rows(Mᵀ)): the two operands of `bit_adj_matmul`."""
    return pack_rows(m), pack_rows(m.T)


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_rows`: int8 [G, C] -> uint8 ones and zeros
    [8 G, C] (the padded matrix)."""
    g, c = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)[None, :, None]
    return ((packed.view(torch.uint8)[:, None, :] >> shifts) & 1).reshape(8 * g, c)


def bit_matmul_plain(packed: torch.Tensor, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version of K11: unpack(packed) @ x rounded to bfloat16, as
    float32 products (each exact) with float32 sums; rows [n_rows, d].
    The bits are unpacked 4,096 rows at a time to bound the float32
    working set at full scale. On the card TF32 must be off."""
    check_exact_matmul(packed.device)
    c_pad = packed.shape[1]
    xb = F.pad(x.to(torch.bfloat16), (0, 0, 0, c_pad - x.shape[0])).float()
    step = _PLAIN_ROWS // 8
    parts = [unpack_rows(packed[p : p + step]).float() @ xb
             for p in range(0, -(-n_rows // 8), step)]
    return torch.cat(parts)[:n_rows]


@functools.cache
def _k11_lib() -> ctypes.CDLL:
    lib = _build.library(_K11)
    lib.bit_matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.bit_matmul.restype = ctypes.c_int
    return lib


def bit_matmul(packed: torch.Tensor, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """bits(packed) @ x -> float32 [n_rows, d] for packed int8
    [R_pad / 8, C_pad] from `pack_rows` and x [C, d] (C <= C_pad, any
    float type, rounded to bfloat16 and zero-padded here). Not
    differentiable (`bit_adj_matmul` is).

    CPU tensors take the plain version; CUDA tensors launch K11 or raise.
    K11 takes d % 8 == 0, R_pad % 128 == 0 and C_pad % 128 == 0, and gives
    the same bits on every launch (no atomics)."""
    g, c_pad = packed.shape
    if x.dim() != 2 or x.shape[0] > c_pad or not 0 <= n_rows <= 8 * g:
        raise ValueError(f"bit_matmul: x {tuple(x.shape)} and n_rows {n_rows} do not fit "
                         f"packed {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return bit_matmul_plain(packed, x, n_rows)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    r_pad, d = 8 * g, x.shape[1]
    if d <= 0 or d % 8 or r_pad % _ROW_TILE or c_pad % _COL_TILE or r_pad == 0 or c_pad == 0:
        raise ValueError(f"{_K11} takes d % 8 == 0, R_pad % {_ROW_TILE} == 0 and C_pad % "
                         f"{_COL_TILE} == 0; got d={d}, R_pad={r_pad}, C_pad={c_pad}")
    xb = _aligned(F.pad(x.to(torch.bfloat16), (0, 0, 0, c_pad - x.shape[0])))
    _check_operand("packed", packed, torch.int8, (g, c_pad), packed.device)
    _check_operand("x", xb, torch.bfloat16, (c_pad, d), packed.device)
    y = torch.empty((r_pad, d), dtype=torch.float32, device=packed.device)
    lib = _k11_lib()
    code = lib.bit_matmul(packed.data_ptr(), xb.data_ptr(), y.data_ptr(), r_pad, c_pad, d,
                          torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(lib, _K11, code)
    bit_matmul.launches += 1
    return y[:n_rows]


bit_matmul.launches = 0


def _both(packed, packed_t, xu, xi):
    return bit_matmul(packed, xi, xu.shape[0]), bit_matmul(packed_t, xu, xi.shape[0])


class _BitAdjMatmul(torch.autograd.Function):
    """`_both` with the swapped-cotangent backward. Saves only the two
    packings."""

    @staticmethod
    def forward(ctx, packed, packed_t, xu, xi):
        ctx.packed, ctx.packed_t = packed, packed_t
        return _both(packed, packed_t, xu, xi)

    @staticmethod
    def backward(ctx, g_yu, g_yi):
        dxu, dxi = _both(ctx.packed, ctx.packed_t, g_yu, g_yi)
        return None, None, dxu, dxi


def bit_adj_matmul(packed: torch.Tensor, packed_t: torch.Tensor, xu: torch.Tensor,
                   xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ xi, Mᵀ @ xu) for bit-packed binary M: packed = pack_rows(M),
    packed_t = pack_rows(Mᵀ); xu [U, d], xi [I, d] floats (fed to the
    products as bfloat16); returns float32 (yu [U, d], yi [I, d]), two
    K11 launches on the card. Differentiable in xu and xi: the backward
    is the same two products on the swapped cotangents."""
    return _BitAdjMatmul.apply(packed, packed_t, xu, xi)
