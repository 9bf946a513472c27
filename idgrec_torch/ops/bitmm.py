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
the hand-written Hopper kernel ``csrc/bit_matmul.cu`` (K11): a scan of
the packed row groups that adds the bfloat16-rounded activation row of
each set bit's column into that bit's row (float32 sums, the zero bits
never touched), rows in natural order (the JAX package's row-group
layout is a TPU sublane convenience and has no counterpart here).
`bit_matmul_plain` is its plain version.

`bit_adj_matmul` applies both directions and is differentiable in the
activations: its backward is the same function on the swapped
cotangents, (dxu, dxi) = (M @ g_yi, Mᵀ @ g_yu), so both packings stay
resident. `bit_rect_matmul` is one direction (the rectangular
adjacency's products), its backward one K11 launch on the other
packing. The activations enter as bfloat16 whatever their type, and so
do the cotangents on the way back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import _build
from idgrec_torch.ops.fusedmm import _aligned, _as_float32, _check_operand, _round_up

BU = 1024  # row padding multiple of a packing (128 packed rows)
BI = 512   # column padding multiple

_K11 = "bit_matmul"
# the multiples of R_pad and C_pad K11 takes, and its widest packing (a
# listed entry keeps its column in 24 bits)
_ROW_TILE, _COL_TILE = 128, 128
_MAX_COLS = 2 ** 24
# K11's plan: a stripe is 32 pieces of 16 bytes of a packed row; PLAN_PARTS
# warps take about equal work, a piece costing 1 and a non-zero byte (an
# entry: one row of x loaded and added) _ENTRY_COST
_STRIPE_BYTES = 512
PLAN_PARTS = 6144
_ENTRY_COST = 8
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


def plan_rows(packed: torch.Tensor) -> torch.Tensor:
    """K11's split of ``packed`` [G, C_pad] among its `PLAN_PARTS` warps,
    int32 [PLAN_PARTS + 1 + 2 G] on the packed matrix's device: warp w
    takes stripes plan[w] .. plan[w + 1] - 1, then for each row group g
    the first and the last warp that take its stripes. A stripe is 32
    pieces of 16 bytes of one packed row (the last of a row cut short),
    numbered row by row. The split points make the warps' costs about
    equal: a piece costs 1, a non-zero byte `_ENTRY_COST` more. Any
    non-decreasing split from 0 to the number of stripes gives the same
    sums, so the plan only balances the work; it depends on the bits
    alone and is made once per packed matrix (`BitSquareAdj` keeps one a
    direction), with no synchronisation."""
    g, c = packed.shape
    dev = packed.device
    stripes = -(-c // _STRIPE_BYTES)
    nz = F.pad((packed != 0).to(torch.int32), (0, stripes * _STRIPE_BYTES - c))
    last = (c - (stripes - 1) * _STRIPE_BYTES) // 16
    pieces = torch.where(torch.arange(stripes, device=dev) == stripes - 1, last,
                         _STRIPE_BYTES // 16)
    cost = (nz.view(g * stripes, _STRIPE_BYTES).sum(1).to(torch.int64) * _ENTRY_COST
            + pieces.repeat(g))
    end = torch.cumsum(cost, 0)
    targets = torch.arange(PLAN_PARTS + 1, dtype=torch.int64, device=dev) * end[-1:]
    split = torch.searchsorted(end - cost, targets // PLAN_PARTS)  # 0 .. G * stripes
    # the warp whose stripes hold stripe s: the last w with split[w] <= s
    first = torch.arange(g, dtype=torch.int64, device=dev) * stripes
    owners = torch.stack([first, first + stripes - 1], 1).reshape(-1)
    owners = torch.searchsorted(split, owners, right=True) - 1
    return torch.cat([split, owners]).to(torch.int32)


@functools.cache
def _k11_lib() -> ctypes.CDLL:
    lib = _build.library(_K11)
    lib.bit_matmul.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.bit_matmul.restype = ctypes.c_int
    return lib


def bit_matmul(packed: torch.Tensor, x: torch.Tensor, n_rows: int,
               plan: torch.Tensor | None = None) -> torch.Tensor:
    """bits(packed) @ x -> float32 [n_rows, d] for packed int8
    [R_pad / 8, C_pad] from `pack_rows` and x [C, d] (C <= C_pad, any
    float type, rounded to bfloat16; missing rows count as zeros). Not
    differentiable (`bit_adj_matmul` is).

    CPU tensors take the plain version; CUDA tensors launch K11 or raise.
    K11 takes d % 8 == 0, R_pad % 128 == 0, C_pad % 128 == 0 and
    C_pad <= 2**24, rounds float32 x itself (other types are rounded to
    bfloat16 here first), adds each set bit's row of x into its output
    row and nothing for a zero bit, and gives the same bits on every
    launch (no atomics, a fixed order of sums). Its warps split the work
    by ``plan`` (`plan_rows` (packed), made here when not given: pass it
    to save that pass over the bits). Two device launches, no
    synchronisation."""
    g, c_pad = packed.shape
    if x.dim() != 2 or x.shape[0] > c_pad or not 0 <= n_rows <= 8 * g:
        raise ValueError(f"bit_matmul: x {tuple(x.shape)} and n_rows {n_rows} do not fit "
                         f"packed {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return bit_matmul_plain(packed, x, n_rows)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    r_pad, d = 8 * g, x.shape[1]
    if (d <= 0 or d % 8 or r_pad % _ROW_TILE or c_pad % _COL_TILE or r_pad == 0 or c_pad == 0
            or c_pad > _MAX_COLS):
        raise ValueError(f"{_K11} takes d % 8 == 0, R_pad % {_ROW_TILE} == 0, C_pad % "
                         f"{_COL_TILE} == 0 and C_pad <= {_MAX_COLS}; got d={d}, R_pad={r_pad}, "
                         f"C_pad={c_pad}")
    if x.shape[0] == 0:  # every column adds zero
        return torch.zeros((n_rows, d), dtype=torch.float32, device=packed.device)
    x = _aligned(_as_float32(x))
    if plan is None:
        plan = plan_rows(packed)
    _check_operand("packed", packed, torch.int8, (g, c_pad), packed.device)
    _check_operand("x", x, torch.float32, (x.shape[0], d), packed.device)
    parts = plan.shape[0] - 1 - 2 * g if plan.dim() == 1 else 0
    _check_operand("plan", plan, torch.int32, (parts + 1 + 2 * g,), packed.device)
    y = torch.empty((n_rows, d), dtype=torch.float32, device=packed.device)
    rec = torch.empty(2 * parts * 8 * d, dtype=torch.float32, device=packed.device)
    lib = _k11_lib()
    code = lib.bit_matmul(packed.data_ptr(), x.data_ptr(), y.data_ptr(), plan.data_ptr(),
                          rec.data_ptr(), parts, n_rows, x.shape[0], g, c_pad, d,
                          torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check(lib, _K11, code)
    bit_matmul.launches += 1
    return y


bit_matmul.launches = 0


def _both(packed, packed_t, plans, xu, xi):
    return (bit_matmul(packed, xi, xu.shape[0], plans[0]),
            bit_matmul(packed_t, xu, xi.shape[0], plans[1]))


class _BitAdjMatmul(torch.autograd.Function):
    """`_both` with the swapped-cotangent backward. Saves only the two
    packings and their plans."""

    @staticmethod
    def forward(ctx, packed, packed_t, plans, xu, xi):
        ctx.packed, ctx.packed_t, ctx.plans = packed, packed_t, plans
        return _both(packed, packed_t, plans, xu, xi)

    @staticmethod
    def backward(ctx, g_yu, g_yi):
        dxu, dxi = _both(ctx.packed, ctx.packed_t, ctx.plans, g_yu, g_yi)
        return None, None, None, dxu, dxi


def bit_adj_matmul(packed: torch.Tensor, packed_t: torch.Tensor, xu: torch.Tensor,
                   xi: torch.Tensor,
                   plans: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ xi, Mᵀ @ xu) for bit-packed binary M: packed = pack_rows(M),
    packed_t = pack_rows(Mᵀ); xu [U, d], xi [I, d] floats (fed to the
    products as bfloat16); returns float32 (yu [U, d], yi [I, d]), one K11
    call a direction on the card (``plans``: their `plan_rows`, made per
    call when not given). Differentiable in xu and xi: the backward is the
    same two products on the swapped cotangents."""
    return _BitAdjMatmul.apply(packed, packed_t, plans or (None, None), xu, xi)


class _BitRectMatmul(torch.autograd.Function):
    """One `bit_matmul` forward, one on the other packing backward. Saves
    only the packings and their plans."""

    @staticmethod
    def forward(ctx, packed, packed_t, plans, x, n_rows):
        ctx.packed_t, ctx.plan_t, ctx.n_cols = packed_t, plans[1], x.shape[0]
        return bit_matmul(packed, x, n_rows, plans[0])

    @staticmethod
    def backward(ctx, g):
        return None, None, None, bit_matmul(ctx.packed_t, g, ctx.n_cols, ctx.plan_t), None


def bit_rect_matmul(packed: torch.Tensor, packed_t: torch.Tensor, x: torch.Tensor,
                    n_rows: int, plans: tuple | None = None) -> torch.Tensor:
    """bits(packed) @ x -> float32 [n_rows, d], differentiable in x: the
    backward is dx = bits(packed)ᵀ @ g = bits(packed_t) @ g, one K11 call
    on the other packing (x and g fed to the products as bfloat16).
    packed = pack_rows(M) and packed_t = pack_rows(Mᵀ) for the forward
    M @ x, or the two swapped for Mᵀ @ x; ``plans`` are their
    `plan_rows` in the same order, made per call when not given."""
    return _BitRectMatmul.apply(packed, packed_t, plans or (None, None), x, n_rows)
