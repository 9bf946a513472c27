"""Dual-direction adjacency products (kernels K1, K5, K6, K7, K8).

Every application of the square adjacency needs both directions of the
int8 interaction-count matrix M [U_pad, I_pad]. With the activations
stored as [d, N] (the layout the whole quantized chain keeps):

    yuT [d, U_pad] = qiT [d, I_pad] . Mᵀ     (M @ qi)
    yiT [d, I_pad] = quT [d, U_pad] . M      (Mᵀ @ qu)

`fused_adj_matmul_int8_t` is the wrapper of the hand-written Hopper
kernel ``csrc/dual_int8_t.cu``, which reads each tile of M once and
feeds both products from shared memory (counterpart of
idgrec_tpu/ops/fusedmm.py `fused_adj_matmul_int8_t`). It returns the raw
integer products as float32; the caller dequantizes.
`fused_adj_matmul_int8_t_plain` is its plain PyTorch version: the tests
run it on the CPU, and chip_smoke.py holds the kernel to it on the card.

The int4 mode is a storage change only. Counts up to `NIBBLE_MAX` are
packed two to a byte (`pack_nibbles`), the activations stay int8, and
`fused_adj_matmul_int4_t` (kernel ``csrc/dual_int4_t.cu``, K5) returns
the same integer products as K1 on the unpacked matrix, bit for bit,
from half the bytes. `fused_adj_matmul_int4_t_plain` unpacks and runs
K1's plain version.

The per-application product (`FusedSquareAdj.matmul`) keeps the
activations in [N, d] layout. `fused_adj_matmul` is the exact-mode dual,
yu = M @ zi and yi = Mᵀ @ zu on bfloat16 activations with float32
accumulation (kernel ``csrc/dual_bf16.cu``, K6; counterpart of the JAX
`fused_adj_matmul`), differentiable by the swapped-cotangent identity.
`fused_adj_matmul_int8` and `fused_adj_matmul_int4` are the quantized
duals on pre-quantized int8 activations (kernels ``csrc/dual_int8_n.cu``,
K7, and ``csrc/dual_int4_n.cu``, K8); their raw sums equal K1's and K5's
on the transposed activations bit for bit. Each has its ``_plain`` twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import _build

TU = 1024  # row padding multiple of the fused matrix
TI = 512   # column padding multiple of the fused matrix

# int4 mode: counts must fit a nibble with headroom, and the nibble
# layout is granular in tiles of PACK_TILE logical columns
NIBBLE_MAX = 7
PACK_TILE = 2048

_KERNELS = {"int8": "dual_int8_t", "int4": "dual_int4_t"}
# the kernel's geometry (csrc/dual_int8_t.cu): feature rows, columns per
# block, rows per pipeline stage
_FEATURES, _STRIP, _CHUNK = 64, 256, 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                   device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: the type, the shape, on
    ``device``, contiguous and 16-byte aligned."""
    shape = tuple(shape)
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be a contiguous 16-byte-aligned tensor on {device}")


def pad_matrix(m: torch.Tensor, item_multiple: int = TI,
               row_multiple: int = TU) -> torch.Tensor:
    """Zero-pad an int8 [U, I] matrix to tile multiples, on its device."""
    u, i = m.shape
    out = torch.zeros((_round_up(u, row_multiple), _round_up(i, item_multiple)),
                      dtype=torch.int8, device=m.device)
    out[:u, :i] = m
    return out


def pick_row_tile(u_pad: int, default: int = TU) -> int | None:
    """Largest power-of-two row tile (≤ default, ≥ 128) dividing u_pad,
    or None."""
    t = default
    while t >= 128:
        if u_pad % t == 0:
            return t
        t //= 2
    return None


def kernel_accepts(u_pad: int, i_pad: int, d: int, quant: str = "int8") -> bool:
    """Whether the geometry of K1 (``quant`` 'int8') or K5 ('int4')
    covers these logical shapes."""
    col_multiple = PACK_TILE if quant == "int4" else _STRIP
    return (d == _FEATURES and i_pad % col_multiple == 0 and u_pad % _CHUNK == 0
            and u_pad > 0 and i_pad > 0)


def pack_nibbles(m8_padded: torch.Tensor) -> torch.Tensor:
    """int8 [U_pad, I_pad] (values 0..NIBBLE_MAX, I_pad % PACK_TILE == 0)
    -> packed int8 [U_pad, I_pad // 2], on the tensor's device. Within
    each tile of PACK_TILE columns, byte p of the tile holds column p in
    its low nibble and column PACK_TILE // 2 + p in its high nibble (no
    interleave): the layout of the JAX package's `pack_nibbles`, byte
    for byte."""
    u, i = m8_padded.shape
    if m8_padded.dtype != torch.int8 or i % PACK_TILE:
        raise ValueError(f"pack_nibbles takes int8 [U, I] with I % {PACK_TILE} == 0, got "
                         f"{m8_padded.dtype} {tuple(m8_padded.shape)}")
    if m8_padded.numel() and (int(m8_padded.min()) < 0 or int(m8_padded.max()) > NIBBLE_MAX):
        raise ValueError(f"pack_nibbles takes values in 0..{NIBBLE_MAX}")
    t = m8_padded.view(torch.uint8).reshape(u, i // PACK_TILE, 2, PACK_TILE // 2)
    return (t[:, :, 0, :] | (t[:, :, 1, :] << 4)).view(torch.int8).reshape(u, i // 2)


def unpack_nibbles(m4: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_nibbles`: packed int8 [U, I_pad // 2] -> int8
    [U, I_pad]. Unpacks unsigned bytes, so a set top bit smears no
    sign."""
    u = m4.shape[0]
    t = m4.contiguous().view(torch.uint8).reshape(u, -1, PACK_TILE // 2)
    return torch.cat([t & 0xF, t >> 4], dim=-1).view(torch.int8).reshape(u, 2 * m4.shape[1])


def fused_adj_matmul_int8_t_plain(m8: torch.Tensor, quT: torch.Tensor,
                                  qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: the same integer products in float64, which
    is exact for int8 operands (every sum stays far below 2**53), then
    rounded once to float32. M is converted in row blocks to bound the
    float64 working set at full scale."""
    u_pad, i_pad = m8.shape
    qi64 = qiT.to(torch.float64)
    qu64 = quT.to(torch.float64)
    yu = torch.empty((qiT.shape[0], u_pad), dtype=torch.float64, device=m8.device)
    yi = torch.zeros((quT.shape[0], i_pad), dtype=torch.float64, device=m8.device)
    step = 4096
    for r in range(0, u_pad, step):
        blk = m8[r : r + step].to(torch.float64)
        yu[:, r : r + step] = qi64 @ blk.T
        yi += qu64[:, r : r + step] @ blk
    return yu.to(torch.float32), yi.to(torch.float32)


def fused_adj_matmul_int4_t_plain(m4: torch.Tensor, quT: torch.Tensor,
                                  qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: unpack, then K1's plain version."""
    return fused_adj_matmul_int8_t_plain(unpack_nibbles(m4), quT, qiT)


@functools.cache
def _lib(kernel: str) -> ctypes.CDLL:
    lib = _build.library(kernel)
    fn = getattr(lib, kernel)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_dual(quant: str, m: torch.Tensor, quT: torch.Tensor,
                 qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the operands of K1 (``quant`` 'int8') or K5 ('int4') and
    launch it on CUDA tensors. ``m`` is the stored matrix: the packed
    one holds two logical columns a byte."""
    kernel = _KERNELS[quant]
    u_pad, m_cols = m.shape
    i_pad = 2 * m_cols if quant == "int4" else m_cols
    d = quT.shape[0]
    for name, t, shape in (("m", m, (u_pad, m_cols)), ("quT", quT, (d, u_pad)),
                           ("qiT", qiT, (d, i_pad))):
        _check_operand(name, t, torch.int8, shape, m.device)
    if not kernel_accepts(u_pad, i_pad, d, quant):
        raise ValueError(
            f"{kernel} takes d == {_FEATURES}, I_pad % "
            f"{PACK_TILE if quant == 'int4' else _STRIP} == 0 and "
            f"U_pad % {_CHUNK} == 0; got d={d}, U_pad={u_pad}, I_pad={i_pad}")
    yu = torch.zeros((d, u_pad), dtype=torch.int32, device=m.device)
    yi = torch.zeros((d, i_pad), dtype=torch.int32, device=m.device)
    lib = _lib(kernel)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    code = getattr(lib, kernel)(m.data_ptr(), quT.data_ptr(), qiT.data_ptr(), yu.data_ptr(),
                                yi.data_ptr(), u_pad, i_pad, stream)
    _build.check(lib, kernel, code)
    return yu.view(torch.float32), yi.view(torch.float32)


def fused_adj_matmul_int8_t(m8: torch.Tensor, quT: torch.Tensor,
                            qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(yuT [d, U_pad], yiT [d, I_pad]) float32 raw integer products of
    int8 m8 [U_pad, I_pad], quT [d, U_pad], qiT [d, I_pad].

    CPU tensors take the plain version; CUDA tensors launch K1 or
    raise."""
    if m8.device.type == "cpu":
        return fused_adj_matmul_int8_t_plain(m8, quT, qiT)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    out = _launch_dual("int8", m8, quT, qiT)
    fused_adj_matmul_int8_t.launches += 1
    return out


fused_adj_matmul_int8_t.launches = 0


def fused_adj_matmul_int4_t(m4: torch.Tensor, quT: torch.Tensor,
                            qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`fused_adj_matmul_int8_t` on the nibble-packed matrix: m4 int8
    [U_pad, I_pad // 2] in `pack_nibbles` layout, quT int8 [d, U_pad],
    qiT int8 [d, I_pad] -> float32 (yuT [d, U_pad], yiT [d, I_pad]),
    equal to K1's output on `unpack_nibbles(m4)`.

    CPU tensors take the plain version; CUDA tensors launch K5 or
    raise."""
    if m4.device.type == "cpu":
        return fused_adj_matmul_int4_t_plain(m4, quT, qiT)
    if m4.device.type != "cuda":
        raise ValueError(f"unsupported device {m4.device}")
    out = _launch_dual("int4", m4, quT, qiT)
    fused_adj_matmul_int4_t.launches += 1
    return out


fused_adj_matmul_int4_t.launches = 0


# ---------------------------------------------------------------------------
# [N, d] layout: the per-application duals (K6, K7, K8)

_K6 = "dual_bf16"
_N_KERNELS = {"int8": "dual_int8_n", "int4": "dual_int4_n"}
# K6-K8 split d into feature groups of 64 (d % 64 == 0) or 32
_FEATURE_GROUP = 32
# the kernels index rows and columns with int32 and bound a row's sum by 2**30
_MAX_SIDE = 2 ** 23
# rows of M converted to float32 at a time by `dual_matmul_f32`
_F32_ROWS = 4096


def kernel_accepts_n(u_pad: int, i_pad: int, d: int, mode: str = "bf16") -> bool:
    """Whether K6 (``mode`` 'bf16'), K7 ('int8') or K8 ('int4') takes
    these logical shapes: d a multiple of 32 (a d above 64 reads the
    matrix once per group of 64, or of 32 when d % 64 != 0), U_pad a
    multiple of 64, I_pad a multiple of 256 (of `PACK_TILE` for int4)."""
    col_multiple = PACK_TILE if mode == "int4" else _STRIP
    return (d > 0 and d % _FEATURE_GROUP == 0 and 0 < u_pad <= _MAX_SIDE
            and 0 < i_pad <= _MAX_SIDE and u_pad % _CHUNK == 0 and i_pad % col_multiple == 0)


def _require_n(kernel: str, mode: str, u_pad: int, i_pad: int, d: int) -> None:
    if not kernel_accepts_n(u_pad, i_pad, d, mode):
        raise ValueError(
            f"{kernel} takes d % {_FEATURE_GROUP} == 0, U_pad % {_CHUNK} == 0, I_pad % "
            f"{PACK_TILE if mode == 'int4' else _STRIP} == 0 and sides up to {_MAX_SIDE}; got "
            f"d={d}, U_pad={u_pad}, I_pad={i_pad}")


def dual_matmul_f32(m8: torch.Tensor, zu: torch.Tensor,
                    zi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ zi, Mᵀ @ zu) as float32 products with float32 accumulation:
    int8 m8 [U_pad, I_pad], zu [U_pad, d], zi [I_pad, d] of any type
    whose values float32 holds exactly. M is converted in row blocks,
    each block feeding both products, to bound the float32 working set
    at full scale. On the card TF32 must be off. This is the plain
    product of the dense backend and of K6's plain version; with
    integer-valued operands it is exact while every sum stays below
    2**24."""
    check_exact_matmul(m8.device)
    u_pad = m8.shape[0]
    zu32, zi32 = zu.to(torch.float32), zi.to(torch.float32)
    yu_parts, yi = [], None
    for r in range(0, u_pad, _F32_ROWS):
        blk = m8[r : r + _F32_ROWS].to(torch.float32)
        yu_parts.append(blk @ zi32)
        part = blk.T @ zu32[r : r + _F32_ROWS]
        yi = part if yi is None else yi + part
    return torch.cat(yu_parts), yi


def _pad_cast(z: torch.Tensor, rows: int, dtype: torch.dtype) -> torch.Tensor:
    return F.pad(z.to(dtype), (0, 0, 0, rows - z.shape[0]))


def fused_adj_matmul_plain(m8: torch.Tensor, zu: torch.Tensor,
                           zi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `fused_adj_matmul` (K6): the activations rounded
    to bfloat16 and zero-padded to M's shape, multiplied in float32 by
    the counts (both exact in float32), float32 accumulation. Differs
    from K6 in the order of the float32 additions only. Differentiable
    by autograd."""
    u_pad, i_pad = m8.shape
    yu, yi = dual_matmul_f32(m8, _pad_cast(zu, u_pad, torch.bfloat16),
                             _pad_cast(zi, i_pad, torch.bfloat16))
    return yu[: zu.shape[0]], yi[: zi.shape[0]]


@functools.cache
def _k6_lib() -> ctypes.CDLL:
    lib = _build.library(_K6)
    lib.dual_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.dual_bf16.restype = ctypes.c_int
    return lib


def _launch_bf16(m8: torch.Tensor, zu_pad: torch.Tensor,
                 zi_pad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Check K6's operands and launch it: int8 m8 [U_pad, I_pad],
    bfloat16 zu_pad [U_pad, d] and zi_pad [I_pad, d] on the card."""
    u_pad, i_pad = m8.shape
    d = zu_pad.shape[1]
    dev = m8.device
    _check_operand("m8", m8, torch.int8, (u_pad, i_pad), dev)
    _check_operand("zu", zu_pad, torch.bfloat16, (u_pad, d), dev)
    _check_operand("zi", zi_pad, torch.bfloat16, (i_pad, d), dev)
    _require_n(_K6, "bf16", u_pad, i_pad, d)
    # the fixed-point scales of the cross-block sums: (max |zu|, max |zi|)
    amax = torch.stack([zu_pad.abs().amax(), zi_pad.abs().amax()]).to(torch.float32)
    acc = torch.zeros((u_pad + i_pad, d), dtype=torch.int64, device=dev)
    yu = torch.empty((u_pad, d), dtype=torch.float32, device=dev)
    yi = torch.empty((i_pad, d), dtype=torch.float32, device=dev)
    lib = _k6_lib()
    code = lib.dual_bf16(m8.data_ptr(), zu_pad.data_ptr(), zi_pad.data_ptr(), amax.data_ptr(),
                         acc[:u_pad].data_ptr(), acc[u_pad:].data_ptr(), yu.data_ptr(),
                         yi.data_ptr(), u_pad, i_pad, d,
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _K6, code)
    return yu, yi


class _FusedAdjMatmul(torch.autograd.Function):
    """K6 with the swapped-cotangent backward: [[0, M], [Mᵀ, 0]] is
    symmetric, so (dzu, dzi) = (M @ g_yi, Mᵀ @ g_yu) is the same
    function of the cotangents. Saves only M."""

    @staticmethod
    def forward(ctx, m8, zu, zi):
        ctx.m8 = m8
        return _fused_fwd(m8, zu, zi)

    @staticmethod
    def backward(ctx, g_yu, g_yi):
        dzu, dzi = _fused_fwd(ctx.m8, g_yu, g_yi)
        return None, dzu, dzi


def _fused_fwd(m8, zu, zi):
    if m8.device.type == "cpu":
        return fused_adj_matmul_plain(m8, zu, zi)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    u_pad, i_pad = m8.shape
    yu, yi = _launch_bf16(m8, _pad_cast(zu, u_pad, torch.bfloat16).contiguous(),
                          _pad_cast(zi, i_pad, torch.bfloat16).contiguous())
    fused_adj_matmul.launches += 1
    return yu[: zu.shape[0]], yi[: zi.shape[0]]


def fused_adj_matmul(m8: torch.Tensor, zu: torch.Tensor,
                     zi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ zi, Mᵀ @ zu) for int8 m8 [U_pad, I_pad] padded with
    `pad_matrix`; zu [U, d], zi [I, d] floats, rounded to bfloat16 and
    zero-padded here; returns float32 (yu [U, d], yi [I, d]).
    Differentiable in zu and zi: the backward is the same product on the
    swapped cotangents (rounded to bfloat16 like any operand).

    CPU tensors take the plain version; CUDA tensors launch K6 or raise.
    K6 takes d % 32 == 0, U_pad % 64 == 0, I_pad % 256 == 0
    (`kernel_accepts_n`) and gives the same bits on every launch: its
    cross-block sums are integer atomics on fixed-point partials."""
    u_pad, i_pad = m8.shape
    if (zu.dim() != 2 or zi.dim() != 2 or zu.shape[1] != zi.shape[1]
            or zu.shape[0] > u_pad or zi.shape[0] > i_pad):
        raise ValueError(f"fused_adj_matmul: zu {tuple(zu.shape)} and zi {tuple(zi.shape)} do "
                         f"not fit m8 {tuple(m8.shape)}")
    return _FusedAdjMatmul.apply(m8, zu, zi)


fused_adj_matmul.launches = 0


def fused_adj_matmul_int8_plain(m8: torch.Tensor, qu: torch.Tensor,
                                qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: K1's plain version on the transposed
    activations (the integer products do not depend on the layout)."""
    yuT, yiT = fused_adj_matmul_int8_t_plain(m8, qu.T, qi.T)
    return yuT.T.contiguous(), yiT.T.contiguous()


def fused_adj_matmul_int4_plain(m4: torch.Tensor, qu: torch.Tensor,
                                qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: unpack, then K7's plain version."""
    return fused_adj_matmul_int8_plain(unpack_nibbles(m4), qu, qi)


@functools.cache
def _lib_n(kernel: str) -> ctypes.CDLL:
    lib = _build.library(kernel)
    fn = getattr(lib, kernel)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_dual_n(quant: str, m: torch.Tensor, qu: torch.Tensor,
                   qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the operands of K7 (``quant`` 'int8') or K8 ('int4') and
    launch it on CUDA tensors. ``m`` is the stored matrix: the packed
    one holds two logical columns a byte."""
    kernel = _N_KERNELS[quant]
    u_pad, m_cols = m.shape
    i_pad = 2 * m_cols if quant == "int4" else m_cols
    d = qu.shape[1]
    _check_operand("m", m, torch.int8, (u_pad, m_cols), m.device)
    _check_operand("qu", qu, torch.int8, (u_pad, d), m.device)
    _check_operand("qi", qi, torch.int8, (i_pad, d), m.device)
    _require_n(kernel, quant, u_pad, i_pad, d)
    yu = torch.zeros((u_pad, d), dtype=torch.int32, device=m.device)
    yi = torch.zeros((i_pad, d), dtype=torch.int32, device=m.device)
    lib = _lib_n(kernel)
    code = getattr(lib, kernel)(m.data_ptr(), qu.data_ptr(), qi.data_ptr(), yu.data_ptr(),
                                yi.data_ptr(), u_pad, i_pad, d,
                                torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(lib, kernel, code)
    return yu.view(torch.float32), yi.view(torch.float32)


def fused_adj_matmul_int8(m8: torch.Tensor, qu: torch.Tensor,
                          qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M @ qi, Mᵀ @ qu) for int8 m8 [U_pad, I_pad] and pre-quantized
    int8 activations qu [U_pad, d], qi [I_pad, d]: float32 (yu
    [U_pad, d], yi [I_pad, d]) of the raw integer products; the caller
    applies the dequantization scales. Not differentiable
    (`propagate.quant_fused_dual` wraps it).

    The sums are accumulated in int32 and converted to float32 once,
    which is exact while every sum stays below 2**24: a row's or
    column's degree times 127 times its largest count (132,000 entries
    of a binary matrix at the worst).

    CPU tensors take the plain version; CUDA tensors launch K7 or
    raise. K7 takes d % 32 == 0, U_pad % 64 == 0, I_pad % 256 == 0."""
    if m8.device.type == "cpu":
        return fused_adj_matmul_int8_plain(m8, qu, qi)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    out = _launch_dual_n("int8", m8, qu, qi)
    fused_adj_matmul_int8.launches += 1
    return out


fused_adj_matmul_int8.launches = 0


def fused_adj_matmul_int4(m4: torch.Tensor, qu: torch.Tensor,
                          qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`fused_adj_matmul_int8` on the nibble-packed matrix: m4 int8
    [U_pad, I_pad // 2] in `pack_nibbles` layout, qu int8 [U_pad, d], qi
    int8 [I_pad, d] -> float32 (yu [U_pad, d], yi [I_pad, d]), equal to
    K7's output on `unpack_nibbles(m4)`.

    CPU tensors take the plain version; CUDA tensors launch K8 or
    raise. K8 takes d % 32 == 0, U_pad % 64 == 0, I_pad % 2,048 == 0."""
    if m4.device.type == "cpu":
        return fused_adj_matmul_int4_plain(m4, qu, qi)
    if m4.device.type != "cuda":
        raise ValueError(f"unsupported device {m4.device}")
    out = _launch_dual_n("int4", m4, qu, qi)
    fused_adj_matmul_int4.launches += 1
    return out


fused_adj_matmul_int4.launches = 0
