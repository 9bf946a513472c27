"""Dual-direction adjacency product in transposed layout (kernels K1, K5).

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int8 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != m.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be a contiguous 16-byte-aligned tensor on {m.device}")
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
