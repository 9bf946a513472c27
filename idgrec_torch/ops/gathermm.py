"""Batch-row partial products of the dense adjacency (kernels K12 and
K13; counterpart of idgrec_tpu/ops/gathermm.py).

The batch-row partial propagation (`DenseSquareAdj.matmul_rows`) needs

    forward:   out[b] = M[rows[b]] @ z           [B, d] float32
    backward:  dz     = Σ_b M[rows[b]]ᵀ g[b]      [C, d]

with M the int8 count matrix [R, C] resident on the device and a batch
of a few thousand row ids, repeats allowed. M stays 2-D: a row of it is
one contiguous run of bytes, so the JAX package's 3-D repack (`pack_rows3`,
there only for the TPU's tiling) has no counterpart.

`gather_rows_matmul` (K12, ``csrc/gather_rows_matmul.cu``) and
`gather_rows_matmul_t` (K13, the same source) are the kernel wrappers,
each beside its plain version; z and g are bfloat16 (tensor cores) or
float32 (full float32 arithmetic, no TF32), the sums float32. K12 splits
M's columns among S blocks of 256 batch rows and adds their partial sums
in share order; K13 splits the batch among the S blocks of a 256-column
tile, a thread-block cluster that adds their sums in rank order.
`plan_rows_matmul` chooses S from the shapes and the card alone, so
every launch adds in the same order. `gather_matmul` is the
differentiable product: its backward rounds the cotangent to z's type
first, sums in float32 and returns dz in z's type, as the JAX VJP does.

Row ids must lie in [0, R). The plain versions raise on the CPU (tensor
indexing); the kernels read no flag back to check: an id out of range
reads nothing, its forward row is NaN and it adds nothing backward. K13
skips tiles of zero counts on the bf16 route and both kernels skip each
zero count on the float32 route, so there a non-finite z or g value need
not reach every sum, as it does in the plain versions' dense product.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import _build
from idgrec_torch.ops.fusedmm import _aligned, _check_operand

_K12, _K13 = "gather_rows_matmul", "gather_rows_matmul_t"
_DTYPES = (torch.bfloat16, torch.float32)
# M's columns in multiples of 128
_COL_TILE = 128
# the kernels' geometry (csrc/gather_rows_matmul.cu): K12's batch rows a
# block and columns a bf16 stage (float32: 64); K13's columns a block and
# batch rows a stage; features a block; K13's batch shares (a thread-block
# cluster)
K12_ROWS, K12_COLS, K13_COLS, K13_ROWS, FEATURES = 256, 128, 256, 32, 64
K13_SHARES = (1, 2, 4, 8)


def _check_args(m: torch.Tensor, rows: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """``what`` is "z" (at most C rows) or "g" (one row per row id)."""
    if m.dtype != torch.int8 or m.dim() != 2:
        raise ValueError(f"m: expected int8 [R, C], got {m.dtype} {tuple(m.shape)}")
    if rows.dtype != torch.int64 or rows.dim() != 1:
        raise ValueError(f"rows: expected int64 [B], got {rows.dtype} {tuple(rows.shape)}")
    fits = v.shape[0] <= m.shape[1] if what == "z" else v.shape[0] == rows.shape[0]
    if v.dtype not in _DTYPES or v.dim() != 2 or not fits:
        raise ValueError(f"{what}: expected bfloat16 or float32 [{'<= C' if what == 'z' else 'B'}"
                         f", d], got {v.dtype} {tuple(v.shape)}")
    if not (m.device == rows.device == v.device):
        raise ValueError(f"m, rows and {what} must share a device")


def _check_range(m: torch.Tensor, rows: torch.Tensor) -> None:
    if rows.numel() and bool(((rows < 0) | (rows >= m.shape[0])).any()):
        raise IndexError(f"rows out of range [0, {m.shape[0]})")


def gather_rows_matmul_plain(m: torch.Tensor, rows: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: M[rows, :Z] @ z in float32 (the counts and
    z's values are exact in float32; TF32 off on the card), float32
    [B, d]. z [Z, d] with Z <= C stands for z zero-padded to C rows."""
    _check_args(m, rows, z, "z")
    _check_range(m, rows)
    check_exact_matmul(m.device)
    return m[rows, : z.shape[0]].to(torch.float32) @ z.to(torch.float32)


def gather_rows_matmul_t_plain(m: torch.Tensor, rows: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: M[rows]ᵀ @ g in float32, float32 [C, d];
    repeated rows add up."""
    _check_args(m, rows, g, "g")
    _check_range(m, rows)
    check_exact_matmul(m.device)
    return m[rows].to(torch.float32).T @ g.to(torch.float32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library(_K12)  # K13 shares the source
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_matmul.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.gather_rows_matmul_t.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.gather_rows_blocks_per_sm.argtypes = [i32] * 2 + [ptr]
    lib.gather_rows_matmul.restype = lib.gather_rows_matmul_t.restype = i32
    lib.gather_rows_blocks_per_sm.restype = i32
    return lib


def _check_cuda(kernel: str, m: torch.Tensor, v: torch.Tensor) -> None:
    r, c = m.shape
    d = v.shape[1]
    if d <= 0 or d % 8 or c % _COL_TILE or c == 0 or r >= 2 ** 31:
        raise ValueError(f"{kernel} takes d % 8 == 0 and C % {_COL_TILE} == 0; got d={d}, "
                         f"C={c}")
    _check_operand("m", m, torch.int8, (r, c), m.device)
    _check_operand("z" if kernel == _K12 else "g", v, v.dtype, tuple(v.shape), m.device)


def plan_rows_matmul(batch: int, c: int, d: int, sms: int, per_sm: int,
                     backward: bool = False) -> int:
    """The kernels' split S for ``batch`` rows of a [R, c] matrix and
    width d, on a card of ``sms`` SMs that each hold ``per_sm`` of the
    kernel's blocks. K12 (``backward`` False): a block per 256 batch rows,
    64 features and one of S column shares, S the most whose blocks fit
    in one wave, each share at least one 128-column stage. K13: a block per
    256 columns, 64 features and one of S batch shares (1, 2, 4 or 8, a
    cluster), S the most whose blocks fit in two waves (a second block on
    an SM hides the first's waits: measured, PERF.md), each share at least
    one 32-row stage. S = 1 where even that does not fit. A function of
    its arguments alone, so every launch on the same shapes and card adds
    in the same order."""
    slots = sms * per_sm
    groups = -(-d // FEATURES)
    if backward:
        tiles = -(-c // K13_COLS) * groups
        fits = [s for s in K13_SHARES if tiles * s <= 2 * slots and batch // s >= K13_ROWS]
    else:
        row_blocks = -(-batch // K12_ROWS) * groups
        fits = [min(c // K12_COLS, slots // row_blocks)]
    return max([1, *fits])


@functools.cache
def _blocks_per_sm(device: int, backward: bool, bf16: bool) -> int:
    lib = _lib()
    out = ctypes.c_int(0)
    _build.check(lib, _K13 if backward else _K12,
                 lib.gather_rows_blocks_per_sm(int(backward), int(bf16), ctypes.byref(out)))
    if out.value < 1:
        raise RuntimeError(f"{_K13 if backward else _K12}: no block fits an SM")
    return out.value


@functools.cache
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan(m: torch.Tensor, batch: int, v: torch.Tensor, backward: bool) -> int:
    dev = m.device.index if m.device.index is not None else torch.cuda.current_device()
    sms = _sms(dev)
    per_sm = _blocks_per_sm(dev, backward, v.dtype == torch.bfloat16)
    return plan_rows_matmul(batch, m.shape[1], v.shape[1], sms, per_sm, backward)


def gather_rows_matmul(m: torch.Tensor, rows: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """M[rows] @ z -> float32 [B, d] for int8 m [R, C], int64 rows [B]
    and z [Z, d] (Z <= C, standing for z zero-padded to C rows),
    bfloat16 or float32. Not differentiable (`gather_matmul` is).

    CPU tensors take the plain version; CUDA tensors launch K12 or raise.
    K12 takes d % 8 == 0 and C % 128 == 0, reads z's rows as they are
    (no pad) and gives the same bits on every launch."""
    if m.device.type == "cpu":
        return gather_rows_matmul_plain(m, rows, z)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    _check_args(m, rows, z, "z")
    r, c = m.shape
    batch, d = rows.shape[0], z.shape[1]
    if batch == 0:
        return torch.zeros((0, d), dtype=torch.float32, device=m.device)
    z, rows = _aligned(z), rows.contiguous()
    _check_cuda(_K12, m, z)
    shares = _plan(m, batch, z, backward=False)
    out = torch.empty((batch, d), dtype=torch.float32, device=m.device)
    part = out if shares == 1 else torch.empty((shares, batch, d), dtype=torch.float32,
                                               device=m.device)
    lib = _lib()
    code = lib.gather_rows_matmul(m.data_ptr(), rows.data_ptr(), z.data_ptr(), part.data_ptr(),
                                  out.data_ptr(), r, c, z.shape[0], batch, d, shares,
                                  int(z.dtype == torch.bfloat16),
                                  torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(lib, _K12, code)
    gather_rows_matmul.launches += 1
    return out


gather_rows_matmul.launches = 0


def gather_rows_matmul_t(m: torch.Tensor, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """M[rows]ᵀ @ g -> float32 [C, d] for int8 m [R, C], int64 rows [B]
    and g [B, d], bfloat16 or float32; repeated rows add up.

    CPU tensors take the plain version; CUDA tensors launch K13 or raise.
    K13 takes d % 8 == 0 and C % 128 == 0; it sums each column in batch
    order within a share and the shares in order, with no atomics, so
    every launch gives the same bits."""
    if m.device.type == "cpu":
        return gather_rows_matmul_t_plain(m, rows, g)
    if m.device.type != "cuda":
        raise ValueError(f"unsupported device {m.device}")
    _check_args(m, rows, g, "g")
    r, c = m.shape
    batch, d = g.shape
    if batch == 0:
        return torch.zeros((c, d), dtype=torch.float32, device=m.device)
    g, rows = _aligned(g), rows.contiguous()
    _check_cuda(_K13, m, g)
    shares = _plan(m, batch, g, backward=True)
    dz = torch.empty((c, d), dtype=torch.float32, device=m.device)
    lib = _lib()
    code = lib.gather_rows_matmul_t(m.data_ptr(), rows.data_ptr(), g.data_ptr(), dz.data_ptr(),
                                    r, c, batch, d, shares, int(g.dtype == torch.bfloat16),
                                    torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(lib, _K13, code)
    gather_rows_matmul_t.launches += 1
    return dz


gather_rows_matmul_t.launches = 0


class _GatherMatmul(torch.autograd.Function):
    """K12 forward, K13 backward. Saves M (a resident constant), the row
    ids and z's type and row count."""

    @staticmethod
    def forward(ctx, m, rows, z):
        ctx.m, ctx.rows, ctx.z_dtype, ctx.z_rows = m, rows, z.dtype, z.shape[0]
        return gather_rows_matmul(m, rows, z)

    @staticmethod
    def backward(ctx, g):
        dz = gather_rows_matmul_t(ctx.m, ctx.rows, g.to(ctx.z_dtype))
        return None, None, dz[: ctx.z_rows].to(ctx.z_dtype)


def gather_matmul(m: torch.Tensor, rows: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``M[rows] @ z`` -> float32 [B, d]: m int8 [R, C] (a constant, no
    gradient), rows int64 [B] in [0, R), z [Z, d] with Z <= C, bfloat16
    or float32 (its type feeds the products; the sums are float32).
    Differentiable in z: dz = Σ_b M[rows[b]]ᵀ g[b], the cotangent rounded
    to z's type first and dz returned in z's type."""
    return _GatherMatmul.apply(m, rows, z)
