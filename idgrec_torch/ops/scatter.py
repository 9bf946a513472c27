"""Batch row scatter-add (kernel K4) and the batch gathers whose
backward runs on it (counterpart of idgrec_tpu/ops/scatter.py).

    out[n_rows, d] f32 = Σ_b onehot(idx[b]) · vals[b]

is the gradient of the batch-embedding gathers in every BPR loss head:
the cotangent rows of a training batch are summed into a zero table.
Duplicates of a row are added in batch order, the order of `np.add.at`
and of the TPU kernel's sequential loop, so a training run repeats bit
for bit. `scatter_add_rows` is the wrapper of ``csrc/scatter_add_rows.cu``
(no atomics: the first occurrence of a row owns it and adds its later
duplicates in order); `scatter_add_rows_plain` defines the same order on
any device (a stable sort, then one collision-free ``index_add_`` per
occurrence rank), where CUDA's ``index_add_`` alone would not.

`gather_batch_embeddings` and `gather_user_pos` are plain indexing
forward; their backward is one K4 launch per destination table (the
item table takes pos and neg concatenated).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from idgrec_torch.ops import _build

_K4 = "scatter_add_rows"


def _check_args(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> None:
    if idx.dtype != torch.int64 or idx.ndim != 1:
        raise ValueError(f"idx: expected int64 [B], got {idx.dtype} {tuple(idx.shape)}")
    if vals.dtype != torch.float32 or vals.ndim != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"vals: expected float32 [{idx.shape[0]}, d], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if vals.device != idx.device:
        raise ValueError(f"idx on {idx.device} but vals on {vals.device}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if idx.numel() and bool(((idx < 0) | (idx >= n_rows)).any()):
        raise IndexError(f"idx out of range [0, {n_rows})")


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain version of K4, the same sums in the same order on any
    device: occurrences of one row are ranked in batch order (stable
    sort), and each rank is one ``index_add_`` whose indices are all
    distinct."""
    _check_args(idx, vals, n_rows)
    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    b = idx.shape[0]
    if b == 0:
        return out
    order = torch.argsort(idx, stable=True)
    rows = idx[order]
    pos = torch.arange(b, device=idx.device)
    starts = torch.ones(b, dtype=torch.bool, device=idx.device)
    starts[1:] = rows[1:] != rows[:-1]
    rank = pos - torch.cummax(torch.where(starts, pos, torch.zeros_like(pos)), dim=0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out.index_add_(0, rows[sel], vals[order[sel]])
    return out


@functools.cache
def _k4_lib() -> ctypes.CDLL:
    lib = _build.library(_K4)
    lib.scatter_add_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.scatter_add_rows.restype = ctypes.c_int
    return lib


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K4 wrapper (see `scatter_add_rows_plain`): idx int64 [B], vals
    float32 [B, d] -> float32 [n_rows, d]. CPU tensors take the plain
    version; CUDA tensors launch csrc/scatter_add_rows.cu or raise. The
    range check reads one flag back from the device: a raw kernel given
    an index out of range would write outside the table."""
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    _check_args(idx, vals, n_rows)
    if not idx.is_contiguous() or not vals.is_contiguous():
        raise ValueError("idx and vals must be contiguous")
    b, d = vals.shape
    if n_rows * d >= 2**31 or b >= 2**31:
        raise ValueError(f"table [{n_rows}, {d}] or batch {b} exceeds the kernel's int32 sizes")
    out = torch.empty((n_rows, d), dtype=torch.float32, device=vals.device)
    lib = _k4_lib()
    code = lib.scatter_add_rows(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), b, d, n_rows,
                                torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(lib, _K4, code)
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


def supports_fast_scatter(n_rows: int, d: int, compute_dtype: str = "int8") -> bool:
    """Whether the batch gathers take the K4 backward: the quantized
    compute modes do, as in the JAX package (the propagated tables are
    f32 in every mode, so the gate keys on the model's compute_dtype).
    The TPU's VMEM budget and mesh test have no counterpart here."""
    return str(compute_dtype).startswith("int")


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_all, item_all, u, p, n):
        ctx.save_for_backward(u, p, n)
        ctx.shapes = (user_all.shape[0], item_all.shape[0], user_all.dtype, item_all.dtype)
        return user_all[u], item_all[p], item_all[n]

    @staticmethod
    def backward(ctx, gu, gp, gn):
        u, p, n = ctx.saved_tensors
        nu, ni, udtype, idtype = ctx.shapes
        du = scatter_add_rows(u, gu.to(torch.float32).contiguous(), nu).to(udtype)
        di = scatter_add_rows(torch.cat([p, n]),
                              torch.cat([gp, gn]).to(torch.float32).contiguous(), ni).to(idtype)
        return du, di, None, None, None


def gather_batch_embeddings(user_all: torch.Tensor, item_all: torch.Tensor, u: torch.Tensor,
                            p: torch.Tensor, n: torch.Tensor):
    """(user_all[u], item_all[p], item_all[n]) with the backward's row
    scatters on K4, one launch per destination table."""
    return _GatherBatch.apply(user_all, item_all, u, p, n)


class _GatherUserPos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_all, item_all, u, p):
        ctx.save_for_backward(u, p)
        ctx.shapes = (user_all.shape[0], item_all.shape[0], user_all.dtype, item_all.dtype)
        return user_all[u], item_all[p]

    @staticmethod
    def backward(ctx, gu, gp):
        u, p = ctx.saved_tensors
        nu, ni, udtype, idtype = ctx.shapes
        du = scatter_add_rows(u, gu.to(torch.float32).contiguous(), nu).to(udtype)
        di = scatter_add_rows(p, gp.to(torch.float32).contiguous(), ni).to(idtype)
        return du, di, None, None


def gather_user_pos(user_all: torch.Tensor, item_all: torch.Tensor, u: torch.Tensor,
                    p: torch.Tensor):
    """(user_all[u], item_all[p]): the two-gather variant (the
    align/uniform models' pattern) with K4 backwards."""
    return _GatherUserPos.apply(user_all, item_all, u, p)
