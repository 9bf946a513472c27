"""Batch row scatter-add (kernel K4) and the batch gathers whose
backward runs on it (counterpart of idgrec_tpu/ops/scatter.py).

    out[n_rows, d] f32 = Σ_b onehot(idx[b]) · vals[b]

is the gradient of the batch-embedding gathers in every BPR loss head:
the cotangent rows of a training batch are summed into a zero table.
Duplicates of a row are added in batch order, the order of `np.add.at`
and of the TPU kernel's sequential loop, so a training run repeats bit
for bit. K4 is ``csrc/scatter_add_rows.cu`` (no float atomics: each
row's entries are bucketed with integer atomics, put in batch order and
added in that order; every row written once). It has two entries:

* `scatter_add_rows`, the public one, checks that every index lies in
  ``[0, n_rows)`` and raises `IndexError` otherwise. On the card that
  check reads one flag back from the device, a synchronisation.
* `scatter_add_rows_unchecked`, the training step's, reads nothing
  back. Its callers, the gathers' backward, indexed the tables with the
  same ids in their forward, where an id out of range faults on the
  device; the kernel itself skips such an entry and never writes
  outside the table.

`scatter_add_rows_plain` defines the same order on any device (a stable
sort, then one collision-free ``index_add_`` per occurrence rank), where
CUDA's ``index_add_`` alone would not.

`gather_batch_embeddings` and `gather_user_pos` are plain indexing
forward; their backward is one K4 launch per destination table (the
item table takes pos and neg concatenated). Under a data split
(`parallel.mesh.split_batch`) the indices are the rank's slice of the
batch: the backward all-gathers the rows' cotangents over the data axis
(`parallel.mesh.WholeBatch`) and K4 scatters the whole batch's in batch
order, so every data rank gets one process's table cotangent, bit for
bit. `correction` is SGL's sum over an edge-dropout view's dropped
edges, both ways on K4's sorted-segment entry `segment_sum_rows`: a list
sorted by row with its row offsets and the rows of a table to gather,
one launch a call, no scratch (its plain version is K4's on the
gathered rows, `segment_sum_rows_plain`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from idgrec_torch.ops import _build
from idgrec_torch.parallel import mesh as mesh_lib

_K4 = "scatter_add_rows"


def _check_shapes(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> None:
    """The checks that read no tensor data: types, shapes, devices."""
    if idx.dtype != torch.int64 or idx.ndim != 1:
        raise ValueError(f"idx: expected int64 [B], got {idx.dtype} {tuple(idx.shape)}")
    if vals.dtype != torch.float32 or vals.ndim != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"vals: expected float32 [{idx.shape[0]}, d], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if vals.get_device() != idx.get_device():
        raise ValueError(f"idx on {idx.device} but vals on {vals.device}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def _check_args(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> None:
    _check_shapes(idx, vals, n_rows)
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
    lib.scatter_add_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.scatter_add_rows.restype = ctypes.c_int
    lib.segment_sum_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                                     + [ctypes.c_void_p] + [ctypes.c_int] * 3
                                     + [ctypes.c_longlong, ctypes.c_void_p])
    lib.segment_sum_rows.restype = ctypes.c_int
    return lib


def scratch_size(n_rows: int, batch: int) -> int:
    """int32 words of K4's scratch (cap: ``batch`` rounded up to even): a
    4-word record per row with two entries or more (at most cap / 2),
    their number (padded to 4 words), a count and an index or bucket
    start per row, a slot and a bucket place per entry."""
    cap = batch + batch % 2
    return 4 * cap + 4 + 2 * n_rows


def _launch(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Launch K4 on CUDA tensors whose shapes `_check_shapes` passed;
    nothing is read back. The launcher zeroes the scratch's counts."""
    b, d = vals.shape
    if n_rows == 0 or d == 0:
        return torch.zeros((n_rows, d), dtype=torch.float32, device=vals.device)
    if not idx.is_contiguous() or not vals.is_contiguous():
        raise ValueError("idx and vals must be contiguous")
    if n_rows * d >= 2**31 or n_rows + b >= 2**30:
        raise ValueError(f"table [{n_rows}, {d}] or batch {b} exceeds the kernel's int32 sizes")
    dev = vals.device
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_size(n_rows, b), dtype=torch.int32, device=dev)
    lib = _k4_lib()
    code = lib.scatter_add_rows(idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), b, d, n_rows,
                                torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, _K4, code)
    scatter_add_rows.launches += 1
    return out


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K4 wrapper (see `scatter_add_rows_plain`): idx int64 [B], vals
    float32 [B, d] -> float32 [n_rows, d]. CPU tensors take the plain
    version; CUDA tensors launch csrc/scatter_add_rows.cu or raise. An
    index out of range raises `IndexError`: on the card the check reads
    one flag back from the device (`scatter_add_rows_unchecked` does
    not)."""
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    _check_args(idx, vals, n_rows)
    return _launch(idx, vals, n_rows)


# K4's launch count; both entries add to it
scatter_add_rows.launches = 0


def scatter_add_rows_unchecked(idx: torch.Tensor, vals: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """`scatter_add_rows` without the range check: nothing is read back.
    For callers whose forward already indexed the table with the same ids
    (the gathers' backward), where an id out of range faults on the
    device; the kernel skips such an entry and never writes outside the
    table. CPU tensors take the plain version (which checks); CUDA
    tensors launch K4 or raise."""
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    _check_shapes(idx, vals, n_rows)
    return _launch(idx, vals, n_rows)


def supports_fast_scatter(n_rows: int, d: int, compute_dtype: str = "int8") -> bool:
    """Whether the batch gathers take the K4 backward: the quantized
    compute modes do, as in the JAX package (the propagated tables are
    f32 in every mode, so the gate keys on the model's compute_dtype).
    The TPU's VMEM budget and mesh test have no counterpart here."""
    return str(compute_dtype).startswith("int")


def _f32(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float32).contiguous()


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_all, item_all, u, p, n):
        ctx.batch = mesh_lib.WholeBatch(u, p, n)
        ctx.shapes = (user_all.shape[0], item_all.shape[0], user_all.dtype, item_all.dtype)
        return user_all[u], item_all[p], item_all[n]

    @staticmethod
    def backward(ctx, gu, gp, gn):
        (u, p, n), (gu, gp, gn) = ctx.batch.indices, ctx.batch.cotangents(gu, gp, gn)
        nu, ni, udtype, idtype = ctx.shapes
        du = scatter_add_rows_unchecked(u, _f32(gu), nu)
        di = scatter_add_rows_unchecked(torch.cat([p, n]), _f32(torch.cat([gp, gn])), ni)
        return du.to(udtype), di.to(idtype), None, None, None


def gather_batch_embeddings(user_all: torch.Tensor, item_all: torch.Tensor, u: torch.Tensor,
                            p: torch.Tensor, n: torch.Tensor):
    """(user_all[u], item_all[p], item_all[n]) with the backward's row
    scatters on K4: one launch per table (the item table takes pos and
    neg concatenated), no data read back."""
    return _GatherBatch.apply(user_all, item_all, u, p, n)


class _GatherUserPos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, user_all, item_all, u, p):
        ctx.batch = mesh_lib.WholeBatch(u, p)
        ctx.shapes = (user_all.shape[0], item_all.shape[0], user_all.dtype, item_all.dtype)
        return user_all[u], item_all[p]

    @staticmethod
    def backward(ctx, gu, gp):
        (u, p), (gu, gp) = ctx.batch.indices, ctx.batch.cotangents(gu, gp)
        nu, ni, udtype, idtype = ctx.shapes
        du = scatter_add_rows_unchecked(u, _f32(gu), nu)
        di = scatter_add_rows_unchecked(p, _f32(gp), ni)
        return du.to(udtype), di.to(idtype), None, None


def gather_user_pos(user_all: torch.Tensor, item_all: torch.Tensor, u: torch.Tensor,
                    p: torch.Tensor):
    """(user_all[u], item_all[p]): the two-gather variant (the
    align/uniform models' pattern) with K4 backwards, one launch per
    table."""
    return _GatherUserPos.apply(user_all, item_all, u, p)


# ---------------------------------------------------------------------------
# K4's sorted-segment entry: SGL's drop corrections


def row_offsets(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int64 [n_rows + 1]: the offsets of the runs of ``rows`` (int64,
    sorted, each in [0, n_rows)), ptr[r] = #{e: rows[e] < r}, on rows'
    device without a synchronisation. The views carry theirs, made on the
    host with the lists (`propagate.build_dropout_adjacency`)."""
    return torch.searchsorted(rows, torch.arange(n_rows + 1, device=rows.device))


def _check_segments(ptr: torch.Tensor, cols: torch.Tensor, z: torch.Tensor,
                    out_rows: int) -> None:
    """The checks that read no tensor data: types, shapes, devices."""
    if ptr.dtype != torch.int64 or ptr.ndim != 1 or ptr.numel() < 1:
        raise ValueError(f"ptr: expected int64 [n_rows + 1], got {ptr.dtype} {tuple(ptr.shape)}")
    if cols.dtype != torch.int64 or cols.ndim != 1:
        raise ValueError(f"cols: expected int64 [E], got {cols.dtype} {tuple(cols.shape)}")
    if z.dtype != torch.float32 or z.ndim != 2:
        raise ValueError(f"z: expected float32 [N, d], got {z.dtype} {tuple(z.shape)}")
    if not ptr.device == cols.device == z.device:
        raise ValueError(f"ptr on {ptr.device}, cols on {cols.device}, z on {z.device}")
    if out_rows < ptr.numel() - 1:
        raise ValueError(f"out_rows {out_rows} below the list's {ptr.numel() - 1} rows")


def segment_sum_rows_plain(ptr: torch.Tensor, cols: torch.Tensor, z: torch.Tensor,
                           out_rows: int | None = None) -> torch.Tensor:
    """Plain version of K4's sorted-segment entry: K4's plain version on
    the gathered rows, `scatter_add_rows_plain` (rows, z[cols], out_rows)
    with the rows the offsets ``ptr`` give (row r holds the entries
    [ptr[r], ptr[r + 1]) of the list)."""
    n_rows = ptr.numel() - 1
    out_rows = n_rows if out_rows is None else out_rows
    _check_segments(ptr, cols, z, out_rows)
    rows = torch.repeat_interleave(torch.arange(n_rows, device=ptr.device), ptr.diff())
    return scatter_add_rows_plain(rows, z[cols], out_rows)


def segment_sum_rows(ptr: torch.Tensor, cols: torch.Tensor, z: torch.Tensor,
                     out_rows: int | None = None) -> torch.Tensor:
    """K4's sorted-segment entry (see `segment_sum_rows_plain`): ptr int64
    [n_rows + 1], the offsets of a list sorted by row (ptr[n_rows] ==
    len(cols)); cols int64 [E], rows of z; z float32 [N, d] of any strides
    -> float32 [out_rows, d] (default n_rows; rows past n_rows are 0),
    out[r] = ((0 + z[c_e0]) + z[c_e1]) + ... over row r's entries in list
    order. CPU tensors take the plain version; CUDA tensors launch the
    entry of csrc/scatter_add_rows.cu or raise: one launch, no scratch,
    the gather inside, nothing read back (a z whose features are strided
    is made contiguous first, a second launch). The offsets and columns
    are trusted (made with the view, `propagate.build_dropout_adjacency`);
    nothing is checked on the device."""
    if z.device.type == "cpu":
        return segment_sum_rows_plain(ptr, cols, z, out_rows)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    n_rows = ptr.numel() - 1
    out_rows = n_rows if out_rows is None else out_rows
    _check_segments(ptr, cols, z, out_rows)
    d = z.shape[1]
    out = torch.empty((out_rows, d), dtype=torch.float32, device=z.device)
    if out_rows == 0 or d == 0:
        return out
    if not ptr.is_contiguous() or not cols.is_contiguous():
        raise ValueError("ptr and cols must be contiguous")
    if out_rows * d >= 2**31 or cols.numel() >= 2**31:
        raise ValueError(f"[{out_rows}, {d}] or {cols.numel()} entries exceed the kernel's "
                         "int32 sizes")
    if z.stride(1) != 1:
        # a transposed view (the quantized views route's): one copy and the
        # kernel's 16-byte loads measured faster than reading it in place
        # (PERF.md §6), so a call is two device launches here
        z = z.contiguous()
    lib = _k4_lib()
    code = lib.segment_sum_rows(ptr.data_ptr(), cols.data_ptr(), z.data_ptr(), z.stride(0),
                                z.stride(1), out.data_ptr(), n_rows, out_rows, d, cols.numel(),
                                torch._C._cuda_getCurrentRawStream(z.device.index))
    _build.check(lib, _K4, code)
    segment_sum_rows.launches += 1
    return out


# launches of K4's sorted-segment entry
segment_sum_rows.launches = 0


def _segments(edges, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ptr, cols) of an edge list given as (rows, cols, ptr) or (rows,
    cols), whose offsets are then made here (`row_offsets`)."""
    if len(edges) == 3:
        return edges[2], edges[1]
    rows, cols = edges
    return row_offsets(rows, n_rows), cols


class _Correction(torch.autograd.Function):
    """out[r] = Σ_e z[c_e] over the edges (r, c_e), on K4's sorted-segment
    entry; the backward is the same sum the other way, on the edges
    sorted by column."""

    @staticmethod
    def forward(ctx, z, by_row, by_col, n_rows):
        ptr, cols = _segments(by_row, n_rows)
        ctx.save_for_backward(*_segments(by_col, z.shape[0]))
        ctx.z_rows = z.shape[0]
        return segment_sum_rows(ptr, cols, z, n_rows)

    @staticmethod
    def backward(ctx, g):
        t_ptr, t_cols = ctx.saved_tensors
        return segment_sum_rows(t_ptr, t_cols, g.to(torch.float32), ctx.z_rows), None, None, None


def correction(z: torch.Tensor, by_row, by_col, n_rows: int) -> torch.Tensor:
    """The edge list's sum Σ_e onehot(rows[e]) · z[cols[e]], float32
    [n_rows, d], for float32 z [N, d] (a view of any strides): the dropped
    edges of an SGL view, subtracted from the full matrix's product
    (ops/propagate.py `_drop_corrections`). ``by_row`` is (rows, cols,
    ptr), int64, sorted by row, with its row offsets (`row_offsets`;
    (rows, cols) has them made on the device at each call); ``by_col``
    the same edges sorted by column, as (cols, rows, col_ptr). The JAX
    package computes the sum with XLA's sorted segment sum; here the
    forward is one launch of K4's sorted-segment entry on (ptr, cols, z)
    and the backward one on by_col's (col_ptr, rows, g) into len(z)
    rows: the gathers inside, in list order, so both repeat bit for bit;
    nothing is read back to the host. CPU tensors run the entry's plain
    version, K4's on the gathered rows."""
    return _Correction.apply(z, by_row, by_col, n_rows)
