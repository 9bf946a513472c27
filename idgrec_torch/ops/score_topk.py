"""Score, mask and rank a user batch in one op (the evaluator's fused
route; the JAX package scores with a product and ranks with XLA's
``lax.top_k``, so this replaces no TPU kernel).

For user ids ``users`` [B], float32 tables ``user_table`` [U, d] and
``item_table`` [I, d], and the batch's train positives as row offsets
``excl_ptr`` [B + 1] into ``excl_cols`` (each row's items sorted, no
repeats), `score_topk` returns the [B, k] int64 item indices that

    torch.topk(masked sigmoid(user_table[users] @ item_tableᵀ), k).indices

gives on the card: float32 scores, the sigmoid ``1 / (1 + exp(-x))``,
each train positive set to ``MASK_VALUE`` (-1e9), and the k best. The
rule among tied scores is the card's ``torch.topk``, since the scores of
a trained or drawn model tie often (the sigmoid near 0.5 rounds products
of ~1e-5 onto a grid of 6e-8: in a LightGCN sweep at amazon-book scale
almost every user's top 20 holds ties). Among scores tied at the k-th
value the lowest item indices are taken, as ``torch.topk`` takes them.
The k are then put in the order ``torch.topk``'s sort leaves them: for
k ≤ 32 its small bitonic sort (not stable) of the k laid out as the
scores above the k-th value, then those equal to it, each group in
ascending index (`bitonic_order`); for larger k a stable sort, so ties
in ascending index. A row with fewer than k unmasked items fills up
with masked ones, lowest index first. Scores are taken to be finite.

CPU tensors take the plain version `score_topk_plain` (the product, the
sigmoid, the mask and a stable sort, then the order above). CUDA tensors
launch ``csrc/score_topk.cu`` or raise: a memset of 12 bytes a user and two
kernels a call. The first, over (64 users × item split) blocks, streams
item rows through shared memory, forms each product as a chain of fused
multiply-adds over the features in order (``__fmaf_rn``, as the SIMT SGEMM
the route replaced sums, so the scores are the same bits), takes the
sigmoid only of products that may reach their user's running k-th (a
bound from the k-th's product and the sigmoid's error), masks those by a
cursor through the user's sorted train positives, and keeps each user's k
best of the split; the splits of a user share the best k-th any of them
holds. The second merges the splits' lists, one warp a user, and writes
the indices in the order above. The [B, I] score block is never written.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from idgrec_torch.device import check_exact_matmul
from idgrec_torch.ops import _build

_LIB = "score_topk"

MASK_VALUE = -1e9
# the kernel's largest k: a split's list holds at most this many entries
MAX_K = 128
# torch.topk's sort of its k results is a 32-wide bitonic network up to this k
BITONIC_MAX = 32


def _network() -> list[tuple[list[int], list[int], list[bool]]]:
    """The compare-exchange stages of the 32-wide bitonic sort, as 16
    pairs (first, second, direction) a stage: a first phase of merges of
    growing size, each pair's direction the bit ``size / 2`` of its pair
    index, then one merge of all 32 with direction false."""
    stages = []

    def stage(size, stride, final):
        firsts, seconds, dirs = [], [], []
        for t in range(16):
            pos = 2 * t - (t & (stride - 1))
            firsts.append(pos)
            seconds.append(pos + stride)
            dirs.append(False if final else bool(t & (size // 2)))
        stages.append((firsts, seconds, dirs))

    size = 2
    while size < 32:
        stride = size // 2
        while stride:
            stage(size, stride, False)
            stride //= 2
        size *= 2
    stride = 16
    while stride:
        stage(32, stride, True)
        stride //= 2
    return stages


_STAGES = _network()


def bitonic_order(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``idx`` [B, k] (k ≤ 32) of the k best by (value descending, index
    ascending), with their values ``vals``, put in the order the card's
    ``torch.topk`` returns them: laid out as the values above the k-th,
    then those equal to it, each group in ascending index, and sorted
    descending by a 32-wide bitonic network of compare-exchanges that
    swap a pair when ``(a > b and a valid) or b invalid`` equals the
    pair's direction, the 32 - k places past the k invalid."""
    b, k = vals.shape
    dev = vals.device
    above = vals > vals[:, k - 1:k]
    key = torch.where(above, idx, idx + (1 << 40))
    lay = torch.argsort(key, dim=1)
    keys = torch.full((b, 32), float("-inf"), dtype=vals.dtype, device=dev)
    ids = torch.zeros((b, 32), dtype=idx.dtype, device=dev)
    valid = torch.zeros((b, 32), dtype=torch.bool, device=dev)
    keys[:, :k] = torch.gather(vals, 1, lay)
    ids[:, :k] = torch.gather(idx, 1, lay)
    valid[:, :k] = True
    for firsts, seconds, dirs in _STAGES:
        p = torch.tensor(firsts, device=dev)
        q = torch.tensor(seconds, device=dev)
        d = torch.tensor(dirs, device=dev)
        ka, kb, va, vb = keys[:, p], keys[:, q], valid[:, p], valid[:, q]
        ia, ib = ids[:, p], ids[:, q]
        swap = ((ka > kb) & va) | ~vb
        do = swap == d
        keys[:, p], keys[:, q] = torch.where(do, kb, ka), torch.where(do, ka, kb)
        ids[:, p], ids[:, q] = torch.where(do, ib, ia), torch.where(do, ia, ib)
        valid[:, p], valid[:, q] = torch.where(do, vb, va), torch.where(do, va, vb)
    return ids[:, :k]


def topk_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The [B, k] int64 indices of the k best scores of each row, among
    ties at the k-th the lowest indices, in the card's ``torch.topk``
    order (see the module's docstring)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if 1 < k <= BITONIC_MAX:
        return bitonic_order(vals, idx)
    return idx


def _check_args(users, user_table, item_table, excl_ptr, excl_cols, k) -> None:
    if users.dtype != torch.int64 or users.ndim != 1:
        raise ValueError(f"users: expected int64 [B], got {users.dtype} {tuple(users.shape)}")
    for name, t in (("user_table", user_table), ("item_table", item_table)):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name}: expected float32 [n, d], got {t.dtype} {tuple(t.shape)}")
    if user_table.shape[1] != item_table.shape[1]:
        raise ValueError(f"tables of widths {user_table.shape[1]} and {item_table.shape[1]}")
    if excl_ptr.dtype != torch.int64 or tuple(excl_ptr.shape) != (users.shape[0] + 1,):
        raise ValueError(f"excl_ptr: expected int64 [{users.shape[0] + 1}], got "
                         f"{excl_ptr.dtype} {tuple(excl_ptr.shape)}")
    if excl_cols.dtype != torch.int64 or excl_cols.ndim != 1:
        raise ValueError(f"excl_cols: expected int64 [P], got {excl_cols.dtype} "
                         f"{tuple(excl_cols.shape)}")
    if not 1 <= k <= min(MAX_K, item_table.shape[0]):
        raise ValueError(f"k = {k}: expected 1 to {min(MAX_K, item_table.shape[0])}")
    devices = {t.device for t in (users, user_table, item_table, excl_ptr, excl_cols)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def score_topk_plain(users: torch.Tensor, user_table: torch.Tensor, item_table: torch.Tensor,
                     excl_ptr: torch.Tensor, excl_cols: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the op on any device: the [B, I] scores, the
    mask, `topk_order`."""
    _check_args(users, user_table, item_table, excl_ptr, excl_cols, k)
    check_exact_matmul(user_table.device)
    scores = torch.sigmoid(torch.matmul(user_table[users], item_table.T))
    counts = excl_ptr[1:] - excl_ptr[:-1]
    rows = torch.repeat_interleave(torch.arange(users.shape[0], device=users.device), counts)
    scores[rows, excl_cols[excl_ptr[0]:excl_ptr[-1]]] = MASK_VALUE
    return topk_order(scores, k)


# shared memory of the kernel's first pass (csrc/score_topk.cu split_smem):
# 64 user rows of d + 4 floats, two stages of 128 item rows of 36 floats,
# 64 lists of k rounded up to 32, plus 1, entries (value, item, product), 64
# queues of 32 (value, product), 12 words a user, 3,072 train positives; the
# card's limit for one block
_USERS, _ITEMS, _STRIDE, _EXCL = 64, 128, 36, 3072
MAX_SMEM = 227 * 1024


def smem_bytes(d: int, k: int) -> int:
    kc = -(-k // 32) * 32
    return (4 * (_USERS * (d + 4) + 2 * _ITEMS * _STRIDE) + 12 * _USERS * (kc + 1)
            + 8 * _USERS * 32 + 4 * 12 * _USERS + 4 * _EXCL)


def supports(d: int, k: int) -> bool:
    """Whether the kernel takes tables of width ``d`` and this ``k``."""
    return d > 0 and d % 4 == 0 and 1 <= k <= MAX_K and smem_bytes(d, k) <= MAX_SMEM


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library(_LIB)
    lib.score_topk.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
    lib.score_topk.restype = ctypes.c_int
    lib.score_topk_splits.argtypes = [ctypes.c_int] * 4
    lib.score_topk_splits.restype = ctypes.c_int
    lib.score_topk_smem.argtypes = [ctypes.c_int] * 2
    lib.score_topk_smem.restype = ctypes.c_longlong
    return lib


def score_topk(users: torch.Tensor, user_table: torch.Tensor, item_table: torch.Tensor,
               excl_ptr: torch.Tensor, excl_cols: torch.Tensor, k: int) -> torch.Tensor:
    """[B, k] int64 top-k item indices of the batch (module docstring).
    CPU tensors take `score_topk_plain`; CUDA tensors launch
    csrc/score_topk.cu or raise."""
    if users.device.type == "cpu":
        return score_topk_plain(users, user_table, item_table, excl_ptr, excl_cols, k)
    if users.device.type != "cuda":
        raise ValueError(f"unsupported device {users.device}")
    _check_args(users, user_table, item_table, excl_ptr, excl_cols, k)
    b = users.shape[0]
    n_items, d = item_table.shape
    if not supports(d, k):
        raise ValueError(f"d = {d}, k = {k}: the kernel takes d % 4 == 0, k <= {MAX_K} and "
                         f"{smem_bytes(d, k)} bytes of shared memory at most {MAX_SMEM}")
    if not user_table.is_contiguous() or not item_table.is_contiguous() or any(
            t.data_ptr() % 16 for t in (user_table, item_table)):
        raise ValueError("the tables must be contiguous and 16-byte aligned")
    if n_items >= 2**31 or b >= 2**31 or excl_cols.numel() >= 2**31:
        raise ValueError(f"{b} users, {n_items} items or {excl_cols.numel()} positives exceed "
                         "the kernel's int32 sizes")
    dev = users.device
    out = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out
    users, excl_ptr, excl_cols = (t.contiguous() for t in (users, excl_ptr, excl_cols))
    lib = _lib()
    splits = lib.score_topk_splits(b, n_items, d, k)
    if splits < 1:
        raise RuntimeError(f"score_topk: no block of {smem_bytes(d, k)} bytes fits the card")
    # the splits' lists, then the splits' shared bar, 12 bytes a user (csrc/score_topk.cu)
    scratch = torch.empty((8 * splits * k + 12) * b, dtype=torch.uint8, device=dev)
    code = lib.score_topk(users.data_ptr(), user_table.data_ptr(), item_table.data_ptr(),
                          excl_ptr.data_ptr(), excl_cols.data_ptr(), scratch.data_ptr(),
                          out.data_ptr(), b, n_items, d, k, splits,
                          torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, _LIB, code)
    score_topk.launches += 2
    return out


# device launches of the op (two a call)
score_topk.launches = 0
