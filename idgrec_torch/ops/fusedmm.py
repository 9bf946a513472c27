"""Dual-direction adjacency products (kernels K1, K5, K6, K7, K8).

Every application of the square adjacency needs both directions of the
int8 interaction-count matrix M [U_pad, I_pad]. With the activations
stored as [d, N] (the layout the whole quantized chain keeps):

    yuT [d, U_pad] = qiT [d, I_pad] . Mᵀ     (M @ qi)
    yiT [d, I_pad] = quT [d, U_pad] . M      (Mᵀ @ qu)

`fused_adj_matmul_int8_t` is the wrapper of the hand-written Hopper
kernel ``csrc/dual_int8_t.cu`` (K1; counterpart of
idgrec_tpu/ops/fusedmm.py `fused_adj_matmul_int8_t`): it turns the
activations to [N, d], runs the scan of M that K7 runs (one read of M,
its non-zero entries only, ``csrc/dual_scan.cuh``) and turns the sums
back (``csrc/dual_turns.cuh``), three launches a call. It returns the
raw integer products as float32; the caller dequantizes.
`fused_adj_matmul_int8_t_plain` is its plain PyTorch version: the tests
run it on the CPU, and chip_smoke.py holds the kernel to it on the card.

The int4 mode is a storage change only. Counts up to `NIBBLE_MAX` are
packed two to a byte (`pack_nibbles`), the activations stay int8, and
`fused_adj_matmul_int4_t` (kernel ``csrc/dual_int4_t.cu``, K5: K1's
turns around K8's scan of the packed bytes) returns the same integer
products as K1 on the unpacked matrix, bit for bit, from half the
bytes. `fused_adj_matmul_int4_t_plain` unpacks and runs K1's plain
version. `launch_sweep_t` runs K1 or K5 as one sweep of the quantized
chain: the previous sweep's float32 output rounded in its turn-in as K3
rounds it, and the per-sweep epilogue in its turn-out: the linear
chain's (`chainmm.dual_sweep`, `dual_sweep_inject`) or the tanh chain's
(`chainmm.dual_sweep_tanh`, `dual_sweep_tanh_inject`).

The per-application product (`FusedSquareAdj.matmul`) keeps the
activations in [N, d] layout. `fused_adj_matmul` is the exact-mode dual,
yu = M @ zi and yi = Mᵀ @ zu on bfloat16 activations with float32
results (kernel ``csrc/dual_bf16.cu``, K6, the same scan of M in 64-bit
fixed point; counterpart of the JAX `fused_adj_matmul`), differentiable
by the swapped-cotangent identity.
`fused_adj_matmul_int8` and `fused_adj_matmul_int4` are the quantized
duals on pre-quantized int8 activations (kernels ``csrc/dual_int8_n.cu``,
K7, and ``csrc/dual_int4_n.cu``, K8: the same scan on the int8 and on
the nibble-packed matrix, one read of it per `scan_feature_group`
features); their raw sums equal K1's and K5's on the transposed
activations bit for bit. Each has its ``_plain`` twin.
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

# the geometry K1 and K5 take: feature rows, column and row multiples
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


def _as_float32(z: torch.Tensor) -> torch.Tensor:
    """``z`` as the float32 a bfloat16-rounding kernel (K6, K11) takes:
    float32 as it is, other types rounded to bfloat16 first (exact in
    float32, and unchanged by the kernel's rounding)."""
    return z if z.dtype == torch.float32 else z.to(torch.bfloat16).float()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when contiguous and 16-byte aligned, else a copy."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format)


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


_K6 = "dual_bf16"
_T_KERNELS = {"int8": "dual_int8_t", "int4": "dual_int4_t"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signature of each kernel of this module: pointers, ints, the stream
_T_SIGNATURE = [_P] * 7 + [_I] * 2 + [_P]
_SIGNATURES = {
    "dual_int8_t": _T_SIGNATURE,
    "dual_int4_t": _T_SIGNATURE,
    # K6, K7 and K8 also report the scans of M they launched
    "dual_bf16": [_P] * 3 + [_I] * 2 + [_P] * 2 + [_I] * 3 + [ctypes.POINTER(_I), _P],
    "dual_int8_n": [_P] * 5 + [_I] * 3 + [ctypes.POINTER(_I), _P],
    "dual_int4_n": [_P] * 5 + [_I] * 3 + [ctypes.POINTER(_I), _P],
}
# K1's and K5's chain sweep (``<kernel>_sweep``)
_SWEEP_SIGNATURE = [_P] * 18 + [_I] * 9 + [_P]
# the turn-out's modes of a chain sweep (``csrc/dual_turns.cuh``): the
# linear chain's epilogue (K2's) and inject mode, the tanh chain's (K9's,
# K10's)
SWEEP_FORWARD, SWEEP_INJECT, SWEEP_TANH, SWEEP_TANH_INJECT = 1, 2, 3, 4
# the turn-in's reads of a side's input: int8 q and its scale; float32 z and
# its amax, rounded as K3 rounds it; a zero input (q = 0, scale 1)
INPUT_Q, INPUT_Z, INPUT_ZERO = 0, 1, 2


@functools.cache
def _lib(kernel: str) -> ctypes.CDLL:
    lib = _build.library(kernel)
    fn = getattr(lib, kernel)
    fn.argtypes = _SIGNATURES[kernel]
    fn.restype = ctypes.c_int
    if kernel in _T_KERNELS.values():
        sweep = getattr(lib, f"{kernel}_sweep")
        sweep.argtypes = _SWEEP_SIGNATURE
        sweep.restype = ctypes.c_int
        words = getattr(lib, f"{kernel}_sweep_aux_words")
        words.argtypes = [_I] * 2
        words.restype = ctypes.c_int
    if kernel == _K6:
        lib.dual_bf16_scratch_bytes.argtypes = [_I] * 3
        lib.dual_bf16_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check_t(kernel: str, quant: str, m: torch.Tensor, quT: torch.Tensor,
             qiT: torch.Tensor) -> tuple[int, int, int]:
    """Raise unless K1 (``quant`` 'int8') or K5 ('int4') takes these
    operands; (U_pad, I_pad, d). ``m`` is the stored matrix: the packed
    one holds two logical columns a byte."""
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
    return u_pad, i_pad, d


def _t_scratch(u_pad: int, i_pad: int, d: int, dev: torch.device) -> tuple[torch.Tensor, int]:
    """K1's and K5's scratch, one allocation: the int32 sums, then the
    turned activations; (scratch, the activations' byte offset)."""
    rows = (u_pad + i_pad) * d
    return torch.empty(5 * rows, dtype=torch.int8, device=dev), 4 * rows


def _launch_t(quant: str, m: torch.Tensor, quT: torch.Tensor,
              qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the operands of K1 (``quant`` 'int8') or K5 ('int4') and
    launch it: the turn to [N, d] with the sums zeroed, the scan, the
    turn back with the float32 conversion. One scratch allocation, no
    fill."""
    kernel = _T_KERNELS[quant]
    u_pad, i_pad, d = _check_t(kernel, quant, m, quT, qiT)
    dev = m.device
    scratch, q_at = _t_scratch(u_pad, i_pad, d, dev)
    yu = torch.empty((d, u_pad), dtype=torch.float32, device=dev)
    yi = torch.empty((d, i_pad), dtype=torch.float32, device=dev)
    lib = _lib(kernel)
    code = getattr(lib, kernel)(m.data_ptr(), quT.data_ptr(), qiT.data_ptr(), yu.data_ptr(),
                                yi.data_ptr(), scratch.data_ptr() + q_at, scratch.data_ptr(),
                                u_pad, i_pad, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, kernel, code)
    return yu, yi


def sweep_input_mode(x: torch.Tensor | None) -> int:
    """The turn-in's mode for a sweep input ``x``: INPUT_ZERO for None,
    INPUT_Q for int8 q (given with its scale), INPUT_Z for float32 z
    (given with its per-feature amax)."""
    if x is None:
        return INPUT_ZERO
    if x.dtype == torch.int8:
        return INPUT_Q
    if x.dtype == torch.float32:
        return INPUT_Z
    raise ValueError(f"a sweep input is int8 q or float32 z, got {x.dtype}")


def launch_sweep_t(quant: str, m: torch.Tensor, in_u: tuple, in_i: tuple, post: tuple,
                   pre: tuple, ext: tuple, mode: int, flag: int, want_next: tuple,
                   hs: tuple = (None, None), runs: tuple = (True, True)):
    """One sweep of the quantized chain on CUDA tensors: K1 (``quant``
    'int8') or K5 ('int4') with the chain's epilogue in its turn-out,
    three device launches (`chainmm.dual_sweep` and
    `chainmm.dual_sweep_tanh` state the arithmetic). in_u, in_i: the
    user and the item input as (x, a), [d, N] and [d] (a scale may come
    as [d, 1]), by `sweep_input_mode`: (z, amax), rounded in the turn-in
    as K3 rounds it; (q, s); or (None, None), a zero input. The user sums
    dequantize by the item input's scale, the item sums by the user
    input's. ``flag``: the combine mode (``mode`` SWEEP_FORWARD or
    SWEEP_TANH) or whether the cotangent is added (SWEEP_INJECT,
    SWEEP_TANH_INJECT), both sides alike. Each of post, pre, ext,
    want_next, hs and runs is a pair (user side, item side): [N]
    vectors; the combine (forward modes, updated in place) or the
    cotangent (inject modes, read only); whether a next input and its
    amax are wanted; the h slice [d, N] (SWEEP_TANH: written;
    SWEEP_TANH_INJECT: read when a next input is wanted; else unused);
    whether the side runs at all. A side that does not run is neither
    read nor written but its input, and its operands may be None.
    Returns (out_u, amax_u, out_i, amax_i): z and its amax where a next
    input is wanted (forward modes; else None), the store and its amax
    (inject modes; amax None unless a next input is wanted), all None
    for a side that does not run. The amaxes are views of this sweep's
    aux buffer; an input's amax may be a view of the previous sweep's,
    which the caller's reference keeps from being handed out as this
    one's until the launch is enqueued."""
    kernel = _T_KERNELS[quant]
    u_pad, m_cols = m.shape
    i_pad = 2 * m_cols if quant == "int4" else m_cols
    d = _FEATURES
    dev = m.device
    _check_operand("m", m, torch.int8, (u_pad, m_cols), dev)
    if not kernel_accepts(u_pad, i_pad, d, quant):
        raise ValueError(f"{kernel} takes I_pad % {PACK_TILE if quant == 'int4' else _STRIP} "
                         f"== 0 and U_pad % {_CHUNK} == 0; got U_pad={u_pad}, I_pad={i_pad}")
    if mode not in (SWEEP_FORWARD, SWEEP_INJECT, SWEEP_TANH, SWEEP_TANH_INJECT):
        raise ValueError(f"unknown sweep mode {mode}")
    if not any(runs):
        raise ValueError("a sweep runs at least one side")
    forward = mode in (SWEEP_FORWARD, SWEEP_TANH)
    nexts = tuple(bool(r and w) for r, w in zip(runs, want_next))
    inputs = []
    for side, n, (x, a) in (("u", u_pad, in_u), ("i", i_pad, in_i)):
        in_mode = sweep_input_mode(x)
        if in_mode != INPUT_ZERO:
            _check_operand(f"x_{side}", x, x.dtype, (d, n), dev)
            if a is None:
                raise ValueError(f"a_{side}: the input's scale or amax is missing")
            _check_operand(f"a_{side}", a.reshape(-1), torch.float32, (d,), dev)
        inputs.append((x, a, in_mode))
    for k, (side, n) in enumerate((("u", u_pad), ("i", i_pad))):
        if not runs[k]:
            continue
        checks = [(f"post_{side}", post[k], (n,)), (f"ext_{side}", ext[k], (d, n))]
        if nexts[k]:
            checks.append((f"pre_{side}", pre[k], (n,)))
        if mode == SWEEP_TANH or (mode == SWEEP_TANH_INJECT and nexts[k]):
            checks.append((f"hs_{side}", hs[k], (d, n)))
        for name, t, shape in checks:
            _check_operand(name, t, torch.float32, shape, dev)
    scratch, q_at = _t_scratch(u_pad, i_pad, d, dev)
    lib = _lib(kernel)
    # the two amax vectors, then the turn-out's per-block maxima and counts
    aux = torch.empty(getattr(lib, f"{kernel}_sweep_aux_words")(u_pad, i_pad),
                      dtype=torch.float32, device=dev)
    outs = [torch.empty((d, n), dtype=torch.float32, device=dev)
            if r and (w or not forward) else None
            for r, w, n in zip(runs, nexts, (u_pad, i_pad))]

    def ptr(k, t):
        return t.data_ptr() if runs[k] and t is not None else None

    def in_ptr(t):
        return t.data_ptr() if t is not None else None

    (xu, au, mu), (xi, ai, mi) = inputs
    code = getattr(lib, f"{kernel}_sweep")(
        m.data_ptr(), in_ptr(xu), in_ptr(xi), in_ptr(au), in_ptr(ai), scratch.data_ptr() + q_at,
        scratch.data_ptr(), aux.data_ptr(), ptr(0, post[0]), ptr(0, pre[0]), ptr(1, post[1]),
        ptr(1, pre[1]), ptr(0, ext[0]), ptr(1, ext[1]), ptr(0, outs[0]), ptr(1, outs[1]),
        ptr(0, hs[0]), ptr(1, hs[1]), u_pad, i_pad, mu, mi, mode,
        int(runs[0]) + 2 * int(runs[1]), int(flag), int(nexts[0]), int(nexts[1]),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, kernel, code)
    return (outs[0], aux[:d] if nexts[0] else None, outs[1], aux[d:2 * d] if nexts[1] else None)


def fused_adj_matmul_int8_t(m8: torch.Tensor, quT: torch.Tensor,
                            qiT: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(yuT [d, U_pad], yiT [d, I_pad]) float32 raw integer products of
    int8 m8 [U_pad, I_pad], quT [d, U_pad], qiT [d, I_pad].

    The sums are exact int32 sums converted to float32 once (exact
    while every sum stays below 2**24, as `fused_adj_matmul_int8`
    states).

    CPU tensors take the plain version; CUDA tensors launch K1 or
    raise. K1 is three launches (the activations turned to [N, d] and
    the sums zeroed, the scan of M, the sums turned back to [d, N] as
    float32) and does not synchronise with the host."""
    if m8.device.type == "cpu":
        return fused_adj_matmul_int8_t_plain(m8, quT, qiT)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    out = _launch_t("int8", m8, quT, qiT)
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
    raise. K5 is K1's three launches with K8's scan of the packed
    bytes, and does not synchronise with the host."""
    if m4.device.type == "cpu":
        return fused_adj_matmul_int4_t_plain(m4, quT, qiT)
    if m4.device.type != "cuda":
        raise ValueError(f"unsupported device {m4.device}")
    out = _launch_t("int4", m4, quT, qiT)
    fused_adj_matmul_int4_t.launches += 1
    return out


fused_adj_matmul_int4_t.launches = 0


# ---------------------------------------------------------------------------
# [N, d] layout: the per-application duals (K6, K7, K8)

_N_KERNELS = {"int8": "dual_int8_n", "int4": "dual_int4_n"}
# K6, K7 and K8 split d into `scan_feature_group` features a read of M
_FEATURE_GROUP = 32
# the kernels index rows and columns with int32 and bound a row's sum by 2**30
_MAX_SIDE = 2 ** 23
# rows of M converted to float32 at a time by `dual_matmul_f32`
_F32_ROWS = 4096


def scan_feature_group(d: int) -> int:
    """Features one scan of M covers in K6, K7 and K8 (the scan of
    ``csrc/dual_scan.cuh``): 128 where d % 128 == 0, else 64 where
    d % 64 == 0, else 32, the rule of the kernels' launcher, which
    reports the scans it launched (``fused_adj_matmul.passes``,
    ``fused_adj_matmul_int8.passes``, ``fused_adj_matmul_int4.passes``)."""
    return 128 if d % 128 == 0 else 64 if d % 64 == 0 else 32


def scan_passes(d: int) -> int:
    """Reads of the stored matrix that one K6, K7 or K8 launch makes at
    width d (d % 32 == 0)."""
    return d // scan_feature_group(d)


def kernel_accepts_n(u_pad: int, i_pad: int, d: int, mode: str = "bf16") -> bool:
    """Whether K6 (``mode`` 'bf16'), K7 ('int8') or K8 ('int4') takes
    these logical shapes: d a multiple of 32 (each reads the matrix once
    per `scan_feature_group`), U_pad a multiple of 64, I_pad a multiple
    of 256 (of `PACK_TILE` for int4)."""
    col_multiple = PACK_TILE if mode == "int4" else _STRIP
    return (d > 0 and d % _FEATURE_GROUP == 0 and 0 < u_pad <= _MAX_SIDE
            and 0 < i_pad <= _MAX_SIDE and u_pad % _CHUNK == 0 and i_pad % col_multiple == 0)


def _require_n(kernel: str, mode: str, u_pad: int, i_pad: int, d: int) -> None:
    if not kernel_accepts_n(u_pad, i_pad, d, mode):
        raise ValueError(
            f"{kernel} takes d % {_FEATURE_GROUP} == 0, U_pad % {_CHUNK} == 0, I_pad % "
            f"{PACK_TILE if mode == 'int4' else _STRIP} == 0 and sides up to {_MAX_SIDE}; got "
            f"d={d}, U_pad={u_pad}, I_pad={i_pad}")


def dual_matmul_f32(m8: torch.Tensor, zu: torch.Tensor | None,
                    zi: torch.Tensor | None) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(M @ zi, Mᵀ @ zu) as float32 products with float32 accumulation:
    int8 m8 [U_pad, I_pad], zu [U_pad, d], zi [I_pad, d] of any type
    whose values float32 holds exactly. M is converted in row blocks,
    each block feeding both products, to bound the float32 working set
    at full scale. A side given as None is not computed and comes back
    None (one direction: the rectangular adjacency's products). On the
    card TF32 must be off. This is the plain product of the dense
    backend and of K6's plain version; with integer-valued operands it
    is exact while every sum stays below 2**24."""
    check_exact_matmul(m8.device)
    u_pad = m8.shape[0]
    zu32 = None if zu is None else zu.to(torch.float32)
    zi32 = None if zi is None else zi.to(torch.float32)
    yu_parts, yi = [], None
    for r in range(0, u_pad, _F32_ROWS):
        blk = m8[r : r + _F32_ROWS].to(torch.float32)
        if zi32 is not None:
            yu_parts.append(blk @ zi32)
        if zu32 is not None:
            part = blk.T @ zu32[r : r + _F32_ROWS]
            yi = part if yi is None else yi + part
    return (torch.cat(yu_parts) if zi32 is not None else None), yi


def _pad_cast(z: torch.Tensor, rows: int, dtype: torch.dtype) -> torch.Tensor:
    return F.pad(z.to(dtype), (0, 0, 0, rows - z.shape[0]))


def _out_rows(z: torch.Tensor | None, padded: int) -> int:
    """Rows of the result on ``z``'s side: ``z``'s own, or M's padded
    count on a side given as None."""
    return padded if z is None else z.shape[0]


def fused_adj_matmul_plain(m8: torch.Tensor, zu: torch.Tensor | None,
                           zi: torch.Tensor | None
                           ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Plain version of `fused_adj_matmul` (K6): the activations rounded
    to bfloat16 and zero-padded to M's shape, multiplied in float32 by
    the counts (both exact in float32), float32 accumulation. Differs
    from K6 in the order of the float32 additions only. A side given as
    None is not computed (`fused_adj_matmul` states the shapes).
    Differentiable by autograd."""
    u_pad, i_pad = m8.shape
    yu, yi = dual_matmul_f32(m8, None if zu is None else _pad_cast(zu, u_pad, torch.bfloat16),
                             None if zi is None else _pad_cast(zi, i_pad, torch.bfloat16))
    return (None if yu is None else yu[: _out_rows(zu, u_pad)],
            None if yi is None else yi[: _out_rows(zi, i_pad)])


def _launch_bf16(m8: torch.Tensor, zu: torch.Tensor | None, zi: torch.Tensor | None
                 ) -> tuple[torch.Tensor | None, torch.Tensor | None, int]:
    """Check K6's operands and launch it on the card: int8 m8
    [U_pad, I_pad], zu [U, d] and zi [I, d] (U <= U_pad, I <= I_pad),
    either of them None (one direction: the kernel takes that side as
    zero rows and never reads its pointer). float32 activations go in as
    they are (the kernel rounds and pads them); others are rounded to
    bfloat16 here and go in as float32, which the kernel's rounding
    leaves as they are. Returns (yu, yi, the scans of M its launcher
    reports), shaped as `fused_adj_matmul` states. Three device
    launches, no read-back."""
    u_pad, i_pad = m8.shape
    given = zu if zu is not None else zi
    d, dev = given.shape[1], m8.device
    _check_operand("m8", m8, torch.int8, (u_pad, i_pad), dev)
    _require_n(_K6, "bf16", u_pad, i_pad, d)
    sides = []
    for name, z in (("zu", zu), ("zi", zi)):
        if z is None:
            sides.append((None, 0, 0))  # zero rows: the pointer is not read
            continue
        z = _aligned(_as_float32(z))
        _check_operand(name, z, torch.float32, (z.shape[0], d), dev)
        sides.append((z, z.shape[0], z.data_ptr()))
    (zu, nu, pu), (zi, ni, pi) = sides
    lib = _lib(_K6)
    scratch = torch.empty(lib.dual_bf16_scratch_bytes(u_pad, i_pad, d), dtype=torch.uint8,
                          device=dev)
    y = torch.empty((u_pad + i_pad, d), dtype=torch.float32, device=dev)
    passes = ctypes.c_int(0)
    code = lib.dual_bf16(m8.data_ptr(), pu, pi, nu, ni, scratch.data_ptr(), y.data_ptr(), u_pad,
                         i_pad, d, ctypes.byref(passes),
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, _K6, code)
    yu = None if zi is None else y[: _out_rows(zu, u_pad)]
    yi = None if zu is None else y[u_pad : u_pad + _out_rows(zi, i_pad)]
    return yu, yi, passes.value


class _FusedAdjMatmul(torch.autograd.Function):
    """K6 with the swapped-cotangent backward: [[0, M], [Mᵀ, 0]] is
    symmetric, so (dzu, dzi) = (M @ g_yi, Mᵀ @ g_yu) is the same
    function of the cotangents. A side given as None in the forward has
    no result and no gradient; the gradient of the given side comes back
    at its own rows. Saves only M."""

    @staticmethod
    def forward(ctx, m8, zu, zi):
        ctx.m8 = m8
        ctx.rows = (None if zu is None else zu.shape[0], None if zi is None else zi.shape[0])
        return _fused_fwd(m8, zu, zi)

    @staticmethod
    def backward(ctx, g_yu, g_yi):
        dzu, dzi = _fused_fwd(ctx.m8, g_yu, g_yi)
        nu, ni = ctx.rows
        return (None, None if nu is None else dzu[:nu], None if ni is None else dzi[:ni])


def _fused_fwd(m8, zu, zi):
    if m8.device.type == "cpu":
        return fused_adj_matmul_plain(m8, zu, zi)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    yu, yi, fused_adj_matmul.passes = _launch_bf16(m8, zu, zi)
    fused_adj_matmul.launches += 1
    return yu, yi


def fused_adj_matmul(m8: torch.Tensor, zu: torch.Tensor | None,
                     zi: torch.Tensor | None
                     ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(M @ zi, Mᵀ @ zu) for int8 m8 [U_pad, I_pad] padded with
    `pad_matrix`; zu [U, d], zi [I, d] floats, rounded to bfloat16 and
    zero-padded here; returns float32 (yu [U, d], yi [I, d]).
    Differentiable in zu and zi: the backward is the same product on the
    swapped cotangents (rounded to bfloat16 like any operand).

    One direction: a side given as None is taken as zero and its result
    comes back None; the other result then has M's padded rows on the
    absent side (``fused_adj_matmul(m8, None, zi)`` gives M @ zi as
    [U_pad, d], the rectangular adjacency's product). Each side's sums
    are scaled by that side's own largest activation, so a one-sided
    launch gives the bits of the same side of a two-sided one.

    CPU tensors take the plain version; CUDA tensors launch K6 or raise.
    K6 takes d % 32 == 0, U_pad % 64 == 0, I_pad % 256 == 0
    (`kernel_accepts_n`), reads M `scan_passes` (d) times (once at d = 64
    and d = 128; the last launch's reads, as its launcher reports them,
    are in ``fused_adj_matmul.passes``) and gives the same bits on every
    launch: each entry's product is rounded once to 64-bit fixed point
    (the scale a power of two from the largest activation) and the sums
    are integer atomics. A non-finite activation on one side gives NaN
    over the other side's results."""
    u_pad, i_pad = m8.shape
    sides = [z for z in (zu, zi) if z is not None]
    if (not sides or any(z.dim() != 2 for z in sides)
            or len({z.shape[1] for z in sides}) != 1
            or (zu is not None and zu.shape[0] > u_pad)
            or (zi is not None and zi.shape[0] > i_pad)):
        shapes = [None if z is None else tuple(z.shape) for z in (zu, zi)]
        raise ValueError(f"fused_adj_matmul: zu {shapes[0]} and zi {shapes[1]} do not fit m8 "
                         f"{tuple(m8.shape)}")
    return _FusedAdjMatmul.apply(m8, zu, zi)


fused_adj_matmul.launches = 0
fused_adj_matmul.passes = 0


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


def _launch_dual_n(quant: str, m: torch.Tensor, qu: torch.Tensor,
                   qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Check the operands of K7 (``quant`` 'int8') or K8 ('int4') and
    launch it on CUDA tensors: (yu, yi, the scans of M its launcher
    reports). ``m`` is the stored matrix: the packed one holds two
    logical columns a byte. Three launches: one zero fill of both int32
    sums, the scan, their conversion to float32 in place."""
    kernel = _N_KERNELS[quant]
    u_pad, m_cols = m.shape
    i_pad = 2 * m_cols if quant == "int4" else m_cols
    d = qu.shape[1]
    _check_operand("m", m, torch.int8, (u_pad, m_cols), m.device)
    _check_operand("qu", qu, torch.int8, (u_pad, d), m.device)
    _check_operand("qi", qi, torch.int8, (i_pad, d), m.device)
    _require_n(kernel, quant, u_pad, i_pad, d)
    sums = torch.zeros((u_pad + i_pad, d), dtype=torch.int32, device=m.device)
    yu, yi = sums[:u_pad], sums[u_pad:]
    lib = _lib(kernel)
    passes = ctypes.c_int(0)
    code = getattr(lib, kernel)(m.data_ptr(), qu.data_ptr(), qi.data_ptr(), yu.data_ptr(),
                                yi.data_ptr(), u_pad, i_pad, d, ctypes.byref(passes),
                                torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(lib, kernel, code)
    return yu.view(torch.float32), yi.view(torch.float32), passes.value


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
    raise. K7 takes d % 32 == 0, U_pad % 64 == 0, I_pad % 256 == 0, and
    reads M `scan_passes` (d) times: once at d = 64 and d = 128. The last
    launch's reads of M, as its launcher reports them, are in
    ``fused_adj_matmul_int8.passes``."""
    if m8.device.type == "cpu":
        return fused_adj_matmul_int8_plain(m8, qu, qi)
    if m8.device.type != "cuda":
        raise ValueError(f"unsupported device {m8.device}")
    yu, yi, fused_adj_matmul_int8.passes = _launch_dual_n("int8", m8, qu, qi)
    fused_adj_matmul_int8.launches += 1
    return yu, yi


fused_adj_matmul_int8.launches = 0
fused_adj_matmul_int8.passes = 0


def fused_adj_matmul_int4(m4: torch.Tensor, qu: torch.Tensor,
                          qi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`fused_adj_matmul_int8` on the nibble-packed matrix: m4 int8
    [U_pad, I_pad // 2] in `pack_nibbles` layout, qu int8 [U_pad, d], qi
    int8 [I_pad, d] -> float32 (yu [U_pad, d], yi [I_pad, d]), equal to
    K7's output on `unpack_nibbles(m4)`.

    CPU tensors take the plain version; CUDA tensors launch K8 or
    raise. K8 is K7's scan on the packed bytes, each non-zero nibble an
    entry: it takes d % 32 == 0, U_pad % 64 == 0, I_pad % 2,048 == 0,
    and reads m4 `scan_passes` (d) times: once at d = 64 and d = 128.
    The last launch's reads of m4, as its launcher reports them, are in
    ``fused_adj_matmul_int4.passes``."""
    if m4.device.type == "cpu":
        return fused_adj_matmul_int4_plain(m4, qu, qi)
    if m4.device.type != "cuda":
        raise ValueError(f"unsupported device {m4.device}")
    yu, yi, fused_adj_matmul_int4.passes = _launch_dual_n("int4", m4, qu, qi)
    fused_adj_matmul_int4.launches += 1
    return yu, yi


fused_adj_matmul_int4.launches = 0
fused_adj_matmul_int4.passes = 0
