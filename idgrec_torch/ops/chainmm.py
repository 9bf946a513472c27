"""Whole-chain quantized propagation (counterpart of
idgrec_tpu/ops/chainmm.py), forward and backward, linear or with tanh.

The TPU ran the K-layer chain as one Pallas kernel whose state (int8
activations, scales, dual accumulators, layer combine; ~52 MB at
yelp2018 scale) stayed in VMEM across sweeps. No such memory exists on
the H100, so the chain here is a short sequence of launches per sweep,
each a hand-written kernel:

    K3 quantize_rows (ops/propagate.py)   z -> int8 q, per-feature scale
    K1 dual_int8_t   (ops/fusedmm.py)     one read of M, both directions:
       q turned to [N, d], the scan of M's non-zero entries that K7 runs,
       the int32 sums turned back to float32 [d, N] (three launches)
       (K5 dual_int4_t when the adjacency is nibble-packed: the chain's
       int4 mode, the same activations and the same integer products)
    K2 chain_sweep_epilogue (this module) dequantize, normalize, combine,
                                          next input and its amax

K3's work runs inside the dual's turn-in and K2's inside its turn-out
(`dual_sweep`, K1's or K5's first and third launches): the turn-in
reads the previous sweep's float32 z and rounds it by its amax as K3
would, the turn-out holds every sum of its tile and completes it as K2
would, so a sweep is the dual's three launches alone. The standalone K2
forms the chain's prologue, where no dual precedes it; K3 standalone
runs on no chain (`propagate.quant_fused_dual_t` keeps it). Each of the
chains' four sweeps (K2's epilogue, its inject mode, K9's, K10's) is a
`DualSweep`: one wrapper, one plain version.

Forward layer: h_{k+1} = l ⊙ dequant(M̂_dual(quant(r ⊙ h_k))), c += h_{k+1}.
The f32 work keeps the TPU kernel's operation order (post * (raw * s),
running combine, mean by division), so the result agrees with the JAX
per-sweep chain to ulps, and a rounding tie may move one quantized
activation by 1 lsb (tests/test_torch_propagate.py holds both bars).
`fused_chain_resident_plain` runs the same chain through the kernels'
plain versions: it is the reference the tests and chip_smoke.py hold
the kernel chain to.

The backward is straight-through and fully quantized, as the TPU
kernel's mode 'bwd': the cotangent g of the combine runs the same chain
with the normalization vectors swapped,

    G_k = g + r ⊙ dequant(M̂_dual(quant(l ⊙ G_{k+1}))),

through K1 with K3 in its turn-in and K2's inject mode in its turn-out
(`dual_sweep_inject`; standalone, `chain_sweep_inject`), and needs
nothing of the forward but the adjacency. Both chains are one
`torch.autograd.Function`, so the plain chain's gradient is the
reference of the kernel chain's.

The tanh chain (EGCF's; the TPU kernel's ``activation='tanh'``, ROADMAP
B.B4) runs K9's epilogue (`chain_sweep_tanh`) where the linear chain
runs K2's, also in the dual's turn-out (`dual_sweep_tanh`): h =
tanh(l ⊙ dequant(...)) goes into an [n_sweeps, d, N] stream, the
combine sums the counted layers (layer 0 is never one), and the next
input is r ⊙ h. Its backward (K10's epilogue, `chain_sweep_tanh_inject`,
in the turn-out of `dual_sweep_tanh_inject`) reads that stream: G =
[g +] r ⊙ dequant(...), next input l ⊙ ((1 − h²) ⊙ G). A sweep is the
dual's three launches; K10 standalone forms the backward's prologue,
and K9 standalone runs on no path. With ``seed_users_from_items`` a
seed sweep comes first: it consumes a zero user input (the turn-in's
zero mode) and the item embeddings, keeps only its user direction
(hu = tanh(l_u ⊙ M(r_i ⊙ E_i)); the turn-out writes no item side), and
the first counted layer reuses its item input, rounded again to the
same integers. The backward appends the matching sweep that maps the
user side of G₀ back to the items through the seed application (a zero
item input; its turn-out writes no user side).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from idgrec_torch.ops import _build, fusedmm, propagate

_K2 = "chain_sweep_epilogue"

# combine modes of K2
COMBINE_NONE, COMBINE_SET, COMBINE_ADD = 0, 1, 2


def chain_sweep_epilogue_plain(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                               pre: torch.Tensor, c: torch.Tensor, combine: int,
                               want_next: bool):
    """Plain version of K2 for one side of one sweep, [d, N] layout:
    nh = post ⊙ (y ⊙ s_in); c = nh (SET) or c + nh (ADD), in place;
    when ``want_next``, z = pre ⊙ nh and amax = max |z| per feature.
    y, c f32 [d, N]; s_in f32 [d]; post, pre f32 [N].
    Returns (z, amax) or (None, None)."""
    nh = post[None, :] * (y * s_in[:, None])
    if combine == COMBINE_SET:
        c.copy_(nh)
    elif combine == COMBINE_ADD:
        c.add_(nh)
    if not want_next:
        return None, None
    z = pre[None, :] * nh
    return z, z.abs().amax(dim=1)


@functools.cache
def _k2_lib() -> ctypes.CDLL:
    lib = _build.library(_K2)
    lib.chain_sweep_epilogue.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
    lib.chain_sweep_epilogue.restype = ctypes.c_int
    lib.chain_sweep_inject.argtypes = lib.chain_sweep_epilogue.argtypes
    lib.chain_sweep_inject.restype = ctypes.c_int
    return lib


def chain_sweep_epilogue(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                         pre: torch.Tensor, c: torch.Tensor, combine: int, want_next: bool):
    """K2 wrapper (see `chain_sweep_epilogue_plain`). CPU tensors take
    the plain version; CUDA tensors launch csrc/chain_sweep_epilogue.cu
    or raise."""
    if y.device.type == "cpu":
        return chain_sweep_epilogue_plain(y, s_in, post, pre, c, combine, want_next)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    d, n = y.shape
    for name, t, shape in (("y", y, (d, n)), ("c", c, (d, n)), ("s_in", s_in, (d,)),
                           ("post", post, (n,)), ("pre", pre, (n,))):
        fusedmm._check_operand(name, t, torch.float32, shape, y.device)
    if n % 4:
        raise ValueError(f"chain_sweep_epilogue takes N % 4 == 0, got N={n}")
    if combine not in (COMBINE_NONE, COMBINE_SET, COMBINE_ADD):
        raise ValueError(f"unknown combine mode {combine}")
    z = torch.empty_like(y) if want_next else y
    amax = torch.zeros(d, dtype=torch.float32, device=y.device)
    lib = _k2_lib()
    code = lib.chain_sweep_epilogue(y.data_ptr(), s_in.data_ptr(), post.data_ptr(),
                                    pre.data_ptr(), c.data_ptr(), z.data_ptr(),
                                    amax.data_ptr(), d, n, combine, int(want_next),
                                    torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, _K2, code)
    chain_sweep_epilogue.launches += 1
    return (z, amax) if want_next else (None, None)


chain_sweep_epilogue.launches = 0


def chain_sweep_inject_plain(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                             pre: torch.Tensor, g: torch.Tensor, inject: bool,
                             want_next: bool):
    """Plain version of K2's inject mode for one side of one backward
    sweep, [d, N] layout: nh = post ⊙ (y ⊙ s_in); store = g + nh when
    ``inject`` else nh. With ``want_next`` returns (pre ⊙ store, its
    per-feature amax), else (store, None): the last sweep's store is the
    chain's result. g is read only."""
    store = post[None, :] * (y * s_in[:, None])
    if inject:
        store = g + store
    if not want_next:
        return store, None
    z = pre[None, :] * store
    return z, z.abs().amax(dim=1)


def chain_sweep_inject(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                       pre: torch.Tensor, g: torch.Tensor, inject: bool, want_next: bool):
    """K2 inject-mode wrapper (see `chain_sweep_inject_plain`). CPU
    tensors take the plain version; CUDA tensors launch
    csrc/chain_sweep_epilogue.cu `chain_sweep_inject` or raise."""
    if y.device.type == "cpu":
        return chain_sweep_inject_plain(y, s_in, post, pre, g, inject, want_next)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    d, n = y.shape
    for name, t, shape in (("y", y, (d, n)), ("g", g, (d, n)), ("s_in", s_in, (d,)),
                           ("post", post, (n,)), ("pre", pre, (n,))):
        fusedmm._check_operand(name, t, torch.float32, shape, y.device)
    if n % 4:
        raise ValueError(f"chain_sweep_inject takes N % 4 == 0, got N={n}")
    out = torch.empty_like(y)
    amax = torch.zeros(d, dtype=torch.float32, device=y.device)
    lib = _k2_lib()
    code = lib.chain_sweep_inject(y.data_ptr(), s_in.data_ptr(), post.data_ptr(),
                                  pre.data_ptr(), g.data_ptr(), out.data_ptr(),
                                  amax.data_ptr(), d, n, int(bool(inject)), int(want_next),
                                  torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, _K2, code)
    chain_sweep_inject.launches += 1
    return out, (amax if want_next else None)


chain_sweep_inject.launches = 0


_K9 = "chain_sweep_tanh"


def chain_sweep_tanh_plain(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                           pre: torch.Tensor, c: torch.Tensor, h_out: torch.Tensor,
                           combine: int, want_next: bool):
    """Plain version of K9 for one side of one forward sweep of the
    tanh chain, [d, N] layout: h = tanh(post ⊙ (y ⊙ s_in)) into
    ``h_out``; c = h (SET) or c + h (ADD), in place; when ``want_next``,
    z = pre ⊙ h and amax = max |z| per feature. y, c, h_out f32 [d, N];
    s_in f32 [d]; post, pre f32 [N]. Returns (z, amax) or (None, None)."""
    h = torch.tanh(post[None, :] * (y * s_in[:, None]))
    h_out.copy_(h)
    if combine == COMBINE_SET:
        c.copy_(h)
    elif combine == COMBINE_ADD:
        c.add_(h)
    if not want_next:
        return None, None
    z = pre[None, :] * h
    return z, z.abs().amax(dim=1)


@functools.cache
def _k9_lib() -> ctypes.CDLL:
    lib = _build.library(_K9)
    lib.chain_sweep_tanh.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
    lib.chain_sweep_tanh.restype = ctypes.c_int
    lib.chain_sweep_tanh_inject.argtypes = lib.chain_sweep_tanh.argtypes
    lib.chain_sweep_tanh_inject.restype = ctypes.c_int
    return lib


def chain_sweep_tanh(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                     pre: torch.Tensor, c: torch.Tensor, h_out: torch.Tensor, combine: int,
                     want_next: bool):
    """K9 wrapper (see `chain_sweep_tanh_plain`). CPU tensors take the
    plain version; CUDA tensors launch csrc/chain_sweep_tanh.cu or
    raise."""
    if y.device.type == "cpu":
        return chain_sweep_tanh_plain(y, s_in, post, pre, c, h_out, combine, want_next)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    d, n = y.shape
    for name, t, shape in (("y", y, (d, n)), ("c", c, (d, n)), ("h_out", h_out, (d, n)),
                           ("s_in", s_in, (d,)), ("post", post, (n,)), ("pre", pre, (n,))):
        fusedmm._check_operand(name, t, torch.float32, shape, y.device)
    if n % 4:
        raise ValueError(f"chain_sweep_tanh takes N % 4 == 0, got N={n}")
    if combine not in (COMBINE_NONE, COMBINE_SET, COMBINE_ADD):
        raise ValueError(f"unknown combine mode {combine}")
    z = torch.empty_like(y) if want_next else y
    amax = torch.zeros(d, dtype=torch.float32, device=y.device)
    lib = _k9_lib()
    code = lib.chain_sweep_tanh(y.data_ptr(), s_in.data_ptr(), post.data_ptr(), pre.data_ptr(),
                                c.data_ptr(), h_out.data_ptr(), z.data_ptr(), amax.data_ptr(),
                                d, n, combine, int(want_next),
                                torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, _K9, code)
    chain_sweep_tanh.launches += 1
    return (z, amax) if want_next else (None, None)


chain_sweep_tanh.launches = 0


def chain_sweep_tanh_inject_plain(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                                  pre: torch.Tensor, g: torch.Tensor, h: torch.Tensor | None,
                                  inject: bool, want_next: bool):
    """Plain version of K10 for one side of one backward sweep of the
    tanh chain, [d, N] layout: store = post ⊙ (y ⊙ s_in), g + store when
    ``inject``. With ``want_next`` returns (pre ⊙ ((1 − h²) ⊙ store),
    its per-feature amax), h the forward's tanh output of the layer
    the next sweep differentiates; else (store, None) and h is not
    read. g is read only."""
    store = post[None, :] * (y * s_in[:, None])
    if inject:
        store = g + store
    if not want_next:
        return store, None
    z = pre[None, :] * ((1.0 - h * h) * store)
    return z, z.abs().amax(dim=1)


def chain_sweep_tanh_inject(y: torch.Tensor, s_in: torch.Tensor, post: torch.Tensor,
                            pre: torch.Tensor, g: torch.Tensor, h: torch.Tensor | None,
                            inject: bool, want_next: bool):
    """K10 wrapper (see `chain_sweep_tanh_inject_plain`). CPU tensors
    take the plain version; CUDA tensors launch
    csrc/chain_sweep_tanh.cu `chain_sweep_tanh_inject` or raise."""
    if y.device.type == "cpu":
        return chain_sweep_tanh_inject_plain(y, s_in, post, pre, g, h, inject, want_next)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    d, n = y.shape
    checks = [("y", y, (d, n)), ("g", g, (d, n)), ("s_in", s_in, (d,)), ("post", post, (n,)),
              ("pre", pre, (n,))]
    if want_next:
        checks.append(("h", h, (d, n)))
    for name, t, shape in checks:
        fusedmm._check_operand(name, t, torch.float32, shape, y.device)
    if n % 4:
        raise ValueError(f"chain_sweep_tanh_inject takes N % 4 == 0, got N={n}")
    out = torch.empty_like(y)
    amax = torch.zeros(d, dtype=torch.float32, device=y.device)
    lib = _k9_lib()
    code = lib.chain_sweep_tanh_inject(y.data_ptr(), s_in.data_ptr(), post.data_ptr(),
                                       pre.data_ptr(), g.data_ptr(),
                                       (h if want_next else y).data_ptr(), out.data_ptr(),
                                       amax.data_ptr(), d, n, int(bool(inject)), int(want_next),
                                       torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, _K9, code)
    chain_sweep_tanh_inject.launches += 1
    return out, (amax if want_next else None)


chain_sweep_tanh_inject.launches = 0


_PLAIN_DUALS = {"int8": fusedmm.fused_adj_matmul_int8_t_plain,
                "int4": fusedmm.fused_adj_matmul_int4_t_plain}
_DUALS = {"int8": fusedmm.fused_adj_matmul_int8_t, "int4": fusedmm.fused_adj_matmul_int4_t}


def _quantized(quantize: Callable, quant: str, m: torch.Tensor, xu, au, xi, ai) -> tuple:
    """(qu, su, qi, si) of a sweep's inputs: (z, amax) through
    ``quantize`` (K3 or its plain version), (q, s) as given, a zero input
    (None) as int8 zeros with scale 1: what the chain computed between
    sweeps before the turn-in rounded its inputs."""
    if xu is None and xi is None:
        raise ValueError("a sweep takes an input on at least one side")
    d = (xu if xu is not None else xi).shape[0]
    out = ()
    for x, a, n in ((xu, au, m.shape[0]), (xi, ai, m.shape[1] * (2 if quant == "int4" else 1))):
        if x is None:
            out += (torch.zeros((d, n), dtype=torch.int8, device=m.device),
                    torch.ones((d, 1), dtype=torch.float32, device=m.device))
        elif fusedmm.sweep_input_mode(x) == fusedmm.INPUT_Q:
            out += (x, a.reshape(d, 1))
        else:
            out += quantize(x, a)
    return out


class DualSweep:
    """One sweep of the quantized chain: the dual product of the
    quantized inputs with one chain epilogue on each side that runs, in
    the dual's turn-out (``csrc/dual_turns.cuh``), its inputs rounded in
    the dual's turn-in, equal bit for bit to `plain`: K3's plain version
    on each side's (z, amax), the plain dual (K1's, or K5's on the packed
    matrix when ``quant`` is 'int4'), then the epilogue's plain version
    on each side. One instance per epilogue: `dual_sweep` (K2's),
    `dual_sweep_inject` (K2's inject mode), `dual_sweep_tanh` (K9's),
    `dual_sweep_tanh_inject` (K10's).

    Called with (quant, m, xu, au, xi, ai, post, pre, ext, flag,
    want_next, hs=(None, None), sides=(True, True)). Each side's input
    (x, a) is the previous sweep's float32 z [d, N] with its amax [d]
    (the chain's sweeps), int8 q with its scale [d, 1] (K3's output: the
    route the fold replaced, `separate`), or (None, None), a zero input
    (q = 0, scale 1; EGCF's seed sweeps). yu = M @ qi dequantizes by the
    item input's scale, yi by the user input's. post, pre, ext and hs
    are (user side, item side) pairs: ext the combine c (forward
    epilogues, updated in place) or the cotangent g (inject epilogues,
    read only); hs the tanh chain's h slices (K9: written; K10: read
    where a next input is wanted). ``flag``: the combine mode or whether
    g is added, both sides alike. ``want_next``: one bool, or a (user,
    item) pair (EGCF's backward seed sweep K − 1 wants the users' next
    input alone). ``sides``: the sides that run (EGCF's forward seed
    sweep runs the users alone, the backward's sweep K the items); both
    inputs are read all the same. Returns (out_u, amax_u, out_i, amax_i)
    as the epilogue returns them, Nones for a side not run.

    CPU tensors take `plain`; CUDA tensors launch K1 or K5 with the
    rounding in its turn-in and the epilogue in its turn-out, three
    device launches and no K3 or epilogue launch, or raise. A launch
    adds one to the dual's count (``fused_adj_matmul_int8_t.launches``
    or ``_int4_t``) and to ``launches``, the number of sides it ran to
    ``sides_run``, the count of the standalone epilogue's launches it
    stands for, and the number of (z, amax) inputs it rounded to
    ``quantized_in_sweep``, the count of K3 launches it stands for."""

    def __init__(self, name: str, mode: int, side_plain: Callable):
        self.__name__ = name
        self.mode = mode
        self.side_plain = side_plain
        self.launches = 0
        self.sides_run = 0
        self.quantized_in_sweep = 0

    def plain(self, quant: str, m: torch.Tensor, xu, au, xi, ai, post: tuple, pre: tuple,
              ext: tuple, flag: int, want_next, hs: tuple = (None, None),
              sides: tuple = (True, True)):
        qu, su, qi, si = _quantized(propagate.quantize_rows_plain, quant, m, xu, au, xi, ai)
        yu, yi = _PLAIN_DUALS[quant](m, qu, qi)
        nexts = want_next if isinstance(want_next, tuple) else (want_next, want_next)
        tanh = self.mode in (fusedmm.SWEEP_TANH, fusedmm.SWEEP_TANH_INJECT)
        out = ()
        for k, (y, s_) in enumerate(((yu, si), (yi, su))):
            h = (hs[k],) if tanh else ()
            out += (self.side_plain(y, s_[:, 0], post[k], pre[k], ext[k], *h, flag, nexts[k])
                    if sides[k] else (None, None))
        return out

    def separate(self, quant: str, m: torch.Tensor, xu, au, xi, ai, *args, **kwargs):
        """The route the turn-in's rounding replaced: K3
        (`propagate.quantize_rows`) on each (z, amax) input and int8
        zeros with scale 1 for a zero input, then this sweep on (q, s).
        The reference the fold is held to, bit for bit."""
        return self(quant, m, *_quantized(propagate.quantize_rows, quant, m, xu, au, xi, ai),
                    *args, **kwargs)

    def __call__(self, quant: str, m: torch.Tensor, xu, au, xi, ai, post: tuple, pre: tuple,
                 ext: tuple, flag: int, want_next, hs: tuple = (None, None),
                 sides: tuple = (True, True)):
        if m.device.type == "cpu":
            return self.plain(quant, m, xu, au, xi, ai, post, pre, ext, flag, want_next, hs,
                              sides)
        if m.device.type != "cuda":
            raise ValueError(f"unsupported device {m.device}")
        if (self.mode in (fusedmm.SWEEP_FORWARD, fusedmm.SWEEP_TANH)
                and flag not in (COMBINE_NONE, COMBINE_SET, COMBINE_ADD)):
            raise ValueError(f"unknown combine mode {flag}")
        if xu is None and xi is None:
            raise ValueError("a sweep takes an input on at least one side")
        nexts = want_next if isinstance(want_next, tuple) else (want_next, want_next)
        out = fusedmm.launch_sweep_t(quant, m, (xu, au), (xi, ai), post, pre, ext, self.mode,
                                     flag, nexts, hs, sides)
        _DUALS[quant].launches += 1
        self.launches += 1
        self.sides_run += sum(map(bool, sides))
        self.quantized_in_sweep += sum(fusedmm.sweep_input_mode(x) == fusedmm.INPUT_Z
                                       for x in (xu, xi))
        return out


dual_sweep = DualSweep("dual_sweep", fusedmm.SWEEP_FORWARD, chain_sweep_epilogue_plain)
dual_sweep_inject = DualSweep("dual_sweep_inject", fusedmm.SWEEP_INJECT, chain_sweep_inject_plain)
dual_sweep_tanh = DualSweep("dual_sweep_tanh", fusedmm.SWEEP_TANH, chain_sweep_tanh_plain)
dual_sweep_tanh_inject = DualSweep("dual_sweep_tanh_inject", fusedmm.SWEEP_TANH_INJECT,
                                   chain_sweep_tanh_inject_plain)
# the linear chain's plain sweeps under the names their callers use
dual_sweep_plain, dual_sweep_inject_plain = dual_sweep.plain, dual_sweep_inject.plain


class ChainOps(NamedTuple):
    """The per-sweep operations of the chain: the sweeps (the dual with
    its inputs rounded in the turn-in and the epilogue of K2, forward and
    inject, or of K9 / K10 for the tanh chain, in the turn-out), and the
    standalone epilogues of the prologues (K2's; K10's for the tanh
    chain's backward)."""

    sweep: Callable
    sweep_inject: Callable
    sweep_tanh: Callable
    sweep_tanh_inject: Callable
    epilogue: Callable
    tanh_inject: Callable


KERNELS = ChainOps(dual_sweep, dual_sweep_inject, dual_sweep_tanh, dual_sweep_tanh_inject,
                   chain_sweep_epilogue, chain_sweep_tanh_inject)
PLAIN = ChainOps(dual_sweep.plain, dual_sweep_inject.plain, dual_sweep_tanh.plain,
                 dual_sweep_tanh_inject.plain, chain_sweep_epilogue_plain,
                 chain_sweep_tanh_inject_plain)


def supports_chain_resident(adj, d: int, num_layers: int, reduce: str | None,
                            activation, include_layer0: bool = True,
                            seed: bool = False) -> bool:
    """Whether `fused_chain_resident` can run this chain: the int8 or
    int4 fused backend, no self-loop diag, a reduce mode, at least one
    layer, and an activation of None or `torch.tanh`; a tanh chain (and
    the seed, which needs one) excludes layer 0 (the JAX rules). The
    TPU's VMEM budget and mesh checks have no counterpart here."""
    if not isinstance(adj, propagate.FusedSquareAdj) or adj.quant not in _DUALS:
        return False
    if num_layers < 1 or reduce not in ("mean", "sum"):
        return False
    if activation is not None and activation is not torch.tanh:
        return False
    if (activation is not None or seed) and include_layer0:
        return False
    if (seed and activation is None) or adj.has_diag:
        return False
    return propagate.supports_chain_t(adj, d)


def _vectors(adj, u_pad: int, i_pad: int):
    pad = propagate._pad_cols
    return (pad(adj.right_u, u_pad).contiguous(), pad(adj.right_i, i_pad).contiguous(),
            pad(adj.left_u, u_pad).contiguous(), pad(adj.left_i, i_pad).contiguous())


def _run_chain(adj, xu: torch.Tensor, xi: torch.Tensor, num_layers: int,
               include_layer0: bool, ops: ChainOps) -> tuple[torch.Tensor, torch.Tensor]:
    """The combine (cu [d, U_pad], ci [d, I_pad]) of the forward chain
    from h0 = (xu, xi)."""
    u_pad, i_pad = adj.padded_shape
    d = xu.shape[0]
    ru, ri, lu, li = _vectors(adj, u_pad, i_pad)
    dev = xu.device
    ones_d = torch.ones(d, dtype=torch.float32, device=dev)
    # prologue: c = h0 (when layer 0 is a combine term), z = r ⊙ h0
    first = COMBINE_SET if include_layer0 else COMBINE_NONE
    cu = torch.empty_like(xu)
    ci = torch.empty_like(xi)
    zu, amax_u = ops.epilogue(xu, ones_d, torch.ones(u_pad, device=dev), ru, cu, first, True)
    zi, amax_i = ops.epilogue(xi, ones_d, torch.ones(i_pad, device=dev), ri, ci, first, True)
    for k in range(num_layers):
        combine = COMBINE_ADD if (include_layer0 or k > 0) else COMBINE_SET
        more = k < num_layers - 1
        zu, amax_u, zi, amax_i = ops.sweep(adj.quant, adj.m8, zu, amax_u, zi, amax_i, (lu, li),
                                           (ru, ri), (cu, ci), combine, more)
    return cu, ci


def _run_chain_bwd(adj, gu: torch.Tensor, gi: torch.Tensor, num_layers: int,
                   include_layer0: bool, ops: ChainOps) -> tuple[torch.Tensor, torch.Tensor]:
    """The cotangent (Gu [d, U_pad], Gi [d, I_pad]) of h0 from the
    combine's cotangent g = (gu, gi): the forward chain with (pre, post)
    bound to (l, r), the cotangent injected after each sweep that
    produces a combine term. The last sweep injects only when layer 0 is
    a combine term, and its store is the result (no extra add of g)."""
    u_pad, i_pad = adj.padded_shape
    d = gu.shape[0]
    ru, ri, lu, li = _vectors(adj, u_pad, i_pad)
    dev = gu.device
    ones_d = torch.ones(d, dtype=torch.float32, device=dev)
    # prologue: z = l ⊙ g and its amax (multiplication by one is exact)
    zu, amax_u = ops.epilogue(gu, ones_d, torch.ones(u_pad, device=dev), lu, gu,
                              COMBINE_NONE, True)
    zi, amax_i = ops.epilogue(gi, ones_d, torch.ones(i_pad, device=dev), li, gi,
                              COMBINE_NONE, True)
    for k in range(num_layers):
        more = k < num_layers - 1
        zu, amax_u, zi, amax_i = ops.sweep_inject(adj.quant, adj.m8, zu, amax_u, zi, amax_i,
                                                  (ru, ri), (lu, li), (gu, gi),
                                                  include_layer0 or more, more)
    return zu, zi


class _ChainT(torch.autograd.Function):
    """The chain's combine in [d, nu + ni] layout with the
    straight-through quantized backward. Saves nothing of the forward:
    the backward needs the adjacency alone."""

    @staticmethod
    def forward(ctx, embT, adj, num_layers, include_layer0, reduce, ops):
        ctx.chain = (adj, num_layers, include_layer0, reduce, ops)
        nu, ni = adj.num_users, adj.num_items
        u_pad, i_pad = adj.padded_shape
        xu = propagate._pad_cols(embT[:, :nu], u_pad).contiguous()
        xi = propagate._pad_cols(embT[:, nu:], i_pad).contiguous()
        cu, ci = _run_chain(adj, xu, xi, num_layers, include_layer0, ops)
        if reduce == "mean":
            # divide, not multiply by the reciprocal: the JAX chain's rounding
            n_terms = float(num_layers + (1 if include_layer0 else 0))
            cu, ci = propagate.true_divide(cu, n_terms), propagate.true_divide(ci, n_terms)
        return torch.cat([cu[:, :nu], ci[:, :ni]], dim=1)

    @staticmethod
    def backward(ctx, gT):
        adj, num_layers, include_layer0, reduce, ops = ctx.chain
        nu, ni = adj.num_users, adj.num_items
        u_pad, i_pad = adj.padded_shape
        gT = gT.to(torch.float32)
        if reduce == "mean":
            n_terms = float(num_layers + (1 if include_layer0 else 0))
            gT = propagate.true_divide(gT, n_terms)
        # the cotangent arrives as a transposed or expanded view: the
        # kernels take contiguous rows
        gu = propagate._pad_cols(gT[:, :nu], u_pad).contiguous()
        gi = propagate._pad_cols(gT[:, nu:], i_pad).contiguous()
        Gu, Gi = _run_chain_bwd(adj, gu, gi, num_layers, include_layer0, ops)
        return torch.cat([Gu[:, :nu], Gi[:, :ni]], dim=1), None, None, None, None, None


def _run_chain_act(adj, xu: torch.Tensor, xi: torch.Tensor, num_layers: int, seed: bool,
                   ops: ChainOps):
    """The tanh chain's forward from h0 = (xu, xi): the combine (cu, ci)
    of the counted layers and the h streams (hs_u [n_sweeps, d, U_pad],
    hs_i [n_sweeps, d, I_pad]; slice k is sweep k's tanh output).

    With ``seed``, sweep 0 consumes a zero user input (q = 0, scale 1)
    and discards its item direction (hs_i[0] is never written), and
    sweep 1 reuses its item input: the same (z, amax) rounds to the same
    integers."""
    u_pad, i_pad = adj.padded_shape
    d = xu.shape[0]
    ru, ri, lu, li = _vectors(adj, u_pad, i_pad)
    dev = xu.device
    first = 1 if seed else 0  # the sweep of the first counted layer
    n_sweeps = num_layers + first
    hs_u = torch.empty((n_sweeps, d, u_pad), dtype=torch.float32, device=dev)
    hs_i = torch.empty((n_sweeps, d, i_pad), dtype=torch.float32, device=dev)
    cu, ci = torch.empty_like(xu), torch.empty_like(xi)
    ones_d = torch.ones(d, dtype=torch.float32, device=dev)
    # prologue: z = r ⊙ h0 (multiplication by one is exact)
    zi, amax_i = ops.epilogue(xi, ones_d, torch.ones(i_pad, device=dev), ri, ci,
                              COMBINE_NONE, True)
    if seed:
        zu = amax_u = None  # a zero input
    else:
        zu, amax_u = ops.epilogue(xu, ones_d, torch.ones(u_pad, device=dev), ru, cu,
                                  COMBINE_NONE, True)
    for k in range(n_sweeps):
        combine = (COMBINE_NONE, COMBINE_SET, COMBINE_ADD)[(k >= first) + (k > first)]
        more = k < n_sweeps - 1
        seed_sweep = seed and k == 0
        zu, amax_u, zi_k, amax_i_k = ops.sweep_tanh(adj.quant, adj.m8, zu, amax_u, zi, amax_i,
                                                    (lu, li), (ru, ri), (cu, ci), combine, more,
                                                    (hs_u[k], hs_i[k]), (True, not seed_sweep))
        if not seed_sweep:
            # the seed sweep keeps its user direction alone: sweep 1 takes
            # the seed's item input again
            zi, amax_i = zi_k, amax_i_k
    return cu, ci, hs_u, hs_i


def _run_chain_act_bwd(adj, gu: torch.Tensor, gi: torch.Tensor, hs_u: torch.Tensor,
                       hs_i: torch.Tensor, num_layers: int, seed: bool, ops: ChainOps):
    """The tanh chain's backward: the cotangent (Gu, Gi) of h0 from the
    combine's cotangent g = (gu, gi) and the forward's h streams.

    Sweep t yields G of layer K−1−t, injecting g for every counted
    layer (k ≥ 1), and prepares l ⊙ ((1 − h²) ⊙ G) with h read from the
    stream (slice K−1−t with the seed sweep, K−2−t without). With
    ``seed``, sweep K−1 yields G₀ without inject: its user side goes on
    through hu_seed's derivative (slice 0), its item side is parked; the
    appended seed sweep maps the users back to the items,
    dE_i = G₀_i + r_i ⊙ dequant(Mᵀ q(z_u)), and the user direction is
    zero (the seed consumed a zero user input)."""
    u_pad, i_pad = adj.padded_shape
    d = gu.shape[0]
    ru, ri, lu, li = _vectors(adj, u_pad, i_pad)
    dev = gu.device
    n_sweeps = num_layers + (1 if seed else 0)
    last = n_sweeps - 1
    ones_d = torch.ones(d, dtype=torch.float32, device=dev)
    # prologue: z = l ⊙ ((1 − h_K²) ⊙ g), h_K the forward's last slice
    zu, amax_u = ops.tanh_inject(gu, ones_d, torch.ones(u_pad, device=dev), lu, gu,
                                 hs_u[last], False, True)
    zi, amax_i = ops.tanh_inject(gi, ones_d, torch.ones(i_pad, device=dev), li, gi,
                                 hs_i[last], False, True)
    for k in range(n_sweeps):
        if seed and k == last:
            # the seed sweep's user direction is discarded: a zero item input
            zi = amax_i = None
        args = (adj.quant, adj.m8, zu, amax_u, zi, amax_i, (ru, ri), (lu, li))
        if not seed or k < num_layers - 1:
            more = k < last
            hidx = num_layers - (1 if seed else 2) - k
            h = (hs_u[hidx], hs_i[hidx]) if more else (None, None)
            zu, amax_u, zi, amax_i = ops.sweep_tanh_inject(*args, (gu, gi), more, more, h)
        elif k == num_layers - 1:
            # G₀: the users go on through hu_seed's derivative, the items' is parked
            zu, amax_u, g0_i, _ = ops.sweep_tanh_inject(*args, (gu, gi), False, (True, False),
                                                        (hs_u[0], None))
        else:
            _, _, zi, _ = ops.sweep_tanh_inject(*args, (None, g0_i), True, False, (None, None),
                                                (False, True))
            zu = torch.zeros_like(gu)
    return zu, zi


class _ChainActT(torch.autograd.Function):
    """The tanh chain's combine in [d, nu + ni] layout with the
    straight-through quantized backward. Saves the forward's h streams,
    which the backward's tanh derivatives read."""

    @staticmethod
    def forward(ctx, embT, adj, num_layers, reduce, seed, ops):
        nu, ni = adj.num_users, adj.num_items
        u_pad, i_pad = adj.padded_shape
        xu = propagate._pad_cols(embT[:, :nu], u_pad).contiguous()
        xi = propagate._pad_cols(embT[:, nu:], i_pad).contiguous()
        cu, ci, hs_u, hs_i = _run_chain_act(adj, xu, xi, num_layers, seed, ops)
        ctx.chain = (adj, num_layers, reduce, seed, ops)
        ctx.hs = (hs_u, hs_i)
        if reduce == "mean":
            cu = propagate.true_divide(cu, float(num_layers))
            ci = propagate.true_divide(ci, float(num_layers))
        return torch.cat([cu[:, :nu], ci[:, :ni]], dim=1)

    @staticmethod
    def backward(ctx, gT):
        adj, num_layers, reduce, seed, ops = ctx.chain
        nu, ni = adj.num_users, adj.num_items
        u_pad, i_pad = adj.padded_shape
        gT = gT.to(torch.float32)
        if reduce == "mean":
            gT = propagate.true_divide(gT, float(num_layers))
        gu = propagate._pad_cols(gT[:, :nu], u_pad).contiguous()
        gi = propagate._pad_cols(gT[:, nu:], i_pad).contiguous()
        Gu, Gi = _run_chain_act_bwd(adj, gu, gi, *ctx.hs, num_layers, seed, ops)
        return torch.cat([Gu[:, :nu], Gi[:, :ni]], dim=1), None, None, None, None, None


def _chain(adj, emb0: torch.Tensor, num_layers: int, include_layer0: bool,
           reduce: str, ops: ChainOps, activation=None, seed: bool = False) -> torch.Tensor:
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    embT = emb0.to(torch.float32).T
    if activation is None and not seed:
        outT = _ChainT.apply(embT, adj, num_layers, include_layer0, reduce, ops)
    elif activation is not torch.tanh or include_layer0:
        raise ValueError("the activation chain takes torch.tanh without layer 0 "
                         "(the seed needs it too)")
    else:
        outT = _ChainActT.apply(embT, adj, num_layers, reduce, seed, ops)
    return outT.T.contiguous().to(emb0.dtype)


def fused_chain_resident(adj, emb0: torch.Tensor, num_layers: int,
                         include_layer0: bool = True, reduce: str = "mean", activation=None,
                         seed_users_from_items: bool = False) -> torch.Tensor:
    """The K-layer chain's layer combine, [N, d], through kernels K1 or
    K5 with K3's rounding in their turn-in and K2 in their turn-out, and
    K2 for the prologue (drop-in for `propagate.fused_chain_t` in reduce
    modes).
    ``activation`` None or `torch.tanh` (K9's and K10's epilogues then
    take K2's place in the turn-out, K10 the backward's prologue);
    ``seed_users_from_items`` is EGCF's parallel-mode seeding
    and needs tanh and ``include_layer0=False``. Differentiable in
    ``emb0``: the backward is the straight-through quantized chain
    through the same kernels."""
    return _chain(adj, emb0, num_layers, include_layer0, reduce, KERNELS, activation,
                  seed_users_from_items)


def fused_chain_resident_plain(adj, emb0: torch.Tensor, num_layers: int,
                               include_layer0: bool = True, reduce: str = "mean",
                               activation=None, seed_users_from_items: bool = False
                               ) -> torch.Tensor:
    """`fused_chain_resident` through the kernels' plain versions, on
    any device: the reference chain, and the reference gradient."""
    return _chain(adj, emb0, num_layers, include_layer0, reduce, PLAIN, activation,
                  seed_users_from_items)
