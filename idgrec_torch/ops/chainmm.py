"""Whole-chain quantized propagation (counterpart of
idgrec_tpu/ops/chainmm.py, no activation), forward and backward.

The TPU ran the K-layer chain as one Pallas kernel whose state (int8
activations, scales, dual accumulators, layer combine; ~52 MB at
yelp2018 scale) stayed in VMEM across sweeps. No such memory exists on
the H100, so the chain here is a short sequence of launches per sweep,
each a hand-written kernel:

    K3 quantize_rows (ops/propagate.py)   z -> int8 q, per-feature scale
    K1 dual_int8_t   (ops/fusedmm.py)     one read of M, both directions
       (K5 dual_int4_t when the adjacency is nibble-packed: the chain's
       int4 mode, the same activations and the same integer products)
    K2 chain_sweep_epilogue (this module) dequantize, normalize, combine,
                                          next input and its amax

Forward layer: h_{k+1} = l ⊙ dequant(M̂_dual(quant(r ⊙ h_k))), c += h_{k+1}.
The f32 work keeps the TPU kernel's operation order (post * (raw * s),
running combine, mean by division), so the result agrees with the JAX
per-sweep chain to ulps, and a rounding tie may move one quantized
activation by 1 lsb (tests/test_torch_propagate.py holds both bars).
`fused_chain_resident_plain` runs the same chain through the three
kernels' plain versions: it is the reference the tests and
chip_smoke.py hold the kernel chain to.

The backward is straight-through and fully quantized, as the TPU
kernel's mode 'bwd': the cotangent g of the combine runs the same chain
with the normalization vectors swapped,

    G_k = g + r ⊙ dequant(M̂_dual(quant(l ⊙ G_{k+1}))),

through K3, K1 and K2's inject mode (`chain_sweep_inject`), and needs
nothing of the forward but the adjacency. Both chains are one
`torch.autograd.Function`, so the plain chain's gradient is the
reference of the kernel chain's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping, NamedTuple

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


class ChainOps(NamedTuple):
    """The per-sweep operations of the chain; the dual by the
    adjacency's ``quant``."""

    dual: Mapping[str, Callable]
    quantize: Callable
    epilogue: Callable
    inject: Callable


KERNELS = ChainOps({"int8": fusedmm.fused_adj_matmul_int8_t,
                    "int4": fusedmm.fused_adj_matmul_int4_t},
                   propagate.quantize_rows, chain_sweep_epilogue, chain_sweep_inject)
PLAIN = ChainOps({"int8": fusedmm.fused_adj_matmul_int8_t_plain,
                  "int4": fusedmm.fused_adj_matmul_int4_t_plain},
                 propagate.quantize_rows_plain, chain_sweep_epilogue_plain,
                 chain_sweep_inject_plain)


def supports_chain_resident(adj, d: int, num_layers: int, reduce: str | None,
                            activation, include_layer0: bool = True,
                            seed: bool = False) -> bool:
    """Whether `fused_chain_resident` can run this chain: the int8 or
    int4 fused backend, no self-loop diag, a reduce mode, at least one layer, and
    no activation or seed (the tanh chains are ROADMAP B.B4). The TPU's
    VMEM budget and mesh checks have no counterpart here."""
    if not isinstance(adj, propagate.FusedSquareAdj) or adj.quant not in KERNELS.dual:
        return False
    if num_layers < 1 or reduce not in ("mean", "sum"):
        return False
    if activation is not None or seed or adj.has_diag:
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
        qu, su = ops.quantize(zu, amax_u)
        qi, si = ops.quantize(zi, amax_i)
        yu, yi = ops.dual[adj.quant](adj.m8, qu, qi)
        combine = COMBINE_ADD if (include_layer0 or k > 0) else COMBINE_SET
        more = k < num_layers - 1
        # yu = M @ qi dequantizes by the item input's scale, yi by the user's
        zu, amax_u = ops.epilogue(yu, si[:, 0], lu, ru, cu, combine, more)
        zi, amax_i = ops.epilogue(yi, su[:, 0], li, ri, ci, combine, more)
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
        qu, su = ops.quantize(zu, amax_u)
        qi, si = ops.quantize(zi, amax_i)
        yu, yi = ops.dual[adj.quant](adj.m8, qu, qi)
        more = k < num_layers - 1
        inject = include_layer0 or more
        zu, amax_u = ops.inject(yu, si[:, 0], ru, lu, gu, inject, more)
        zi, amax_i = ops.inject(yi, su[:, 0], ri, li, gi, inject, more)
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


def _chain(adj, emb0: torch.Tensor, num_layers: int, include_layer0: bool,
           reduce: str, ops: ChainOps) -> torch.Tensor:
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    embT = emb0.to(torch.float32).T
    outT = _ChainT.apply(embT, adj, num_layers, include_layer0, reduce, ops)
    return outT.T.contiguous().to(emb0.dtype)


def fused_chain_resident(adj, emb0: torch.Tensor, num_layers: int,
                         include_layer0: bool = True, reduce: str = "mean") -> torch.Tensor:
    """The K-layer chain's layer combine, [N, d], through kernels K1-K3
    (drop-in for `propagate.fused_chain_t` in reduce modes).
    Differentiable in ``emb0``: the backward is the straight-through
    quantized chain through the same kernels."""
    return _chain(adj, emb0, num_layers, include_layer0, reduce, KERNELS)


def fused_chain_resident_plain(adj, emb0: torch.Tensor, num_layers: int,
                               include_layer0: bool = True,
                               reduce: str = "mean") -> torch.Tensor:
    """`fused_chain_resident` through the kernels' plain versions, on
    any device: the reference chain, and the reference gradient."""
    return _chain(adj, emb0, num_layers, include_layer0, reduce, PLAIN)
