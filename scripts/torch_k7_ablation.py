#!/usr/bin/env python3
"""Where kernels K7 (idgrec_torch/csrc/dual_int8_n.cu), K1
(csrc/dual_int8_t.cu), K5 (csrc/dual_int4_t.cu), K8 (csrc/dual_int4_n.cu),
K6 (csrc/dual_bf16.cu), K11 (csrc/bit_matmul.cu) and K12/K13
(csrc/gather_rows_matmul.cu) spend their time, and where kernel K4's time
goes (idgrec_torch/csrc/scatter_add_rows.cu), on one NVIDIA GPU.

    python3 scripts/torch_k7_ablation.py [--root DIR] [--skip-k7] [--skip-k1]
                                         [--skip-k5] [--skip-k8] [--skip-k4]
                                         [--skip-k6] [--skip-k11] [--skip-sweep]
                                         [--skip-k12] [--k12-quick]

``--root`` names the tree whose ``idgrec_torch`` is measured (default:
this one), so a checkout of an earlier commit can be measured with the
same script.

K7: each variant is the kernel source with one text patch applied, built
with the port's nvcc flags into idgrec_torch/_build/ablation/ (all nvcc
processes started together); the variants follow the kernel found: the
tile kernel (mma.sync on 64 x 256 stages of M) of commit d8c1be8 and
earlier, measured with ``--root`` pointed at such a checkout, or the
scan kernel that replaced it. Only the full variant computes the right
sums; the others exist to be timed. All run on the yelp2018-scale int8
matrix of chip_smoke.py with random int8 activations, at d = 64 and
d = 128, the outputs zeroed before every launch as the wrapper does.
A patch whose anchor text is missing from the source fails the run.
ptxas's registers, shared memory and spills of the full variant are
printed. The scan's body lives in ``csrc/dual_scan.cuh``, which K1, K5,
K7 and K8 include, and K1's and K5's turns in ``csrc/dual_turns.cuh``: a
variant's source has the headers pasted in, so a patch reaches them.

K1 (the scan with the layout turned at both edges, three launches), at
d = 64 on the same matrix with random [d, N] activations: the full call,
the entries' work taken out (the stream of M alone, turns kept), each
turn taken out, the scan launch alone, the stream alone, and the two
turns alone; K5 (the same turns around the scan of the nibble-packed
matrix) the same variants on the packed matrix. K8 (the scan on the
nibble-packed matrix) at d = 64 and d = 128: the full call and the
stream alone. On a tree whose K1, K5 or K8 is the tile kernel (K1 and
K8: commit 2d94ae4 and earlier; K5: commit 438eec0 and earlier) those
variants are skipped. For every tree: the wrappers of K1, K5, K7 and K8
timed, and the device launches of one call of each counted with
torch.profiler (kernels and memsets, the wrapper's allocations and fills
included).

The chain's sweep (K1 with K2's epilogue in its turn-out,
``dual_int8_t_sweep``; trees after commit 438eec0) at d = 64, forward
with the combine added and a next input, through the library call: the
full sweep and its raw dual (``dual_int8_t``) beside it, the per-tile
maxima sent straight to the amax (no K2-block maxima, no last block),
the maxima not sent, the last block's pass out, and the combine's reads
out. The full variant is held to `chainmm.dual_sweep_plain` bit for bit.
On a tree whose turn-out has the tanh chain's modes (K9's and K10's
epilogues; the sweep's C call takes per-side next inputs, h slices and
sides), each tanh variant is timed forward (the combine added,
a next input) and inject (the cotangent injected, a next input): the
full sweep beside its raw dual, tanhf taken out, the h slice's writes
(forward) or reads (inject) taken out, the combine's or cotangent's
reads taken out, and the maxima sent straight to the amax. The full
variant is held to `chainmm.dual_sweep_tanh.plain` and
`dual_sweep_tanh_inject.plain` bit for bit. On a tree whose turn-in
rounds the previous sweep's float32 z (the sweep's C call takes each
side's input mode), the linear forward sweep on (z, amax) is timed
beside the same library's sweep on (q, s) (the bare sweep) and K3 twice
followed by it, with the whole turn-in taken out (its q left in the
scratch by the full variant) or the rounding's division made a product
with the reciprocal. No variant changes q's values: the scan's time
depends on them (q = -1 everywhere took 0.05 ms off a sweep on an H100). The full variant is held to
`chainmm.dual_sweep.plain` on (z, amax) bit for bit.

K6 and K11: each variant's library is loaded in place of the tree's own
and timed through the tree's wrapper (its allocations and launches
included), on the yelp2018-scale matrix with random float32 activations
(K6 at d = 64 and 128; K11 both directions at d = 64, per application).
The variants follow the source found: K6's tile kernel (mma.sync on
64 x 256 stages, zero-tile votes; commit f93bb61 and earlier) or its scan
in 64-bit fixed point; K11's tile kernel (every bit multiplied on the
tensor cores; commit f93bb61 and earlier) or its scan of the packed row
groups. The full variant is held to the plain version within rtol 3e-5,
atol 3e-6 of the largest sum. The device launches of one call of each
wrapper are counted last, with the tree's own libraries.

K12 and K13: each variant's library loaded in place of the tree's and
timed through the wrappers, at chip_smoke.py's step rows (one sampled
batch: 2,048 user rows of M, 4,096 item rows of Mᵀ, repeats kept),
random z and g at d = 64, bf16 and float32, each time one step's two
calls under CUDA events and as a CUDA graph's replay, the smaller of two
passes in turns. The variants follow the source found: the tile kernel of
commit 327ceb4 and earlier (measured with ``--root``; its products, the
counts' conversion, z / g or M loads, the share sum taken out, other
rings and row blocks, other column splits) or the design that replaced
it (its products, votes, conversion, z / g or M loads, all compute, the
share sums, the partials or K13's epilogue taken out, other rings,
geometries and numbers of K12's producer warps, half and twice the plan's
split). The full variant is held
to the plain version within rtol 3e-5, atol 3e-6 of the largest sum and
to itself bit for bit. Beside them: the tree's kernels on the rows
sorted and on the first B rows, a stream probe (plain 16-byte loads of
the same rows by run length, in the stages' order), ``index_select`` of
the rows, the device launches of a call and the device time by kernel
(profiled last). ``--k12-quick`` keeps the tree's kernels and the
yardsticks.

K4: the step's two tables (2,048 sampled user rows into [31,668, 64],
4,096 item rows into [38,048, 64]) timed four ways under CUDA events:
the library call alone on preallocated buffers, the same launches
replayed from a CUDA graph (device time without the host), the wrapper
the training step calls (no range check; the tree before it had none,
and its public wrapper is timed with the check taken out) and the public
wrapper (with the range check), beside ``index_add_`` into a zeroed
table. Then K4 at SGL's drop-list lengths (`k4_sgl_lists`): one view's
dropped edges into the users and into the items, each on the list
sorted by its index and on the one sorted the other way: the generic
entry, and on the sorted lists the sorted-segment entry
(``segment_sum_rows``, the gather inside; z contiguous, strided, and
made contiguous first; its constants varied one at a time), beside
``index_add_``, timed and profiled by kernel name.

Prints one line per measurement, the card's name and power limit, and a
JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

YELP = (31_668, 38_048, 1_237_259, 324_147)
BATCH = 2048
WIDTHS = (64, 128)

_NEVER = ("__device__ __forceinline__ void add_never(int* dst, int v) {\n"
          "  if (v == 0x7ffffff1) atomicAdd(dst, v);\n}\n"
          "__device__ __forceinline__ void add_never(long long* dst, long long v) {\n"
          "  if (v == 0x7ffffff1) atomicAdd(reinterpret_cast<unsigned long long*>(dst),\n"
          "                                static_cast<unsigned long long>(v));\n}\n\n")

# name -> list of (regex, replacement); every regex must match.
# The tile kernel (mma.sync on 64 x 256 stages of M) of commit d8c1be8 and
# earlier, measured with --root:
TILE_VARIANTS = {
    "full": [],
    "no_yu_atomics": [(r"add_nonzero\((dst \+ f), ", r"add_never(\1, ")],
    "no_yi_atomics": [(r"add_nonzero\((dst[^,]*), acc_i", r"add_never(\1, acc_i")],
    "no_yu_mma": [(r"mma_s8\(acc_u\[mt\], a1, b0, b1\);", "acc_u[mt][0] ^= b0 ^ b1 ^ a1[0];")],
    "no_yi_mma": [(r"mma_s8\(acc_i\[mt\]\[nt\], a2\[mt\], b0, b1\);",
                   "acc_i[0][nt][0] ^= b0 ^ b1 ^ a2[mt][0];")],
    # the byte gathers of the M^T fragments and the products that use them
    "no_yi_gather_mma": [(r"const uint32_t b0 = column4\(mcol\);\s*"
                          r"const uint32_t b1 = column4\(mcol \+ 16 \* M_STRIDE\);\s*"
                          r"#pragma unroll\s*"
                          r"for \(int mt = 0; mt < MT; \+\+mt\) "
                          r"mma_s8\(acc_i\[mt\]\[nt\], a2\[mt\], b0, b1\);",
                          "acc_i[0][nt][0] ^= a2[0][0] + nt;")],
    # every tile's products, the votes gone (nothing reads them)
    "no_votes": [(r"if \(!\(\(tiles >> ks\) & 1u\)\) continue;", ""),
                 (r"if \(nz == 0\) continue;", ""),
                 (r"if \(!\(\(nz >> nt\) & 1u\)\) continue;", "")],
    "no_float_pass": [(r"int32_to_float_inplace<<<[^;]*;", "")],
    # the M stream, the activation loads and the barriers alone
    "stream_only": [(r"(const int r0 = \(c_begin \+ it\) \* CHUNK;)",
                     r"\1\n    if (r0 >= 0) continue;")],
}


# The scan's entries taken out: only the stream of M is left (the loop
# over a piece's entries is `bytes` in commit 2d94ae4, `bits` since)
_NO_ENTRIES = (r"while \((bytes|bits)\) \{", r"while (\1 && u < 0) {")

# The scan kernel (a warp per non-zero entry, int32 atomics):
SCAN_VARIANTS = {
    "full": [],
    "no_yu_atomics": [(r"add_nonzero\(yu_row", "add_never(yu_row")],
    "no_yi_atomics": [(r"add_nonzero\(yi_row", "add_never(yi_row")],
    # the activation rows not read: constants in their place
    "no_activation_loads": [(r"__ldg\(qi \+ static_cast<size_t>\(i\) \* d \+ f0 \+ lane \+ 32 \* k\)",
                             "(i + k)"),
                            (r"__ldg\(qu \+ static_cast<size_t>\(u\) \* d \+ f0 \+ lane \+ 32 \* k\)",
                             "(u + k)")],
    "no_float_pass": [(r"int32_to_float_inplace<<<[^;]*;", "")],
    # the scan of M alone: no entry is taken
    "scan_only": [_NO_ENTRIES],
}
# the full scan kernel at other settings: blocks an SM must hold (the
# register budget), pieces a thread has in flight, entries whose activation
# rows load together
for _b in (3, 4):
    SCAN_VARIANTS[f"min_blocks_{_b}"] = [(r"__launch_bounds__\(((?:SCAN_)?THREADS)(?:, \d)?\)\n",
                                          rf"__launch_bounds__(\1, {_b})\n")]
for _u in (2, 8):
    SCAN_VARIANTS[f"unroll_{_u}"] = [(r"constexpr int UNROLL = \d+;", f"constexpr int UNROLL = {_u};")]
SCAN_VARIANTS["batch_double"] = [(r"constexpr int BATCH = 8 / FPL;", "constexpr int BATCH = 16 / FPL;")]

# K1 and K5: the scan between the two layout turns (turn_in, then
# turn_out, a template on its mode since the turns moved to a header)
_NO_TURN_IN = (r"turn_in<<<[^;]*;", "")
_NO_TURN_OUT = (r"turn_out(?:<\w+>)?<<<[^;]*;", "")
K1_VARIANTS = {
    "full": [],
    "no_entries": [_NO_ENTRIES],
    "no_turn_in": [_NO_TURN_IN],
    "no_turn_out": [_NO_TURN_OUT],
    "scan_launch_alone": [_NO_TURN_IN, _NO_TURN_OUT],
    "stream_alone": [_NO_TURN_IN, _NO_TURN_OUT, _NO_ENTRIES],
    "turns_alone": [(r"err = launch_scan<\w+>\([^;]*;", "err = cudaSuccess;")],
}
# The chain's sweep: K1 with K2's epilogue in the turn-out
_SEND = r"tile_max\(m, sw\.block_max \+ k2_block \+ f, "
SWEEP_VARIANTS = {
    "full": [],
    "one_amax_target": [(_SEND, "tile_max(m, reinterpret_cast<int*>(sd.amax + f), "),
                        (r"finish_amax\(sw\);", ";")],
    "no_maxima": [(r"if \(lane == 0\) tile_max\([^;]*;", ";")],
    "no_finish": [(r"finish_amax\(sw\);", ";")],
    "no_combine_reads": [(r"ext\[k\]\[(\d)\] = sd\.ext\[[^;]*;", r"ext[k][\1] = 0.0f;")],
}
# The tanh chain's sweep (K9's and K10's epilogues in the same turn-out),
# each variant timed forward and inject
TANH_SWEEP_VARIANTS = {
    "full": [],
    "no_tanh": [(r"v = tanhf\(nh\);", "v = nh;")],
    "no_h_writes": [(r"sd\.hs\[e\] = v;", ";")],
    "no_h_reads": [(r"hv\[k\]\[(\d)\] = sd\.hs\[[^;]*;", r"hv[k][\1] = 0.5f;")],
    "no_ext_reads": SWEEP_VARIANTS["no_combine_reads"],
    "one_amax_target": SWEEP_VARIANTS["one_amax_target"],
}
# The sweep's turn-in rounding the previous sweep's z (K3's work), timed on
# (z, amax) inputs
# (z, amax) inputs. Only variants that leave q's values as they are: the
# scan's time depends on them. "no_turn_in" runs right after "full" and
# reads the q it left in the shared scratch.
QUANT_SWEEP_VARIANTS = {
    "full": [],
    "no_turn_in": [_NO_TURN_IN],
    # the division by s as a product with its reciprocal: the same integers
    # but where a quotient lies within an ulp of a rounding tie
    "reciprocal": [(r"__float2int_rn\(__fdiv_rn\(v, s\)\)",
                    "__float2int_rn(__fmul_rn(v, __frcp_rn(s)))")],
}
# K8: the scan on the packed bytes
K8_VARIANTS = {"full": [], "stream_alone": [_NO_ENTRIES]}

_HEADER = '#include "dual_scan.cuh"\n'
_INCLUDE = re.compile(r'#include "(\w+\.cuh)"\n')

# K6's tile kernel (commit f93bb61 and earlier), measured with --root
K6_TILE_VARIANTS = {
    "full": [],
    # the M stream, the activation loads and the barriers alone
    "stream_only": [(r"(const int r0 = \(c_begin \+ it\) \* CHUNK;)",
                     r"\1\n    if (r0 >= 0) continue;")],
    "no_votes": [(r"if \(!\(\(tiles >> ks\) & 1u\)\) continue;", ""),
                 (r"if \(nz == 0\) continue;", ""),
                 (r"if \(!\(\(nz >> nt\) & 1u\)\) continue;", "")],
    "no_atomics": [(r"if \(v != 0\.0f\) atomicAdd", "if (v == 12345.0f) atomicAdd")],
    "no_conversion": [(r"fixed_to_float<<<[^;]*;", "")],
}
# K6's scan in 64-bit fixed point: prep (the bf16 copy, maxima, zeroed
# sums), the scan, the conversion
_NO_PREP = (r"prep_kernel<<<[^;]*;", ";")
_NO_CONVERSION = (r"convert_kernel<<<[^;]*;", "")
K6_SCAN_VARIANTS = {
    "full": [],
    "entries_out": [_NO_ENTRIES],
    "stream_alone": [_NO_ENTRIES, _NO_PREP, _NO_CONVERSION],
    "no_yi_atomics": [(r"add_nonzero\(yi_row", "add_never(yi_row")],
    "no_yu_atomics": [(r"add_nonzero\(yu_row", "add_never(yu_row")],
    "no_conversion": [_NO_CONVERSION],
    "no_prep": [_NO_PREP],
}
# K11's tile kernel (commit f93bb61 and earlier), measured with --root
K11_TILE_VARIANTS = {
    "full": [],
    "no_mma": [(r"for \(int j = 0; j < NT; \+\+j\) mma_bf16\(acc\[mt\]\[j\], a0, a1, a2, a3, "
                r"b\[j\]\[0\], b\[j\]\[1\]\);",
                "acc[mt][0][0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b[0][0]);")],
    # the stages' copies and barriers alone
    "stream_only": [(r"(const uint16_t\* xs = reinterpret_cast<const uint16_t\*>\(ps \+ P_BYTES\);)",
                     r"\1\n    if (it >= 0) continue;")],
}
# K11's scan of the packed row groups
K11_SCAN_VARIANTS = {
    "full": [],
    # the bits streamed, no piece taken
    "stream_alone": [(r"unsigned todo = __ballot_sync\(FULL, \((\w+)\.x \| \1\.y \| \1\.z \| \1\.w\) != 0u\);",
                      r"unsigned todo = __ballot_sync(FULL, (\1.x | \1.y | \1.z | \1.w) == 0x7ffffff1u);")],
    # the non-zero pieces found, their entries not listed
    "entries_out": [(r"while \(bytes\) \{", "while (bytes && c0 < 0) {"),
                    (r"tail \+= __shfl_sync\(FULL, upto, 31\);", "")],
    # the entries taken, x not copied (the stage's old contents added)
    "no_x_loads": [(r"cp_async16\(stage \+ e \* DF \+ q \* CHUNK,[^;]*;", ";")],
    # the entries listed, no row copied or added
    "no_take": [(r"while \(tail - head >= L::BATCH\) flush\(\);", "head = tail;")],
    # the entries' rows copied, not added
    "no_adds": [(r"acc\[k / L::RS\]\[v\] \+= a\[v\];", "acc[k / L::RS][v] = a[v];")],
    # the staged rows not waited for (their sums wrong)
    "no_wait": [(r"cp_async_wait<1>\(\);", ";"), (r"cp_async_wait<0>\(\);", ";")],
    # the staged rows not added (no ballots, no adds)
    "no_add_pass": [(r"unsigned take = __ballot_sync\(FULL, \(bits >> k\) & 1\);",
                     "unsigned take = 0u;")],
    # the shared row groups' sums not added (the fixup launch out)
    "no_fixup": [(r"bit_fixup_kernel<DF><<<[^;]*;", "")],
}
# the full scan at other settings: a stage's size, stripes a warp has in
# flight, blocks an SM must hold (the register budget)
for _kb, _e in ((1, 256), (4, 1024)):
    K11_SCAN_VARIANTS[f"batch_{_kb}kb"] = [(r"512 / DF < 32 \? 512 / DF",
                                            f"{_e} / DF < 32 ? {_e} / DF")]
for _r in (1, 4):
    K11_SCAN_VARIANTS[f"ring_{_r}"] = [(r"constexpr int RING = \d+;", f"constexpr int RING = {_r};")]
for _b in (4, 8):
    K11_SCAN_VARIANTS[f"min_blocks_{_b}"] = [(r"__launch_bounds__\(THREADS, \d\)\nbit_scan",
                                              f"__launch_bounds__(THREADS, {_b})\nbit_scan")]
# plans of other numbers of parts (warps a launch), timed with the tree's library
K11_PLAN_PARTS = (4096, 8192)

# K12 and K13's tile kernel (mma.sync on staged 64-row blocks of M for K12,
# 128-column blocks walking the whole batch for K13; commit 327ceb4 and
# earlier). Each variant: its patches and the kernels it is timed on.
_K12_MMA = (r"for \(int j = 0; j < NT; \+\+j\) mma_bf16\(acc16\[j\], a0, a1, a2, a3, "
            r"b\[j\]\[0\], b\[j\]\[1\]\);",
            "acc16[0][0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b[0][0] ^ b[NT - 1][1]);")
_K13_MMA = (r"for \(int j = 0; j < NT; \+\+j\) mma_bf16\(acc16\[mt\]\[j\], a0, a1, a2, a3, "
            r"b\[j\]\[0\], b\[j\]\[1\]\);",
            "acc16[mt][0][0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b[0][0] ^ b[NT - 1][1]);")
K12_TILE_VARIANTS = {
    "full": ([], ("K12", "K13")),
    # the bf16 products out (the counts' conversion and z's fragments kept)
    "no_mma": ([_K12_MMA, _K13_MMA], ("K12", "K13")),
    # the counts' conversion to bf16 out too (the raw bytes multiplied)
    "no_convert": ([(r"const __nv_bfloat162 v =\s*__floats2bfloat162_rn\([^;]*;\s*"
                     r"return \*reinterpret_cast<const uint32_t\*>\(&v\);", "return w;")],
                   ("K12", "K13")),
    # z's (K12) and g's (K13) rows not copied into the stages
    "no_zg_loads": ([(r"cp_async16\(zs \+ r \* Z_PITCH \* ESZ \+ pc,[^;]*;", ";"),
                     (r"cp_async16_zfill\(gs \+ r \* G::G_PITCH \* G::ESZ \+ pc,[^;]*;", ";")],
                    ("K12", "K13")),
    # M's rows not read: the stages zero-filled
    "no_m_loads": ([(r"(cp_async16_zfill\(ms \+ r \* M_PITCH \+ cc, [^;]*), id >= 0\);",
                     r"\1, false);"),
                    (r"(cp_async16_zfill\(ms \+ r \* G::M_PITCH \+ cc, [^;]*), ok\);",
                     r"\1, false);")],
                   ("K12", "K13")),
    # K12's second launch (the S partials' sum) out
    "no_share_sum": ([(r"sum_shares<<<[^;]*;", "")], ("K12",)),
    # a ring of six stages (K12's bf16 block then fits once an SM)
    "stages_6": ([(r"constexpr int STAGES = 3;", "constexpr int STAGES = 6;")], ("K12", "K13")),
    # 128 batch rows a K12 block, 8 warps (K13 is not timed: its blocks
    # would then span 256 columns)
    "rows_128": ([(r"constexpr int THREADS = 128;", "constexpr int THREADS = 256;"),
                  (r"constexpr int RB = 64;", "constexpr int RB = 128;")], ("K12",)),
}
# K12 and K13 with the features as the mma's m (after commit 327ceb4): K12's
# bf16 route a ring fed by producer warps, its float32 route and K13 a
# block-synchronous ring, zero tiles (K13) or counts (float32) skipped by
# warp votes
_NO_VOTE_SKIPS = [(r"if \(!\(\(live >> \(4 \* ks\)\) & 0xfu\)\) continue;", ";"),
                  (r"if \(!\(\(live >> \(4 \* ks \+ i\)\) & 1u\)\) continue;", ";"),
                  (r"if \(!__any_sync\(FULL, \(piece\.x \| piece\.y \| piece\.z \| piece\.w\) "
                   r"!= 0u\)\) continue;", ";"),
                  (r"if \(!__any_sync\(FULL, cnt != 0\)\) continue;", ";")]
_WS = r"constexpr int WS_{} = \d+;"
K12_VOTE_VARIANTS = {
    "full": ([], ("K12", "K13")),
    # the bf16 products out (the counts' conversion and the fragments kept)
    "no_mma": ([(r"mma_bf16\(acc\[mt\]\[([ij])\], a\[mt\]\[0\], a\[mt\]\[1\], a\[mt\]\[2\], "
                 r"a\[mt\]\[3\], lo, hi\);",
                 r"acc[mt][\1][0] += __uint_as_float(lo ^ hi ^ a[mt][0] ^ a[mt][3]);")],
               ("K12", "K13")),
    # K13 and the float32 routes: every tile or count multiplied, zero or not
    "no_skips": (_NO_VOTE_SKIPS, ("K12 f32", "K13")),
    # the counts converted as if some were negative (the general route)
    "signed_route": ([(r"const bool negative = __reduce_or_sync\([^;]*;",
                       "const bool negative = true;")], ("K12", "K13")),
    # z's (K12) and g's (K13) rows not staged
    "no_zg_loads": ([(r"stage_rows<[^>]*>\([^;]*;", ";")], ("K12", "K13")),
    # M's rows not read: the stages zero-filled
    "no_m_loads": ([(r"(cp_async16_zfill\(ms \+ r \* (?:M1[23]_PITCH|Ws::M_PITCH) \+ 16 \* q, "
                     r"[^;]*),\s*(?:id >= 0|ok)\);", r"\1, false);")], ("K12", "K13")),
    # M's rows read, nothing multiplied: K12 bf16's consumers only wait and
    # release, no tile found live elsewhere
    "no_compute": ([(r"for \(int half = 0; half < 2; \+\+half\) \{",
                     "for (int half = 0; half < 0; ++half) {"),
                    (r"live = __reduce_or_sync\(FULL, live\);", "live = 0u;"),
                    (r"if \(!__any_sync\(FULL, \(piece\.x \| piece\.y \| piece\.z \| piece\.w\) "
                     r"!= 0u\)\) continue;", "continue;"),
                    (r"if \(!__any_sync\(FULL, cnt != 0\)\) continue;", "continue;")],
                   ("K12", "K13")),
    # K12's second launch (the partials' sum) and K13's sum over the
    # cluster's ranks out
    "no_share_sum": ([(r"sum_shares<<<[^;]*;", ""), (r"if \(k < shares\) \{", "if (k < 1) {")],
                     ("K12", "K13")),
    # K12's partials not written (the sum adds what the scratch holds)
    "no_partials": ([(r"if \(f < dg\) o\[f\] = srow\[r\] >= 0 \? acc\[mt\]\[j\]\[2 \* h \+ e\] : "
                      r"nanf\(\"\"\);", "if (f < dg && acc[mt][j][2 * h + e] == 12345.0f) o[f] = 0.0f;"),
                     (r"if \(4 \* f4 < dg\) \{", "if (4 * f4 < dg && acc[0][0][0] == 12345.0f) {")],
                    ("K12",)),
    # K13's sums not parked, summed or written
    "no_epilogue": ([(r"cg::cluster_group cluster = cg::this_cluster\(\);",
                      "if (acc[0][0][0] != 12345.0f) return;\n  cg::cluster_group cluster = "
                      "cg::this_cluster();")], ("K13",)),
    # shallower rings: K12 bf16 three stages, float32 two; K13 four (bf16)
    # and three (float32)
    "stages_less": ([(_WS.format("STAGES"), "constexpr int WS_STAGES = 3;"),
                     (r"static constexpr int STAGES = 3;", "static constexpr int STAGES = 2;"),
                     (r"static constexpr int STAGES = BF16 \? 6 : 4;",
                      "static constexpr int STAGES = BF16 ? 4 : 3;")], ("K12", "K13")),
    # deeper rings: K12 float32 four stages (one block an SM), K13 eight and
    # five
    "stages_more": ([(r"static constexpr int STAGES = 3;", "static constexpr int STAGES = 4;"),
                     (r"static constexpr int STAGES = BF16 \? 6 : 4;",
                      "static constexpr int STAGES = BF16 ? 8 : 5;")], ("K12 f32", "K13")),
    # K12 bf16: one, two or eight producer warps (four in the tree); 64
    # columns a stage, seven stages
    "ws_producers_1": ([(_WS.format("PRODUCERS"), "constexpr int WS_PRODUCERS = 1;")],
                       ("K12 bf16",)),
    "ws_producers_2": ([(_WS.format("PRODUCERS"), "constexpr int WS_PRODUCERS = 2;")],
                       ("K12 bf16",)),
    "ws_producers_8": ([(_WS.format("PRODUCERS"), "constexpr int WS_PRODUCERS = 8;")],
                       ("K12 bf16",)),
    "ws_cols_64_stages_7": ([(_WS.format("KC"), "constexpr int WS_KC = 64;"),
                             (_WS.format("STAGES"), "constexpr int WS_STAGES = 7;")],
                            ("K12 bf16",)),
    # K12 bf16: a k16 step skipped when its four tiles hold no count
    "ws_k16_skips": ([(r"uint32_t w\[KS\]\[4\];\n      unsigned sign = 0;",
                       "uint32_t w[KS][4];\n      unsigned sign = 0, live = 0;"),
                      (r"          sign \|= w\[k\]\[j\];",
                       "          sign |= w[k][j];\n          live |= static_cast<unsigned>(w[k][j] != 0u) << k;"),
                      (r"(      const bool negative = __reduce_or_sync\(FULL, sign & 0x80808080u\) != 0u;\n"
                       r"#pragma unroll\n      for \(int k = 0; k < KS; \+\+k\) \{\n)"
                       r"(        const int ks = KS \* half \+ k;)",
                       "      live = __reduce_or_sync(FULL, live);\n\\1        if (!((live >> k) & 1u)) continue;\n\\2")],
                     ("K12 bf16",)),
    # K12 float32: 128 columns a stage (one block an SM)
    "k12_cols_128": ([(r"constexpr int KC = 64;", "constexpr int KC = 128;")], ("K12 f32",)),
    # K13: 128 columns (4 warps) a block; the plan told so
    "k13_cols_128": ([(r"constexpr int CT = 256;", "constexpr int CT = 128;")], ("K13",),
                     {"K13_COLS": 128}),
    # K13: 64 batch rows a stage (one block an SM)
    "k13_rows_64": ([(r"constexpr int KB = 32;", "constexpr int KB = 64;")], ("K13",)),
}
# the split, other plans with the tree's library: half and twice the
# tree's S (K13: one share, and twice the tree's)
K12_VOTE_PLANS = {
    "half": lambda plan: lambda batch, c, d, sms, per_sm, backward=False: (
        1 if backward else max(1, plan(batch, c, d, sms, per_sm, backward) // 2)),
    "double": lambda plan: lambda batch, c, d, sms, per_sm, backward=False: (
        min(8, 2 * plan(batch, c, d, sms, per_sm, backward)) if backward
        else min(c // 64, 2 * plan(batch, c, d, sms, per_sm, backward))),
}
# K12's column split of the tile kernel, timed with the tree's library:
# the tree's (two waves if a block filled an SM), whole waves of the two
# blocks an SM holds, and twice that
K12_TILE_SHARES = {
    "whole_waves": lambda sms, row_blocks, chunks: max(1, min(chunks, 2 * sms // row_blocks)),
    "waves_x2": lambda sms, row_blocks, chunks: max(1, min(chunks, 4 * sms // row_blocks)),
}


def variants_for(text: str) -> dict:
    return TILE_VARIANTS if "column4(" in text else SCAN_VARIANTS


def with_header(text: str, csrc_dir: str) -> str:
    """``text`` with the kernels' headers pasted in place of their
    includes, the headers' own includes too, each header once."""
    pasted = set()

    def paste(match):
        name = match.group(1)
        if name in pasted:
            return ""
        pasted.add(name)
        with open(os.path.join(csrc_dir, name)) as f:
            body = f.read().replace("#pragma once\n", "")
        return _INCLUDE.sub(paste, body)

    return _INCLUDE.sub(paste, text)


def build_all(build_mod, source: str, variants: dict | None = None, tag: str = "k7") -> dict:
    """Every variant of ``source`` (default: K7's for the kernel found),
    all nvcc processes at once; returns name -> (library path or None,
    nvcc output)."""
    text = with_header(open(source).read(), build_mod.CSRC_DIR)
    out_dir = os.path.join(build_mod.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, patches in (variants or variants_for(text)).items():
        src = text
        for pattern, repl in patches:
            src, n = re.subn(pattern, repl, src)
            if n == 0:
                raise RuntimeError(f"variant {name}: anchor {pattern!r} not in {source}")
        src = src.replace("namespace {\n", "namespace {\n\n" + _NEVER, 1)
        cu = os.path.join(out_dir, f"{tag}_{name}.cu")
        so = os.path.join(out_dir, f"lib{tag}_{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        # the variant sits in another directory: point -I at the kernels' headers
        cmd = [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, f"-I{build_mod.CSRC_DIR}", "-o",
               so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        built[name] = (so if proc.returncode == 0 else None, log)
    return built


def timed(fn, iters=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_launches(fn) -> int:
    """Kernels and memsets that one call of ``fn`` puts on the device, as
    torch.profiler records them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """The device time of one call of ``fn`` by kernel name (its first 40
    characters), the mean over ``reps`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            by[ev.name[:40]] = by.get(ev.name[:40], 0.0) + t / 1e3 / reps
    return by


def _ptxas(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def turned_ablation(dev, m, build_mod, fusedmm, kernel: str) -> dict:
    """K1 (``kernel`` 'dual_int8_t', m the int8 matrix) or K5
    ('dual_int4_t', m the nibble-packed one) at d = 64: its wrapper and
    device launches, and on the scan design its variants (the library
    call, no allocation)."""
    tag = {"dual_int8_t": "K1", "dual_int4_t": "K5"}[kernel]
    quant = "int4" if tag == "K5" else "int8"
    wrapper = getattr(fusedmm, f"fused_adj_matmul_{quant}_t")
    plain = getattr(fusedmm, f"fused_adj_matmul_{quant}_t_plain")
    u_pad, i_pad = m.shape[0], m.shape[1] * (2 if tag == "K5" else 1)
    d = 64
    g = torch.Generator(device="cpu").manual_seed(2)
    quT = torch.randint(-127, 128, (d, u_pad), generator=g, dtype=torch.int8).to(dev)
    qiT = torch.randint(-127, 128, (d, i_pad), generator=g, dtype=torch.int8).to(dev)
    call = lambda: wrapper(m, quT, qiT)  # noqa: E731
    out = {"wrapper_ms": timed(call), "device_launches_per_call": device_launches(call)}
    print(f"{tag} wrapper {out['wrapper_ms']:.4f} ms, {out['device_launches_per_call']} device "
          "launches a call", flush=True)
    source = build_mod.source_path(kernel)
    if "turn_in<<<" not in with_header(open(source).read(), build_mod.CSRC_DIR):
        print(f"{tag} is the tile kernel in this tree: no variants", flush=True)
        return out
    built = build_all(build_mod, source, K1_VARIANTS, tag.lower())
    out["ptxas_full"] = _ptxas(built["full"][1])
    for ln in out["ptxas_full"]:
        print(f"ptxas ({tag} full): {ln}", flush=True)
    rows = (u_pad + i_pad) * d
    scratch = torch.empty(5 * rows, dtype=torch.int8, device=dev)
    yu = torch.empty((d, u_pad), dtype=torch.float32, device=dev)
    yi = torch.empty((d, i_pad), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = plain(m, quT, qiT)
    ms = {}
    for name, (so, log) in built.items():
        if so is None:
            print(f"{tag} {name}: not measured, nvcc failed:\n{log}", flush=True)
            ms[name] = None
            continue
        lib = ctypes.CDLL(so)
        fn = getattr(lib, kernel)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            code = fn(m.data_ptr(), quT.data_ptr(), qiT.data_ptr(), yu.data_ptr(), yi.data_ptr(),
                      scratch.data_ptr() + 4 * rows, scratch.data_ptr(), u_pad, i_pad, stream)
            if code:
                raise RuntimeError(f"{tag} {name}: CUDA error {code}")

        ms[name] = timed(run)
        if name == "full":
            run()
            if not (torch.equal(yu, want[0]) and torch.equal(yi, want[1])):
                raise RuntimeError(f"the full {tag} variant differs from the plain version")
        print(f"{tag} {name}: d=64 {ms[name]:.4f} ms", flush=True)
    out["ms"] = ms
    return out


def k8_ablation(dev, data, build_mod, fusedmm, propagate) -> dict:
    """K8 at d = 64 and 128 on the nibble-packed matrix: its wrapper and
    device launches, and on the scan design the full call against the
    stream alone."""
    m4 = fusedmm.pack_nibbles(fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev),
                                                 fusedmm.PACK_TILE, fusedmm.TU))
    u_pad, i_pad = m4.shape[0], 2 * m4.shape[1]
    g = torch.Generator(device="cpu").manual_seed(3)
    acts = {d: (torch.randint(-127, 128, (u_pad, d), generator=g, dtype=torch.int8).to(dev),
                torch.randint(-127, 128, (i_pad, d), generator=g, dtype=torch.int8).to(dev))
            for d in WIDTHS}
    out = {"wrapper_ms": {}, "device_launches_per_call": {}}
    for d in WIDTHS:
        call = lambda d=d: fusedmm.fused_adj_matmul_int4(m4, *acts[d])  # noqa: E731
        out["wrapper_ms"][d] = timed(call)
        out["device_launches_per_call"][d] = device_launches(call)
    print(f"K8 wrapper d=64 {out['wrapper_ms'][64]:.4f} ms, d=128 {out['wrapper_ms'][128]:.4f} "
          f"ms; device launches a call {out['device_launches_per_call']}", flush=True)
    source = build_mod.source_path("dual_int4_n")
    if _HEADER not in open(source).read():
        print("K8 is the tile kernel in this tree: no variants", flush=True)
        return out
    built = build_all(build_mod, source, K8_VARIANTS, "k8")
    out["ptxas_full"] = _ptxas(built["full"][1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    passes = ctypes.c_int(0)
    ms = {}
    for name, (so, log) in built.items():
        if so is None:
            print(f"K8 {name}: not measured, nvcc failed:\n{log}", flush=True)
            ms[name] = None
            continue
        lib = ctypes.CDLL(so)
        lib.dual_int4_n.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.dual_int4_n.restype = ctypes.c_int
        row = {}
        for d in WIDTHS:
            qu, qi = acts[d]
            sums = torch.zeros((u_pad + i_pad, d), dtype=torch.int32, device=dev)

            def run():
                sums.zero_()
                code = lib.dual_int4_n(m4.data_ptr(), qu.data_ptr(), qi.data_ptr(),
                                       sums.data_ptr(), sums[u_pad:].data_ptr(), u_pad, i_pad, d,
                                       ctypes.byref(passes), stream)
                if code:
                    raise RuntimeError(f"K8 {name}: CUDA error {code}")

            row[d] = timed(run)
            if name == "full":
                run()
                want = fusedmm.fused_adj_matmul_int4_plain(m4, qu, qi)
                got = sums.view(torch.float32)
                if not (torch.equal(got[:u_pad], want[0]) and torch.equal(got[u_pad:], want[1])):
                    raise RuntimeError(f"the full K8 variant differs from the plain version at "
                                       f"d={d}")
        ms[name] = row
        print(f"K8 {name}: d=64 {row[64]:.4f} ms, d=128 {row[128]:.4f} ms", flush=True)
    out["ms"] = ms
    return out


def k7_ablation(dev, data, build_mod, fusedmm, propagate) -> dict:
    m8 = fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev), fusedmm.TI, fusedmm.TU)
    u_pad, i_pad = m8.shape
    built = build_all(build_mod, build_mod.source_path("dual_int8_n"))
    ptxas = _ptxas(built["full"][1])
    for ln in ptxas:
        print(f"ptxas (full): {ln}", flush=True)
    g = torch.Generator(device="cpu").manual_seed(0)
    acts = {d: (torch.randint(-127, 128, (u_pad, d), generator=g, dtype=torch.int8).to(dev),
                torch.randint(-127, 128, (i_pad, d), generator=g, dtype=torch.int8).to(dev))
            for d in WIDTHS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the scan kernel's launcher reports its reads of M; the tile kernel's does not
    scan = variants_for(with_header(open(build_mod.source_path("dual_int8_n")).read(),
                                    build_mod.CSRC_DIR)) is SCAN_VARIANTS
    passes = ctypes.c_int(0)
    reported = (ctypes.byref(passes),) if scan else ()
    results, launched = {}, {}
    for name, (so, log) in built.items():
        if so is None:
            print(f"{name}: not measured, nvcc failed:\n{log}", flush=True)
            results[name] = None
            continue
        lib = ctypes.CDLL(so)
        lib.dual_int8_n.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                    + [ctypes.POINTER(ctypes.c_int)] * len(reported)
                                    + [ctypes.c_void_p])
        lib.dual_int8_n.restype = ctypes.c_int
        row = {}
        for d in WIDTHS:
            qu, qi = acts[d]
            yu = torch.zeros((u_pad, d), dtype=torch.int32, device=dev)
            yi = torch.zeros((i_pad, d), dtype=torch.int32, device=dev)

            def run():
                yu.zero_()
                yi.zero_()
                code = lib.dual_int8_n(m8.data_ptr(), qu.data_ptr(), qi.data_ptr(), yu.data_ptr(),
                                       yi.data_ptr(), u_pad, i_pad, d, *reported, stream)
                if code:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            row[d] = timed(run)
            if name == "full":
                if scan:
                    launched[d] = passes.value
                want = fusedmm.fused_adj_matmul_int8_plain(m8, qu, qi)
                run()
                ok = (torch.equal(yu.view(torch.float32), want[0])
                      and torch.equal(yi.view(torch.float32), want[1]))
                if not ok:
                    raise RuntimeError(f"the full variant differs from the plain version at d={d}")
        results[name] = row
        print(f"{name}: d=64 {row[64]:.4f} ms, d=128 {row[128]:.4f} ms", flush=True)
    zero = {}
    for d in WIDTHS:
        yu = torch.zeros((u_pad, d), dtype=torch.int32, device=dev)
        yi = torch.zeros((i_pad, d), dtype=torch.int32, device=dev)
        zero[d] = timed(lambda: (yu.zero_(), yi.zero_()))
    wrapper = {d: timed(lambda d=d: fusedmm.fused_adj_matmul_int8(m8, *acts[d])) for d in WIDTHS}
    launches = {d: device_launches(lambda d=d: fusedmm.fused_adj_matmul_int8(m8, *acts[d]))
                for d in WIDTHS}
    copy = torch.empty_like(m8)
    copy_ms = timed(lambda: copy.copy_(m8))
    print(f"zeroing the outputs: d=64 {zero[64]:.4f} ms, d=128 {zero[128]:.4f} ms; the wrapper "
          f"(allocation, checks, launch): d=64 {wrapper[64]:.4f}, d=128 {wrapper[128]:.4f} ms; "
          f"copy of M {copy_ms:.4f} ms; device launches a call {launches}", flush=True)
    out = {"u_pad": u_pad, "i_pad": i_pad, "ms": results, "zero_outputs_ms": zero,
           "wrapper_ms": wrapper, "device_launches_per_call": launches, "copy_of_M_ms": copy_ms,
           "ptxas_full": ptxas}
    if launched:
        out["passes_over_M"] = launched  # as the full variant's launcher reported them
    return out


def _close(got, want) -> bool:
    top = float(want.abs().max()) if want.numel() else 0.0
    return bool(torch.allclose(got, want, rtol=3e-5, atol=3e-6 * max(top, 1e-30)))


def _swapped(build_mod, module, cache, kernel: str, so: str):
    """Load ``so`` as ``kernel``'s library of ``module`` (the wrapper's
    cached loader ``cache`` cleared), so that the wrapper launches it."""
    build_mod._loaded[kernel] = ctypes.CDLL(so)
    cache.cache_clear()


def _restored(build_mod, cache, kernel: str):
    build_mod._loaded.pop(kernel, None)
    cache.cache_clear()


def k6_ablation(dev, data, build_mod, fusedmm, propagate) -> dict:
    """K6 through its wrapper with each variant's library, at d = 64 and
    128 on the yelp2018-scale matrix, random float32 activations."""
    m8 = fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev), fusedmm.TI, fusedmm.TU)
    nu, ni = data.num_users, data.num_items
    g = torch.Generator(device="cpu").manual_seed(4)
    acts = {d: (torch.randn(nu, d, generator=g).to(dev), torch.randn(ni, d, generator=g).to(dev))
            for d in WIDTHS}
    source = build_mod.source_path("dual_bf16")
    tile = "column4(" in open(source).read()
    built = build_all(build_mod, source, K6_TILE_VARIANTS if tile else K6_SCAN_VARIANTS, "k6")
    out = {"design": "tile" if tile else "scan", "ptxas_full": _ptxas(built["full"][1])}
    for ln in out["ptxas_full"]:
        print(f"ptxas (K6 full): {ln}", flush=True)
    ms = {}
    try:
        for name, (so, log) in built.items():
            if so is None:
                print(f"K6 {name}: not measured, nvcc failed:\n{log}", flush=True)
                ms[name] = None
                continue
            _swapped(build_mod, fusedmm, fusedmm._lib, "dual_bf16", so)
            row = {}
            for d in WIDTHS:
                row[d] = timed(lambda d=d: fusedmm.fused_adj_matmul(m8, *acts[d]))
                if name == "full":
                    got = fusedmm.fused_adj_matmul(m8, *acts[d])
                    want = fusedmm.fused_adj_matmul_plain(m8, *acts[d])
                    if not all(_close(a, b) for a, b in zip(got, want)):
                        raise RuntimeError(f"the full K6 variant differs from the plain version "
                                           f"at d={d}")
            ms[name] = row
            print(f"K6 {name}: d=64 {row[64]:.4f} ms, d=128 {row[128]:.4f} ms", flush=True)
    finally:
        _restored(build_mod, fusedmm._lib, "dual_bf16")
    out["ms"] = ms
    out["wrapper_ms"] = {d: timed(lambda d=d: fusedmm.fused_adj_matmul(m8, *acts[d]))
                         for d in WIDTHS}
    print(f"K6 wrapper (the tree's library) d=64 {out['wrapper_ms'][64]:.4f} ms, d=128 "
          f"{out['wrapper_ms'][128]:.4f} ms", flush=True)
    out["launch_call"] = lambda: fusedmm.fused_adj_matmul(m8, *acts[64])
    return out


def k11_ablation(dev, data, build_mod, bitmm, propagate) -> dict:
    """K11 through its wrapper with each variant's library: both
    directions at d = 64 on the yelp2018-scale binary matrix, random
    float32 activations."""
    m = propagate._count_matrix_int8(data, dev)
    packed, packed_t = bitmm.pack_rows(m), bitmm.pack_rows(m.T)
    del m
    nu, ni, d = data.num_users, data.num_items, 64
    g = torch.Generator(device="cpu").manual_seed(5)
    xu, xi = torch.randn(nu, d, generator=g).to(dev), torch.randn(ni, d, generator=g).to(dev)
    dirs = {"users": (packed, xi, nu), "items": (packed_t, xu, ni)}
    if hasattr(bitmm, "plan_rows"):  # the scan's split among its warps, made once
        dirs = {k: (*a, bitmm.plan_rows(a[0])) for k, a in dirs.items()}
    source = build_mod.source_path("bit_matmul")
    tile = "mma_bf16(" in open(source).read()
    built = build_all(build_mod, source, K11_TILE_VARIANTS if tile else K11_SCAN_VARIANTS, "k11")
    out = {"design": "tile" if tile else "scan", "ptxas_full": _ptxas(built["full"][1])}
    for ln in out["ptxas_full"]:
        print(f"ptxas (K11 full): {ln}", flush=True)
    ms = {}
    try:
        # two passes over the variants, in turns; each time is the smaller of two
        for rnd in range(2):
            for name, (so, log) in built.items():
                if so is None:
                    if rnd == 0:
                        print(f"K11 {name}: not measured, nvcc failed:\n{log}", flush=True)
                    ms[name] = None
                    continue
                _swapped(build_mod, bitmm, bitmm._k11_lib, "bit_matmul", so)
                row = {k: timed(lambda a=a: bitmm.bit_matmul(*a)) for k, a in dirs.items()}
                if name == "full" and rnd == 0:
                    for k, a in dirs.items():
                        if not _close(bitmm.bit_matmul(*a), bitmm.bit_matmul_plain(*a[:3])):
                            raise RuntimeError(f"the full K11 variant differs from the plain "
                                               f"version ({k})")
                if rnd == 1:
                    row = {k: min(v, ms[name][k]) for k, v in row.items()}
                row["application"] = row["users"] + row["items"]
                ms[name] = row
                if rnd == 1:
                    print(f"K11 {name}: users {row['users']:.4f} ms, items {row['items']:.4f} ms, "
                          f"application {row['application']:.4f} ms", flush=True)
    finally:
        _restored(build_mod, bitmm._k11_lib, "bit_matmul")
    out["ms"] = ms
    if hasattr(bitmm, "plan_rows"):
        saved = bitmm.PLAN_PARTS
        try:
            for parts in K11_PLAN_PARTS:
                bitmm.PLAN_PARTS = parts
                other = {k: (*a[:3], bitmm.plan_rows(a[0])) for k, a in dirs.items()}
                row = {k: timed(lambda a=a: bitmm.bit_matmul(*a)) for k, a in other.items()}
                row["application"] = row["users"] + row["items"]
                ms[f"parts_{parts}"] = row
                print(f"K11 parts_{parts}: users {row['users']:.4f} ms, items {row['items']:.4f} ms, "
                      f"application {row['application']:.4f} ms", flush=True)
        finally:
            bitmm.PLAN_PARTS = saved
    out["wrapper_ms"] = sum(timed(lambda a=a: bitmm.bit_matmul(*a)) for a in dirs.values())
    print(f"K11 wrapper (the tree's library) per application {out['wrapper_ms']:.4f} ms",
          flush=True)
    out["launch_call"] = lambda: bitmm.bit_matmul(*dirs["users"])
    return out


# A yardstick for K12's and K13's stream: the batch's rows of M read in runs
# of `run` bytes, every row's first run, then every row's second, ... (the
# order K12's and K13's stages visit them), by plain 16-byte loads, each
# lane UNROLL of them in flight; nothing kept but an XOR.
STREAM_PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int UNROLL = 8;
__global__ void __launch_bounds__(256) probe(const int8_t* m, const long long* rows, int batch,
                                             int c, int cols, int run, unsigned* out) {
  const int pieces_a_run = run / 16, runs = cols / run;
  const long long total = static_cast<long long>(batch) * runs * pieces_a_run;
  const long long first = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned acc = 0;
  for (long long p0 = first; p0 < total; p0 += stride * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = p0 + u * stride;
      v[u] = make_uint4(0, 0, 0, 0);
      if (p < total) {
        const long long unit = p / pieces_a_run;
        const int piece = static_cast<int>(p % pieces_a_run);
        const int seg = static_cast<int>(unit / batch), b = static_cast<int>(unit % batch);
        v[u] = __ldcs(reinterpret_cast<const uint4*>(m + rows[b] * c +
                                                     static_cast<long long>(seg) * run) + piece);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x9e3779b9u) out[0] = acc;
}
}  // namespace
extern "C" int stream_probe(const void* m, const void* rows, int batch, int c, int cols, int run,
                            int blocks, void* out, void* stream) {
  probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(m), static_cast<const long long*>(rows), batch, c, cols, run,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_RUNS = (64, 128, 256, 512, 1024, 4096)


def stream_probe(dev, build_mod, sides) -> dict:
    """The probe on each side's rows: GB/s of M read by run length."""
    out_dir = os.path.join(build_mod.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "stream_probe.cu"), os.path.join(out_dir, "libstream_probe.so")
    with open(cu, "w") as f:
        f.write(STREAM_PROBE_SRC)
    subprocess.run([build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.stream_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for (m_, r_), side in zip(sides, ("users", "items")):
        for run in PROBE_RUNS:
            c_ = m_.shape[1] // run * run
            t_ = timed(lambda: lib.stream_probe(m_.data_ptr(), r_.data_ptr(), r_.numel(),
                                                m_.shape[1], c_, run, blocks, sink.data_ptr(),
                                                stream))
            gbs = r_.numel() * c_ / t_ / 1e6
            res[f"{side} {run}"] = [t_, gbs]
            print(f"K12/K13 stream probe, {side}: runs of {run} B, {t_:.4f} ms, {gbs:.0f} GB/s",
                  flush=True)
    return res


def k12_ablation(dev, data, build_mod, gathermm, propagate, quick: bool = False) -> dict:
    """K12 and K13 through their wrappers with each variant's library, at
    chip_smoke.py's shapes: one sampled batch's 2,048 user rows of M and
    4,096 item rows of Mᵀ (repeats kept), random z and g at d = 64, bf16
    and float32; each time is one step's two calls, the smaller of two
    passes in turns."""
    from idgrec_torch.engine.sampler import NegativeSampler

    m = propagate._count_matrix_int8(data, dev)
    m_t = m.T.contiguous()
    users, pos, neg = NegativeSampler(data).sample_epoch(torch.Generator(device=dev).manual_seed(0))
    idx_u, idx_i = users[:BATCH].contiguous(), torch.cat([pos[:BATCH], neg[:BATCH]])
    nu, ni, d = data.num_users, data.num_items, 64
    g = torch.Generator(device="cpu").manual_seed(6)
    zs = (torch.randn(ni, d, generator=g).to(dev), torch.randn(nu, d, generator=g).to(dev))
    gs = (torch.randn(BATCH, d, generator=g).to(dev), torch.randn(2 * BATCH, d, generator=g).to(dev))
    sides = ((m, idx_u), (m_t, idx_i))
    fns = {"K12": (gathermm.gather_rows_matmul, gathermm.gather_rows_matmul_plain, zs),
           "K13": (gathermm.gather_rows_matmul_t, gathermm.gather_rows_matmul_t_plain, gs)}
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = {(tag, dn): [(m_, r_, v.to(dt).contiguous()) for (m_, r_), v in zip(sides, vs)]
             for tag, (_, _, vs) in fns.items() for dn, dt in dts.items()}
    out = {"rows": [BATCH, 2 * BATCH], "shapes": [list(m.shape), list(m_t.shape)],
           "distinct_rows": [int(torch.unique(r_).numel()) for _, r_ in sides],
           "nonzeros": [int((m_[r_] != 0).sum()) for m_, r_ in sides]}
    print(f"K12/K13: rows {out['rows']} of {out['shapes']}, distinct {out['distinct_rows']}, "
          f"non-zero counts in the gathered rows {out['nonzeros']}", flush=True)
    source = build_mod.source_path("gather_rows_matmul")
    tile = "__reduce_or_sync(" not in open(source).read()
    variants = K12_TILE_VARIANTS if tile else K12_VOTE_VARIANTS
    if quick:  # the tree's kernels and the yardsticks alone
        variants = {"full": variants["full"]}
    built = build_all(build_mod, source, {k: v[0] for k, v in variants.items()}, "k12")
    out.update(design="tile" if tile else "vote", ptxas_full=_ptxas(built["full"][1]))
    for ln in out["ptxas_full"]:
        print(f"ptxas (K12/K13 full): {ln}", flush=True)

    def step_ms(tag, dn):
        """One step's two calls under CUDA events, and captured ten times
        in a CUDA graph and replayed: the device's time without the host's
        between launches."""
        fn = fns[tag][0]
        call = lambda: [fn(*c) for c in cases[(tag, dn)]]  # noqa: E731
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(10):
                call()
        replay = timed(graph.replay, 5) / 10
        del graph
        return timed(call), replay

    ms = {}
    try:
        for rnd in range(2):
            for name, (so, log) in built.items():
                if so is None:
                    if rnd == 0:
                        print(f"K12/K13 {name}: not measured, nvcc failed:\n{log}", flush=True)
                    ms[name] = None
                    continue
                _swapped(build_mod, gathermm, gathermm._lib, "gather_rows_matmul", so)
                if not tile:  # the variant's blocks an SM, for its plan
                    gathermm._blocks_per_sm.cache_clear()
                if name == "full" and rnd == 0:
                    for (tag, dn), cs in cases.items():
                        fn, plain, _ = fns[tag]
                        for c in cs:
                            got = fn(*c)
                            if not (torch.equal(got, fn(*c)) and _close(got, plain(*c))):
                                raise RuntimeError(f"the full {tag} variant differs from the "
                                                   f"plain version or from itself ({dn})")
                # a variant's kernels, each "K12" or "K13" (both types) or with one
                # type, and the wrapper's settings it needs
                patch = variants[name][2] if len(variants[name]) > 2 else {}
                saved_attrs = {k: getattr(gathermm, k) for k in patch}
                for k, v in patch.items():
                    setattr(gathermm, k, v)
                try:
                    row = {f"{tag.split()[0]} {dn}": step_ms(tag.split()[0], dn)
                           for tag in variants[name][1] for dn in dts
                           if tag.split()[1:] in ([], [dn])}
                finally:
                    for k, v in saved_attrs.items():
                        setattr(gathermm, k, v)
                if rnd == 1:
                    row = {k: [min(a, b) for a, b in zip(v, ms[name][k])] for k, v in row.items()}
                    print(f"K12/K13 {name}: " + ", ".join(
                        f"{k} {v[0]:.4f} ms (graph {v[1]:.4f})" for k, v in row.items()), flush=True)
                ms[name] = row
    finally:
        _restored(build_mod, gathermm._lib, "gather_rows_matmul")
        if not tile:
            gathermm._blocks_per_sm.cache_clear()
    # the split of the work, other plans with the tree's library (K12 only on
    # the tile kernel, whose K13 has no split)
    plans = {} if quick else K12_TILE_SHARES if tile else K12_VOTE_PLANS
    attr = "_shares" if tile else "plan_rows_matmul"
    saved = getattr(gathermm, attr)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        for name, plan in plans.items():
            if tile:
                setattr(gathermm, attr, lambda m_, batch, dtype, plan=plan: plan(
                    sms, -(-batch // 64), m_.shape[1] // (128 if dtype == torch.bfloat16 else 64)))
                timed_tags = ("K12",)
            else:
                setattr(gathermm, attr, plan(saved))
                timed_tags = ("K12", "K13")
            row = {f"{tag} {dn}": [min(a, b) for a, b in zip(step_ms(tag, dn), step_ms(tag, dn))]
                   for tag in timed_tags for dn in dts}
            ms[f"plan_{name}"] = row
            print(f"K12/K13 plan_{name}: " + ", ".join(
                f"{k} {v[0]:.4f} ms (graph {v[1]:.4f})" for k, v in row.items()), flush=True)
    finally:
        setattr(gathermm, attr, saved)
    out["ms"] = ms
    # the same calls on other rows of M: the batch's rows sorted by id (its
    # repeats then adjacent) and the first B rows in order (one contiguous
    # run of B * C bytes): what the rows' scatter over M costs
    for how in ("sorted", "contiguous"):
        saved_cases = dict(cases)
        for (tag, dn), cs in saved_cases.items():
            cases[(tag, dn)] = [(m_, torch.sort(r_).values if how == "sorted"
                                 else torch.arange(r_.numel(), device=dev), v)
                                for m_, r_, v in cs]
        row = {f"{tag} {dn}": step_ms(tag, dn) for tag in fns for dn in dts}
        cases.update(saved_cases)
        ms[f"rows_{how}"] = row
        print(f"K12/K13 rows_{how} (the tree's library): " + ", ".join(
            f"{k} {v[0]:.4f} ms (graph {v[1]:.4f})" for k, v in row.items()), flush=True)
    out["stream_probe"] = stream_probe(dev, build_mod, sides)
    # yardsticks for the stream: the batch's whole rows copied out
    # (index_select: each row one run of C bytes, read and written once)
    for (m_, r_), side in zip(sides, ("users", "items")):
        t_ = timed(lambda m_=m_, r_=r_: m_.index_select(0, r_))
        out[f"index_select_{side}_ms"] = t_
        print(f"K12/K13 yardstick: index_select of the {side}' rows {t_:.4f} ms "
              f"({2 * r_.numel() * m_.shape[1] / t_ / 1e6:.0f} GB/s read + written)", flush=True)
    out["wrapper_ms"] = {f"{tag} {dn}": step_ms(tag, dn) for tag in fns for dn in dts}
    print("K12/K13 wrappers (the tree's library): " + ", ".join(
        f"{k} {v[0]:.4f} ms (graph {v[1]:.4f})" for k, v in out["wrapper_ms"].items()), flush=True)
    out["launch_calls"] = {tag: (lambda fn=fns[tag][0], c=cases[(tag, "bf16")][0]: fn(*c))
                           for tag in fns}
    # device time by kernel, each side and type alone (profiled last, with the
    # launch counts)
    out["profile_calls"] = {f"{tag} {dn} {side}": (lambda fn=fns[tag][0], c=c: fn(*c))
                            for (tag, dn), cs in cases.items()
                            for side, c in zip(("users", "items"), cs)}
    return out


def sweep_ablation(dev, m8, build_mod, fusedmm, chainmm, propagate) -> dict:
    """The int8 chain sweep at d = 64 through each variant's library
    call, beside the raw dual: the linear chain's (forward, the combine
    added, a next input) and, on a tree whose turn-out has the tanh
    modes, the tanh chain's forward (the combine added) and inject (the
    cotangent injected), each with a next input; on a tree whose turn-in
    rounds z, the linear forward sweep on (z, amax)."""
    source = build_mod.source_path("dual_int8_t")
    text = open(source).read()
    if "dual_int8_t_sweep" not in text:
        print("this tree has no chain sweep in K1: no variants", flush=True)
        return {}
    # per-side next inputs, h slices and sides (the tanh modes)
    sides_api = "int sides" in text
    # each side's input mode: the turn-in rounds z (K3's work)
    in_api = "int in_u" in text
    u_pad, i_pad = m8.shape
    d = 64
    g = torch.Generator(device="cpu").manual_seed(5)
    qu, qi = (torch.randint(-127, 128, (d, n), generator=g, dtype=torch.int8).to(dev)
              for n in (u_pad, i_pad))
    su, si = ((torch.rand(d, 1, generator=g) * 1e-3 + 1e-4).to(dev) for _ in range(2))
    post = tuple(torch.rand(n, generator=g).to(dev) for n in (u_pad, i_pad))
    pre = tuple(torch.rand(n, generator=g).to(dev) for n in (u_pad, i_pad))
    c0 = tuple(torch.randn(d, n, generator=g).to(dev) for n in (u_pad, i_pad))
    h0 = tuple(torch.tanh(torch.randn(d, n, generator=g)).to(dev) for n in (u_pad, i_pad))
    rows = (u_pad + i_pad) * d
    scratch = torch.empty(5 * rows, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def load(so):
        lib = ctypes.CDLL(so)
        lib.dual_int8_t_sweep.argtypes = ([ctypes.c_void_p] * (18 if sides_api else 16)
                                          + [ctypes.c_int] * (9 if in_api else
                                                              7 if sides_api else 5)
                                          + [ctypes.c_void_p])
        lib.dual_int8_t_sweep.restype = ctypes.c_int
        lib.dual_int8_t.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                                    + [ctypes.c_void_p])
        lib.dual_int8_t.restype = ctypes.c_int
        lib.dual_int8_t_sweep_aux_words.argtypes = [ctypes.c_int] * 2
        return lib

    def sweep_call(lib, name, mode, flag, ext, out, hs=(None, None), vecs=(post, pre),
                   inputs=None):
        """``inputs``: each side's (x, a, input mode), on a tree whose
        turn-in takes them; default K3's (q, s)."""
        aux = torch.empty(lib.dual_int8_t_sweep_aux_words(u_pad, i_pad), device=dev)
        p_, r_ = vecs
        tail = [p_[0].data_ptr(), r_[0].data_ptr(), p_[1].data_ptr(), r_[1].data_ptr(),
                ext[0].data_ptr(), ext[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr()]
        if in_api:
            (xu, au, mu), (xi, ai, mi) = inputs or ((qu, su, 0), (qi, si, 0))
            head = [m8.data_ptr(), xu.data_ptr(), xi.data_ptr(), au.data_ptr(), ai.data_ptr(),
                    scratch.data_ptr() + 4 * rows, scratch.data_ptr(), aux.data_ptr()] + tail
            args = head + [t.data_ptr() if t is not None else None for t in hs] + [
                u_pad, i_pad, mu, mi, mode, 3, int(flag), 1, 1, stream]
        elif sides_api:
            head = [m8.data_ptr(), qu.data_ptr(), qi.data_ptr(), scratch.data_ptr() + 4 * rows,
                    scratch.data_ptr(), aux.data_ptr(), si.data_ptr(), su.data_ptr()] + tail
            args = head + [t.data_ptr() if t is not None else None for t in hs] + [
                u_pad, i_pad, mode, 3, int(flag), 1, 1, stream]
        else:
            head = [m8.data_ptr(), qu.data_ptr(), qi.data_ptr(), scratch.data_ptr() + 4 * rows,
                    scratch.data_ptr(), aux.data_ptr(), si.data_ptr(), su.data_ptr()] + tail
            args = head + [u_pad, i_pad, mode, int(flag), 1, stream]

        def run():
            code = lib.dual_int8_t_sweep(*args)
            if code:
                raise RuntimeError(f"sweep {name}: CUDA error {code}")

        return run, aux

    def raw_ms(lib):
        z = [torch.empty(d, n, device=dev) for n in (u_pad, i_pad)]

        def raw():
            code = lib.dual_int8_t(m8.data_ptr(), qu.data_ptr(), qi.data_ptr(), z[0].data_ptr(),
                                   z[1].data_ptr(), scratch.data_ptr() + 4 * rows,
                                   scratch.data_ptr(), u_pad, i_pad, stream)
            if code:
                raise RuntimeError(f"raw dual: CUDA error {code}")

        return timed(raw)

    out = {"ms": {}}
    c_want = [t.clone() for t in c0]
    want = chainmm.dual_sweep_plain("int8", m8, qu, su, qi, si, post, pre, c_want,
                                    chainmm.COMBINE_ADD, True)
    for name, (so, log) in build_all(build_mod, source, SWEEP_VARIANTS, "sweep").items():
        if so is None:
            print(f"sweep {name}: not measured, nvcc failed:\n{log}", flush=True)
            out["ms"][name] = None
            continue
        lib = load(so)
        c = [t.clone() for t in c0]
        z = [torch.empty(d, n, device=dev) for n in (u_pad, i_pad)]
        run, aux = sweep_call(lib, name, fusedmm.SWEEP_FORWARD, chainmm.COMBINE_ADD, c, z)
        if name == "full":
            run()
            got = (z[0], aux[:d], z[1], aux[d:2 * d], *c)
            if not all(torch.equal(a, b) for a, b in zip(got, (*want, *c_want))):
                raise RuntimeError("the full sweep variant differs from its plain version")
            out["ms"]["raw_dual"] = raw_ms(lib)
            print(f"sweep raw_dual: {out['ms']['raw_dual']:.4f} ms", flush=True)
        out["ms"][name] = timed(run)
        print(f"sweep {name}: {out['ms'][name]:.4f} ms", flush=True)
    if not sides_api:
        return out
    # the tanh sweeps: forward (h slices written) and inject (h read)
    out["tanh_ms"] = {}
    c_want, hs_want = [t.clone() for t in c0], [torch.empty_like(t) for t in c0]
    want_f = (*chainmm.dual_sweep_tanh.plain("int8", m8, qu, su, qi, si, post, pre, c_want,
                                             chainmm.COMBINE_ADD, True, hs_want),
              *c_want, *hs_want)
    want_i = chainmm.dual_sweep_tanh_inject.plain("int8", m8, qu, su, qi, si, pre, post, c0,
                                                  True, True, h0)
    for name, (so, log) in build_all(build_mod, source, TANH_SWEEP_VARIANTS, "tanh").items():
        if so is None:
            print(f"tanh sweep {name}: not measured, nvcc failed:\n{log}", flush=True)
            out["tanh_ms"][name] = None
            continue
        lib = load(so)
        c, hs = [t.clone() for t in c0], [torch.empty_like(t) for t in c0]
        z, o = ([torch.empty(d, n, device=dev) for n in (u_pad, i_pad)] for _ in range(2))
        fwd, aux_f = sweep_call(lib, name, fusedmm.SWEEP_TANH, chainmm.COMBINE_ADD, c, z, hs)
        # the backward binds (post, pre) to (r, l): swapped here too
        inj, aux_i = sweep_call(lib, name, fusedmm.SWEEP_TANH_INJECT, True, c0, o, h0,
                                (pre, post))
        if name == "full":
            fwd()
            inj()
            got_f = (z[0], aux_f[:d], z[1], aux_f[d:2 * d], *c, *hs)
            got_i = (o[0], aux_i[:d], o[1], aux_i[d:2 * d])
            if not (all(torch.equal(a, b) for a, b in zip(got_f, want_f))
                    and all(torch.equal(a, b) for a, b in zip(got_i, want_i))):
                raise RuntimeError("the full tanh sweep variant differs from its plain version")
            out["tanh_ms"]["raw_dual"] = raw_ms(lib)
            print(f"tanh sweep raw_dual: {out['tanh_ms']['raw_dual']:.4f} ms", flush=True)
        out["tanh_ms"][name] = {"forward": timed(fwd), "inject": timed(inj)}
        print(f"tanh sweep {name}: forward {out['tanh_ms'][name]['forward']:.4f} ms, inject "
              f"{out['tanh_ms'][name]['inject']:.4f} ms", flush=True)
    if not in_api:
        return out
    # the sweep on (z, amax): the turn-in rounds as K3 does
    out["quant_ms"] = {}
    zu, zi = ((torch.randn(d, n, generator=g) * 0.3).to(dev) for n in (u_pad, i_pad))
    au, ai = zu.abs().amax(dim=1), zi.abs().amax(dim=1)
    z_in = ((zu, au, fusedmm.INPUT_Z), (zi, ai, fusedmm.INPUT_Z))
    c_want = [t.clone() for t in c0]
    want = chainmm.dual_sweep.plain("int8", m8, zu, au, zi, ai, post, pre, c_want,
                                    chainmm.COMBINE_ADD, True)
    for name, (so, log) in build_all(build_mod, source, QUANT_SWEEP_VARIANTS, "quant").items():
        if so is None:
            print(f"quantizing sweep {name}: not measured, nvcc failed:\n{log}", flush=True)
            out["quant_ms"][name] = None
            continue
        lib = load(so)
        c = [t.clone() for t in c0]
        z = [torch.empty(d, n, device=dev) for n in (u_pad, i_pad)]
        run, aux = sweep_call(lib, name, fusedmm.SWEEP_FORWARD, chainmm.COMBINE_ADD, c, z,
                              inputs=z_in)
        if name == "full":
            run()
            got = (z[0], aux[:d], z[1], aux[d:2 * d], *c)
            if not all(torch.equal(a, b) for a, b in zip(got, (*want, *c_want))):
                raise RuntimeError("the full quantizing sweep variant differs from its plain "
                                   "version")
            q_in = tuple((*propagate.quantize_rows(x, a), fusedmm.INPUT_Q) for x, a, _ in z_in)
            bare, _ = sweep_call(lib, "bare", fusedmm.SWEEP_FORWARD, chainmm.COMBINE_ADD, c, z,
                                 inputs=q_in)

            def k3_then_bare():
                for x, a, _ in z_in:
                    propagate.quantize_rows(x, a)
                bare()

            out["quant_ms"]["bare_sweep"] = timed(bare)
            out["quant_ms"]["k3_and_bare_sweep"] = timed(k3_then_bare)
            print(f"quantizing sweep: the bare sweep on (q, s) {out['quant_ms']['bare_sweep']:.4f}"
                  f" ms, K3 x2 and the bare sweep {out['quant_ms']['k3_and_bare_sweep']:.4f} ms",
                  flush=True)
        out["quant_ms"][name] = timed(run)
        print(f"quantizing sweep {name}: {out['quant_ms'][name]:.4f} ms", flush=True)
    return out


def k4_split(dev, data, scatter) -> dict:
    from idgrec_torch.engine.sampler import NegativeSampler

    gen = torch.Generator(device=dev).manual_seed(0)
    users, pos, neg = NegativeSampler(data).sample_epoch(gen)
    nu, ni, d = data.num_users, data.num_items, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    u, p, n = (x[:BATCH].contiguous() for x in (users, pos, neg))
    gu, gp, gn = (torch.randn(BATCH, d, generator=g).to(dev) for _ in range(3))
    # the step's two tables: the user batch, and the item table's positives
    # then negatives, concatenated as the gathers' backward does
    step = {"u": u, "p": p, "n": n}

    def step_cases():
        return ((step["u"], gu, nu), (torch.cat([step["p"], step["n"]]), torch.cat([gp, gn]), ni))

    cases = step_cases()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = scatter._k4_lib()
    outs = [torch.empty((nr, d), dtype=torch.float32, device=dev) for _, _, nr in cases]
    new = hasattr(scatter, "scatter_add_rows_unchecked")
    if new:
        scratch = [torch.empty(scatter.scratch_size(nr, idx.numel()), dtype=torch.int32,
                               device=dev) for idx, _, nr in cases]

        def kernel():
            """The library call alone, one per table, on the concatenated item
            batch (the concatenation not timed)."""
            for (idx, vals, nr), out, buf in zip(cases, outs, scratch):
                code = lib.scatter_add_rows(idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                            buf.data_ptr(), idx.numel(), d, nr, stream)
                if code:
                    raise RuntimeError(f"K4: CUDA error {code}")

        def unchecked():
            """As the gathers' backward calls it: the concatenation included."""
            scatter.scatter_add_rows_unchecked(step["u"], gu, nu)
            scatter.scatter_add_rows_unchecked(torch.cat([step["p"], step["n"]]),
                                               torch.cat([gp, gn]), ni)
    else:  # the tree before the unchecked entry: same kernel, its wrapper's check skipped
        def kernel():
            for (idx, vals, nr), out in zip(cases, outs):
                code = lib.scatter_add_rows(idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                            idx.numel(), d, nr, stream)
                if code:
                    raise RuntimeError(f"K4: CUDA error {code}")

        def unchecked():
            saved = scatter._check_args
            scatter._check_args = lambda *a: None
            try:
                for idx, vals, nr in step_cases():
                    scatter.scatter_add_rows(idx.contiguous(), vals.contiguous(), nr)
            finally:
                scatter._check_args = saved

    def checked():
        for idx, vals, nr in cases:
            scatter.scatter_add_rows(idx, vals, nr)

    def index_add():
        for idx, vals, nr in cases:
            torch.zeros((nr, d), device=dev).index_add_(0, idx, vals)

    kernel()
    for (idx, vals, nr), out in zip(cases, outs):
        if not torch.equal(out, scatter.scatter_add_rows_plain(idx, vals, nr)):
            raise RuntimeError("K4 differs from its plain version")
    res = {"kernel": timed(kernel, 50)}

    def graph_ms():
        """kernel()'s launches captured ten times in a CUDA graph, replayed:
        device time without the host between launches."""
        nonlocal stream
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            stream = side.cuda_stream
            kernel()  # warm on the capture stream
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=side):
                for _ in range(10):
                    kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        return timed(graph.replay, 10) / 10

    res["kernel_graph"] = graph_ms()
    # the same launches on batches of distinct rows: what duplicates cost
    saved = dict(step), cases
    step["u"] = torch.randperm(nu, device=dev)[:BATCH]
    step["p"], step["n"] = torch.randperm(ni, device=dev)[:2 * BATCH].split(BATCH)
    cases = step_cases()
    res["kernel_graph_distinct"] = graph_ms()
    (step, cases) = saved
    # device time by kernel name, per step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kernel()
        torch.cuda.synchronize()
    res["device_by_kernel"] = {
        e.key: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3 / 20
        for e in prof.key_averages()
        if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) > 0}
    print(f"K4 device time per step by kernel (profiler, ms): {res['device_by_kernel']}",
          flush=True)
    res["unchecked"] = timed(unchecked, 50)
    res["checked"] = timed(checked, 50)
    res["index_add"] = timed(index_add, 50)
    dup_u = BATCH - int(torch.unique(cases[0][0]).numel())
    dup_i = 2 * BATCH - int(torch.unique(cases[1][0]).numel())
    print(f"K4 per step (2 tables; {dup_u} + {dup_i} duplicate rows): library call "
          f"{res['kernel']:.4f} ms, graph replay {res['kernel_graph']:.4f} ms (distinct rows "
          f"{res['kernel_graph_distinct']:.4f}), step's wrapper {res['unchecked']:.4f} ms, "
          f"public wrapper {res['checked']:.4f} ms, index_add_ {res['index_add']:.4f} ms",
          flush=True)
    res["duplicates"] = [dup_u, dup_i]
    return res


# K4's sorted-segment entry (``segment_sum_rows``): its constants changed one
# at a time; every variant computes the right sums
SEGMENT_VARIANTS = {
    "full": [],
    "stages_2": [(r"constexpr int SEG_STAGES = 4;", "constexpr int SEG_STAGES = 2;")],
    "stages_3": [(r"constexpr int SEG_STAGES = 4;", "constexpr int SEG_STAGES = 3;")],
    "stages_6": [(r"constexpr int SEG_STAGES = 4;", "constexpr int SEG_STAGES = 6;")],
    "warps_4": [(r"constexpr int SEG_THREADS = 64;", "constexpr int SEG_THREADS = 128;")],
    "window_32": [(r"constexpr int SEG_WINDOW = 64;", "constexpr int SEG_WINDOW = 32;")],
    "window_128": [(r"constexpr int SEG_WINDOW = 64;", "constexpr int SEG_WINDOW = 128;")],
    # 4-byte copies (the path of a strided z) on the contiguous z
    "copies_4": [(r"const bool vec = z_feat == 1", "const bool vec = false && z_feat == 1")],
    # timed only (wrong sums): the gathered copies or the adds taken out
    "no_loads": [(r"for \(int q = 0; q < width; q \+= 4\) cp_async<16>\(dst \+ q, src \+ q\);",
                  "")],
    "no_adds": [(r"acc = __fadd_rn\(acc, x\[(j|u)\]\);", r"acc = x[\1];")],
}
SEGMENT_TIMED_ONLY = ("no_loads", "no_adds")


def k4_sgl_lists(dev, data, build_mod, scatter) -> dict:
    """K4 at SGL's drop-list lengths: one edge-dropout view of the
    yelp2018-scale set at ``ssl_ratio`` 0.1, its dropped edges drawn as
    `propagate.build_dropout_adjacency` draws them (a permutation from a
    numpy generator seeded 0, the tail dropped, the lists sorted stably by
    user and by item), d = 64, random tables. Into the users and into the
    items on the list sorted by its index (a correction's forward and
    backward): the sorted-segment entry (``segment_sum_rows``, the gather
    inside) through its wrapper, on a contiguous z and on the [N, d] view of
    a [d, N] one (read in place, and made contiguous first), beside the
    generic K4 library call on the gathered rows (preallocated buffers, the
    gather not counted), the generic entry's wrapper with the gather, and
    ``index_add_`` of the gathered rows; on the list sorted the other way
    (the index unsorted) the generic library call. Each is held to K4's
    plain version and timed under CUDA events; the entry's variants
    (`SEGMENT_VARIANTS`, where the tree has the entry) through the wrapper;
    then each call is profiled by kernel name."""
    nnz = int(data.nnz)
    users = np.repeat(np.arange(data.num_users, dtype=np.int64), np.diff(data.row_ptr))
    items = data.col_idx.astype(np.int64)
    dropped = np.random.default_rng(0).permutation(nnz)[int(round(0.9 * nnz)):]
    d_users, d_items = users[dropped], items[dropped]
    by_user, by_item = np.argsort(d_users, kind="stable"), np.argsort(d_items, kind="stable")
    nu, ni, d = data.num_users, data.num_items, 64
    g = torch.Generator().manual_seed(2)
    z_of = {"users": torch.randn(nu, d, generator=g).to(dev),
            "items": torch.randn(ni, d, generator=g).to(dev)}
    # name -> (rows, the other side's ids, rows into, the table gathered)
    cases = {"users_sorted": (d_users[by_user], d_items[by_user], nu, "items"),
             "items_sorted": (d_items[by_item], d_users[by_item], ni, "users"),
             "items_unsorted": (d_items[by_user], d_users[by_user], ni, "users"),
             "users_unsorted": (d_users[by_item], d_items[by_item], nu, "items")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = scatter._k4_lib()
    segmented = hasattr(scatter, "segment_sum_rows")
    res, calls = {"rows": int(dropped.size)}, {}
    for name, (idx_np, other_np, nr, side) in cases.items():
        idx = torch.from_numpy(idx_np).to(dev)
        other = torch.from_numpy(other_np).to(dev)
        z = z_of[side]
        vals = z[other].contiguous()
        out = torch.empty((nr, d), dtype=torch.float32, device=dev)
        buf = torch.empty(scatter.scratch_size(nr, idx.numel()), dtype=torch.int32, device=dev)

        def kernel(idx=idx, nr=nr, out=out, buf=buf, vals=vals):
            code = lib.scatter_add_rows(idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                                        buf.data_ptr(), idx.numel(), d, nr, stream)
            if code:
                raise RuntimeError(f"K4: CUDA error {code}")

        kernel()
        want = scatter.scatter_add_rows_plain(idx, vals, nr)
        if not torch.equal(out, want):
            raise RuntimeError(f"K4 differs from its plain version on SGL's list ({name})")
        r = {"ms": timed(kernel, 20),
             "hot_rows": int((np.bincount(idx_np, minlength=nr) > 32).sum()),
             "longest": int(np.bincount(idx_np, minlength=nr).max())}
        calls[name] = {"generic": kernel}
        if name.endswith("_sorted"):
            r["generic_with_gather_ms"] = timed(
                lambda idx=idx, z=z, other=other, nr=nr:
                scatter.scatter_add_rows_unchecked(idx, z[other], nr), 20)
            r["index_add_ms"] = timed(
                lambda idx=idx, z=z, other=other, nr=nr:
                torch.zeros((nr, d), device=dev).index_add_(0, idx, z[other]), 20)
        if name.endswith("_sorted") and segmented:
            ptr = scatter.row_offsets(idx, nr)
            z_t = z.T.contiguous().T  # strides (1, N)

            def entry(ptr=ptr, other=other, z=z):
                return scatter.segment_sum_rows(ptr, other, z)

            for layout, zz in (("contiguous", z), ("strided", z_t)):
                if not torch.equal(scatter.segment_sum_rows(ptr, other, zz), want):
                    raise RuntimeError(f"the sorted-segment entry differs from K4's plain "
                                       f"version on SGL's list ({name}, {layout})")
            r["segment_ms"] = timed(entry, 50)
            # a strided z read in place (the library call: the wrapper copies it)
            out_s = torch.empty((nr, d), dtype=torch.float32, device=dev)

            def in_place(ptr=ptr, other=other, z_t=z_t, out_s=out_s, nr=nr):
                code = lib.segment_sum_rows(ptr.data_ptr(), other.data_ptr(), z_t.data_ptr(),
                                            z_t.stride(0), z_t.stride(1), out_s.data_ptr(), nr,
                                            nr, d, other.numel(), stream)
                if code:
                    raise RuntimeError(f"K4's sorted-segment entry: CUDA error {code}")
                return out_s

            if not torch.equal(in_place(), want):
                raise RuntimeError(f"the sorted-segment entry read in place differs ({name})")
            r["segment_strided_ms"] = timed(in_place, 50)
            r["segment_copied_ms"] = timed(
                lambda ptr=ptr, other=other, z_t=z_t: scatter.segment_sum_rows(ptr, other, z_t),
                50)
            r["segment_device_launches"] = device_launches(entry)
            calls[name]["segment"] = entry
        res[name] = r
        print(f"K4 on SGL's drop list ({res['rows']} rows of {d}) {name}: the generic library "
              f"call {r['ms']:.4f} ms" + (
                  f", its wrapper with the gather {r['generic_with_gather_ms']:.4f}, index_add_ "
                  f"{r['index_add_ms']:.4f}" if "index_add_ms" in r else "") + (
                  f"; the sorted-segment entry {r['segment_ms']:.4f} ms (z strided, read in "
                  f"place {r['segment_strided_ms']:.4f}, made contiguous first by the wrapper "
                  f"{r['segment_copied_ms']:.4f}; {r['segment_device_launches']} device "
                  f"launches a call)" if "segment_ms" in r else "")
              + f"; {r['hot_rows']} rows with more than 32 entries, the longest {r['longest']}",
              flush=True)
    if segmented:
        source = build_mod.source_path("scatter_add_rows")
        built = build_all(build_mod, source, SEGMENT_VARIANTS, tag="k4")
        print("K4 full variant ptxas: " + " | ".join(_ptxas(built["full"][1])), flush=True)
        res["segment_variants"] = {}
        for vname, (so, log) in built.items():
            if so is None:
                print(f"K4 variant {vname}: build failed\n{log}", flush=True)
                continue
            _swapped(build_mod, scatter, scatter._k4_lib, "scatter_add_rows", so)
            try:
                row = {}
                for name in ("users_sorted", "items_sorted"):
                    fn = calls[name]["segment"]
                    idx_np, _, nr, _ = cases[name]
                    if vname not in SEGMENT_TIMED_ONLY and not torch.equal(
                            fn(), scatter.scatter_add_rows_plain(
                                torch.from_numpy(idx_np).to(dev), z_of[cases[name][3]][
                                    torch.from_numpy(cases[name][1]).to(dev)], nr)):
                        raise RuntimeError(f"K4 variant {vname} differs on {name}")
                    row[name] = timed(fn, 50)
                # one row of n entries alone: the time an entry of a hot row
                for n_hot in (2_000, 8_000):
                    cols_h = torch.randint(0, nu, (n_hot,), generator=g).to(dev)
                    ptr_h = torch.tensor([0, n_hot], device=dev)
                    row[f"one_row_{n_hot}"] = timed(
                        lambda ptr_h=ptr_h, cols_h=cols_h:
                        scatter.segment_sum_rows(ptr_h, cols_h, z_of["users"]), 20)
            finally:
                _restored(build_mod, scatter._k4_lib, "scatter_add_rows")
            res["segment_variants"][vname] = row
            print(f"K4 sorted-segment variant {vname}: into the users {row['users_sorted']:.4f} "
                  f"ms, into the items {row['items_sorted']:.4f} ms; one row of 2,000 entries "
                  f"{row['one_row_2000']:.4f} ms, of 8,000 {row['one_row_8000']:.4f}", flush=True)
    # profiled after every timing: the profiler slows the later launches
    for name, fns in calls.items():
        for what, fn in fns.items():
            by = device_ms_by_kernel(fn)
            res[name][f"{what}_device_ms_by_kernel"] = by
            print(f"K4 {what} on SGL's list {name}: device ms by kernel "
                  + ", ".join(f"{k} {v:.4f}" for k, v in by.items()), flush=True)
    return res


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--skip-k7", action="store_true")
    parser.add_argument("--skip-k1", action="store_true")
    parser.add_argument("--skip-k5", action="store_true")
    parser.add_argument("--skip-k8", action="store_true")
    parser.add_argument("--skip-k4", action="store_true")
    parser.add_argument("--skip-k6", action="store_true")
    parser.add_argument("--skip-k11", action="store_true")
    parser.add_argument("--skip-sweep", action="store_true")
    parser.add_argument("--skip-k12", action="store_true")
    parser.add_argument("--k12-quick", action="store_true",
                        help="K12/K13: the full variant and the yardsticks only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.ops import _build, bitmm, chainmm, fusedmm, gathermm, propagate, scatter

    dev = torch.device("cuda")
    data = make_synthetic_dataset(*YELP, seed=0)
    result = {"root": os.path.abspath(args.root)}
    if not args.skip_k7:
        result["k7"] = k7_ablation(dev, data, _build, fusedmm, propagate)
    if not args.skip_k1:
        m8 = fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev), fusedmm.TI, fusedmm.TU)
        result["k1"] = turned_ablation(dev, m8, _build, fusedmm, "dual_int8_t")
        del m8
    if not args.skip_k5:
        m4 = fusedmm.pack_nibbles(fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev),
                                                     fusedmm.PACK_TILE, fusedmm.TU))
        result["k5"] = turned_ablation(dev, m4, _build, fusedmm, "dual_int4_t")
        del m4
    if not args.skip_k8:
        result["k8"] = k8_ablation(dev, data, _build, fusedmm, propagate)
    if not args.skip_k4:
        result["k4"] = k4_split(dev, data, scatter)
        result["k4_sgl"] = k4_sgl_lists(dev, data, _build, scatter)
    if not args.skip_k6:
        result["k6"] = k6_ablation(dev, data, _build, fusedmm, propagate)
    if not args.skip_k11:
        result["k11"] = k11_ablation(dev, data, _build, bitmm, propagate)
    if not args.skip_sweep:
        m8 = fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev), fusedmm.TI, fusedmm.TU)
        result["sweep"] = sweep_ablation(dev, m8, _build, fusedmm, chainmm, propagate)
        del m8
    if not args.skip_k12:
        result["k12"] = k12_ablation(dev, data, _build, gathermm, propagate, args.k12_quick)
    # the device launches of one K6 and one K11 call, counted last: once
    # used, the profiler slows the host's later launches
    for key in ("k6", "k11"):
        if key in result:
            n = device_launches(result[key].pop("launch_call"))
            result[key]["device_launches_per_call"] = n
            print(f"{key.upper()} device launches a call: {n}", flush=True)
    if "k12" in result:
        calls = result["k12"].pop("launch_calls")
        result["k12"]["device_launches_per_call"] = {tag: device_launches(fn)
                                                     for tag, fn in calls.items()}
        print(f"K12/K13 device launches a call (bf16, user side): "
              f"{result['k12']['device_launches_per_call']}", flush=True)
        result["k12"]["device_ms_by_kernel"] = {
            name: device_ms_by_kernel(fn) for name, fn in result["k12"].pop("profile_calls").items()}
        for name, by in result["k12"]["device_ms_by_kernel"].items():
            print(f"K12/K13 {name}: device ms a call by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in by.items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    result["card"] = card
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
