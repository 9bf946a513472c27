#!/usr/bin/env python3
"""Where kernels K7 (idgrec_torch/csrc/dual_int8_n.cu), K1
(csrc/dual_int8_t.cu), K5 (csrc/dual_int4_t.cu), K8 (csrc/dual_int4_n.cu),
K6 (csrc/dual_bf16.cu) and K11 (csrc/bit_matmul.cu) spend their time,
and where kernel K4's time goes (idgrec_torch/csrc/scatter_add_rows.cu),
on one NVIDIA GPU.

    python3 scripts/torch_k7_ablation.py [--root DIR] [--skip-k7] [--skip-k1]
                                         [--skip-k5] [--skip-k8] [--skip-k4]
                                         [--skip-k6] [--skip-k11] [--skip-sweep]

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

K4: the step's two tables (2,048 sampled user rows into [31,668, 64],
4,096 item rows into [38,048, 64]) timed four ways under CUDA events:
the library call alone on preallocated buffers, the same launches
replayed from a CUDA graph (device time without the host), the wrapper
the training step calls (no range check; the tree before it had none,
and its public wrapper is timed with the check taken out) and the public
wrapper (with the range check), beside ``index_add_`` into a zeroed
table.

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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from idgrec_torch.data.dataset import make_synthetic_dataset
    from idgrec_torch.ops import _build, bitmm, chainmm, fusedmm, propagate, scatter

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
    if not args.skip_k6:
        result["k6"] = k6_ablation(dev, data, _build, fusedmm, propagate)
    if not args.skip_k11:
        result["k11"] = k11_ablation(dev, data, _build, bitmm, propagate)
    if not args.skip_sweep:
        m8 = fusedmm.pad_matrix(propagate._count_matrix_int8(data, dev), fusedmm.TI, fusedmm.TU)
        result["sweep"] = sweep_ablation(dev, m8, _build, fusedmm, chainmm, propagate)
        del m8
    # the device launches of one K6 and one K11 call, counted last: once
    # used, the profiler slows the host's later launches
    for key in ("k6", "k11"):
        if key in result:
            n = device_launches(result[key].pop("launch_call"))
            result[key]["device_launches_per_call"] = n
            print(f"{key.upper()} device launches a call: {n}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    result["card"] = card
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
