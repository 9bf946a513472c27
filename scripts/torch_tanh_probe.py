#!/usr/bin/env python3
"""Whether the tanh chain's kernel K9 computes PyTorch's tanh on this
card bit for bit, and whether autograd's tanh backward rounds like the
chain's backward, on one NVIDIA GPU.

    python3 scripts/torch_tanh_probe.py

Builds idgrec_torch/csrc/chain_sweep_tanh.cu twice into
idgrec_torch/_build/: with the port's nvcc flags (`-fmad=false`) and
without that flag. Runs K9 with post = 1 and s_in = 1, which makes its
h = tanhf(y), on 2**22 normal draws at each of five scales, an even grid
on [-12, 12] and 2**22 random finite bit patterns with both signs, and
counts the outputs that differ from `torch.tanh` and their largest
distance in ulps. Then counts the gradients where autograd's tanh
backward differs from (1 - h*h) * g rounded twice, the chain's order
(K10), and from the same product with 1 - h*h rounded once (an FMA).

Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from idgrec_torch.ops import _build  # noqa: E402


def _library(tag: str, flags: list[str]) -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libtanh_probe_{tag}.so")
    cmd = [_build.nvcc_path(), *flags, "-o", out, _build.source_path("chain_sweep_tanh")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.chain_sweep_tanh.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.chain_sweep_tanh.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tanh_probe: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 22
    parts = [torch.randn(n, device=dev, generator=g) * s for s in (0.01, 0.3, 1.0, 3.0, 10.0)]
    parts.append(torch.linspace(-12, 12, n, device=dev))
    bits = torch.randint(0, 2**31 - 1, (n,), device=dev, generator=g, dtype=torch.int32)
    xb = bits.view(torch.float32)
    xb = xb[torch.isfinite(xb)]
    x = torch.cat(parts + [xb, -xb])
    x = x[: x.numel() // 4 * 4].reshape(1, -1).contiguous()
    d, cols = x.shape
    ones_d, ones_n = torch.ones(d, device=dev), torch.ones(cols, device=dev)
    ref = torch.tanh(x)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "inputs": cols}
    for tag, flags in (("fmad_false", list(_build.NVCC_FLAGS)),
                       ("fmad_true", [f for f in _build.NVCC_FLAGS if f != "-fmad=false"])):
        lib = _library(tag, flags)
        h, z, c = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        amax = torch.zeros(d, device=dev)
        code = lib.chain_sweep_tanh(x.data_ptr(), ones_d.data_ptr(), ones_n.data_ptr(),
                                    ones_n.data_ptr(), c.data_ptr(), h.data_ptr(), z.data_ptr(),
                                    amax.data_ptr(), d, cols, 1, 1,
                                    torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if code:
            raise RuntimeError(f"chain_sweep_tanh ({tag}) failed with CUDA error {code}")
        ulps = (h.view(torch.int32).long() - ref.view(torch.int32).long()).abs()
        result[tag] = {"differ": int((ulps > 0).sum()), "max_ulps": int(ulps.max())}
    xr = torch.randn(n, device=dev, generator=g).mul_(2).requires_grad_(True)
    gg = torch.randn(n, device=dev, generator=g)
    y = torch.tanh(xr)
    y.backward(gg)
    yd = y.detach()
    result["tanh_backward"] = {
        "gradients": n,
        "differ_from_two_roundings": int((xr.grad != (1.0 - yd * yd) * gg).sum()),
        "differ_from_one_rounding": int((xr.grad != (1 - yd.double() ** 2).float() * gg).sum()),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
