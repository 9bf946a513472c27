"""Build and load the hand-written CUDA kernels of `idgrec_torch/csrc`.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries go to
``idgrec_torch/_build/`` under a name that carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
or header is rebuilt and a stale library is never loaded. Nothing is
built at import: `library` builds on first use, and `build_all` builds
every kernel at once, one ``nvcc`` process per source, all started
together.

No ``--use_fast_math``: the quantization needs IEEE division and
round-half-even. ``-fmad=false`` keeps nvcc from contracting the
epilogues' multiply-adds into FMAs. The sources in ``FMAD_SOURCES`` build
with ``-fmad=true`` instead, as PyTorch's own kernels do, so that the
CUDA math library's ``expf`` there gives PyTorch's bits; they write
their own multiply-adds as ``__fmaf_rn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNEL_SOURCES = ("dual_int8_t", "dual_int4_t", "dual_bf16", "dual_int8_n", "dual_int4_n",
                  "chain_sweep_epilogue", "chain_sweep_tanh", "quantize_rows", "scatter_add_rows",
                  "bit_matmul", "gather_rows_matmul", "score_topk")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

FMAD_SOURCES = ("score_topk",)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags kernel ``name`` builds with."""
    if name in FMAD_SOURCES:
        return tuple("-fmad=true" if f == "-fmad=false" else f for f in NVCC_FLAGS)
    return NVCC_FLAGS


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in (source_path(name), *(os.path.join(CSRC_DIR, f) for f in headers)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(nvcc_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> tuple[subprocess.Popen, str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {source_path(name)}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return log


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every missing library, all nvcc processes at once. Returns
    nvcc's output (ptxas registers, shared memory, spills) by kernel for
    the libraries built."""
    started, logs, errors = [], {}, []
    try:
        for name in names:
            if not os.path.exists(library_path(name)):
                started.append((name, *_start(name)))
    finally:
        for name, proc, tmp, out in started:
            try:
                logs[name] = _finish(name, proc, tmp, out)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all((name,))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA kernel {name} failed: {fn(code).decode()} ({code})")
