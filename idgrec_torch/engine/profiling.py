"""Tracing and throughput observability (counterpart of
idgrec_tpu/engine/profiling.py).

* `maybe_trace`: a context manager around `torch.profiler.profile`,
  gated by a directory argument (``train_model(profile_dir=...)`` / CLI
  ``--profile_dir``); writes one Chrome trace file of the wrapped work
  (host activity, and the card's kernels when the run is on the card)
  into the directory;
* `ThroughputMeter`: derives pairs/s and propagation GFLOP/s from epoch
  wall time and the model's static work estimate (2·nnz·d FLOPs per
  sparse application; the dense backend's tensor-core work is
  2·U_pad·I_pad·d per direction). The keys (``pairs_per_sec``,
  ``sparse_gflops``, ``mxu_gflops``) are the JAX package's, so the
  ``train_epoch`` events of both packages line up; ``mxu_gflops`` names
  the dense matrix-unit work on whichever device ran it;
* `debug_options`: ``debug_nans = 1`` in the config turns on
  `torch.autograd.set_detect_anomaly`, which fails fast on a NaN in a
  backward pass.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir: str | None):
    """torch.profiler trace when a directory is given, no-op otherwise."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{int(time.time() * 1e3)}_{os.getpid()}.json"))


def debug_options(config) -> None:
    """Apply run-debug flags from config:

    debug_nans = 1      -> torch.autograd.set_detect_anomaly(True)
    """
    if config.int("debug_nans", 0) == 1:
        torch.autograd.set_detect_anomaly(True)


@dataclass
class ThroughputMeter:
    """Static per-epoch work model; turns epoch seconds into rates."""

    num_train: int          # BPR triples per epoch
    nnz: int                # interaction count (edges; x2 for symmetric Â)
    emb_size: int
    num_layers: int
    steps_per_epoch: int
    aggregates_per_step: int = 1
    dense_dims: tuple[int, int] | None = None  # padded (U, I) if dense backend

    @property
    def sparse_flops_per_epoch(self) -> float:
        """Algorithmic sparse FLOPs: fwd+bwd per layer, both directions
        (2·nnz rows each way), 2 FLOPs per multiply-add."""
        per_app = 2.0 * (2 * self.nnz) * self.emb_size
        apps = 2 * self.num_layers * self.aggregates_per_step * self.steps_per_epoch
        return per_app * apps

    @property
    def mxu_flops_per_epoch(self) -> float:
        """Dense matrix-unit FLOPs when a dense backend runs (0 otherwise)."""
        if self.dense_dims is None:
            return 0.0
        u, i = self.dense_dims
        per_app = 2.0 * u * i * self.emb_size * 2  # both directions
        apps = 2 * self.num_layers * self.aggregates_per_step * self.steps_per_epoch
        return per_app * apps

    def rates(self, epoch_seconds: float) -> dict[str, float]:
        s = max(epoch_seconds, 1e-9)
        return {
            "pairs_per_sec": self.num_train / s,
            "sparse_gflops": self.sparse_flops_per_epoch / s / 1e9,
            "mxu_gflops": self.mxu_flops_per_epoch / s / 1e9,
        }
