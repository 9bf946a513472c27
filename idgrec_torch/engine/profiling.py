"""Tracing and throughput observability (counterpart of
idgrec_tpu/engine/profiling.py).

* `maybe_trace`: a context manager around `torch.profiler.profile`,
  gated by a directory argument (``train_model(profile_dir=...)`` / CLI
  ``--profile_dir``); writes one Chrome trace file of the wrapped work
  (host activity, the program's spans, and the card's kernels when the
  run is on the card) into the directory, and empties the span log when
  it ends;
* `span`: the program's spans (the training step and its forward,
  backward and Adam, K6's applications, the evaluation sweep and its
  representation, scores, mask and top-k, the sampler's epoch). Off, a
  span is one check and a shared no-op object; while a `torch.profiler`
  records, it is a host record on the profiler's clock, enclosing the
  ops it runs, and a device interval in stream order in the span log
  (`span_log`, `clear_spans`);
* `ThroughputMeter`: derives pairs/s and propagation GFLOP/s from epoch
  wall time and the model's static work estimate (2·nnz·d FLOPs per
  sparse application). The keys (``pairs_per_sec``, ``sparse_gflops``)
  are the JAX package's, so the ``train_epoch`` events of both packages
  line up;
* `debug_options`: ``debug_nans = 1`` in the config turns on
  `torch.autograd.set_detect_anomaly`, which fails fast on a NaN in a
  backward pass.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass

import torch
from torch._C._profiler import _RecordFunctionFast


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
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_{int(time.time() * 1e3)}_{os.getpid()}.json"))
    finally:
        clear_spans()


# ---------------------------------------------------------------------------
# spans

_OFF = contextlib.nullcontext()  # what `span` gives while no profiler records
_LOG: list[_Open] = []           # every span entered while a profiler recorded, in entry order
_OPEN = threading.local()        # .stack: this thread's open spans, innermost last


@dataclass(frozen=True)
class Span:
    """One span of the log. ``parent`` is the index in the same log of
    the innermost span open on the same thread at entry, or None (K6's
    spans on autograd's device thread have none). ``device_ms``: on the
    card the interval between the span's two events on the current
    stream, so the device time of the work it enqueued in stream order,
    with any idle of the stream between; on the CPU the host clock.
    ``whole``: the profiler still recorded when the span ended (false
    for the span in which it stopped)."""

    name: str
    parent: int | None
    thread: int
    device_ms: float
    whole: bool


class _Open:
    """A span entered while a profiler recorded: the host record, the
    two clock readings, and its fields once ended."""

    __slots__ = ("name", "parent", "thread", "record", "start", "end", "whole", "ms")

    def __init__(self, name: str):
        self.name, self.end, self.ms = name, None, None

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        _LOG.append(self)
        self.record = _RecordFunctionFast(self.name)
        self.record.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.end = _clock()
        self.whole = torch.autograd._profiler_enabled()
        self.record.__exit__(*exc)
        _OPEN.stack.pop()
        return False


def _clock():
    """A timing event recorded on the current CUDA stream once the process
    uses the card, else the host clock in seconds. (`torch.Event` finds
    the stream in C++; `torch.cuda.Event.record` builds a Python stream
    object first, which costs a span on the card about twice as much.)"""
    if torch.cuda.is_initialized():
        event = torch.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def span(name: str):
    """The context of span ``name``: the shared no-op object unless a
    `torch.profiler` is recording on this thread."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Open(name)


def span_log() -> list[Span]:
    """The ended spans since the log was last emptied, in entry order,
    with their device ms (one synchronize when any was timed on the
    card). A span still open is left out, and so is its place: a
    ``parent`` refers to this list."""
    ended = [s for s in _LOG if s.end is not None]
    if any(s.ms is None and not isinstance(s.start, float) for s in ended):
        torch.cuda.synchronize()
    for s in ended:
        if s.ms is None:
            s.ms = (1e3 * (s.end - s.start) if isinstance(s.start, float)
                    else s.start.elapsed_time(s.end))
    at = {id(s): k for k, s in enumerate(ended)}
    return [Span(s.name, None if s.parent is None else at.get(id(s.parent)), s.thread, s.ms,
                 s.whole) for s in ended]


def clear_spans() -> None:
    """Empty the span log."""
    _LOG.clear()


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

    @property
    def sparse_flops_per_epoch(self) -> float:
        """Algorithmic sparse FLOPs: fwd+bwd per layer, both directions
        (2·nnz rows each way), 2 FLOPs per multiply-add."""
        per_app = 2.0 * (2 * self.nnz) * self.emb_size
        apps = 2 * self.num_layers * self.aggregates_per_step * self.steps_per_epoch
        return per_app * apps

    def rates(self, epoch_seconds: float) -> dict[str, float]:
        s = max(epoch_seconds, 1e-9)
        return {
            "pairs_per_sec": self.num_train / s,
            "sparse_gflops": self.sparse_flops_per_epoch / s / 1e9,
        }
