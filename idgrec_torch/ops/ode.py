"""Fixed-step Euler integration (counterpart of idgrec_tpu/ops/ode.py),
LightGODE's graph ODE.

The reference integrates ``dx/dt = Â·x + e₀`` with torchdiffeq's Euler
solver over ``t = [0, T]``. With no step-size option, torchdiffeq's
fixed-grid solver steps on the output times themselves: one Euler step
per consecutive pair, so over [0, T] a single step of size T,
``x(T) = e₀ + T·(Â·e₀ + e₀)``. `odeint_euler` keeps that grid rule for
any list of times, and its operation order: the step is not folded into
``(1 + T)·e₀ + T·Â·e₀``, which rounds differently.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def odeint_euler(f: Callable[[float, torch.Tensor], torch.Tensor], y0: torch.Tensor,
                 ts: Sequence[float]) -> torch.Tensor:
    """y at the last time of ``ts`` for y' = f(t, y), y(ts[0]) = y0: one
    Euler step y + (t1 - t0)·f(t0, y) per consecutive pair of ``ts``
    (Python floats). Differentiable in whatever ``f`` and ``y0`` are."""
    y = y0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        y = y + (t1 - t0) * f(t0, y)
    return y
