"""Device policy shared by every entry point of the port.

The port runs on the card. The CPU is used only when the caller asks
for it by name (``device="cpu"``, as the tests do); there is no silent
fallback when CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for (or
    implied) and the process has no usable card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_exact_matmul(device: torch.device) -> None:
    """Raise unless float32 products on the card run in full float32
    (the JAX scoring uses Precision.HIGHEST, and the exact-mode products
    keep a float32 accumulator's value)."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 matmul must run in full precision: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False and "
                           "float32 matmul precision 'highest'")
