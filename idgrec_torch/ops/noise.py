"""The random draws inside a model's step (counterpart of the
``jax.random`` calls in the JAX models: ``uniform`` in SimGCL and
XSimGCL, ``normal`` in BIGCF, ``beta``, ``dirichlet`` and
``permutation`` in MixRec, ``bernoulli`` in HCCF's, IMPGCN's and NGCF's
dropout, ``choice`` in NCL's k-means).

* Every draw takes an explicit `torch.Generator` and lands on that
  generator's device. The global generators are never used, so
  `torch.distributions` (which samples from them) is not either. A
  generator of None raises `ValueError`.
* Nothing here reads a value back to the host: a step's draws do not
  synchronise with it.
* Models call these through the module (``noise.uniform(...)``), so a
  test can swap them for a replay of the JAX package's draws.
* The gamma-based draws work in log space, as ``jax.random.beta`` and
  ``jax.random.dirichlet`` do. At MixRec's published concentrations
  (0.1) about one Gamma(0.1) draw in 6,000 lies below float32's
  smallest normal number, where PyTorch's sampler clamps it; X / (X + Y)
  of two such draws is then 1/2 whatever their true ratio, and 0/0
  without the clamp. Here a concentration below 1 draws
  Gamma(alpha + 1) and adds log(U) / alpha (Marsaglia and Tsang's
  boost), and the draws are normalised by a softmax of their logs, so
  no draw is NaN.
"""

from __future__ import annotations

from typing import Sequence

import torch


def require_generator(generator: torch.Generator | None, who: str) -> torch.Generator:
    """``generator``, or `ValueError` when it is None: a step that draws
    never falls back to a global generator."""
    if generator is None:
        raise ValueError(f"{who} draws random numbers: pass a torch.Generator "
                         "on the model's device")
    return generator


def uniform(shape: Sequence[int], generator: torch.Generator,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` (``jax.random.uniform``)."""
    generator = require_generator(generator, "noise.uniform")
    return torch.rand(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def normal(shape: Sequence[int], generator: torch.Generator,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` (``jax.random.normal``)."""
    generator = require_generator(generator, "noise.normal")
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def _log_gamma(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """log of one Gamma(alpha, 1) draw per entry of ``alpha``, finite for
    every positive alpha: below 1, log Gamma(alpha + 1) + log(U) / alpha,
    with U in (0, 1]."""
    boost = alpha < 1
    g = torch._standard_gamma(torch.where(boost, alpha + 1, alpha), generator=generator)
    u = 1 - torch.rand(alpha.shape, generator=generator, device=alpha.device, dtype=alpha.dtype)
    return torch.log(g) + torch.where(boost, torch.log(u) / alpha, 0)


def beta(a: float, b: float, generator: torch.Generator,
         shape: Sequence[int] = ()) -> torch.Tensor:
    """Beta(a, b) draws of ``shape`` (a 0-d tensor by default;
    ``jax.random.beta``): the first coordinate of a Dirichlet([a, b])
    draw, sigmoid(log X − log Y), in [0, 1] and never NaN."""
    generator = require_generator(generator, "noise.beta")
    conc = torch.stack([torch.full(tuple(shape), float(c), dtype=torch.float32,
                                   device=generator.device) for c in (a, b)], dim=-1)
    log_g = _log_gamma(conc, generator)
    return torch.sigmoid(log_g[..., 0] - log_g[..., 1])


def dirichlet(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One Dirichlet(alpha) draw over the last axis of ``alpha`` (float32,
    on the generator's device; ``jax.random.dirichlet``): the softmax of
    the log-gamma draws, so each row sums to 1 and none is NaN."""
    generator = require_generator(generator, "noise.dirichlet")
    return torch.softmax(_log_gamma(alpha, generator), dim=-1)


def permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """A uniform random permutation of range(n), int64
    (``jax.random.permutation`` of an integer)."""
    generator = require_generator(generator, "noise.permutation")
    return torch.randperm(int(n), generator=generator, device=generator.device)


def bernoulli(p: float, shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """A bool mask of ``shape``, each entry True with probability ``p``
    (``jax.random.bernoulli``: U[0, 1) < p)."""
    generator = require_generator(generator, "noise.bernoulli")
    return torch.rand(tuple(shape), generator=generator, device=generator.device) < p


def choice(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` distinct indices of range(n), int64, uniformly at random
    (``jax.random.choice(key, n, (k,), replace=False)``): the first k of a
    random permutation."""
    generator = require_generator(generator, "noise.choice")
    if not 0 <= k <= n:
        raise ValueError(f"cannot choose {k} distinct indices of range({n})")
    return torch.randperm(int(n), generator=generator, device=generator.device)[:k]
