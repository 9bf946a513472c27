"""Adam (Kingma and Ba) with bias correction, the update the reference
framework trains with: lr, betas (0.9, 0.999), eps 1e-8, no decay."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], lr: float, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> None:
        self.count += 1
        bc1 = 1 - self.beta1 ** self.count
        bc2 = 1 - self.beta2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            self.v[k].mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
