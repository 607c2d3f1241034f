"""Adam (Kingma and Ba) as torch defines it: betas (0.9, 0.999), eps
outside the square root, bias-corrected moments, no weight decay;
optionally the gradients first clipped to a global norm (optax's
``clip_by_global_norm``: scaled by max / ||g|| where ||g|| >= max)."""

from __future__ import annotations

from typing import List, Optional

import torch

BETA1, BETA2 = 0.9, 0.999


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = None):
        self.params = params
        self.lr, self.eps, self.max_grad_norm = lr, eps, max_grad_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """One update in place; returns the gradients as applied (after
        clipping)."""
        if self.max_grad_norm is not None:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= self.max_grad_norm:
                grads = [g * float(self.max_grad_norm / norm) for g in grads]
        self.t += 1
        bc1 = 1.0 - BETA1 ** self.t
        bc2 = 1.0 - BETA2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(BETA1).add_(g, alpha=1.0 - BETA1)
            v.mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
            denom = v.sqrt() / (bc2 ** 0.5) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)
        return grads
