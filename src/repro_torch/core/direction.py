"""One-dimensional Newton direction for the l1 subproblem (paper Eq. 4/5).

    d(w; j) = argmin_d  g d + (1/2) h d^2 + |w_j + d|

Closed form (Eq. 5), tested in this order:

    d = -(g + 1)/h   if g + 1 <= h w_j
    d = -(g - 1)/h   if g - 1 >= h w_j
    d = -w_j         otherwise

Port of `repro.core.direction`; the CUDA kernels apply the same branch
order in their epilogues (kernels/csrc/common.cuh).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def newton_direction(g: Tensor, h: Tensor, w: Tensor) -> Tensor:
    """Eq. 5, elementwise over a bundle. g, h, w: (P,) -> d: (P,)."""
    d_neg = -(g + 1.0) / h
    d_pos = -(g - 1.0) / h
    hw = h * w
    return torch.where(g + 1.0 <= hw, d_neg,
                       torch.where(g - 1.0 >= hw, d_pos, -w))


def delta_decrement(g: Tensor, h: Tensor, w: Tensor, d: Tensor,
                    gamma: float) -> Tensor:
    """Armijo decrement Delta (paper Eq. 7), restricted to the bundle.

    Delta = g.d + gamma d^T H d + ||w+d||_1 - ||w||_1
    """
    quad = torch.sum(h * torch.square(d))
    lin = torch.sum(g * d)
    l1 = torch.sum(torch.abs(w + d)) - torch.sum(torch.abs(w))
    return lin + gamma * quad + l1
