"""l1-regularized ERM problem container (paper Eq. 1), in torch.

    min_w  F_c(w) = c * sum_i phi(w . x_i, y_i) + ||w||_1

Port of `repro.core.problem`: the design matrix behind the `DesignMatrix`
interface, labels y (s,), the regularization weight c, the loss, and an
optional elastic-net (lambda2/2)||w||^2 term that folds into the gradient
and Hessian diagonals. `c` is a plain Python float: the CUDA kernels take
it as a run-time argument, so changing it never rebuilds anything.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.design_matrix import (DenseSlab, DesignMatrix,
                                            Slab, SparseSlab, as_design)
from repro_torch.core.losses import HESSIAN_FLOOR, Loss, get_loss
from repro_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class L1Problem:
    """l1-regularized problem over a DesignMatrix backend. y: (s,) +-1."""

    design: DesignMatrix
    y: Tensor
    c: float
    loss_name: str = "logistic"
    elastic_net_l2: float = 0.0

    def with_c(self, c) -> "L1Problem":
        """Replace the regularization weight (same design and labels)."""
        return dataclasses.replace(self, c=float(c))

    @property
    def loss(self) -> Loss:
        return get_loss(self.loss_name)

    @property
    def n_samples(self) -> int:
        return self.design.n_samples

    @property
    def n_features(self) -> int:
        return self.design.n_features

    @property
    def dtype(self):
        return self.design.dtype

    @property
    def device(self):
        return self.design.device

    # -- objective -----------------------------------------------------------
    def margins(self, w: Tensor) -> Tensor:
        return self.design.matvec(w)

    def objective_from_margins(self, z: Tensor, w: Tensor) -> Tensor:
        f = self.loss.margin_objective(z, self.y, self.c) + \
            torch.sum(torch.abs(w))
        if self.elastic_net_l2:
            f = f + 0.5 * self.elastic_net_l2 * torch.sum(torch.square(w))
        return f

    # -- per-sample factors ----------------------------------------------------
    def grad_factor(self, z: Tensor) -> Tensor:
        """u_i = c * dphi/dz_i ; grad_j L = X[:,j] . u."""
        return self.c * self.loss.dz(z, self.y)

    def hess_factor(self, z: Tensor) -> Tensor:
        """v_i = c * d2phi/dz2_i ; hess_jj L = sum_i v_i x_ij^2."""
        return self.c * self.loss.d2z(z, self.y)

    def grad_factor_at(self, z_R: Tensor, y_R: Tensor) -> Tensor:
        """`grad_factor` over gathered support rows (z_R, y_R)."""
        return self.c * self.loss.dz(z_R, y_R)

    def hess_factor_at(self, z_R: Tensor, y_R: Tensor) -> Tensor:
        """`hess_factor` over gathered support rows (z_R, y_R)."""
        return self.c * self.loss.d2z(z_R, y_R)

    def _fold(self, g: Tensor, h: Tensor, w_B: Tensor):
        """Elastic-net fold, then the Hessian floor (in that order)."""
        if self.elastic_net_l2:
            g = g + self.elastic_net_l2 * w_B
            h = h + self.elastic_net_l2
        return g, torch.clamp_min(h, HESSIAN_FLOOR)

    def bundle_grad_hess_support(self, slab: SparseSlab, pos: Tensor,
                                 z_R: Tensor, y_R: Tensor, w_B: Tensor):
        """`bundle_grad_hess` computed entirely on a bundle's row support."""
        u_R = self.grad_factor_at(z_R, y_R)
        v_R = self.hess_factor_at(z_R, y_R)
        g, h = self.design.slab_grad_hess_support(slab, pos, u_R, v_R)
        return self._fold(g, h, w_B)

    def bundle_grad_hess(self, z: Tensor, slab: Union[Slab, Tensor],
                         w_B: Tensor):
        """Gradient and Hessian diagonal restricted to a bundle slab: a
        DenseSlab/SparseSlab, or a raw dense (s, P) block. -> (g_B, h_B)."""
        u = self.grad_factor(z)
        v = self.hess_factor(z)
        if isinstance(slab, (DenseSlab, SparseSlab)):
            g, h = self.design.slab_grad_hess(slab, u, v)
        else:
            g = slab.T @ u
            h = torch.square(slab).T @ v
        return self._fold(g, h, w_B)

    def full_grad(self, z: Tensor, w: Tensor) -> Tensor:
        """grad L(w) (n,) -- used by the KKT stopping criterion."""
        g = self.design.rmatvec(self.grad_factor(z))
        if self.elastic_net_l2:
            g = g + self.elastic_net_l2 * w
        return g

    # -- KKT optimality measure ----------------------------------------------
    def kkt_violation_from_grad(self, w: Tensor, g: Tensor) -> Tensor:
        """Per-feature |minimum-norm subgradient| of F_c at w (n,)."""
        pos = g + 1.0
        neg = g - 1.0
        zero = torch.clamp_min(torch.abs(g) - 1.0, 0.0)
        v = torch.where(w > 0, pos, torch.where(w < 0, neg, zero))
        return torch.abs(v)

    def kkt_violation(self, w: Tensor, z: Optional[Tensor] = None) -> Tensor:
        """inf-norm of the minimum-norm subgradient of F_c at w."""
        if z is None:
            z = self.margins(w)
        g = self.full_grad(z, w)
        return torch.max(self.kkt_violation_from_grad(w, g))

    def c_max(self) -> float:
        """Largest c for which w = 0 is optimal: 1 / ||X^T phi'(0, y)||_inf."""
        z0 = torch.zeros((self.n_samples,), dtype=torch.float32,
                         device=self.y.device)
        g0 = self.design.rmatvec(self.loss.dz(z0, self.y))
        denom = float(torch.max(torch.abs(g0)))
        if denom <= 0.0:
            raise ValueError("degenerate problem: X^T phi'(0, y) == 0 "
                             "(no feature correlates with the labels)")
        return 1.0 / denom


def make_problem(X, y, c: float, loss: str = "logistic",
                 elastic_net_l2: float = 0.0, layout: str = "auto",
                 k_max: Optional[int] = None,
                 device="cuda") -> L1Problem:
    """Build an L1Problem on `device` from a dense array, a PaddedCSC
    object or a DesignMatrix. Float64 inputs are cast to float32 (the
    reference runs without x64)."""
    dev = resolve_device(device)
    design = as_design(X, layout=layout, k_max=k_max, device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    return L1Problem(design=design, y=y, c=float(c), loss_name=loss,
                     elastic_net_l2=float(elastic_net_l2))
