"""l1-regularized ERM problem container (paper Eq. 1), in torch.

    min_w  F_c(w) = c * sum_i phi(w . x_i, y_i) + ||w||_1

Port of `repro.core.problem`: the design matrix behind the `DesignMatrix`
interface, labels y (s,), the regularization weight c, the loss, and an
optional elastic-net (lambda2/2)||w||^2 term that folds into the gradient
and Hessian diagonals. The design may store bf16 values; the labels and
the solver state (w, z) stay float32 (`solve_dtype`). `c` is a plain
Python float: the CUDA kernels take it as a run-time argument, so changing
it never rebuilds anything.
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

    def with_labels(self, y: Tensor) -> "L1Problem":
        """Replace the labels (same design); the batch solver's per-problem
        labels. y: (s,) float32 on the design's device."""
        return dataclasses.replace(self, y=y)

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

    @property
    def solve_dtype(self):
        """Dtype of the solver state (w, z, labels): float32 under bf16
        storage, the design's dtype otherwise."""
        return self.design.acc_dtype

    # -- objective -----------------------------------------------------------
    def margins(self, w: Tensor) -> Tensor:
        return self.design.matvec(w)

    def objective_from_margins(self, z: Tensor, w: Tensor) -> Tensor:
        f = self.loss.margin_objective(z, self.y, self.c) + \
            torch.sum(torch.abs(w))
        if self.elastic_net_l2:
            f = f + 0.5 * self.elastic_net_l2 * torch.sum(torch.square(w))
        return f

    def objective(self, w: Tensor) -> Tensor:
        return self.objective_from_margins(self.margins(w), w)

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

    # -- Lemma 1 quantities ----------------------------------------------------
    def column_norms_sq(self) -> Tensor:
        """(X^T X)_jj for j in N: the lambda_j of Lemma 1 / Theorem 2."""
        return self.design.column_norms_sq()


def make_problem(X, y, c: float, loss: str = "logistic",
                 elastic_net_l2: float = 0.0, dtype=torch.float32,
                 layout: str = "auto", k_max: Optional[int] = None,
                 device="cuda") -> L1Problem:
    """Build an L1Problem on `device` from a dense array, a PaddedCSC
    object or a DesignMatrix, its values stored in `dtype` (float32 or
    bfloat16; float64 inputs are cast, as the reference runs without
    x64). The labels are float32 either way."""
    dev = resolve_device(device)
    design = as_design(X, dtype=dtype, layout=layout, k_max=k_max,
                       device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    return L1Problem(design=design, y=y, c=float(c), loss_name=loss,
                     elastic_net_l2=float(elastic_net_l2))


def validation_accuracy(design, y, w, device="cuda") -> float:
    """Classification accuracy of sign(X_val @ w) against +-1 labels.

    `design` may be anything `as_design` accepts (a dense array, a
    PaddedCSC object, a DesignMatrix, which keeps its own device), so a
    held-out split is never densified. Zero margins count as +1, as in
    data.synthetic.train_accuracy.
    """
    if isinstance(design, DesignMatrix):
        d = design
    else:
        d = as_design(design, device=resolve_device(device))
    w_t = torch.as_tensor(np.asarray(w, np.float32), device=d.device)
    z = d.matvec(w_t.to(d.acc_dtype)).cpu().numpy()
    pred = np.sign(z)
    pred[pred == 0] = 1.0
    return float(np.mean(pred == np.asarray(y)))


def expected_max_column_norm(problem: L1Problem, P: int) -> float:
    """E_B[ lambda_bar(B) ] for uniform random size-P bundles (Lemma 1a).

    f(P) = (1/C(n,P)) * sum_k lambda_(k) * C(k-1, P-1), computed stably in
    log space with numpy on the host (analysis-time only).
    """
    lam = np.sort(problem.column_norms_sq().double().cpu().numpy())
    return float(expected_max_of_sample(lam, P))


def expected_max_of_sample(lam_sorted: np.ndarray, P: int) -> float:
    """E[max of a uniform size-P subset] given sorted values (Lemma 1a,
    Eq. 22).

    The weight of the k-th smallest value (1-indexed) is
    C(k-1,P-1)/C(n,P), computed in log space via cumulative
    log-factorials.
    """
    lam_sorted = np.asarray(lam_sorted, dtype=np.float64)
    n = lam_sorted.shape[0]
    P = int(P)
    if not 1 <= P <= n:
        raise ValueError(f"P={P} out of [1, {n}]")
    if P == 1:
        return float(lam_sorted.mean())
    # log k! for k = 0..n
    logfact = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, n + 1)))])

    def logC(a: np.ndarray, b: int) -> np.ndarray:  # log C(a, b), a >= b
        return logfact[a] - logfact[b] - logfact[a - b]

    k = np.arange(P, n + 1)  # only k >= P contribute
    logw = logC(k - 1, P - 1) - logC(np.array([n]), P)
    w = np.exp(logw)
    return float(np.sum(w * lam_sorted[P - 1:]))
