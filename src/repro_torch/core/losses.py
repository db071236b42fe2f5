"""Loss functions for l1-regularized minimization (paper Eq. 1-3), in torch.

Port of `repro.core.losses`: every loss is expressed through the
per-sample margin z_i = w . x_i with the same numerically stable forms
(`_softplus`, sigmoid), so the port and the reference agree elementwise
to float32 rounding.

    value(z, y)  per-sample loss
    dz(z, y)     d phi / d z     (gradient factor)
    d2z(z, y)    d^2 phi / d z^2 (diagonal-Hessian factor; generalized
                 second derivative for the L2-SVM)

The full objective is F_c(w) = c * sum_i phi(z_i, y_i) + ||w||_1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor

# Positive floor on Hessian diagonal entries (paper footnote 1 / Lemma 1(b)).
HESSIAN_FLOOR = 1e-12


def _softplus(m: Tensor) -> Tensor:
    """log(1 + e^m), stable for any m."""
    return torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-torch.abs(m)))


@dataclasses.dataclass(frozen=True)
class Loss:
    """A convex per-sample loss phi(z; y) with margin z = w.x."""

    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    dz: Callable[[Tensor, Tensor], Tensor]
    d2z: Callable[[Tensor, Tensor], Tensor]
    theta: float  # Lemma 1(b): d2z <= theta pointwise

    def margin_objective(self, z: Tensor, y: Tensor, c) -> Tensor:
        """c * sum_i phi(z_i, y_i)  (loss part of F_c)."""
        return c * torch.sum(self.value(z, y))


# --- logistic regression (paper Eq. 2) --------------------------------------

def _log_value(z, y):
    return _softplus(-y * z)


def _log_dz(z, y):
    return (torch.sigmoid(y * z) - 1.0) * y


def _log_d2z(z, y):
    t = torch.sigmoid(y * z)
    return t * (1.0 - t)


LOGISTIC = Loss("logistic", _log_value, _log_dz, _log_d2z, theta=0.25)


# --- L2-loss SVM (squared hinge, paper Eq. 3) --------------------------------

def _svm_value(z, y):
    return torch.square(torch.clamp_min(1.0 - y * z, 0.0))


def _svm_dz(z, y):
    return -2.0 * y * torch.clamp_min(1.0 - y * z, 0.0)


def _svm_d2z(z, y):
    return 2.0 * (y * z < 1.0).to(z.dtype)


SQUARED_HINGE = Loss("squared_hinge", _svm_value, _svm_dz, _svm_d2z,
                     theta=2.0)


# --- squared loss (Lasso; paper section 6 extension) -------------------------

def _sq_value(z, y):
    return 0.5 * torch.square(z - y)


def _sq_dz(z, y):
    return z - y


def _sq_d2z(z, y):
    return torch.ones_like(z)


SQUARED = Loss("squared", _sq_value, _sq_dz, _sq_d2z, theta=1.0)


LOSSES = {l.name: l for l in (LOGISTIC, SQUARED_HINGE, SQUARED)}


def get_loss(name: str) -> Loss:
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; have {sorted(LOSSES)}")
    return LOSSES[name]
