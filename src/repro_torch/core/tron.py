"""Trust Region Newton (TRON) baseline (Lin & More 1999; Yuan et al. 2010),
in torch.

Port of `repro.core.tron`, the comparison solver of paper sections 5.1 and
5.2. The l1 problem in its bound-constrained form with duplicated
variables

    min_{v >= 0} f(v) = c sum_i phi((v+ - v-) . x_i, y_i) + sum_j v_j ,
    v = [v+; v-] in R^{2n}_+,  w = v+ - v- ,

solved by projected trust-region Newton: the free set from the projected
gradient, truncated conjugate gradient on it, a projected Armijo search
(sigma = 0.01, beta = 0.1) and the actual/predicted radius update. Every
touch of X is the design's matvec / rmatvec (either layout); the branches
read host floats, as the reference's do, so each CG step and each search
candidate costs host syncs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import HESSIAN_FLOOR
from repro_torch.core.problem import L1Problem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TRONConfig:
    max_outer: int = 500
    max_cg: int = 50
    tol_kkt: float = 1e-3
    sigma: float = 0.01   # projected line search sufficient-decrease
    beta: float = 0.1     # projected line search backtracking factor
    eta0: float = 1e-4    # radius update thresholds (Lin-More)
    eta1: float = 0.25
    eta2: float = 0.75


class TRONResult(NamedTuple):
    w: Tensor
    objective: float
    n_outer: int
    converged: bool
    history: dict


def _make_oracles(problem: L1Problem):
    """(fgrad, hess_vec) over the design's matvec / rmatvec."""
    design, y, c = problem.design, problem.y, problem.c
    loss = problem.loss
    n = problem.n_features

    def fgrad(v):
        w = v[:n] - v[n:]
        z = design.matvec(w)
        f = c * torch.sum(loss.value(z, y)) + torch.sum(v)
        g = design.rmatvec(c * loss.dz(z, y))
        return f, torch.cat([g, -g]) + 1.0, z

    def hess_vec(z, p):
        pw = p[:n] - p[n:]
        hv = design.rmatvec(
            torch.clamp_min(c * loss.d2z(z, y), HESSIAN_FLOOR) *
            design.matvec(pw))
        return torch.cat([hv, -hv])

    return fgrad, hess_vec


def _where(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _truncated_cg(hess_vec, z, grad, free, radius, max_cg, tol=0.1):
    """CG on the free set for H p = -grad, truncated at the TR boundary."""
    g = _where(free, grad)
    p = torch.zeros_like(g)
    r = -g
    d = r
    rr = torch.dot(r, r)
    gnorm = torch.sqrt(rr)
    for _ in range(max_cg):
        if float(torch.sqrt(rr)) <= tol * float(gnorm) + 1e-12:
            break
        Hd = _where(free, hess_vec(z, _where(free, d)))
        dHd = torch.dot(d, Hd)
        if float(dHd) <= 1e-16:  # nonpositive curvature: go to boundary
            tau = _boundary_tau(p, d, radius)
            return p + tau * d, True
        alpha = rr / dHd
        p_next = p + alpha * d
        if float(torch.linalg.vector_norm(p_next)) >= radius:
            tau = _boundary_tau(p, d, radius)
            return p + tau * d, True
        p = p_next
        r = r - alpha * Hd
        rr_next = torch.dot(r, r)
        d = r + (rr_next / rr) * d
        rr = rr_next
    return p, False


def _boundary_tau(p, d, radius):
    """largest tau >= 0 with ||p + tau d|| = radius."""
    pp = float(torch.dot(p, p))
    pd = float(torch.dot(p, d))
    dd = float(torch.dot(d, d)) + 1e-30
    disc = max(pd * pd + dd * (radius * radius - pp), 0.0)
    return (-pd + np.sqrt(disc)) / dd


def solve(problem: L1Problem, cfg: TRONConfig = TRONConfig()) -> TRONResult:
    n = problem.n_features
    fgrad, hess_vec = _make_oracles(problem)
    v = torch.zeros((2 * n,), dtype=problem.solve_dtype,
                    device=problem.device)
    f, grad, z = fgrad(v)
    radius = float(torch.linalg.vector_norm(grad))

    hist = {"outer_iter": [], "objective": [], "kkt": [], "wall_time": []}
    t0 = time.perf_counter()
    converged = False
    it = 0
    for it in range(cfg.max_outer):
        # projected-gradient KKT measure for v >= 0
        free = (v > 0) | (grad < 0)
        kkt = float(torch.max(torch.abs(_where(free, grad))))
        hist["outer_iter"].append(it)
        hist["objective"].append(float(f))
        hist["kkt"].append(kkt)
        hist["wall_time"].append(time.perf_counter() - t0)
        if kkt <= cfg.tol_kkt:
            converged = True
            break

        p, _ = _truncated_cg(hess_vec, z, grad, free, radius, cfg.max_cg)

        # projected Armijo line search (sigma, beta from paper section 5.1)
        step = 1.0
        accepted = False
        for _ in range(30):
            v_new = torch.clamp_min(v + step * p, 0.0)
            f_new, grad_new, z_new = fgrad(v_new)
            gTd = float(torch.dot(grad, v_new - v))
            if float(f_new) - float(f) <= cfg.sigma * gTd and gTd <= 0:
                accepted = True
                break
            step *= cfg.beta
        if not accepted:
            radius *= 0.25
            continue

        # radius update from actual vs predicted reduction
        s = v_new - v
        pred = float(torch.dot(grad, s) + 0.5 * torch.dot(s, hess_vec(z, s)))
        actual = float(f_new) - float(f)
        rho = actual / pred if pred < 0 else -1.0
        snorm = float(torch.linalg.vector_norm(s))
        if rho < cfg.eta1:
            radius = max(0.25 * radius, 0.5 * snorm)
        elif rho > cfg.eta2 and snorm >= 0.9 * radius:
            radius = 2.0 * radius
        if rho > cfg.eta0:
            v, f, grad, z = v_new, f_new, grad_new, z_new

    w = v[:n] - v[n:]
    return TRONResult(w=w, objective=float(f), n_outer=it + 1,
                      converged=converged,
                      history={k: np.asarray(x) for k, x in hist.items()})
