"""Certified safe parallelism (port of `repro.diag.safep`).

PCDN's bundle size P is a raw knob: too large and the parallel updates
fight (deep backtracks, then the divergence guard). Two theory lines
certify a safe P from quantities the design matrix already holds:

* **Spectral (Bradley et al., arXiv 1105.5379 -- Shotgun).** With
  unit-normalized columns, parallel coordinate descent is near-guaranteed
  up to P* ~ n / rho, rho the spectral radius of the normalized Gram
  matrix M = D^{-1/2} X'X D^{-1/2}, D = diag(||x_j||^2). M is PSD, so
  plain power iteration on matvec / rmatvec finds rho without ever
  forming the Gram matrix.
* **ESO (Fercoq-Richtarik, arXiv 1309.5885).** For uniform tau-nice
  sampling, beta(tau) = 1 + (tau-1)(omega-1)/(n-1), omega the most
  features any one sample touches. The largest tau with beta(tau) <=
  beta_max is certified.

`certify(design)` reports both and P_cert = the larger. The arithmetic is
the reference's: the products are float32, through the design's own
`matvec` / `rmatvec` (on the card for a CUDA design: `index_add_` and
gathers on the padded-CSC layout, a matrix-vector product on the dense
one), and the Rayleigh quotient, the norms and the stop test are float64
numpy on the host, from a numpy start vector drawn from `seed`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _col_scale(design) -> np.ndarray:
    """1/||x_j|| per column with zeros for empty columns (which contribute
    a zero eigendirection, not a division blow-up)."""
    d = design.column_norms_sq().detach().double().cpu().numpy()
    scale = np.zeros_like(d)
    np.divide(1.0, np.sqrt(d), out=scale, where=d > 0)
    return scale


def _f32(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def power_iteration_rho(design, n_iter: int = 1000, tol: float = 1e-9,
                        seed: int = 0) -> dict:
    """Top eigenvalue of the normalized Gram M = D^{-1/2} X'X D^{-1/2}.

    One matvec + one rmatvec a step through the design (dense or
    padded-CSC, never densified), the Rayleigh-quotient estimate, stop at
    relative change <= tol. Deterministic start from `seed`.
    """
    n = design.n_features
    dev = design.device
    scale = _col_scale(design)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    rho_prev = 0.0
    converged = False
    it = 0
    for it in range(1, n_iter + 1):
        u = design.matvec(_f32(v * scale, dev))
        mv = scale * design.rmatvec(u).double().cpu().numpy()
        rho = float(v @ mv)                      # Rayleigh quotient
        nrm = np.linalg.norm(mv)
        if nrm == 0.0:                           # X == 0: rho is 0
            rho, converged = 0.0, True
            break
        v = mv / nrm
        if abs(rho - rho_prev) <= tol * max(abs(rho), 1.0):
            converged = True
            rho_prev = rho
            break
        rho_prev = rho
    return {"rho": float(rho_prev), "n_iter": int(it),
            "converged": bool(converged)}


def omega_row_support(design) -> int:
    """omega = the most features any one sample touches (max row nnz).

    Padded-CSC: histogram the col_rows ids, leaving out the sentinel
    (== n_samples) padding slots and explicit zero values (a stored zero
    couples nothing). Dense: count nonzeros per row.
    """
    if design.layout == "padded_csc":
        rows = design.col_rows.cpu().numpy().ravel()
        vals = design.col_vals.float().cpu().numpy().ravel()
        keep = (rows != design.n_samples) & (vals != 0.0)
        if not np.any(keep):
            return 0
        return int(np.bincount(rows[keep],
                               minlength=design.n_samples).max())
    X = design.X
    if X.numel() == 0:
        return 0
    return int(torch.max(torch.sum(X != 0, dim=1)))


def eso_safe_p(omega: int, n_features: int, beta_max: float = 2.0) -> int:
    """Largest tau with beta(tau) = 1 + (tau-1)(omega-1)/(n-1) <= beta_max.

    omega <= 1 means no sample couples two features: tau = n is safe.
    n == 1 is trivially tau = 1.
    """
    n = int(n_features)
    if n <= 1:
        return max(n, 1)
    if omega <= 1:
        return n
    tau = 1.0 + (float(beta_max) - 1.0) * (n - 1) / (omega - 1)
    return int(np.clip(np.floor(tau), 1, n))


def spectral_safe_p(rho: float, n_features: int) -> int:
    """Shotgun's P* = n / rho (rho of the column-normalized Gram)."""
    n = int(n_features)
    if rho <= 0.0:
        return n
    return int(np.clip(np.floor(n / rho), 1, n))


def certify(design, beta_max: float = 2.0, n_iter: int = 1000,
            tol: float = 1e-9, seed: int = 0,
            observed_p: Optional[int] = None) -> dict:
    """The certified-parallelism record the health report renders.

    P_cert is the larger of the two certified bounds; `observed_p` (the P
    a solve ran) rides along for the report's comparison.
    """
    power = power_iteration_rho(design, n_iter=n_iter, tol=tol, seed=seed)
    omega = omega_row_support(design)
    n = int(design.n_features)
    p_spec = spectral_safe_p(power["rho"], n)
    p_eso = eso_safe_p(omega, n, beta_max)
    out = {"n_samples": int(design.n_samples), "n_features": n,
           "rho_normalized": power["rho"],
           "power_iters": power["n_iter"],
           "power_converged": power["converged"],
           "P_spectral": p_spec,
           "omega": int(omega), "beta_max": float(beta_max),
           "P_eso": p_eso,
           "P_cert": max(p_spec, p_eso)}
    if observed_p is not None:
        out["observed_P"] = int(observed_p)
    return out
