"""Geometric c-grids anchored at the analytic c_max (copy of
`repro.path.grid`).

The paper's objective F_c(w) = c * L(w) + ||w||_1 puts the regularization
strength at lambda ~ 1/c: SMALL c means strong regularization. The
largest c whose solution is exactly w = 0 is

    c_max = 1 / || X^T phi'(0, y) ||_inf        (L1Problem.c_max)

-- the analogue of the classical lasso lambda_max. A regularization path
therefore sweeps c geometrically UP from c_max toward weaker
regularization (lambda descends, features activate one by one), which is
the order that makes warm starting effective: each point's solution is a
small perturbation of the previous one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.problem import L1Problem


def c_grid(c_max: float, c_final: Optional[float] = None,
           n_points: int = 20, span: float = 100.0) -> np.ndarray:
    """Geometric grid of n_points values from c_max to c_final, ascending.

    c_final defaults to span * c_max (span=100 covers two decades of
    lambda, the usual glmnet-style default). The first point sits exactly
    at c_max, where the all-zero model is optimal and the solver converges
    in one KKT check -- the free anchor every warm chain starts from.
    """
    if c_max <= 0:
        raise ValueError(f"c_max must be positive, got {c_max}")
    if c_final is None:
        c_final = span * c_max
    if c_final <= c_max:
        raise ValueError(
            f"c_final={c_final} must exceed c_max={c_max}: values at or "
            f"below c_max all have the trivial solution w = 0")
    if n_points < 2:
        raise ValueError(f"need at least 2 grid points, got {n_points}")
    return np.geomspace(c_max, c_final, n_points)


def problem_grid(problem: L1Problem, c_final: Optional[float] = None,
                 n_points: int = 20, span: float = 100.0) -> np.ndarray:
    """c_grid anchored at `problem.c_max()` (problem.c itself is ignored)."""
    return c_grid(problem.c_max(), c_final=c_final, n_points=n_points,
                  span=span)
