"""Shotgun CDN baseline (Bradley et al. 2011; paper Algorithm 2), in torch.

SCDN picks P_bar features uniformly at random (with replacement) and
updates them in parallel, each with its own 1-D Newton direction and 1-D
line search. Port of `repro.core.scdn`, which simulates the racing updates
at iteration granularity: all P_bar updates are computed from the same
stale (w, z), then applied together

    w <- w + sum_j alpha_j d_j e_j ,   z <- z + sum_j alpha_j d_j x^j .

The per-coordinate searches do not account for each other, so the combined
step can increase F_c, and the method diverges when P_bar exceeds the
spectral threshold (paper section 2.2).

A batch's P_bar line searches are one call of `armijo_batched` on the
(P_bar, s) per-coordinate margin deltas: one launch of the batched
line-search kernel (K5) for all of them on the card, its plain version on
the CPU. A round's (n_batches, P_bar) indices are drawn at once from the
carry's CPU `torch.Generator` and copied to the device once; they differ
from the reference's `jax.random` draws, so parity tests feed `one_batch`
shared indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import bundles as B
from repro_torch.core.direction import newton_direction
from repro_torch.core.linesearch import ArmijoParams, armijo_batched
from repro_torch.core.problem import L1Problem
from repro_torch.engine.loop import EngineState, run_outer_loop

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SCDNConfig:
    P_bar: int = 8               # paper section 5.1 follows Bradley et al.
    armijo: ArmijoParams = ArmijoParams()
    max_rounds: int = 2000       # each round = ceil(n/P_bar) parallel updates
    tol_kkt: float = 1e-3
    seed: int = 0


class SCDNResult(NamedTuple):
    w: Tensor
    objective: float
    n_rounds: int
    converged: bool
    diverged: bool
    history: dict


class Round:
    """One epoch-equivalent, built by `make_round`: ceil(n / P_bar) batches
    of P_bar racing updates.

    `one_batch(w, z, idx)` applies one batch for the (P_bar,) indices idx
    to w and z IN PLACE and returns the (P_bar,) accepted alphas.
    `__call__(w, z, gen, idxs=None)` copies the carry once, draws the
    round's (n_batches, P_bar) indices from `gen` (or takes `idxs`), runs
    the batches and returns (w, z, gen, f, kkt), f and kkt on the device.
    """

    def __init__(self, problem: L1Problem, cfg: SCDNConfig,
                 loss_deltas: Optional[Callable] = None):
        self.problem = problem
        self.cfg = cfg
        self.n_batches = -(-problem.n_features // cfg.P_bar)
        self._loss_deltas = loss_deltas

    def one_batch(self, w: Tensor, z: Tensor, idx: Tensor) -> Tensor:
        prob, cfg = self.problem, self.cfg
        design = prob.design
        slab = design.gather_slab(idx)
        w_B, _ = B.gather_vec(w, idx)
        g, h = prob.bundle_grad_hess(z, slab, w_B)
        d = newton_direction(g, h, w_B)
        # each coordinate's Armijo decrement (Eq. 7 on its own)
        Delta = g * d + cfg.armijo.gamma * (h * torch.square(d)) + \
            (torch.abs(w_B + d) - torch.abs(w_B))
        deltas = design.slab_coordinate_deltas(slab, d)          # (P, s)
        res = armijo_batched(prob.loss, prob.c, z, deltas, prob.y, w_B, d,
                             Delta, cfg.armijo,
                             loss_deltas=self._loss_deltas)
        upd = res.alpha * d
        # duplicate indices: index_add_ and the slab product add both
        B.scatter_add(w, idx, upd)
        z.add_(design.slab_matvec(slab, upd))
        return res.alpha

    def __call__(self, w: Tensor, z: Tensor, gen: torch.Generator,
                 idxs: Optional[Tensor] = None):
        n = self.problem.n_features
        if idxs is None:
            idxs = torch.randint(0, n, (self.n_batches, self.cfg.P_bar),
                                 generator=gen, dtype=torch.int32)
        idxs = torch.as_tensor(idxs, dtype=torch.int32).to(w.device)
        w = w.clone()
        z = z.clone()
        for idx in idxs.unbind(0):
            self.one_batch(w, z, idx)
        f = self.problem.objective_from_margins(z, w)
        kkt = self.problem.kkt_violation(w, z)
        return w, z, gen, f, kkt


def make_round(problem: L1Problem, cfg: SCDNConfig,
               _loss_deltas: Optional[Callable] = None) -> Round:
    """One epoch-equivalent: ceil(n/P_bar) batches of P_bar racing updates.
    `_loss_deltas` replaces the batched line search's loss-delta function
    (K5 by default), e.g. by its plain version for a lockstep check."""
    return Round(problem, cfg, _loss_deltas)


def solve(problem: L1Problem, cfg: SCDNConfig,
          f_star: Optional[float] = None,
          divergence_factor: float = 1e3,
          _loss_deltas: Optional[Callable] = None) -> SCDNResult:
    """The engine's host loop over SCDN rounds, with SCDN's divergence
    guard: a round whose objective exceeds divergence_factor * F_c(0), or
    is non-finite, stops the run with `diverged` set. `f_star` is taken
    and unused, as in the reference."""
    n = problem.n_features
    round_fn = make_round(problem, cfg, _loss_deltas)

    def outer(w, z, gen, active, recheck, c):
        """The round in the engine's outer contract: no shrinking, and c
        and recheck unused (the round uses problem.c)."""
        w, z, gen, f, kkt = round_fn(w, z, gen)
        return (w, z, gen, f, kkt, torch.sum(w != 0), 0.0, active, n)

    dt, dev = problem.solve_dtype, problem.device
    state = EngineState(
        w=torch.zeros((n,), dtype=dt, device=dev),
        z=torch.zeros((problem.n_samples,), dtype=dt, device=dev),
        gen=torch.Generator().manual_seed(cfg.seed),
        active=torch.ones((n,), dtype=torch.bool, device=dev))
    f0 = float(problem.objective_from_margins(state.z, state.w))

    def guard(f: float) -> bool:
        return (not np.isfinite(f)) or f > divergence_factor * f0

    _, res = run_outer_loop(outer, state, problem.c,
                            max_outer=cfg.max_rounds, tol_kkt=cfg.tol_kkt,
                            divergence_guard=guard)
    h = res.history
    return SCDNResult(w=res.w, objective=res.objective, n_rounds=res.n_outer,
                      converged=res.converged, diverged=res.diverged,
                      history={"round": h.outer_iter,
                               "objective": h.objective, "kkt": h.kkt,
                               "wall_time": h.wall_time})
