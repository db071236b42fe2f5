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

A whole batch is one call: on the padded-CSC layout `ops.scdn_batch`, one
launch of K5's batch entry on the card (the gathers, the P_bar directions
and racing line searches over each coordinate's own rows, and the w and z
updates), `ref.scdn_batch_ref` on the CPU; on the dense layout
`ops.scdn_dense_batch`, K5's dense batch entry over the design's
feature-major copy (the batch launch and the update launch),
`ref.scdn_dense_batch_ref` on the CPU. A round's (n_batches, P_bar)
indices are drawn at once from the carry's CPU `torch.Generator` and
copied to the device once; they differ from the reference's `jax.random`
draws, so parity tests feed `one_batch` shared indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
from repro_torch.core.problem import L1Problem
from repro_torch.engine.loop import EngineState, run_outer_loop
from repro_torch.kernels import ops

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

    `one_batch(w, z, idx, alpha=None)` applies one batch for the (P_bar,)
    indices idx to w and z IN PLACE and returns the (P_bar,) accepted
    alphas (written into `alpha` when given). `__call__(w, z, gen,
    idxs=None)` copies the carry once, draws the round's (n_batches,
    P_bar) indices from `gen` (or takes `idxs`), runs the batches and
    returns (w, z, gen, f, kkt), f and kkt on the device.
    """

    def __init__(self, problem: L1Problem, cfg: SCDNConfig,
                 batch: Optional[Callable] = None):
        self.problem = problem
        self.cfg = cfg
        self.n_batches = -(-problem.n_features // cfg.P_bar)
        self.sparse = problem.design.layout == "padded_csc"
        self._batch = batch
        self._launch = None

    def launch(self):
        """The round's batch launch, built at the first call: K5's batch
        entry (`ops.ScdnBatchLaunch`) on padded-CSC, its dense batch entry
        (`ops.ScdnDenseBatchLaunch`, on the design's feature-major copy)
        on dense."""
        if self._launch is None:
            prob, arm = self.problem, self.cfg.armijo
            design = prob.design
            alphas = candidate_alphas(arm, prob.solve_dtype, prob.device)
            kw = dict(kind=prob.loss.name, l2=prob.elastic_net_l2,
                      sigma=arm.sigma, gamma=arm.gamma)
            if self.sparse:
                self._launch = ops.ScdnBatchLaunch(
                    design.col_rows, design.col_vals, prob.y, alphas,
                    prob.c, self.cfg.P_bar, **kw)
            else:
                self._launch = ops.ScdnDenseBatchLaunch(
                    design.feature_major(), prob.y, alphas, prob.c,
                    self.cfg.P_bar, **kw)
        return self._launch

    def one_batch(self, w: Tensor, z: Tensor, idx: Tensor,
                  alpha: Optional[Tensor] = None) -> Tensor:
        L = self.launch()
        if self._batch is None:
            entry = ops.scdn_batch if self.sparse else ops.scdn_dense_batch
            return entry(L, w, z, idx, alpha)
        a, _ = self._batch(*L.design_args, idx, w, z, L.y, L.alphas, L.c,
                           kind=L.kind, sigma=L.sigma, gamma=L.gamma,
                           l2=L.l2)
        return a if alpha is None else alpha.copy_(a)

    def __call__(self, w: Tensor, z: Tensor, gen: torch.Generator,
                 idxs: Optional[Tensor] = None):
        n = self.problem.n_features
        if idxs is None:
            idxs = torch.randint(0, n, (self.n_batches, self.cfg.P_bar),
                                 generator=gen, dtype=torch.int32)
        idxs = torch.as_tensor(idxs, dtype=torch.int32).to(w.device)
        w = w.clone()
        z = z.clone()
        # the batch kernel's accepted steps, a row a batch (one allocation
        # a round, none a batch)
        outs = torch.empty(idxs.shape, dtype=w.dtype, device=w.device)
        for idx, alpha in zip(idxs.unbind(0), outs.unbind(0)):
            self.one_batch(w, z, idx, alpha)
        f = self.problem.objective_from_margins(z, w)
        kkt = self.problem.kkt_violation(w, z)
        return w, z, gen, f, kkt


def make_round(problem: L1Problem, cfg: SCDNConfig,
               _batch: Optional[Callable] = None) -> Round:
    """One epoch-equivalent: ceil(n/P_bar) batches of P_bar racing updates.
    For a lockstep check against the plain versions, `_batch` replaces the
    batch entry of either layout: `ref.scdn_batch_ref` on padded-CSC (for
    `ops.scdn_batch`), `ref.scdn_dense_batch_ref` on dense (for
    `ops.scdn_dense_batch`)."""
    return Round(problem, cfg, _batch)


def solve(problem: L1Problem, cfg: SCDNConfig,
          f_star: Optional[float] = None,
          divergence_factor: float = 1e3,
          _batch: Optional[Callable] = None) -> SCDNResult:
    """The engine's host loop over SCDN rounds, with SCDN's divergence
    guard: a round whose objective exceeds divergence_factor * F_c(0), or
    is non-finite, stops the run with `diverged` set. `f_star` is taken
    and unused, as in the reference. `_batch` as for `make_round`."""
    n = problem.n_features
    round_fn = make_round(problem, cfg, _batch=_batch)

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
