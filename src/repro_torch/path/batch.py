"""Multi-problem batch solving over one shared design (port of
`repro.path.batch`).

Solves B l1 problems that share one DesignMatrix -- different c values,
labels and/or partition seeds -- advanced in lockstep one outer iteration
at a time. The reference `jax.vmap`s its outer iteration over the B
carries; a CUDA launch cannot be vmapped, so here the batch axis is
explicit: the carries are (B, n) and (B, s) tensors, and an outer
iteration steps the bundles in turn, at each bundle one per-problem bundle
step for every problem (on the padded-CSC support scope with the kernels:
one K1 launch a problem, in place on the problem's rows of w and z).

Contract (the reference's "vmap batching contract"):
  * the design is shared and read-only; per-problem state is the carry,
    so memory is B * (n + s) plus one design;
  * every problem has its own torch.Generator, seeded from its seed and
    carried as its (B,)-stacked state, so its partitions are those a solo
    `pcdn.solve` with that seed draws;
  * convergence is per problem: a problem whose full-set KKT drops to tol
    is frozen by `engine.loop.run_lockstep_loop` (its carry re-selected,
    not updated) while the stragglers iterate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bundles as B
from repro_torch.core.pcdn import PCDNConfig, make_bundle_step
from repro_torch.core.problem import L1Problem
from repro_torch.engine import loop as engine_loop

Tensor = torch.Tensor


class BatchSolveResult(NamedTuple):
    w: Tensor           # (B, n)
    objective: Tensor   # (B,)
    kkt: Tensor         # (B,)
    nnz: Tensor         # (B,)
    n_outer: Tensor     # (B,) outer iterations until each problem froze
    converged: Tensor   # (B,) bool
    z: Tensor           # (B, s) final margins X w (OVR's train accuracy)


def make_batch_outer(problem: L1Problem, cfg: PCDNConfig,
                     batched_labels: bool):
    """One outer iteration over B problem carries:

        outer(w (B, n), z (B, s), gen_states (B, L) uint8, c (B,)
              [, y (B, s)]) -> (w, z, gen_states, f, kkt, nnz)

    gen_states are the problems' CPU torch.Generator states; w and z come
    back as new tensors (the inputs are kept, as the lockstep loop's
    freeze needs)."""
    n = problem.n_features

    def outer(w: Tensor, z: Tensor, gen_states: Tensor, c: Tensor,
              y: Optional[Tensor] = None):
        if batched_labels != (y is not None):
            raise ValueError("labels given to an outer built without "
                             "batched_labels, or missing")
        batch = w.shape[0]
        w = w.clone()
        z = z.clone()
        new_states = torch.empty_like(gen_states)
        probs, steps, rows = [], [], []
        for i in range(batch):
            prob = problem.with_c(float(c[i]))
            if y is not None:
                prob = prob.with_labels(y[i])
            gen = torch.Generator()
            # a row view at an offset crashes set_state: hand it a copy
            gen.set_state(gen_states[i].clone())
            idxs = B.partition(gen, n, cfg.P, device=w.device)
            new_states[i] = gen.get_state()
            probs.append(prob)
            steps.append(make_bundle_step(prob, cfg,
                                          n_bundles=idxs.shape[0]))
            rows.append(idxs.unbind(0))
        for t in range(len(rows[0])):
            for i in range(batch):
                steps[i].update(w[i], z[i], rows[i][t], t)
        f = torch.stack([p.objective_from_margins(z[i], w[i])
                         for i, p in enumerate(probs)])
        kkt = torch.stack([p.kkt_violation(w[i], z[i])
                           for i, p in enumerate(probs)])
        nnz = torch.sum(w != 0, dim=1)
        return w, z, new_states, f, kkt, nnz

    return outer


def solve_batch(problem: L1Problem, cfg: PCDNConfig,
                cs: Sequence[float],
                ys: Optional[np.ndarray] = None,
                seeds: Optional[Sequence[int]] = None,
                w0: Optional[np.ndarray] = None) -> BatchSolveResult:
    """Solve B problems sharing `problem.design` in lockstep.

    cs: (B,) per-problem regularization values. ys: optional (B, s)
    per-problem labels (default: share problem.y). seeds: optional (B,)
    partition seeds (default: cfg.seed for every problem -- same schedule,
    different c). w0: optional (B, n) warm starts. Each problem's result
    equals a solo `pcdn.solve` with its c, labels and seed.
    """
    if cfg.shrink:
        raise ValueError(
            "solve_batch does not implement active-set shrinking (every "
            "problem would need its own active mask and bundle count, "
            "breaking the lockstep); pass PCDNConfig(shrink=False) and use "
            "run_path for shrinking sweeps")
    cs = np.asarray(cs, np.float64)
    batch = cs.shape[0]
    n, s = problem.n_features, problem.n_samples
    dtype = problem.solve_dtype
    dev = problem.device
    if ys is not None:
        ys = torch.as_tensor(np.asarray(ys, np.float32), device=dev)
        if ys.shape != (batch, s):
            raise ValueError(f"ys must be ({batch}, {s}), got "
                             f"{tuple(ys.shape)}")
    if seeds is None:
        seeds = [cfg.seed] * batch
    if len(seeds) != batch:
        raise ValueError(f"need {batch} seeds, got {len(seeds)}")

    if w0 is None:
        w = torch.zeros((batch, n), dtype=dtype, device=dev)
        z = torch.zeros((batch, s), dtype=dtype, device=dev)
    else:
        w = torch.as_tensor(np.asarray(w0, np.float32), device=dev)
        if w.shape != (batch, n):
            raise ValueError(f"w0 must be ({batch}, {n}), got "
                             f"{tuple(w.shape)}")
        z = torch.stack([problem.margins(w[i]) for i in range(batch)])
    states = torch.stack([torch.Generator().manual_seed(int(sd)).get_state()
                          for sd in seeds])
    c_arr = torch.as_tensor(cs)

    outer = make_batch_outer(problem, cfg, batched_labels=ys is not None)
    args = (ys,) if ys is not None else ()

    (w, z, _), f, kkt, nnz, n_outer, done = engine_loop.run_lockstep_loop(
        outer, (w, z, states), (c_arr,) + args,
        max_outer=cfg.max_outer, tol_kkt=cfg.tol_kkt, dtype=dtype)
    return BatchSolveResult(w=w, objective=f, kkt=kkt, nnz=nnz,
                            n_outer=n_outer, converged=done, z=z)
