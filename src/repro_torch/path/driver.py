"""Warm-started regularization-path driver (port of `repro.path.driver`).

Solves an l1 problem along a geometric c-grid built from the analytic
c_max, chaining the engine carry (w, z, generator, active set) from each
point into the next. One built outer iteration serves the whole sweep: c
is a run-time argument of the kernels, so no point rebuilds anything.

Per point the driver records objective / nnz / full-set KKT / iterations
and wall time (the device waited for) and, given a validation split, the
held-out accuracy, and picks the best c by it. With the trace on, each
point is a `path.point` span on the `path` track, and `path.points`
counts them. With a `fault.SolveCheckpointer` the sweep checkpoints at
every grid-point boundary and resumes from the newest committed point
(its c-grid checked against the live one); a `fault.FaultPlan` injects
faults at global iteration and point indices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.design_matrix import DesignMatrix, as_design
from repro_torch.core.pcdn import PCDNConfig
from repro_torch.core.problem import L1Problem, validation_accuracy
from repro_torch.device import sync
from repro_torch.engine import loop as engine_loop
from repro_torch.engine.local import LocalBackend
from repro_torch.path import grid as grid_mod


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """A c-sweep: grid geometry + the per-point PCDN solver settings
    (max_outer / tol_kkt / recheck_every / tol_rel_obj stop every point;
    P, ls_kind, use_kernels, shrink, record_aux build the backend)."""

    solver: PCDNConfig = PCDNConfig(P=256)
    n_points: int = 20
    span: float = 100.0                 # c_final = span * c_max when unset
    c_final: Optional[float] = None
    warm_start: bool = True             # chain (w, z, active) across points


class PathPoint(NamedTuple):
    c: float
    objective: float
    nnz: int
    kkt: float
    n_outer: int
    seconds: Optional[float]            # wall time on this point (None in
                                        # batch mode -- lockstep solves
                                        # have no per-point timing)
    converged: bool
    val_accuracy: Optional[float]       # None without a validation split


class PathResult(NamedTuple):
    c_max: float
    cs: np.ndarray                      # (n_points,) ascending grid
    points: list                        # [PathPoint]
    weights: np.ndarray                 # (n_points, n) solutions per point
    best_index: Optional[int]           # argmax val accuracy (ties -> sparser)
    total_seconds: float
    # the final grid point's SolveHistory (None in batch mode)
    last_history: Optional[object] = None
    last_postmortem: Optional[dict] = None

    @property
    def best(self) -> Optional[PathPoint]:
        return None if self.best_index is None else self.points[self.best_index]


def pick_best(points: Sequence[PathPoint]) -> Optional[int]:
    """Highest validation accuracy; ties go to the sparser (smaller-c)
    model. Shared by the sweep driver and the batch-mode CLI so both modes
    pick identically."""
    scored = [(p.val_accuracy, -p.nnz, -i) for i, p in enumerate(points)
              if p.val_accuracy is not None]
    if not scored:
        return None
    return -max(scored)[2]


def run_path(problem: Optional[L1Problem], cfg: PathConfig,
             val_design=None, val_y=None,
             verbose: bool = False, backend=None, callback=None,
             ckpt=None, resume: bool = False,
             fault_plan=None) -> PathResult:
    """Sweep the c-grid; `problem.c` is a template value and is ignored.

    backend: an engine backend; defaults to a `LocalBackend` over
    `problem`. val_design / val_y: an optional held-out split (anything
    `as_design` accepts; placed on the backend's device once) scored after
    each point; enables the best-c pick. callback: forwarded to every
    point's engine loop (`--progress`: (k, w, f, kkt, mean_q)).
    ckpt: optional `fault.SolveCheckpointer`: the finished carry, the
    per-point records and the weight rows are checkpointed after EVERY
    grid point. resume=True restarts from the newest committed point
    checkpoint (the same host image and generator state the
    uninterrupted run had, so the resumed sweep matches it); the stored
    c-grid must equal the live one. fault_plan: optional
    `fault.FaultPlan`; its iteration hooks count outer iterations across
    the sweep, and `crash_at_point` fires right AFTER a point's
    checkpoint commits.
    """
    if (val_design is None) != (val_y is None):
        raise ValueError("pass both val_design and val_y or neither")
    if backend is None:
        if problem is None:
            raise ValueError("run_path needs a problem or a backend")
        backend = LocalBackend(problem, cfg.solver)
    solver = cfg.solver
    engine_loop.check_shrink_stop_consistency(backend, solver.tol_kkt)
    c_max = backend.c_max()
    cs = grid_mod.c_grid(c_max, c_final=cfg.c_final, n_points=cfg.n_points,
                         span=cfg.span)
    if val_design is not None and not isinstance(val_design, DesignMatrix):
        val_design = as_design(val_design, device=backend.device)

    n = backend.n_features
    state = backend.init_state()
    points: list[PathPoint] = []
    res = None
    weights = np.zeros((len(cs), n), np.float32)
    i_start = 0
    if resume and ckpt is not None:
        got = ckpt.restore_path(backend, cs=cs, c_max=c_max)
        if got is not None:
            state, meta, saved_w = got
            i_start = int(meta["point_index"]) + 1
            points = [PathPoint(**p) for p in meta["points"]]
            weights[:i_start] = saved_w[:i_start]
            if verbose:
                print(f"[fault] resuming path sweep at point "
                      f"{i_start}/{len(cs)}", flush=True)
    outer_fn = backend.outer
    if fault_plan is not None:
        from repro_torch.fault import inject as fault_inject
        outer_fn = fault_inject.wrap_outer(backend.outer, fault_plan)
    t_total0 = time.perf_counter()
    for i in range(i_start, len(cs)):
        c = cs[i]
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        if not cfg.warm_start:
            state = backend.init_state()
        else:
            # refresh margins from w once a point: one matvec, stops the
            # float32 drift of z from building up along the sweep
            state = state._replace(z=backend.margins(state.w))
        state, res = engine_loop.run_outer_loop(
            outer_fn, state, float(c),
            max_outer=solver.max_outer, tol_kkt=solver.tol_kkt,
            recheck_every=solver.recheck_every,
            tol_rel_obj=solver.tol_rel_obj, callback=callback)
        sync(state.w)
        seconds = time.perf_counter() - t0
        obs.complete("path.point", "path", t0_ns, time.perf_counter_ns(),
                     args={"i": i, "c": float(c), "n_outer": res.n_outer,
                           "converged": res.converged})
        obs.inc("path.points")
        w_host = backend.host_weights(state.w)
        val_acc = (validation_accuracy(val_design, val_y, w_host)
                   if val_design is not None else None)
        weights[i] = w_host
        points.append(PathPoint(
            c=float(c), objective=res.objective,
            nnz=int(np.count_nonzero(weights[i])),
            kkt=float(res.history.kkt[-1]) if res.history.kkt.size else 0.0,
            n_outer=res.n_outer, seconds=seconds,
            converged=res.converged, val_accuracy=val_acc))
        if verbose:
            p = points[-1]
            extra = (f" val_acc={p.val_accuracy:.4f}"
                     if p.val_accuracy is not None else "")
            print(f"[path] c={p.c:.5g} F={p.objective:.5f} nnz={p.nnz} "
                  f"kkt={p.kkt:.2e} iters={p.n_outer} "
                  f"t={p.seconds:.2f}s{extra}", flush=True)
        if ckpt is not None:
            ckpt.save_path(backend, state, point_index=i, cs=cs,
                           c_max=c_max, points=points, weights=weights)
        if fault_plan is not None:
            fault_plan.fire_point(i)

    return PathResult(c_max=c_max, cs=cs, points=points, weights=weights,
                      best_index=pick_best(points),
                      total_seconds=time.perf_counter() - t_total0,
                      last_history=res.history if res else None,
                      last_postmortem=res.postmortem if res else None)


def path_summary(result: PathResult) -> dict:
    """JSON-ready summary (weights omitted -- they go to .npy if wanted)."""
    return {
        "c_max": result.c_max,
        "total_seconds": result.total_seconds,
        "best_index": result.best_index,
        "best_c": None if result.best is None else result.best.c,
        "points": [p._asdict() for p in result.points],
    }
