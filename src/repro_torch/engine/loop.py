"""The solver's host loop around one outer iteration, in torch.

Port of `repro.engine.loop`. A backend hands out an outer iteration

    outer(w, z, gen, active, recheck, c)
      -> (w, z, gen, f, kkt, nnz, mean_q, active, n_active)

and this module drives it: the KKT stop, the optional relative-objective
stop, the always-on non-finite detector with rollback to the last good
iterate, per-iteration history, and `start_iter`. The
carry's `gen` is the torch.Generator of the bundle partitions; the
rollback restores its state too. After each iteration the loop waits for
the device (`torch.cuda.synchronize`) before it stamps the time.
Telemetry, progress callbacks, diagnostics, the divergence guard and its
post-mortem belong to later slices of the port.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import sync

Tensor = torch.Tensor


class EngineState(NamedTuple):
    """The backend-independent solver carry."""

    w: Tensor                # (n,) weights
    z: Tensor                # (s,) margins X w
    gen: torch.Generator     # bundle-partition generator (CPU)
    active: Tensor           # (n,) bool un-shrunk mask


class SolveHistory(NamedTuple):
    outer_iter: np.ndarray   # (K,)
    objective: np.ndarray    # (K,) F_c(w) after each outer iteration
    kkt: np.ndarray          # (K,)
    nnz: np.ndarray          # (K,) number of nonzeros in w
    ls_steps: np.ndarray     # (K,) mean line-search steps per bundle
    wall_time: np.ndarray    # (K,) cumulative seconds
    n_active: np.ndarray     # (K,) un-shrunk features (== n without shrink)


class SolveResult(NamedTuple):
    w: Tensor
    objective: float
    n_outer: int
    converged: bool
    history: SolveHistory
    nonfinite: bool = False  # NaN/inf in (f, kkt): w is the last good one


def run_outer_loop(outer: Callable, state: EngineState, c: float, *,
                   max_outer: int, tol_kkt: float,
                   recheck_every: int = 1, tol_rel_obj: float = 0.0,
                   f_star: Optional[float] = None,
                   start_iter: int = 0,
                   ) -> Tuple[EngineState, SolveResult]:
    """Host-side convergence loop around a backend outer iteration.

    Runs iterations [start_iter, max_outer) with global indices (so a
    resumed solve keeps the recheck cadence); iteration 0 always rechecks.
    Stops at kkt <= tol_kkt or, given f_star and tol_rel_obj > 0, at
    f - f_star <= tol_rel_obj * |f_star|. A NaN/inf objective or KKT stops
    the loop with nonfinite = True and returns the carry from before that
    iteration.
    """
    w, z, gen, active = state
    c = float(c)
    fields = ("outer_iter", "objective", "kkt", "nnz", "ls_steps",
              "wall_time", "n_active")
    hist = {k: [] for k in fields}
    t0 = time.perf_counter()
    converged = nonfinite = False
    f = f_good = float("nan")
    k = start_iter - 1
    for k in range(start_iter, max_outer):
        recheck = k == 0 or recheck_every <= 1 or k % recheck_every == 0
        prev_state = (w, z, gen.get_state(), active)
        w, z, gen, f_, kkt, nnz, mean_q, active, n_active = outer(
            w, z, gen, active, recheck, c)
        sync(w)
        f = float(f_)
        kkt_f = float(kkt)
        hist["outer_iter"].append(k)
        hist["objective"].append(f)
        hist["kkt"].append(kkt_f)
        hist["nnz"].append(int(nnz))
        hist["ls_steps"].append(float(mean_q))
        hist["wall_time"].append(time.perf_counter() - t0)
        hist["n_active"].append(int(n_active))
        if not (np.isfinite(f) and np.isfinite(kkt_f)):
            nonfinite = True
            w, z, gen_state, active = prev_state
            gen.set_state(gen_state)
            f = f_good
            break
        f_good = f
        if kkt_f <= tol_kkt:
            converged = True
            break
        if f_star is not None and tol_rel_obj > 0:
            if (f - f_star) <= tol_rel_obj * abs(f_star):
                converged = True
                break
    history = SolveHistory(**{k_: np.asarray(v) for k_, v in hist.items()})
    result = SolveResult(w=w, objective=f, n_outer=k + 1,
                         converged=converged, history=history,
                         nonfinite=nonfinite)
    return EngineState(w, z, gen, active), result


def check_shrink_stop_consistency(backend, tol_kkt: float):
    """Refuse a stop tolerance tighter than the shrinking backend's
    un-shrink threshold: a feature between them would stay shrunk while
    the loop never reaches its stop."""
    cfg = getattr(backend, "cfg", None)
    if cfg is None or not getattr(cfg, "shrink", False):
        return
    if tol_kkt < cfg.tol_kkt:
        raise ValueError(
            f"stop tol_kkt={tol_kkt} is tighter than the backend's "
            f"un-shrink threshold cfg.tol_kkt={cfg.tol_kkt}; rebuild the "
            f"backend with cfg.tol_kkt <= the stop tolerance.")


def solve(backend, c: float, w0=None, *, max_outer: int, tol_kkt: float,
          recheck_every: int = 1, tol_rel_obj: float = 0.0,
          f_star: Optional[float] = None) -> SolveResult:
    """One full solve on a backend: init state, loop to the KKT stop."""
    check_shrink_stop_consistency(backend, tol_kkt)
    state = backend.init_state(w0)
    _, result = run_outer_loop(
        backend.outer, state, c, max_outer=max_outer, tol_kkt=tol_kkt,
        recheck_every=recheck_every, tol_rel_obj=tol_rel_obj,
        f_star=f_star)
    return result
