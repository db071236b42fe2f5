"""The solver's host loop around one outer iteration, in torch.

Port of `repro.engine.loop`. A backend hands out an outer iteration

    outer(w, z, gen, active, recheck, c)
      -> (w, z, gen, f, kkt, nnz, mean_q, active, n_active) [+ extras]

and this module drives it: the KKT stop, the optional relative-objective
stop, the always-on non-finite detector with rollback to the last good
iterate, per-iteration history, `start_iter`, the optional divergence
guard (SCDN's), the per-iteration `callback` (`--progress`), and the
telemetry of `repro_torch.obs`: the `solver.*` metrics, the `engine.outer`
span and the guards' instants. Extras past the 9-tuple are dispatched by
structure: a (q, alpha) tuple is the per-bundle aux plane
(`PCDNConfig.record_aux`), a bare tensor the per-feature KKT vector
(`record_kkt_vec`); both are read to the host once an iteration, at the
sync the loop already does. The carry's `gen` is the torch.Generator of
the bundle partitions; the rollback restores its state too. After each
iteration the loop waits for the device (`torch.cuda.synchronize`) before
it stamps the time. A non-finite or divergence-guard trip attaches the
divergence post-mortem (`diag.forensics`) to `SolveResult.postmortem` and
emits the `engine.divergence_postmortem` instant; `state_callback` (the
periodic checkpoint of `fault.SolveCheckpointer`) sees every finite
iteration's carry and never a poisoned one.

`run_lockstep_loop` is the freeze-on-convergence loop of the batch solver
(`path/batch.py`).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
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
    # per-bundle series, present only with record_aux: (K, b), sentinel
    # q == -1 / alpha == nan on bundles that did not run (shrinking)
    bundle_q: Optional[np.ndarray] = None       # (K, b) int32
    bundle_alpha: Optional[np.ndarray] = None   # (K, b)
    # per-feature KKT violation series, present only with record_kkt_vec
    kkt_vec: Optional[np.ndarray] = None        # (K, n)


class SolveResult(NamedTuple):
    w: Tensor
    objective: float
    n_outer: int
    converged: bool
    history: SolveHistory
    diverged: bool = False     # divergence guard OR non-finite detector
    # divergence post-mortem (diag.forensics.divergence_postmortem),
    # attached when the divergence guard or the non-finite detector trips;
    # None otherwise
    postmortem: Optional[dict] = None
    nonfinite: bool = False    # NaN/inf in (f, kkt): w is the last good one
    # the rollback / P-backoff record fault.resilient_solve attaches:
    # {"rollbacks", "p_schedule", "p_cert", "resumed_from"}; None on
    # fault-free solves
    faults: Optional[dict] = None


def _build_postmortem(hist: dict, aux_q: list, aux_alpha: list,
                      k: int) -> dict:
    """The divergence post-mortem from the rows recorded so far, richer
    when the per-bundle aux rode along, and its trace instant. A local
    import: diag consumes the engine."""
    from repro_torch.diag import forensics
    postmortem = forensics.divergence_postmortem(
        objective=np.asarray(hist["objective"]),
        kkt=np.asarray(hist["kkt"]),
        ls_steps=np.asarray(hist["ls_steps"]),
        bundle_q=np.asarray(aux_q) if aux_q else None,
        bundle_alpha=np.asarray(aux_alpha) if aux_alpha else None)
    obs.instant("engine.divergence_postmortem", "engine",
                args={"k": k,
                      "objective_growth": postmortem["objective_growth"],
                      "deepest_mean_q": postmortem["deepest_mean_q"]})
    return postmortem


def run_outer_loop(outer: Callable, state: EngineState, c: float, *,
                   max_outer: int, tol_kkt: float,
                   recheck_every: int = 1, tol_rel_obj: float = 0.0,
                   f_star: Optional[float] = None,
                   callback: Optional[Callable] = None,
                   divergence_guard: Optional[Callable[[float], bool]] = None,
                   start_iter: int = 0,
                   state_callback: Optional[Callable] = None,
                   check_finite_w: bool = False,
                   ) -> Tuple[EngineState, SolveResult]:
    """Host-side convergence loop around a backend outer iteration.

    Runs iterations [start_iter, max_outer) with global indices (so a
    resumed solve keeps the recheck cadence); iteration 0 always rechecks.
    Stops at kkt <= tol_kkt or, given f_star and tol_rel_obj > 0, at
    f - f_star <= tol_rel_obj * |f_star|. A NaN/inf objective or KKT stops
    the loop with diverged = nonfinite = True and returns the carry from
    before that iteration (generator state included); check_finite_w=True
    also scans the whole of w each iteration (the mode
    `fault.resilient_solve` runs its retries in). divergence_guard(f) ->
    True after a finite iteration stops the loop with diverged = True
    (converged stays False), keeping that iteration's carry. Either trip
    attaches `postmortem`.
    state_callback(k, EngineState, f, kkt) fires after each finite
    iteration (before the guard and the stop tests): the periodic
    checkpoint hook.

    Outputs past the 9-tuple: a 2-tuple (q (b,), alpha (b,)) goes to
    `SolveHistory.bundle_q/bundle_alpha` (and, with the registry on, to
    the solver.bundle_q / solver.bundle_alpha histograms, sentinels
    dropped); a bare (n,) tensor goes to `SolveHistory.kkt_vec`.
    callback(k, w, f, kkt, mean_q) fires after every iteration's sync.
    """
    w, z, gen, active = state
    c = float(c)
    fields = ("outer_iter", "objective", "kkt", "nnz", "ls_steps",
              "wall_time", "n_active")
    hist = {k: [] for k in fields}
    aux_q: list = []
    aux_alpha: list = []
    kkt_rows: list = []
    t0 = time.perf_counter()
    converged = diverged = nonfinite = False
    postmortem = None
    f = f_good = float("nan")
    prev_active = None
    k = start_iter - 1
    for k in range(start_iter, max_outer):
        recheck = k == 0 or recheck_every <= 1 or k % recheck_every == 0
        t_iter = time.perf_counter_ns()
        prev_state = (w, z, gen.get_state(), active)
        out = outer(w, z, gen, active, recheck, c)
        w, z, gen, f_, kkt, nnz, mean_q, active, n_active = out[:9]
        aux = kkt_vec = None
        for extra in out[9:]:
            if isinstance(extra, tuple):
                aux = extra
            else:
                kkt_vec = extra
        sync(w)
        t_now = time.perf_counter_ns()
        f = float(f_)
        kkt_f = float(kkt)
        mean_q_f = float(mean_q)
        n_active_i = int(n_active)
        hist["outer_iter"].append(k)
        hist["objective"].append(f)
        hist["kkt"].append(kkt_f)
        hist["nnz"].append(int(nnz))
        hist["ls_steps"].append(mean_q_f)
        hist["wall_time"].append(time.perf_counter() - t0)
        hist["n_active"].append(n_active_i)
        if aux is not None:
            q_np = aux[0].cpu().numpy()
            a_np = aux[1].cpu().numpy()
            aux_q.append(q_np)
            aux_alpha.append(a_np)
            if obs.metrics_enabled():
                ran = q_np >= 0          # sentinel -1: bundle did not run
                obs.observe_many("solver.bundle_q", q_np[ran],
                                 bounds=obs.Q_BOUNDS)
                obs.observe_many("solver.bundle_alpha", a_np[ran],
                                 bounds=obs.ALPHA_BOUNDS)
        if kkt_vec is not None:
            kkt_rows.append(kkt_vec.cpu().numpy())
        if obs.metrics_enabled():
            obs.inc("solver.outer_iters")
            obs.observe("solver.iter_seconds", (t_now - t_iter) / 1e9)
            obs.observe("solver.mean_q", mean_q_f, bounds=obs.Q_BOUNDS)
            obs.set_gauge("solver.n_active", n_active_i)
            obs.set_gauge("solver.kkt", kkt_f)
            if prev_active is not None and n_active_i != prev_active:
                if n_active_i < prev_active:
                    obs.inc("solver.shrink_events",
                            prev_active - n_active_i)
                else:
                    obs.inc("solver.unshrink_events",
                            n_active_i - prev_active)
        prev_active = n_active_i
        obs.complete("engine.outer", "engine", t_iter, t_now,
                     args={"k": k, "objective": f, "kkt": kkt_f,
                           "mean_q": mean_q_f, "n_active": n_active_i})
        if callback is not None:
            callback(k, w, f, kkt_f, mean_q_f)
        finite = bool(np.isfinite(f) and np.isfinite(kkt_f))
        if finite and check_finite_w:
            finite = bool(torch.all(torch.isfinite(w)))
        if not finite:
            diverged = nonfinite = True
            obs.inc("solver.nonfinite_trips")
            obs.instant("engine.nonfinite_guard", "engine",
                        args={"k": k, "objective": f, "kkt": kkt_f})
            postmortem = _build_postmortem(hist, aux_q, aux_alpha, k)
            # the poisoned carry never leaks into warm starts, checkpoints
            # or the returned weights
            w, z, gen_state, active = prev_state
            gen.set_state(gen_state)
            f = f_good
            break
        f_good = f
        if state_callback is not None:
            state_callback(k, EngineState(w, z, gen, active), f, kkt_f)
        if divergence_guard is not None and divergence_guard(f):
            diverged = True
            obs.inc("solver.divergence_trips")
            obs.instant("engine.divergence_guard", "engine",
                        args={"k": k, "objective": f})
            postmortem = _build_postmortem(hist, aux_q, aux_alpha, k)
            break
        if kkt_f <= tol_kkt:
            converged = True
            break
        if f_star is not None and tol_rel_obj > 0:
            if (f - f_star) <= tol_rel_obj * abs(f_star):
                converged = True
                break
    history = SolveHistory(
        **{k_: np.asarray(v) for k_, v in hist.items()},
        bundle_q=np.asarray(aux_q) if aux_q else None,
        bundle_alpha=np.asarray(aux_alpha) if aux_alpha else None,
        kkt_vec=np.asarray(kkt_rows) if kkt_rows else None)
    result = SolveResult(w=w, objective=f, n_outer=k + 1,
                         converged=converged, history=history,
                         diverged=diverged, postmortem=postmortem,
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
          f_star: Optional[float] = None,
          callback: Optional[Callable] = None) -> SolveResult:
    """One full solve on a backend: init state, loop to the KKT stop."""
    check_shrink_stop_consistency(backend, tol_kkt)
    state = backend.init_state(w0)
    _, result = run_outer_loop(
        backend.outer, state, c, max_outer=max_outer, tol_kkt=tol_kkt,
        recheck_every=recheck_every, tol_rel_obj=tol_rel_obj,
        f_star=f_star, callback=callback)
    return result


def run_lockstep_loop(outer: Callable, carry: Sequence[Tensor],
                      extra: Sequence, *, max_outer: int, tol_kkt: float,
                      dtype):
    """Freeze-on-convergence lockstep loop over B problems.

    outer(*carry, *extra) must return (*carry', f, kkt, nnz), every tensor
    B-leading (the carry's tensors may live on different devices, e.g. the
    problems' generator states on the CPU). A problem whose KKT drops to
    tol is frozen: its carry is re-selected, not updated, on later
    iterations, so its result is that of stopping while stragglers keep
    iterating. One host sync an iteration (the all-done check).

    Returns (carry, f, kkt, nnz, n_outer, done).
    """
    carry = tuple(carry)
    batch = carry[0].shape[0]
    dev = carry[0].device
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    n_outer = torch.zeros((batch,), dtype=torch.int32, device=dev)
    f = torch.full((batch,), float("inf"), dtype=dtype, device=dev)
    kkt = torch.full((batch,), float("inf"), dtype=dtype, device=dev)
    nnz = torch.zeros((batch,), dtype=torch.int32, device=dev)
    for _ in range(max_outer):
        out = outer(*carry, *extra)
        new_carry, (f_n, kkt_n, nnz_n) = out[:-3], out[-3:]
        carry = tuple(
            torch.where(done.to(old.device).reshape(
                (batch,) + (1,) * (old.ndim - 1)), old, new)
            for old, new in zip(carry, new_carry))
        f = torch.where(done, f, f_n.to(dtype))
        kkt = torch.where(done, kkt, kkt_n.to(dtype))
        nnz = torch.where(done, nnz, nnz_n.to(torch.int32))
        n_outer = torch.where(done, n_outer, n_outer + 1)
        done = done | (kkt <= tol_kkt)
        if bool(torch.all(done)):
            break
    return carry, f, kkt, nnz, n_outer, done
