"""Non-finite rollback with automatic P-backoff (port of
`repro.fault.resilient`).

Parallelism P speeds convergence right up to the point where it destroys
it (Bradley et al., arXiv 1105.5379). `diag.safep` measures the
certified safe bundle size; this module acts on it. `resilient_solve`
wraps the engine loop in a bounded retry state machine:

    RUN -- finite -----------------------------> DONE (converged/budget)
     |
     +- non-finite (engine detector) --> ROLLBACK to the last good iterate
            |                              (the engine already returns it)
            +- retries left: halve P toward P_cert (never below), rebuild
            |  the backend, re-enter RUN at the poisoned iteration index
            +- retries exhausted: surface the last good iterate and the
               post-mortem (diverged=True, nonfinite=True)

The backoff target is `max(P // 2, P_cert)` (plain halving once below
P_cert, floor 1). P_cert is computed lazily -- one power iteration over
the design -- only when a rollback happens; fault-free solves never pay
for it.

Checkpoint/resume rides the same driver: pass a
`fault.SolveCheckpointer` and the engine's `state_callback` snapshots
every N-th iterate; `resume=True` restarts from the newest committed
snapshot (one the reference wrote restores too) and continues at the P
that snapshot ran.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.device import sync
from repro_torch.engine import loop as engine_loop
from repro_torch.fault import inject as inject_mod
from repro_torch.fault.checkpoint import SolveCheckpointer, host_state


def next_bundle_size(P: int, p_cert: Optional[int] = None) -> int:
    """The backoff schedule: halve toward (but not below) the certified
    safe bundle size; plain halving with floor 1 when no certificate."""
    half = max(int(P) // 2, 1)
    if p_cert is not None and 0 < int(p_cert) < int(P):
        return max(half, int(p_cert))
    return half


def _merge_histories(histories) -> engine_loop.SolveHistory:
    """Concatenate per-attempt histories into one global-iteration
    record. Attempts overlap at the redo boundary (the rolled-back
    iteration is re-run), so later rows supersede earlier ones at the
    same outer_iter. Aux series of different widths (P changed across
    retries, so a different bundle count) are padded to the widest with
    the engine's sentinels (q = -1, alpha = NaN)."""
    histories = [h for h in histories if h.outer_iter.size]
    if not histories:
        return engine_loop.SolveHistory(
            *(np.asarray([]) for _ in range(7)))
    rows: dict = {}
    for h in histories:
        d = h._asdict()
        for i, it in enumerate(np.asarray(h.outer_iter)):
            rows[int(it)] = {k: (None if v is None else np.asarray(v)[i])
                             for k, v in d.items()}
    order = sorted(rows)
    fields = {}
    for name in engine_loop.SolveHistory._fields:
        vals = [rows[it][name] for it in order]
        if any(v is None for v in vals):
            fields[name] = None
            continue
        if name in ("bundle_q", "bundle_alpha"):
            width = max(np.asarray(v).shape[0] for v in vals)
            pad_val = -1 if name == "bundle_q" else np.nan
            out = np.full((len(vals), width),
                          pad_val, np.asarray(vals[0]).dtype)
            for i, v in enumerate(vals):
                out[i, :np.asarray(v).shape[0]] = v
            fields[name] = out
        else:
            fields[name] = np.asarray(vals)
    return engine_loop.SolveHistory(**fields)


def resilient_solve(factory: Callable, c: float, *, P: int,
                    w0=None, max_outer: int, tol_kkt: float,
                    recheck_every: int = 1, tol_rel_obj: float = 0.0,
                    f_star: Optional[float] = None,
                    callback: Optional[Callable] = None,
                    checkpointer: Optional[SolveCheckpointer] = None,
                    resume: bool = False, max_retries: int = 2,
                    design=None, p_cert: Optional[int] = None,
                    plan: Optional[inject_mod.FaultPlan] = None,
                    ) -> engine_loop.SolveResult:
    """One fault-tolerant solve. `factory(P) -> backend` rebuilds the
    backend at a damped bundle size after a rollback (for the local
    backend: `LocalBackend(problem, with_bundle_size(cfg, P))`). Returns a
    SolveResult whose `w` is the HOST weight vector (numpy) -- the backend
    that produced it may not be the one the caller built. `design`
    (anything `diag.safep.certify` accepts, or a zero-arg callable
    returning one) enables the certified-P floor; `plan` threads the
    fault-injection hooks into every attempt."""
    backend = factory(int(P))
    engine_loop.check_shrink_stop_consistency(backend, tol_kkt)

    start_iter = 0
    resumed_from = None
    state = None
    if resume and checkpointer is not None:
        meta = checkpointer.latest_meta()
        if meta is not None and "P" in meta and int(meta["P"]) != int(P):
            # continue the P schedule the crashed run had backed off to
            P = int(meta["P"])
            backend = factory(P)
        got = checkpointer.restore_solve(backend)
        if got is not None:
            state, meta = got
            resumed_from = int(meta["outer_iter"])
            start_iter = resumed_from + 1
            obs.inc("fault.resumes")
            print(f"[fault] resuming solve at outer iteration "
                  f"{start_iter} (checkpoint {checkpointer.manager.directory})")
    if state is None:
        state = backend.init_state(w0)

    p_schedule = [int(P)]
    rollbacks = 0
    histories = []
    res = None
    while True:
        outer = backend.outer
        if plan is not None:
            outer = inject_mod.wrap_outer(outer, plan, start_iter=start_iter)
        state_cb = (checkpointer.solve_callback(backend, P=int(P))
                    if checkpointer is not None else None)
        if start_iter >= max_outer:
            break
        state, res = engine_loop.run_outer_loop(
            outer, state, c, max_outer=max_outer, tol_kkt=tol_kkt,
            recheck_every=recheck_every, tol_rel_obj=tol_rel_obj,
            f_star=f_star, callback=callback, start_iter=start_iter,
            state_callback=state_cb, check_finite_w=rollbacks > 0)
        histories.append(res.history)
        if not res.nonfinite:
            break
        rollbacks += 1
        obs.inc("fault.rollbacks")
        if rollbacks > max_retries:
            print(f"[fault] non-finite iterate persisted through "
                  f"{max_retries} rollback(s); surfacing post-mortem")
            break
        # the engine handed back the LAST GOOD state; redo the poisoned
        # iteration (its global index is the last recorded history row)
        k_bad = int(res.history.outer_iter[-1])
        start_iter = k_bad
        if p_cert is None and design is not None:
            from repro_torch.diag import safep
            t0 = time.perf_counter()
            # a callable defers building the design to the first rollback
            d = design() if callable(design) else design
            p_cert = int(safep.certify(d, observed_p=int(P))["P_cert"])
            print(f"[fault] certified safe bundle size P_cert={p_cert} "
                  f"({time.perf_counter() - t0:.3f}s)")
        new_p = next_bundle_size(P, p_cert)
        print(f"[fault] non-finite at outer iteration {k_bad}: rolling "
              f"back and retrying with P={new_p} (was {P})")
        if new_p != P:
            obs.inc("fault.p_backoff")
            t0 = time.perf_counter()
            snap = host_state(backend, state)
            gen_state = state.gen.get_state()
            P = new_p
            backend = factory(int(P))
            engine_loop.check_shrink_stop_consistency(backend, tol_kkt)
            state = backend.restore_state(**snap, gen_state=gen_state)
            sync(state.w)
            print(f"[fault] rebuilt the backend at P={P} in "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        p_schedule.append(int(P))

    if res is None:        # resume landed at/after the budget: 0 new iters
        res = engine_loop.SolveResult(
            w=state.w, objective=float("nan"), n_outer=start_iter,
            converged=False, history=_merge_histories([]))
    faults = None
    if rollbacks or resumed_from is not None or len(p_schedule) > 1:
        faults = {"rollbacks": rollbacks, "p_schedule": p_schedule,
                  "p_cert": p_cert, "resumed_from": resumed_from}
    return res._replace(w=backend.host_weights(res.w),
                        history=_merge_histories(histories) if histories
                        else res.history,
                        faults=faults)
