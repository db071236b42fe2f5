"""Regularization-path driver of the port:

    python -m repro_torch.launch.path --dataset real-sim --points 20 --shrink
    python -m repro_torch.launch.path --dataset data.libsvm --mode batch

Builds the geometric c-grid from the analytic c_max, runs the
warm-started sweep on the chosen device -- the card by default -- (or,
with --mode batch, solves every grid point in lockstep as one batch),
reports per-point objective / nnz / KKT / validation accuracy, and picks
the best c by held-out accuracy. Writes a JSON report with --out (and a
.npy weight matrix next to it with --save-weights) and the whole sweep as
one kind="path" serve artifact with --save-model. As in the reference,
only profile datasets get a --val-frac split; a file dataset has none.

Sweep mode takes the reference's fault and diagnostics flags:
--ckpt-dir checkpoints after every grid point, --resume continues from
the newest committed point, the REPRO_FAULT_PLAN variable injects faults,
and --diag-out writes the health report of the last grid point; batch
mode refuses them, as the reference does. ``--backend sharded`` runs the
sweep on a mesh of `torch.distributed` ranks (`launch.solve` says how to
start them), warm-started through the backend's margins; batch mode is
local only, as in the reference. Rank 0 prints and writes the files.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import make_problem
from repro_torch.core.problem import validation_accuracy
from repro_torch.device import resolve_device
from repro_torch.launch import common
from repro_torch.path import (PathConfig, PathPoint, PathResult,
                              path_summary, pick_best, problem_grid,
                              run_path, solve_batch)
from repro_torch.serve import artifact as art


def _load(args):
    """-> (X, y, val_X, val_y) honoring --val-frac."""
    X, y, _Xte, _yte, spec = common.load_dataset(args)
    if spec is None:
        if args.val_frac > 0:
            print("[path] --val-frac ignored for file datasets "
                  "(no validation split, best-c pick disabled)")
        return X, y, None, None
    if args.val_frac <= 0:
        return X, y, None, None
    cut = max(1, int(round((1.0 - args.val_frac) * X.shape[0])))
    if cut >= X.shape[0]:
        raise SystemExit(f"--val-frac {args.val_frac} leaves no "
                         f"validation rows (s={X.shape[0]})")
    return X[:cut], y[:cut], X[cut:], y[cut:]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="real-sim",
                    help="paper dataset profile name or a .libsvm path")
    ap.add_argument("--loss", default="logistic",
                    choices=["logistic", "squared_hinge"])
    ap.add_argument("--points", type=int, default=20)
    ap.add_argument("--span", type=float, default=100.0,
                    help="c_final = span * c_max (ignored with --c-final)")
    ap.add_argument("--c-final", type=float, default=None)
    ap.add_argument("--cold", action="store_true",
                    help="disable warm starting (ablation)")
    ap.add_argument("--mode", default="sweep", choices=["sweep", "batch"],
                    help="sweep: sequential warm-started path; batch: "
                         "solve all grid points at once, in lockstep")
    ap.add_argument("--scale", type=float, default=None,
                    help="paper_like size scale (None = CPU-budget shape)")
    ap.add_argument("--val-frac", type=float, default=0.2,
                    help="held-out row fraction for the best-c pick "
                         "(profile datasets; 0 disables)")
    common.add_solver_args(ap)
    common.add_backend_args(ap)
    common.add_dtype_arg(ap)
    ap.add_argument("--out", default=None, help="write path JSON here")
    ap.add_argument("--save-weights", action="store_true",
                    help="also write <out>.weights.npy")
    ap.add_argument("--save-model", default=None, metavar="PATH",
                    help="write the whole sweep as ONE kind='path' serve "
                         "artifact family: every grid point becomes a "
                         "servable model")
    common.add_obs_args(ap)
    common.add_diag_args(ap)
    common.add_fault_args(ap)
    args = ap.parse_args(argv)
    if args.mode == "batch" and (args.ckpt_dir or args.resume):
        ap.error("--ckpt-dir/--resume require --mode sweep (the lockstep "
                 "batch engine solves all points at once — there is no "
                 "point cursor to checkpoint)")
    if args.mode == "batch" and args.shrink:
        ap.error("--shrink requires --mode sweep (the batch engine has no "
                 "active-set masking)")
    if args.mode == "batch" and args.backend == "sharded":
        ap.error("--mode batch is local-only (the lockstep batch solver "
                 "has no sharded execution backend)")
    if args.mode == "batch" and args.diag_out:
        ap.error("--diag-out requires --mode sweep (the lockstep batch "
                 "engine keeps no per-iteration history)")
    common.check_dtype_envelope(args, ap, loss=args.loss)
    resolve_device(args.device)

    X, y, Xval, yval = _load(args)
    common.setup_obs(args)
    solver = common.build_pcdn_config(args)
    sharded = args.backend == "sharded"
    if sharded:
        backend, prob = common.make_backend(args, X, y, 1.0, args.loss)
    else:
        backend = None
        prob = make_problem(X, y, c=1.0, loss=args.loss, layout=args.layout,
                            dtype=common.DTYPES[args.dtype],
                            device=args.device)
    view = backend if sharded else prob
    writer = common.is_writer(backend)
    if writer:
        print(f"[path] dataset={args.dataset} s={view.n_samples} "
              f"n={view.n_features} c_max={view.c_max():.5g} "
              f"points={args.points} mode={args.mode} shrink={args.shrink} "
              f"warm={not args.cold} device={args.device} "
              f"backend={args.backend}")

    if args.mode == "batch":
        cs = problem_grid(prob, c_final=args.c_final,
                          n_points=args.points, span=args.span)
        t0 = time.perf_counter()
        bres = solve_batch(prob, solver, cs)
        weights = bres.w.cpu().numpy()
        total_s = time.perf_counter() - t0
        points = []
        for i, c in enumerate(cs):
            acc = (validation_accuracy(Xval, yval, weights[i],
                                       device=args.device)
                   if Xval is not None else None)
            p = PathPoint(c=float(c), objective=float(bres.objective[i]),
                          nnz=int(bres.nnz[i]), kkt=float(bres.kkt[i]),
                          n_outer=int(bres.n_outer[i]),
                          seconds=None,   # lockstep: no per-point timing
                          converged=bool(bres.converged[i]),
                          val_accuracy=acc)
            points.append(p)
            print(f"[path] c={p.c:.5g} F={p.objective:.5f} nnz={p.nnz} "
                  f"kkt={p.kkt:.2e} iters={p.n_outer}"
                  + (f" val_acc={acc:.4f}" if acc is not None else ""))
        # a PathResult, so the report schema and the best-c tie-break are
        # the sweep's
        res = PathResult(c_max=float(cs[0]), cs=cs, points=points,
                         weights=weights, best_index=pick_best(points),
                         total_seconds=total_s)
        payload = {"mode": "batch", **path_summary(res)}
    else:
        cfg = PathConfig(solver=solver, n_points=args.points,
                         span=args.span, c_final=args.c_final,
                         warm_start=not args.cold)
        from repro_torch import fault
        res = run_path(prob, cfg, val_design=Xval, val_y=yval,
                       verbose=writer, backend=backend,
                       callback=(common.make_progress_callback(args)
                                 if writer else None),
                       ckpt=common.make_checkpointer(args, ap),
                       resume=args.resume,
                       fault_plan=fault.plan_from_env())
        common.finish_progress(args)
        payload = {"mode": "sweep", "backend": args.backend,
                   **path_summary(res)}
        weights = res.weights
        if res.best is not None and writer:
            print(f"[path] best c={res.best.c:.5g} "
                  f"val_acc={res.best.val_accuracy:.4f} nnz={res.best.nnz}")

    if not writer:
        return payload
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1, default=float)
        if args.save_weights:
            np.save(args.out + ".weights.npy", weights)
        print(f"[path] wrote {args.out}")
    if args.save_model:
        metas = [{"objective": p.objective, "kkt": p.kkt, "nnz": p.nnz,
                  "n_outer": p.n_outer, "converged": p.converged,
                  "val_accuracy": p.val_accuracy} for p in res.points]
        family = art.path_family(
            weights, res.cs, args.loss, metas=metas,
            provenance=art.solver_provenance(
                solver="pcdn", dataset=args.dataset, backend=args.backend,
                mode=args.mode, P=args.P, tol_kkt=args.tol, seed=args.seed,
                shrink=bool(args.shrink), loss=args.loss,
                dtype=args.dtype, best_index=res.best_index,
                package="repro_torch", device=args.device))
        art.save_model(args.save_model, family)
        print(f"[path] wrote model family ({len(family)} points) to "
              f"{args.save_model}")
    if args.diag_out:
        last = res.points[-1] if res.points else None
        diag_report = {
            "provenance": art.solver_provenance(
                solver="pcdn", dataset=args.dataset, backend=args.backend,
                mode=args.mode, P=args.P, tol_kkt=args.tol, seed=args.seed,
                shrink=bool(args.shrink), loss=args.loss, dtype=args.dtype,
                package="repro_torch", device=args.device),
            "loss": args.loss, "n_features": int(view.n_features),
            "objective": last.objective if last else None,
            "converged": last.converged if last else None,
            "nnz": last.nnz if last else None,
            "seconds": res.total_seconds,
            "history": (common.history_dict(res.last_history)
                        if res.last_history is not None else None),
            "postmortem": res.last_postmortem}
        if res.best is not None:
            diag_report["best_c"] = res.best.c
        common.write_diag(
            args, diag_report,
            design=(common.host_design(X, args.layout, args.device)
                    if sharded else prob.design),
            tol_kkt=args.tol)
    common.finish_obs(args, meta={
        "cli": "path", "dataset": args.dataset, "mode": args.mode,
        "backend": args.backend, "device": args.device,
        "points": len(res.points), "total_seconds": res.total_seconds})
    return payload


if __name__ == "__main__":
    main()
