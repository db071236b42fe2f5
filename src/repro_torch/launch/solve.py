"""PCDN solver driver of the port:
``python -m repro_torch.launch.solve --dataset a9a --use-kernels --layout padded_csc``

Loads or generates an l1 classification problem, runs the selected solver
(pcdn / cdn / scdn / tron) on the chosen device -- the card by default --
with the design stored in fp32 or bf16 (`--dtype`, pcdn/cdn only), and
prints the final objective and the held-out accuracy, as
`repro.launch.solve` does on its local backend.

``--out`` writes a report that is at once a servable model artifact (the
`repro.serve/model@1` schema both packages read), a ``--warm-start`` input
(its top-level sparse weight record) and a history log; ``--save-model``
writes just the artifact, for `repro_torch.launch.predict`.
``--metrics-out`` / ``--trace-out`` record the run's telemetry (and turn on
the per-bundle aux plane, pcdn/cdn); ``--progress`` prints a live status
line.

pcdn and cdn run through `fault.resilient_solve`, as in the reference: a
non-finite iterate rolls back and retries at a smaller P (``--retries``),
``--ckpt-dir`` / ``--ckpt-every`` / ``--resume`` checkpoint and resume
the solve, and the ``REPRO_FAULT_PLAN`` variable injects faults.
``--diag-out`` writes the markdown health report (KKT attribution,
backtrack forensics, the certified-P table on the solve's own design).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import fault
from repro_torch.core import make_problem, scdn, tron, with_bundle_size
from repro_torch.data.synthetic import train_accuracy
from repro_torch.engine import LocalBackend
from repro_torch.launch import common
from repro_torch.serve import artifact as art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="real-sim",
                    help="paper dataset profile name or a .libsvm path")
    ap.add_argument("--solver", default="pcdn",
                    choices=["pcdn", "cdn", "scdn", "tron"])
    ap.add_argument("--loss", default="logistic",
                    choices=["logistic", "squared_hinge"])
    ap.add_argument("--c", type=float, default=None,
                    help="regularization (default: paper's c* per dataset)")
    common.add_solver_args(ap)
    common.add_backend_args(ap)
    common.add_dtype_arg(ap)
    ap.add_argument("--out", default=None,
                    help="write the combined report (model artifact + "
                         "warm-start record + history) here")
    ap.add_argument("--save-model", default=None, metavar="PATH",
                    help="write just the serve artifact (no history)")
    common.add_obs_args(ap)
    common.add_diag_args(ap)
    common.add_fault_args(ap)
    args = ap.parse_args(argv)
    if ((args.ckpt_dir or args.resume)
            and args.solver not in ("pcdn", "cdn")):
        ap.error("--ckpt-dir/--resume require --solver pcdn or cdn (the "
                 "checkpoint image is the bundle solver's EngineState)")
    if args.diag_out and args.solver not in ("pcdn", "cdn"):
        ap.error("--diag-out requires --solver pcdn or cdn (the KKT "
                 "attribution harvest is a bundle-solver output)")
    if args.warm_start and args.solver not in ("pcdn", "cdn"):
        ap.error("--warm-start requires --solver pcdn or cdn")
    if args.shrink and args.solver not in ("pcdn", "cdn"):
        ap.error("--shrink requires --solver pcdn or cdn")
    if args.dtype == "bf16" and args.solver not in ("pcdn", "cdn"):
        ap.error("--dtype bf16 is studied for --solver pcdn/cdn only")
    common.check_dtype_envelope(args, ap, loss=args.loss)

    X, y, Xte, yte, spec = common.load_dataset(args, with_test=True)
    if spec is not None:
        c = args.c or (spec.c_logistic if args.loss == "logistic"
                       else spec.c_svm)
    else:
        c = args.c or 1.0
    print(f"[solve] dataset={args.dataset} s={X.shape[0]} n={X.shape[1]} "
          f"c={c} loss={args.loss} solver={args.solver} P={args.P} "
          f"device={args.device}")
    prob = make_problem(X, y, c=c, loss=args.loss, layout=args.layout,
                        dtype=common.DTYPES[args.dtype], device=args.device)
    common.setup_obs(args)
    progress = common.make_progress_callback(args)
    ckpt = common.make_checkpointer(args, ap)
    plan = fault.plan_from_env()
    t0 = time.time()
    if args.solver in ("pcdn", "cdn"):
        # CDN = PCDN with bundle size 1 and a backtracking search
        cfg = (common.build_pcdn_config(args) if args.solver == "pcdn"
               else common.build_pcdn_config(args, P=1,
                                             ls_kind="backtracking"))
        w0 = (common.load_warm_start(args.warm_start, prob.n_features)
              if args.warm_start else None)

        def factory(P):
            return LocalBackend(prob, with_bundle_size(cfg, P))

        res = fault.resilient_solve(
            factory, c, P=cfg.P, w0=w0, max_outer=cfg.max_outer,
            tol_kkt=cfg.tol_kkt, recheck_every=cfg.recheck_every,
            tol_rel_obj=cfg.tol_rel_obj, callback=progress,
            checkpointer=ckpt, resume=args.resume,
            max_retries=args.retries, design=prob.design, plan=plan)
        w = res.w                      # resilient_solve returns host w
        n_outer = res.n_outer
        history = common.history_dict(res.history)
    elif args.solver == "scdn":
        res = scdn.solve(prob, scdn.SCDNConfig(max_rounds=args.max_outer,
                                               tol_kkt=args.tol,
                                               seed=args.seed))
        n_outer = res.n_rounds
    else:
        res = tron.solve(prob, tron.TRONConfig(max_outer=args.max_outer,
                                               tol_kkt=args.tol))
        n_outer = res.n_outer
    if args.solver in ("scdn", "tron"):     # their history is a dict
        history = {k: np.asarray(v).tolist() for k, v in res.history.items()}
        w = res.w.detach().cpu().numpy()
    dt = time.time() - t0
    common.finish_progress(args)
    nnz = int(np.sum(w != 0))
    faults = getattr(res, "faults", None)
    postmortem = getattr(res, "postmortem", None)
    if faults:
        print(f"[fault] rollbacks={faults['rollbacks']} "
              f"p_schedule={faults['p_schedule']} "
              f"p_cert={faults['p_cert']} "
              f"resumed_from={faults['resumed_from']}")
    print(f"[solve] F={res.objective:.6f} converged={res.converged} "
          f"nnz={nnz} n_outer={n_outer} time={dt:.1f}s")
    if Xte is not None:
        acc = train_accuracy(Xte, yte, w)
        print(f"[solve] test accuracy: {acc:.4f}")
    prov = art.solver_provenance(
        solver=args.solver, dataset=args.dataset, backend="local",
        P=args.P, tol_kkt=args.tol, seed=args.seed,
        shrink=bool(args.shrink), loss=args.loss, dtype=args.dtype,
        package="repro_torch", device=args.device)
    diag_block = None
    if args.diag_out:
        # rendered first, so --out carries the certified-P record too and
        # `python -m repro_torch.diag.report --report` re-renders the same
        # markdown from it
        diag_report = {
            "provenance": prov, "loss": args.loss,
            "n_features": int(w.shape[0]),
            "objective": float(res.objective),
            "converged": bool(res.converged), "nnz": nnz, "seconds": dt,
            "history": history, "postmortem": postmortem}
        common.write_diag(args, diag_report, design=prob.design,
                          tol_kkt=args.tol)
        diag_block = diag_report["diag"]
    if args.out or args.save_model:
        meta = {"objective": float(res.objective),
                "converged": bool(res.converged), "nnz": nnz}
        if history.get("kkt"):
            meta["kkt"] = float(history["kkt"][-1])
            meta["n_outer"] = len(history["kkt"])
        family = art.ModelFamily(
            kind="binary",
            models=(art.artifact_from_solution(w, args.loss, c, meta=meta),),
            provenance=prov)
        if args.save_model:
            art.save_model(args.save_model, family)
        if args.out:
            # the top-level sparse weight record keeps the report a valid
            # --warm-start input; n_features comes from the artifact block
            record = common.sparse_weight_record(w)
            record.pop("n_features")
            extra = {"objective": float(res.objective),
                     "converged": bool(res.converged), "nnz": nnz,
                     "seconds": dt, **record, "history": history}
            if postmortem:
                extra["postmortem"] = postmortem
            if faults:
                extra["faults"] = faults
            if diag_block:
                extra["diag"] = diag_block
            art.save_model(args.out, family, extra=extra)
    common.finish_obs(args, meta={
        "cli": "solve", "dataset": args.dataset, "solver": args.solver,
        "backend": "local", "device": args.device,
        "objective": float(res.objective),
        "converged": bool(res.converged), "nnz": nnz, "seconds": dt})
    return res.objective


if __name__ == "__main__":
    main()
