"""PCDN solver driver of the port:
``python -m repro_torch.launch.solve --dataset a9a --use-kernels --layout padded_csc``

Loads or generates an l1 classification problem, runs PCDN (or CDN) on the
chosen device -- the card by default -- and prints the final objective and
the held-out accuracy, as `repro.launch.solve` does on its local backend.

``--out`` writes a report that is at once a servable model artifact (the
`repro.serve/model@1` schema both packages read), a ``--warm-start`` input
(its top-level sparse weight record) and a history log; ``--save-model``
writes just the artifact, for `repro_torch.launch.predict`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import cdn_config, make_problem
from repro_torch.data.synthetic import train_accuracy
from repro_torch.engine import LocalBackend
from repro_torch.engine import loop as engine_loop
from repro_torch.launch import common
from repro_torch.serve import artifact as art


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="real-sim",
                    help="paper dataset profile name or a .libsvm path")
    ap.add_argument("--solver", default="pcdn", choices=["pcdn", "cdn"])
    ap.add_argument("--loss", default="logistic",
                    choices=["logistic", "squared_hinge"])
    ap.add_argument("--c", type=float, default=None,
                    help="regularization (default: paper's c* per dataset)")
    common.add_solver_args(ap)
    common.add_backend_args(ap)
    ap.add_argument("--out", default=None,
                    help="write the combined report (model artifact + "
                         "warm-start record + history) here")
    ap.add_argument("--save-model", default=None, metavar="PATH",
                    help="write just the serve artifact (no history)")
    args = ap.parse_args(argv)

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
                        device=args.device)
    if args.solver == "pcdn":
        cfg = common.build_pcdn_config(args)
    else:
        cfg = cdn_config(max_outer=args.max_outer, tol_kkt=args.tol,
                         seed=args.seed, shrink=args.shrink,
                         use_kernels=args.use_kernels,
                         ls_scope=args.ls_scope)
    w0 = (common.load_warm_start(args.warm_start, prob.n_features)
          if args.warm_start else None)
    t0 = time.time()
    backend = LocalBackend(prob, cfg)
    res = engine_loop.solve(backend, c, w0, max_outer=cfg.max_outer,
                            tol_kkt=cfg.tol_kkt,
                            recheck_every=cfg.recheck_every,
                            tol_rel_obj=cfg.tol_rel_obj)
    w = backend.host_weights(res.w)
    dt = time.time() - t0
    nnz = int(np.sum(w != 0))
    print(f"[solve] F={res.objective:.6f} converged={res.converged} "
          f"nnz={nnz} n_outer={res.n_outer} time={dt:.1f}s")
    if Xte is not None:
        acc = train_accuracy(Xte, yte, w)
        print(f"[solve] test accuracy: {acc:.4f}")
    if args.out or args.save_model:
        history = common.history_dict(res.history)
        meta = {"objective": float(res.objective),
                "converged": bool(res.converged), "nnz": nnz}
        if history.get("kkt"):
            meta["kkt"] = float(history["kkt"][-1])
            meta["n_outer"] = len(history["kkt"])
        family = art.ModelFamily(
            kind="binary",
            models=(art.artifact_from_solution(w, args.loss, c, meta=meta),),
            provenance=art.solver_provenance(
                solver=args.solver, dataset=args.dataset, backend="local",
                P=args.P, tol_kkt=args.tol, seed=args.seed,
                shrink=bool(args.shrink), loss=args.loss, dtype="fp32",
                package="repro_torch", device=args.device))
        if args.save_model:
            art.save_model(args.save_model, family)
        if args.out:
            # the top-level sparse weight record keeps the report a valid
            # --warm-start input; n_features comes from the artifact block
            record = common.sparse_weight_record(w)
            record.pop("n_features")
            art.save_model(args.out, family, extra={
                "objective": float(res.objective),
                "converged": bool(res.converged), "nnz": nnz,
                "seconds": dt, **record, "history": history})
    return res.objective


if __name__ == "__main__":
    main()
