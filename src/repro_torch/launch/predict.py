"""Serving CLI of the port: load a model artifact, score traffic, report
latency.

    python -m repro_torch.launch.solve --dataset a9a --save-model m.json
    python -m repro_torch.launch.predict --model m.json --dataset a9a

Loads a `repro.serve/model@1` artifact (binary model, OVR head, or path
family; saved by either package), stacks it into a `ModelBank` on
`--device` (the card by default), and streams the dataset's rows through
the microbatched prediction engine: requests are padded to bucket shapes
and per-bucket latency / throughput are reported. `--layout padded_csc`
serves the feature-major sparse request path; `--use-kernels` routes
margins through the hand-written CUDA kernels K4a/K4b (their plain PyTorch
versions on `--device cpu`), whose output is held against the plain
scorer on the first batch.

`--route` picks the dense-layout scorer: "sparse" (union-gather), "dense"
(densified matmul), or "auto" (the crossover table of serve.predict).
`--best-c` reduces a kind="path" artifact to its best grid point
(serve.artifact.pick_best_c) before serving.

`--serve` switches to the continuous-batching loop: open-loop Poisson
traffic at `--rate` rps with per-request budget `--slo-ms`, reporting
admission-to-response p50/p99, padding efficiency and SLO violations.
`--swap-model` hot-swaps a second artifact in mid-stream (best-c selected
live for path artifacts) at `--swap-at` of the run; the report says
whether every bank tensor kept its storage across the swap and which
kernel libraries, if any, were loaded after warm-up.

`--metrics-out` / `--trace-out` record the run's telemetry: the batcher's
or the loop's `serve.*` metrics and spans and the kernels' launch counts
and enqueue spans (validate with `python -m repro_torch.obs.validate`).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np

from repro_torch.data import load_libsvm, paper_like
from repro_torch.data.libsvm import CSRMatrix, csr_to_padded_csc
from repro_torch.device import resolve_device
from repro_torch.launch import common
from repro_torch.launch.common import DTYPES
from repro_torch.serve.artifact import ModelFamily, load_model, pick_best_c
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.loop import ServeLoop, drive_poisson
from repro_torch.serve.policy import default_buckets
from repro_torch.serve.predict import ModelBank, decide, predict


def _load_requests(args, n_features: int):
    """-> (requests, y_raw, codes) -- y_raw in the loader's normalized
    vocabulary (+-1 for <= 2 labels), codes the sorted-vocabulary class
    codes. File datasets honor --layout; profile names score the held-out
    test split of the generator."""
    if os.path.exists(args.dataset):
        csr, codes, classes = load_libsvm(args.dataset,
                                          n_features=n_features,
                                          layout="csr",
                                          return_classes=True)
        codes = np.asarray(codes, np.int64)
        y_raw = np.asarray(classes)[codes]
        if args.layout == "padded_csc":
            return csr, y_raw, codes
        return csr.to_dense(), y_raw, codes
    _, _, Xte, yte, _ = paper_like(args.dataset, with_test=True,
                                   seed=args.seed)
    codes = (np.asarray(yte) > 0).astype(np.int64)
    if args.layout == "padded_csc":
        return CSRMatrix.from_dense(Xte), yte, codes
    return Xte, yte, codes


def _accuracy(bank: ModelBank, preds: np.ndarray, y_raw, codes) -> dict:
    """Per-kind accuracy: one scalar for binary/ovr, per-point for path.
    OVR banks compare on class CODES (both vocabularies are sorted)."""
    if bank.kind == "ovr":
        pred_codes = np.searchsorted(np.asarray(bank.classes), preds)
        return {"accuracy": float(np.mean(pred_codes == codes))}
    if bank.kind == "path":
        accs = [float(np.mean(preds[:, k] == y_raw))
                for k in range(bank.n_models)]
        best = int(np.argmax(accs))
        return {"per_point": accs, "best_index": best,
                "best_accuracy": accs[best]}
    return {"accuracy": float(np.mean(preds == y_raw))}


def _kernel_guard(args, bank, requests, head: int) -> float:
    """Hold the kernel scorer against the plain one on the first `head`
    requests; raises SystemExit when they disagree. -> max |err|."""
    if args.layout == "dense":
        probe = np.asarray(requests[:head], np.float32)
    else:
        probe = csr_to_padded_csc(requests.rows(0, head))
    zk = predict(bank, probe, use_kernels=True).cpu().numpy()
    zr = predict(bank, probe, use_kernels=False).cpu().numpy()
    err = float(np.abs(zk - zr).max()) if zk.size else 0.0
    print(f"[predict] kernel-vs-reference max |err| = {err:.2e}")
    # bf16 banks: both scorers read the same rounded weights but reduce in
    # other orders, so a looser (still f32-accumulation-sized) band
    rtol = 1e-4 if args.dtype == "fp32" else 1e-3
    if err > rtol * max(1.0, float(np.abs(zr).max())):
        raise SystemExit("CUDA margin kernel disagrees with the plain "
                         "scorer")
    return err


def _run_serve(args, family) -> dict:
    """--serve: the continuous-batching loop under open-loop Poisson load,
    with an optional mid-stream hot-swap."""
    if args.layout != "dense":
        raise SystemExit("--serve admits dense request rows only "
                         "(--layout dense)")
    # the per-request budget (the internal flush deadline) gets headroom
    # under the SLO, so deadline-flush jitter still lands under it
    budget_s = 0.8 * args.slo_ms / 1e3
    loop = ServeLoop(family, max_batch=args.max_batch,
                     buckets=([int(b) for b in args.buckets.split(",")]
                              if args.buckets else None),
                     default_budget_s=budget_s,
                     max_queue=args.max_queue, route=args.route,
                     use_kernels=args.use_kernels,
                     dtype=DTYPES[args.dtype], device=args.device)
    bank = loop.bank()
    ptrs0 = loop.storage_ptrs()
    print(f"[serve] model={args.model} kind={bank.kind} K={bank.n_models} "
          f"n={bank.n_features} sparsity={bank.sparsity():.4f} "
          f"routes={loop.stats()['models']['default']['routes']} "
          f"device={bank.device}")

    requests, y_raw, codes = _load_requests(args, bank.n_features)
    X = np.asarray(requests, np.float32)     # the loop serves dense rows
    n_req = min(args.serve_requests,
                X.shape[0] if args.limit is None else args.limit)

    swap_state = {}
    swapper = None
    if args.swap_model:
        swap_family = load_model(args.swap_model)
        delay = args.swap_at * args.serve_requests / args.rate

        t_start = time.perf_counter()

        def _fire():
            time.sleep(delay)
            t_fire = time.perf_counter()
            swap_state["ticket"] = loop.swap(model=swap_family)
            swap_state["fired_at_s"] = t_fire - t_start
            swap_state["queue_s"] = time.perf_counter() - t_fire

        swapper = threading.Thread(target=_fire, daemon=True)
        swapper.start()

    drive = drive_poisson(loop, X[:n_req], rate_rps=args.rate,
                          n_requests=args.serve_requests,
                          budget_s=budget_s)
    if swapper is not None:
        swapper.join()
        swap_state["ticket"].installed.wait(10.0)
    loop.stop()
    storage_kept = loop.storage_ptrs() == ptrs0
    late_libs = list(loop.libraries_loaded_since_warmup())

    results = drive.pop("results")
    stats = loop.stats()
    slot = stats["models"]["default"]
    pad_total = slot["rows"] + slot["pad_rows"]
    slo_violations = sum(r.latency_s > args.slo_ms / 1e3 for r in results)
    payload = {"model": args.model, "kind": bank.kind, "mode": "serve",
               "rate_rps": args.rate, "slo_ms": args.slo_ms,
               "route": args.route, "device": str(bank.device), **drive,
               "padding_efficiency": (slot["rows"] / pad_total
                                      if pad_total else None),
               "slo_violations": slo_violations,
               "bank_storage_kept": storage_kept,
               "libraries_loaded_after_warmup": late_libs,
               "stats": stats}
    if args.swap_model:
        versions = sorted({r.version for r in results})
        payload["swap"] = {"model": args.swap_model,
                           "installed_version": swap_state["ticket"].version,
                           "response_versions": versions,
                           # when the swap was called, after the run's
                           # start, and how long building and queueing the
                           # new bank held the calling thread
                           "fired_at_s": swap_state["fired_at_s"],
                           "queue_s": swap_state["queue_s"]}
        print(f"[serve] hot-swap -> version "
              f"{swap_state['ticket'].version}, response versions "
              f"{versions}, bank storage kept={storage_kept}, libraries "
              f"loaded after warm-up={late_libs}")
    if y_raw is not None and drive["rejects"] == 0 and results \
            and bank.kind == "binary" and not args.swap_model:
        preds = decide(bank, np.stack([r.margins for r in results]))
        # arrivals cycle the first n_req rows in submit order
        sel = np.arange(len(results)) % n_req
        payload["accuracy"] = float(np.mean(preds == y_raw[sel]))
        print(f"[serve] accuracy={payload['accuracy']:.4f}")
    print(f"[serve] {drive['responses']} responses at "
          f"{drive['offered_rps']:.0f} rps offered: "
          f"p50={1e3 * (drive['p50_s'] or 0):.2f}ms "
          f"p99={1e3 * (drive['p99_s'] or 0):.2f}ms "
          f"rejects={drive['rejects']} "
          f"slo_violations={slo_violations} "
          f"padding_eff={payload['padding_efficiency']:.3f} "
          f"flushes={slot['flushes']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1, default=float)
        print(f"[serve] wrote {args.out}")
    common.finish_obs(args, meta={
        "cli": "predict--serve", "model": args.model,
        "dataset": args.dataset, "device": str(bank.device),
        "rate_rps": args.rate, "p99_s": drive["p99_s"],
        "rejects": drive["rejects"],
        "libraries_loaded_after_warmup": len(late_libs)})
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True,
                    help="artifact JSON from --save-model (either package)")
    ap.add_argument("--dataset", required=True,
                    help="paper dataset profile name or a .libsvm path")
    ap.add_argument("--layout", default="dense",
                    choices=["dense", "padded_csc"],
                    help="request layout served to the margin engine")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route margins through the hand-written CUDA "
                         "kernels (plain PyTorch versions on --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the bank lives and scoring runs; cuda "
                         "raises when no card is present")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="bank storage dtype: bf16 halves bank memory and "
                         "scorer traffic; margins still accumulate in f32")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated bucket sizes (default: powers "
                         "of two up to --max-batch)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--limit", type=int, default=None,
                    help="serve only the first N requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write predictions + bucket stats JSON here")
    ap.add_argument("--route", default="sparse",
                    choices=["sparse", "dense", "auto"],
                    help="dense-layout scorer: union-gather, densified "
                         "matmul, or the crossover table")
    ap.add_argument("--best-c", nargs="?", const="val_accuracy",
                    default=None, metavar="METRIC",
                    help="serve only the best grid point of a path "
                         "artifact, selected by METRIC "
                         "(default val_accuracy; 'nnz' = sparsest)")
    ap.add_argument("--serve", action="store_true",
                    help="continuous-batching loop under Poisson load "
                         "instead of the synchronous batcher")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="[--serve] offered load, requests/s")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="[--serve] per-request latency budget")
    ap.add_argument("--serve-requests", type=int, default=512,
                    help="[--serve] total Poisson arrivals to drive")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="[--serve] admission-control queue bound "
                         "(default: unbounded)")
    ap.add_argument("--swap-model", default=None,
                    help="[--serve] artifact to hot-swap in mid-stream "
                         "(path artifacts: best-c selected live)")
    ap.add_argument("--swap-at", type=float, default=0.5,
                    help="[--serve] fire the swap at this fraction of "
                         "the run")
    common.add_obs_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    common.setup_obs(args)

    family = load_model(args.model)
    if args.best_c is not None:
        i, best = pick_best_c(family, metric=args.best_c)
        print(f"[predict] --best-c {args.best_c}: grid point {i} "
              f"(c={best.c:.4g}, nnz={best.nnz}, "
              f"meta={best.meta.get(args.best_c)})")
        family = ModelFamily(kind="binary", models=(best,),
                             provenance=family.provenance)
    if args.serve:
        return _run_serve(args, family)
    bank = ModelBank.from_family(family, dtype=DTYPES[args.dtype],
                                 device=args.device)
    print(f"[predict] model={args.model} kind={bank.kind} "
          f"K={bank.n_models} n={bank.n_features} a_max={bank.a_max} "
          f"sparsity={bank.sparsity():.4f} dtype={args.dtype} "
          f"device={bank.device}")

    requests, y_raw, codes = _load_requests(args, bank.n_features)
    n_req = requests.shape[0]
    if args.limit is not None and args.limit < n_req:
        if isinstance(requests, CSRMatrix):
            requests = requests.rows(0, args.limit)
        else:
            requests = requests[:args.limit]
        y_raw = None if y_raw is None else y_raw[:args.limit]
        codes = None if codes is None else codes[:args.limit]
        n_req = args.limit

    buckets = ([int(b) for b in args.buckets.split(",")] if args.buckets
               else default_buckets(args.max_batch))
    # padded-CSC chunks are packed at their own column width
    batcher = MicroBatcher(bank, buckets=buckets, layout=args.layout,
                           use_kernels=args.use_kernels, route=args.route)

    guard_err = None
    if args.use_kernels:
        guard_err = _kernel_guard(args, bank, requests,
                                  min(n_req, min(buckets)))

    margins = batcher.predict(requests)
    stats = batcher.stats()
    preds = decide(bank, margins)
    payload = {"model": args.model, "kind": bank.kind,
               "n_requests": int(n_req), "layout": args.layout,
               "use_kernels": args.use_kernels, "device": str(bank.device),
               "kernel_guard_max_abs_err": guard_err, "stats": stats}
    if y_raw is not None:
        payload.update(_accuracy(bank, preds, y_raw, codes))
        acc = payload.get("accuracy", payload.get("best_accuracy"))
        print(f"[predict] accuracy={acc:.4f} over {n_req} requests")
    for b in stats["buckets"]:
        rps = b["rows_per_s"]
        print(f"[predict] bucket={b['bucket']:>5} calls={b['calls']} "
              f"rows={b['rows']} pad={b['pad_rows']} "
              f"warmup={b['warmup_seconds'] * 1e3:.1f}ms "
              + (f"steady={rps:.0f} rows/s" if rps else "steady=n/a"))
    print(f"[predict] calls={stats['calls']} "
          f"warmup_calls={stats['warmup_calls']} (one per bucket shape)")
    if args.out:
        payload["predictions"] = np.asarray(preds).tolist()
        payload["margins"] = np.asarray(margins).tolist()
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1, default=float)
        print(f"[predict] wrote {args.out}")
    common.finish_obs(args, meta={
        "cli": "predict", "model": args.model, "dataset": args.dataset,
        "layout": args.layout, "device": str(bank.device),
        "n_requests": int(n_req),
        "steady_rows_per_s": stats.get("steady_rows_per_s")})
    return payload


if __name__ == "__main__":
    main()
