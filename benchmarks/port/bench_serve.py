#!/usr/bin/env python3
"""Serving-engine benchmark of the port on one NVIDIA card, and the
measured dense-layout route crossover that `--route auto` reads.

    python3 benchmarks/port/bench_serve.py [--smoke]

Sections, over a bank of K synthetic sparse models (`make_bank`, seeded):

  * scorer -- dense (B, n) request slabs through both dense-layout
    routes of `serve.predict.margins_dense`: "dense" (the densified
    (K, n) torch.matmul) and "sparse" (the union gather, an index_select
    and a (B, U) x (U, K) matmul), and K4a's per-model gather (the
    --use-kernels route), over weight sparsity x batch;
  * route_crossover (`derive_route_crossover`, the reference's function):
    per sparsity, the smallest measured batch from which the union gather
    beats the densified matmul at it and every larger batch, or None.
    `serve.predict.route_crossover()` reads it from this run's file, so
    `--route auto` (which chooses between those two routes) picks the
    card's measured winner;
  * csc_scorer -- the same bank on padded-CSC request batches: the plain
    scatter (`index_add_`) and K4b;
  * batcher -- `MicroBatcher` under a ragged stream on the dense layout:
    rows/s by bucket.

Times are host wall seconds a call: 50 calls queued back to back and
one synchronize, the median of 5 such readings after a warm-up call (a
call's cost is the larger of its host enqueue and its device time; the
synchronize a serving call also pays is the same for every route). A
full run writes benchmarks/port/results/BENCH_serve_h100.json ("smoke":
false, the card's name and power limit in `meta`); --smoke writes only
BENCH_serve_h100_smoke.json, which `route_crossover()` skips. Needs a
card; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
RESULTS = HERE / "results"
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _sync() -> None:
    import torch
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def _time(fn, calls: int = 50, readings: int = 5) -> float:
    """Host seconds a call: `calls` calls queued back to back and one
    synchronize, the median of `readings` such readings, after a warm-up
    call. A call's cost is then the larger of its host enqueue and its
    device time, without the synchronize's own latency, which is the same
    for every route and swamps their difference when paid per call."""
    fn()
    _sync()
    ts = []
    for _ in range(readings):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync()
        ts.append((time.perf_counter() - t0) / calls)
    ts.sort()
    return ts[len(ts) // 2]


def make_bank(K: int, n: int, sparsity: float, seed: int = 0):
    from repro_torch.serve.predict import ModelBank
    rng = np.random.default_rng(seed)
    nnz = max(1, int(round((1.0 - sparsity) * n)))
    W = np.zeros((K, n), np.float32)
    for k in range(K):
        sup = rng.choice(n, size=nnz, replace=False)
        W[k, sup] = rng.standard_normal(nnz).astype(np.float32)
    return ModelBank.from_dense(W, kind="path", device=DEVICE)


def bench_scorer(K, n, batches, sparsities, seed=0):
    import torch
    from repro_torch.serve.predict import margins_dense
    rng = np.random.default_rng(seed + 1)
    rows = []
    for sp in sparsities:
        bank = make_bank(K, n, sp, seed=seed)
        bank.dense_matrix()                 # built once, as serving does
        for B in batches:
            X = torch.as_tensor(rng.standard_normal((B, n)),
                                dtype=torch.float32, device=DEVICE)
            t_dense = _time(lambda: margins_dense(bank, X, route="dense"))
            t_sparse = _time(lambda: margins_dense(bank, X, route="sparse"))
            t_kernel = _time(lambda: margins_dense(bank, X,
                                                   use_kernels=True))
            want = margins_dense(bank, X, route="dense")
            err = max(
                float(torch.max(torch.abs(
                    margins_dense(bank, X, route="sparse") - want))),
                float(torch.max(torch.abs(
                    margins_dense(bank, X, use_kernels=True) - want))))
            row = {"sparsity": sp, "batch": B, "a_max": bank.a_max,
                   "dense_s": t_dense, "sparse_gather_s": t_sparse,
                   "kernel_s": t_kernel,
                   "dense_rows_per_s": B / t_dense,
                   "sparse_rows_per_s": B / t_sparse,
                   "kernel_rows_per_s": B / t_kernel,
                   "speedup": t_dense / t_sparse,
                   "kernel_speedup": t_dense / t_kernel,
                   "max_abs_err": err}
            rows.append(row)
            print(f"[scorer] sparsity={sp} B={B}: dense "
                  f"{t_dense * 1e6:.1f} us, union gather "
                  f"{t_sparse * 1e6:.1f} us (x{row['speedup']:.2f}), K4a "
                  f"{t_kernel * 1e6:.1f} us (x{row['kernel_speedup']:.2f}); "
                  f"err {err:.1e}", flush=True)
    return rows


def derive_route_crossover(scorer_rows):
    """The measured dense-vs-union-gather crossover per sparsity level:
    the smallest measured batch from which the sparse-gather route wins
    (speedup >= 1 there AND at every larger measured batch -- monotone
    in practice, and requiring it keeps a noisy mid-table win from
    flipping the route), or None when dense wins everywhere. Committed
    under the `route_crossover` key; serve.predict.pick_route reads it
    so launch.predict --route auto picks the measured winner instead of
    always preferring the sparse path."""
    table = []
    for sp in sorted({r["sparsity"] for r in scorer_rows}):
        rows = sorted((r for r in scorer_rows if r["sparsity"] == sp),
                      key=lambda r: r["batch"])
        crossover = None
        for i, r in enumerate(rows):
            if all(q["speedup"] >= 1.0 for q in rows[i:]):
                crossover = r["batch"]
                break
        table.append({"sparsity": sp, "min_batch_sparse": crossover})
    return table


def bench_csc_scorer(K, n, batches, sparsity, req_density, seed=0):
    import torch
    from repro_torch.core.design_matrix import PaddedCSCDesign
    from repro_torch.serve.predict import margins_dense, margins_padded_csc
    rng = np.random.default_rng(seed + 2)
    bank = make_bank(K, n, sparsity, seed=seed)
    rows = []
    for B in batches:
        mask = rng.random((B, n)) < req_density
        Xd = np.where(mask, rng.standard_normal((B, n)), 0.0) \
            .astype(np.float32)
        design = PaddedCSCDesign.from_dense(Xd, device=DEVICE)
        Xt = torch.as_tensor(Xd, device=DEVICE)
        t_dense_req = _time(lambda: margins_dense(bank, Xt))
        t_csc = _time(lambda: margins_padded_csc(bank, design))
        t_kernel = _time(lambda: margins_padded_csc(bank, design,
                                                    use_kernels=True))
        want = margins_dense(bank, Xt)
        err = max(float(torch.max(torch.abs(
            margins_padded_csc(bank, design) - want))),
            float(torch.max(torch.abs(margins_padded_csc(
                bank, design, use_kernels=True) - want))))
        rows.append({"batch": B, "req_density": req_density,
                     "k_max": design.k_max,
                     "dense_request_s": t_dense_req,
                     "padded_csc_s": t_csc, "kernel_s": t_kernel,
                     "csc_rows_per_s": B / t_csc,
                     "kernel_rows_per_s": B / t_kernel,
                     "max_abs_err": err})
        print(f"[csc] B={B} k_max={design.k_max}: dense-request "
              f"{B / t_dense_req:.0f} rows/s, padded-csc {B / t_csc:.0f} "
              f"rows/s, K4b {B / t_kernel:.0f} rows/s (err {err:.1e})",
              flush=True)
    return rows


def bench_batcher(K, n, sparsity, n_requests, buckets, seed=0):
    from repro_torch.serve.batcher import MicroBatcher
    rng = np.random.default_rng(seed + 3)
    bank = make_bank(K, n, sparsity, seed=seed)
    X = rng.standard_normal((n_requests, n)).astype(np.float32)
    batcher = MicroBatcher(bank, buckets=buckets, layout="dense")
    # ragged steady-state stream: random batch sizes
    sizes = rng.integers(1, buckets[-1] + 1, size=64)
    t0 = time.perf_counter()
    start = 0
    for r in sizes:
        stop = min(start + int(r), n_requests)
        if stop <= start:
            start = 0
            stop = int(r)
        batcher.predict(X[start:stop])
        start = stop
    wall = time.perf_counter() - t0
    stats = batcher.stats()
    stats["wall_seconds"] = wall
    stats["stream_batches"] = len(sizes)
    print(f"[batcher] {stats['total_rows']} rows over {len(sizes)} ragged "
          f"batches ({len(buckets)} buckets), steady "
          f"{(stats['steady_rows_per_s'] or 0):.0f} rows/s", flush=True)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes; writes only "
                         "BENCH_serve_h100_smoke.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.smoke:
        K, n = 8, 8192
        batches = (16, 64, 256)
        sparsities = (0.99, 0.999)
        n_requests, buckets = 1024, (16, 64, 256)
    else:
        K, n = 16, 32768
        batches = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
        sparsities = (0.9, 0.99, 0.999)
        n_requests, buckets = 8192, (16, 64, 256, 1024)
    smi = nvidia_smi_line()
    print(f"[serve] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    scorer = bench_scorer(K, n, batches, sparsities)
    at99 = [r for r in scorer if r["sparsity"] >= 0.99
            and r["batch"] == max(b["batch"] for b in scorer)]
    best = max(at99, key=lambda r: r["speedup"])
    payload = {
        "meta": {"card": smi, "torch": torch.__version__,
                 "cuda": torch.version.cuda,
                 "timing": "host wall a call: 50 calls back to back and "
                           "one synchronize, median of 5 readings after a "
                           "warm-up call",
                 "when": time.strftime("%Y-%m-%dT%H:%M:%S")},
        "backend": "cuda",
        "smoke": bool(args.smoke),
        "bank": {"K": K, "n": n},
        "scorer": scorer,
        "speedup_at_ge_099": best["speedup"],
        "headline_sparsity": best["sparsity"],
        "headline_batch": best["batch"],
        "route_crossover": derive_route_crossover(scorer),
        "csc_scorer": bench_csc_scorer(K, n, batches[-3:], sparsities[-1],
                                       req_density=0.02),
        "batcher": bench_batcher(K, n, sparsities[-1], n_requests, buckets),
    }
    print(f"[serve] route crossover {payload['route_crossover']}",
          flush=True)
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / ("BENCH_serve_h100_smoke.json" if args.smoke
                     else "BENCH_serve_h100.json")
    out.write_text(json.dumps(payload, indent=1, default=float) + "\n")
    print(f"[serve] wrote {out.relative_to(ROOT)}", flush=True)
    return payload


if __name__ == "__main__":
    main()
