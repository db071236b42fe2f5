#!/usr/bin/env python3
"""K1 and K2 of one source tree, L2-cold and L2-warm, on one card: the A/B
of a change to either kernel against its parent.

    python3 benchmarks/port/fixed_order_ab.py --src src --label change
    # the parent unpacked beside it (a directory .gitignore lists):
    #   git archive <parent> src | tar -x -C build/ab/parent
    python3 benchmarks/port/fixed_order_ab.py --src build/ab/parent/src \
        --label parent

Run parent, change, change, parent in one call on one card: each process
imports `repro_torch` from `--src` alone, builds that tree's kernels (into
the tree's own build directory) and times, at the support and full
cells' real-sim shape (57,848 x 20,958, k_max 278, seed 0, c 4, a sparse
iterate from seed 1 as `chip_smoke.py`'s kernels phase makes it):

  * K1 (`ops.pcdn_bundle`), P 32: each call the next bundle of a
    partition, on a carry the calls evolve;
  * K2 (`ops.pcdn_sparse_direction`), P 512: one bundle's slab.

Device us a call by CUDA events behind a spin kernel (100 calls; L2-cold:
128 MB written before each call). Prints one JSON line with the card's
name and power limit. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def device_us(torch, fn, n: int, flush=None) -> float:
    """Mean device us a call from CUDA events around each call, the host's
    launch gaps hidden behind a spin kernel (`chip_smoke.device_ms`)."""
    for _ in range(3):
        fn()
        if flush is not None:
            flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
        if flush is not None:
            flush()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / 3 * 1e3
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(int(2 * per_call * n * 2e6))
    for i in range(n):
        if flush is not None:
            flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return 1e3 * sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the tree's src directory (holding repro_torch)")
    ap.add_argument("--label", required=True)
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("fixed_order_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.core import bundles as B
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.core.problem import make_problem
    from repro_torch.data import make_sparse_classification
    from repro_torch.kernels import build, ops

    build.build_all()
    dev = torch.device("cuda")
    csc, y, _ = make_sparse_classification(57_848, 20_958, nnz_per_col=278,
                                           seed=0)
    prob = make_problem(csc, y, c=4.0, layout="padded_csc", device=dev)
    design = prob.design
    n = prob.n_features
    gen = torch.Generator().manual_seed(1)
    w = torch.zeros((n,), device=dev)
    on = torch.randperm(n, generator=gen)[: n // 10].to(dev)
    w[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(dev)
    z = prob.margins(w)
    alphas = candidate_alphas(ArmijoParams(), torch.float32, dev)
    flush_buf = torch.empty((128 * 1024 * 1024 // 4,), device=dev)

    def flush():
        flush_buf.zero_()

    bundles = B.partition(gen, n, 32, device=dev).unbind(0)
    launch = ops.BundleLaunch(design.col_rows, design.col_vals, prob.y,
                              alphas, 4.0, 32, len(bundles))
    wc, zc, it = w.clone(), z.clone(), [0]

    def k1():
        t = it[0] % len(bundles)
        it[0] += 1
        ops.pcdn_bundle(launch, wc, zc, bundles[t], t)

    idx = B.partition(gen, n, 512, device=dev)[0]
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)

    def k2():
        ops.pcdn_sparse_direction(slab.rows, slab.vals, z, prob.y, w_B, 4.0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"label": args.label, "card": smi,
           "k1_cold_us": device_us(torch, k1, args.calls, flush),
           "k1_warm_us": device_us(torch, k1, args.calls),
           "k2_cold_us": device_us(torch, k2, args.calls, flush),
           "k2_warm_us": device_us(torch, k2, args.calls)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
