#!/usr/bin/env python3
"""The host cost of resolving launch plans through the tuner's memo
(`ops.tuned_plan`) on the solver's host-bound scopes, on one card.

    python3 benchmarks/port/plan_memo_ab.py [--readings 8] [--iters 10]

Two ways of planning the same launches, alternating in one process so
both see the same host state:

  * "memo": the dispatchers as they ship, each call resolving its plan
    through `ops.tuned_plan` (a dict lookup once the shape is known);
  * "rule": the plan functions' rules called directly, as the dispatchers
    did before the tuner (K3's plan behind an lru_cache, as it was).

With a cold cache both give the same plans, so the launches are equal and
only the host work a call differs. Timed: the full scope (K2 a bundle;
real-sim 57,848 x 20,958, k_max 278, P 512, c 4) and the dense scope (K3
a bundle; gisette 6,000 x 5,000, P 512, c 0.25), each reading a solve of
`--iters` outer iterations from w = 0 after 3 warm-up iterations, wall
over the iterations, the modes' order swapped every reading; and the
plan lookup alone, host us a call. Prints one JSON line with the card's
name and power limit. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parents[1] / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import bench_kernels as bk  # noqa: E402

SCOPES = {"full": ("realsim", 4.0, "padded_csc"),
          "dense": ("gisette", 0.25, "dense")}
P = 512


def _warps_rule(K: int) -> int:
    """K2's warps as the dispatcher computed them before the tuner."""
    return 1 if K <= 64 else (2 if K <= 128 else 4)


def rule_planners(ops) -> dict:
    """The dispatchers' plan helpers with the rules called directly, as
    before the tuner."""
    direction = functools.lru_cache(maxsize=64)(ops.direction_plan)
    return {
        "_sparse_warps": lambda vals, m, config: _warps_rule(vals.shape[1]),
        "_direction_plan": lambda XT, P, config: direction(
            XT.shape[1], P, XT.element_size(),
            ops.direction_max_clusters(XT.device)),
    }


def per_call_us(fn, n: int = 100_000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--readings", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("plan_memo_ab: needs a CUDA card")
    # a cold cache of this run's own: the memo resolves the rules' plans
    tmp = tempfile.mkdtemp()
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "cold.json")
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import autotune, ops

    autotune.invalidate_cache()
    smi = bk.nvidia_smi_line()
    data = bk.build_data(False)
    memo = {name: getattr(ops, name) for name in ("_sparse_warps",
                                                  "_direction_plan")}
    modes = {"memo": memo, "rule": rule_planners(ops)}

    def use(mode):
        for name, fn in modes[mode].items():
            setattr(ops, name, fn)

    out = {"card": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "P": P, "iters": args.iters,
           "readings": args.readings, "scopes": {}}
    for scope, (key, c, layout) in SCOPES.items():
        X, y = data[key]
        prob = make_problem(X, y, c=c, layout=layout, device="cuda")
        backend = LocalBackend(prob, PCDNConfig(P=P, use_kernels=True,
                                                tol_kkt=0.0, seed=0))
        walls = {"memo": [], "rule": []}
        for mode in ("memo", "rule"):
            use(mode)
            engine_loop.solve(backend, c, max_outer=3, tol_kkt=0.0)
        for r in range(args.readings):
            order = ("memo", "rule") if r % 2 == 0 else ("rule", "memo")
            for mode in order:
                use(mode)
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine_loop.solve(backend, c, max_outer=args.iters,
                                  tol_kkt=0.0)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0)
                                   / args.iters * 1e3)
        launches = ops.launch_counts()
        use("memo")
        out["scopes"][scope] = {
            "ms": walls,
            "median_ms": {m: statistics.median(w) for m, w in walls.items()},
            "mean_ms": {m: statistics.fmean(w) for m, w in walls.items()},
            "launches_a_reading": {k: v for k, v in launches.items() if v},
        }

    # the plan lookup alone, on the operands of each scope's kernel
    vals = torch.zeros((P, 278), device="cuda")
    XT = torch.zeros((8, 6000), device="cuda")
    lookups = {}
    for mode in ("memo", "rule"):
        fns = modes[mode]
        lookups[mode] = {
            "K2": per_call_us(lambda: fns["_sparse_warps"](vals, 57_848,
                                                           None)),
            "K3": per_call_us(lambda: fns["_direction_plan"](XT, P, None)),
        }
    out["plan_lookup_host_us"] = lookups
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
