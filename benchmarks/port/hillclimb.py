#!/usr/bin/env python3
"""The `kernel` cell of the hillclimb driver, on one NVIDIA card: a greedy
coordinate climb of K1's launch plan (`ops.bundle_plan`: the cluster's
CTAs and the warps a column is split over) at the real-sim support shape
(P 32, K 278, s 57,848, Q 40; `bench_kernels.cell_bundle`), through
`repro_torch.kernels.autotune.tune(strategy="hillclimb")`.

    python3 benchmarks/port/hillclimb.py [--smoke] [--no-persist]

It starts from the rules' plan and improves one axis at a time, each step
an L2-cold CUDA-event median; every accepted step is logged. The
trajectory is the deliverable: which axis bought what on this card. The
winner is held against the plain version (w, z rel 1e-4; alpha and
n_steps equal) and persisted in the tuner's cache unless --no-persist or
--smoke. Writes benchmarks/port/results/hillclimb/kernel.json (--smoke:
kernel_smoke.json) with the card's name and power limit. Needs a card;
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
RESULTS = HERE / "results" / "hillclimb"
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import bench_kernels as bk  # noqa: E402


def cell_kernel(smoke: bool = False, persist: bool = True) -> dict:
    import torch
    from repro_torch.kernels import autotune, build
    smi = bk.nvidia_smi_line()
    build.build_all()
    data = bk.build_data(smoke)
    csc, y = data["realsim"]
    cell = bk.cell_bundle(torch, csc, y, "float32", P=8 if smoke else 32)
    print(f"[kernel] climbing {cell.kernel} {cell.shape} on {smi}...",
          flush=True)
    t0 = time.perf_counter()
    res = autotune.tune(cell.kernel, cell.runner,
                        autotune.shape_bucket(**cell.shape), torch.float32,
                        strategy="hillclimb", repeats=3 if smoke else 7,
                        persist=persist and not smoke, plan=cell.plan,
                        device=bk.DEVICE)
    seconds = time.perf_counter() - t0
    for i, step in enumerate(res.trajectory):
        print(f"  step {i}: {step['config']} -> {step['us']:.2f} us",
              flush=True)
    plans = [repr(cell.plan(c)) for c in (autotune.DEFAULTS[cell.kernel],
                                          res.config)]
    agree = cell.agree(res.config) if plans[0] != plans[1] else None
    payload = {
        "kernel": cell.kernel, "shape": cell.shape, "card": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "backend": autotune.backend_tag(), "smoke": smoke,
        "timing": "CUDA-event medians; L2-cold: 128 MB written before "
                  "each call",
        "default_us": res.default_us, "tuned_us": res.us,
        "tuned_config": res.config, "default_plan": plans[0],
        "tuned_plan": plans[1], "speedup": res.speedup,
        "margin": res.margin,
        "trajectory": list(res.trajectory), "table": list(res.table),
        "n_measured": len(res.table), "skipped": res.skipped,
        "seconds": seconds, "agreement": agree,
    }
    print(f"  {cell.kernel}: default {res.default_us:.2f} us, tuned "
          f"{res.us:.2f} us x{res.speedup:.3f}, margin {res.margin:.3f} "
          f"({len(res.table)} measured "
          f"in {seconds:.1f}s)"
          + ("" if agree is None else
             f"; agreement {'ok' if agree['ok'] else 'FAILED'}"), flush=True)
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / ("kernel_smoke.json" if smoke else "kernel.json")
    out.write_text(json.dumps(payload, indent=1, default=float) + "\n")
    print(f"[kernel] wrote {out.relative_to(HERE.parents[1])}", flush=True)
    if agree is not None and not agree["ok"]:
        raise SystemExit("hillclimb: the winner disagrees with the plain "
                         "version")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="kernel", choices=["kernel"],
                    help="the kernel cell (the sharded ladder is not "
                         "ported)")
    ap.add_argument("--smoke", action="store_true",
                    help="a small real-sim profile, no cache write")
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("hillclimb: needs a CUDA device")
    cell_kernel(smoke=args.smoke, persist=not args.no_persist)


if __name__ == "__main__":
    main()
