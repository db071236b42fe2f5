#!/usr/bin/env python3
"""Dense SCDN of one source tree on gisette, on one card: the A/B of a
change to the dense SCDN batch against its parent.

    python3 benchmarks/port/scdn_dense_ab.py --src src --label change
    # the parent unpacked beside it (a directory .gitignore lists):
    #   git archive <parent> src | tar -x -C build/ab/parent
    python3 benchmarks/port/scdn_dense_ab.py --src build/ab/parent/src \
        --label parent

Run parent, change, change, parent in one call on one card: each process
imports `repro_torch` from `--src` alone, builds that tree's kernels and
measures, on gisette at its published shape (6,000 x 5,000, dense, seed
0, c 0.25) at P_bar 64, through the tree's public SCDN API
(`core.scdn.make_round`, `Round.one_batch`, `scdn.solve`):

  * a batch (`one_batch`), each call the next batch of a round on a carry
    the calls evolve, from a carry solved by one round from 0: device us
    by CUDA events behind a spin kernel (L2-cold: 128 MB written before
    each call; and L2-warm), and host us a batch (calls back to back, one
    synchronize);
  * `scdn.solve` for 30 rounds (after a 1-round warm-up): ms a round, us
    a batch, the objective after each round;
  * one round of the same batches traced with torch.profiler: device ops
    a batch, busy us a batch (the union of the device ops' intervals) and
    the idle share against the untraced wall of the same round, the top
    device ops (a programmatic launch's time includes its wait for the
    kernel before it).

Prints one JSON line with the card's name and power limit. Imports
neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

P_BAR = 64
ROUNDS = 30
C = 0.25


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


def host_us(torch, fn, n: int) -> float:
    """Mean wall us a call, n calls back to back and one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def device_busy_s(prof) -> float:
    """Seconds the card was busy in a trace: the union of its device
    events' intervals (`chip_smoke.device_busy_s`: a programmatic launch
    overlaps the kernel before it, which a sum would count twice)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, spans[0][0] if spans else 0.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


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
        print("scdn_dense_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import scdn
    from repro_torch.core.problem import make_problem
    from repro_torch.data import paper_like
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    X, y, _ = paper_like("gisette", scale=1.0, seed=0)
    prob = make_problem(X, y, c=C, layout="dense", device=dev)
    n, s = prob.n_features, prob.n_samples
    cfg = scdn.SCDNConfig(P_bar=P_BAR)
    round_ = scdn.make_round(prob, cfg)
    w, z = round_(torch.zeros((n,), device=dev),
                  torch.zeros((s,), device=dev),
                  torch.Generator().manual_seed(1))[:2]
    idxs = torch.randint(0, n, (round_.n_batches, P_BAR),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    batches = idxs.to(dev).unbind(0)
    flush_buf = torch.empty((128 * 1024 * 1024 // 4,), device=dev)

    def flush():
        flush_buf.zero_()

    wc, zc, it = w.clone(), z.clone(), [0]

    def batch():
        t = it[0] % len(batches)
        it[0] += 1
        round_.one_batch(wc, zc, batches[t])

    out = {"label": args.label,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "batch_cold_us": device_us(torch, batch, args.calls, flush),
           "batch_warm_us": device_us(torch, batch, args.calls),
           "batch_host_us": host_us(torch, batch, 2 * args.calls)}

    scdn.solve(prob, scdn.SCDNConfig(P_bar=P_BAR, max_rounds=1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = scdn.solve(prob, scdn.SCDNConfig(P_bar=P_BAR, max_rounds=ROUNDS))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out.update(rounds=res.n_rounds, diverged=res.diverged,
               round_ms=dt / res.n_rounds * 1e3,
               solve_batch_us=dt / (res.n_rounds * round_.n_batches) * 1e6,
               objective=[float(f) for f in res.history["objective"]],
               launches={k: v for k, v in ops.launch_counts().items() if v})

    def one_round():
        round_(w, z, torch.Generator(), idxs=idxs)

    one_round()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        one_round()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_round()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e6)
            for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy = device_busy_s(prof)
    nb = round_.n_batches
    out.update(traced_batches=nb, round_wall_ms=wall * 1e3,
               device_ops_a_batch=sum(r[1] for r in rows) / nb,
               busy_us_a_batch=busy / nb * 1e6,
               idle_share=1.0 - busy / wall if busy > 0 else None,
               top=[(k[:80], c, t / nb * 1e6) for k, c, t in rows[:6]])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
