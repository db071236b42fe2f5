#!/usr/bin/env python3
"""What gloo's collectives cost between ranks that share one card (CUDA
tensors, staged through the host): the collectives the sharded train step
uses (`launch.mesh.Mesh.all_gather`, `psum_ordered`, `pmax`), each first
held to its exact result on small tensors of every dtype the step sends
(bf16, float32, int64), then timed at sizes of the step's buffers: an
all-gather of 256 MB of bf16 and an all-reduce of 512 MB of float32,
`--repeats` times each (wall a call, the card synchronised).

    torchrun --standalone --nproc-per-node 2 benchmarks/port/gloo_probe.py

Rank 0 prints a line a reading, then one JSON line with every reading and
the card's name and power limit. Needs a CUDA card; imports neither jax
nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    for dtype in (torch.bfloat16, torch.float32, torch.int64):
        x = torch.full((5,), rank + 1, dtype=dtype, device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert [int(p[0]) for p in parts] == list(range(1, world + 1))
        y = x.clone()
        dist.all_reduce(y)
        assert int(y[0]) == world * (world + 1) // 2
    out = {"world": world, "all_gather_256MB_bf16_ms": [],
           "all_reduce_512MB_f32_ms": []}
    big = torch.ones(128 << 20, dtype=torch.bfloat16, device=dev)
    wide = torch.ones(128 << 20, dtype=torch.float32, device=dev)
    for _ in range(args.repeats):
        parts = [torch.empty_like(big) for _ in range(world)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_gather(parts, big)
        torch.cuda.synchronize()
        out["all_gather_256MB_bf16_ms"].append(
            (time.perf_counter() - t0) * 1e3)
        del parts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(wide)
        torch.cuda.synchronize()
        out["all_reduce_512MB_f32_ms"].append(
            (time.perf_counter() - t0) * 1e3)
    dist.barrier()
    if rank == 0:
        for k, v in out.items():
            if isinstance(v, list):
                print(f"{k}: {', '.join(f'{x:.1f}' for x in v)}", flush=True)
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
