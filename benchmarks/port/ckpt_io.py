#!/usr/bin/env python3
"""What a train checkpoint costs to write and to read back: qwen2-0.5b at
its published width on the card (bf16 parameters, float32 AdamW moments:
4.9 GB in the reference's layout), saved and restored through
`launch.train.TrainCheckpoints` (the port's writer and reader,
`fault.checkpoint._write_npz` / `_read_member`), then the same leaves
through numpy's `np.savez` (after a pageable copy of each to the host)
and `np.load`, and the fsync of each file, interleaved over `--rounds`.

    python3 benchmarks/port/ckpt_io.py [--rounds 2] [--dir build/ckpt_io]

Prints a line a reading, then one JSON line with every reading and the
card's name and power limit. The reads come from the page cache (the file
was just written): warm. Needs a CUDA card; imports neither jax nor the
JAX package. Removes its files.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dir", default=str(ROOT / "build" / "ckpt_io"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.fault import checkpoint as ck
    from repro_torch.launch.train import TrainCheckpoints
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config("qwen2-0.5b")
    model = Model(cfg, "cuda")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = (params, adamw_init(params, AdamWConfig()))
    shutil.rmtree(args.dir, ignore_errors=True)
    store = TrainCheckpoints(args.dir, cfg)
    named = [(f"{i:05d}§{n}", leaf) for i, (n, leaf) in
             enumerate(ck.flatten_with_names(store._nested(state)))]
    nbytes = sum(leaf.numel() * leaf.element_size() for _, leaf in named)
    out = {"bytes": nbytes, "port_save_s": [], "port_restore_s": [],
           "savez_s": [], "savez_fsync_s": [], "np_load_s": []}
    torch.cuda.synchronize()
    for r in range(args.rounds):
        t0 = time.perf_counter()
        store.save(r + 1, state)
        out["port_save_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        store.restore(state)
        torch.cuda.synchronize()
        out["port_restore_s"].append(time.perf_counter() - t0)
        path = os.path.join(args.dir, "savez.npz")
        t0 = time.perf_counter()
        np.savez(path, **{k: ck._to_host(leaf) for k, leaf in named})
        out["savez_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ck._fsync_file(path)
        out["savez_fsync_s"].append(time.perf_counter() - t0)
        likes = [leaf for _, leaf in named]
        t0 = time.perf_counter()
        with np.load(path) as d:
            for k, like in zip(d.files, likes):
                ck._from_host(d[k], like)
        torch.cuda.synchronize()
        out["np_load_s"].append(time.perf_counter() - t0)
        os.remove(path)
        for k, v in out.items():
            if isinstance(v, list):
                print(f"round {r}: {k} {v[-1]:.2f}", flush=True)
    shutil.rmtree(args.dir, ignore_errors=True)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
