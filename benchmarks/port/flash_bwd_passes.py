#!/usr/bin/env python3
"""Where K6b's time goes at head dim 256: the device time of each of its
launches (the dQ pass, the dK/dV pass and, when the dK/dV pass is split,
the sum of its splits) by kernel name from `torch.profiler`, over calls
back to back, at recurrentgemma-2b's train shape (B 1 x 10 query heads
over 1, S 4096, window 2048) and gemma-7b's (B 1 x 16 over 16, S 4096,
causal), bf16, with the splits the rule picks, each pass's TFLOP/s of the
products it runs (the dQ pass S, dP and dS K; the dK/dV pass S^T, dP^T,
P^T dO and dS^T Q, on the band's pairs), and SDPA's backward on the same
inputs (the band as a boolean mask) by CUDA events, as a yardstick.

    python3 benchmarks/port/flash_bwd_passes.py [--calls 5]

Prints a line a shape, then one JSON line with every reading and the
card's name and power limit. Needs a CUDA card; imports neither jax nor
the JAX package.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parents[1] / "src"))
sys.path.insert(0, str(ROOT))

# (label, q shape, kv shape, window)
SHAPES = [("recurrentgemma-2b", (1, 4096, 10, 256), (1, 4096, 1, 256), 2048),
          ("gemma-7b", (1, 4096, 16, 256), (1, 4096, 16, 256), 0)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    import work

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_passes: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card, "shapes": []}
    for label, q_shape, kv_shape, window in SHAPES:
        q, k, v, do = (torch.randn(s, generator=gen, device=dev)
                       .to(torch.bfloat16)
                       for s in (q_shape, kv_shape, kv_shape, q_shape))
        o, lse = ops._flash_forward(q, k, v, True, None, None, True, window)

        def kernel():
            return ops.flash_attention_bwd(q, k, v, o, lse, do,
                                           window=window)

        kernel()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                kernel()
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            m = re.search(r"wgb::(\w+)", e.key)
            if m and e.device_time_total > 0:
                passes[m.group(1)] = e.device_time_total / e.count
        B, S, H, D = q_shape
        pairs = work.attention_pairs(S, S, True, window) * B * H
        flop = {"bwd_dq_d256_kernel": 3 * 2 * D * pairs,
                "bwd_dkdv_d256_kernel": 4 * 2 * D * pairs}
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if window:
            i = torch.arange(S, device=dev)
            band = (i[:, None] >= i[None, :]) & \
                (i[:, None] - i[None, :] < window)
            ot = sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
        else:
            ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(args.calls):
            torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        end.record()
        torch.cuda.synchronize()
        row = {"shape": label, "q": q_shape, "kv": kv_shape,
               "window": window,
               "splits": ops.flash_bwd_splits(
                   "wgmma", B, kv_shape[2], S, S, H // kv_shape[2], D, True,
                   window, ops._sm_count(dev)),
               "pass_us": passes,
               "pass_tflops": {name: flop[name] / (us * 1e-6) / 1e12
                               for name, us in passes.items()
                               if name in flop},
               "total_us": sum(passes.values()),
               "sdpa_us": start.elapsed_time(end) / args.calls * 1e3}
        print(json.dumps(row), flush=True)
        out["shapes"].append(row)
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
