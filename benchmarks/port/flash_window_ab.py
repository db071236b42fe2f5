#!/usr/bin/env python3
"""K6 (`kernels/csrc/flash_attention.cu`) of this tree against a parent's
built from its source, on one card: the A/B of a change to the flash
forward that must leave the causal launch as it was.

    # the parent's source unpacked in a directory .gitignore lists:
    #   git archive <parent> src | tar -x -C build/ab/parent
    python3 benchmarks/port/flash_window_ab.py --parent build/ab/parent/src

The parent's `flash_attention.cu` is compiled with this tree's nvcc flags
into `build/ab/` and bound through its entries' interface before the
sliding window (q, k, v, o, lse, B, H, G, Sq, Skv, D, causal, scale, 12
strides, stream); this tree's kernel runs through `ops.flash_attention`.
On the same inputs (seeded, model layout), for each case and each of
causal and non-causal, window 0: the two outputs bit-equal. At the
4096-long bf16 cases (qwen2-0.5b's, deepseek-moe-16b's, pixtral-12b's
and recurrentgemma-2b's prefill shapes) the causal launch's device us by
CUDA events with L2 flushed before each call (a 128 MB write),
interleaved parent, change, change, parent; at recurrentgemma's shape
also the change with its window of 2048. Prints a line a case, then one
JSON line with every reading and the card's name and power limit.
Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (q shape, kv shape, dtype, variant, timed)
CASES = [((4, 4096, 14, 64), (4, 4096, 2, 64), "bfloat16", "wgmma", True),
         ((4, 4096, 16, 128), (4, 4096, 16, 128), "bfloat16", "wgmma", True),
         ((4, 4352, 32, 128), (4, 4352, 8, 128), "bfloat16", "wgmma", True),
         ((4, 4096, 10, 256), (4, 4096, 1, 256), "bfloat16", "mma", True),
         ((1, 1000, 16, 256), (1, 1500, 16, 256), "float32", "f32", False),
         ((1, 2048, 14, 64), (1, 2048, 2, 64), "float32", "f32", False),
         ((1, 777, 6, 64), (1, 777, 2, 64), "bfloat16", "mma", False)]
WINDOW = 2048      # recurrentgemma-2b's
TIMED_CALLS = 30


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the parent tree's src directory")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        raise SystemExit("flash_window_ab: needs a CUDA card")
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libflash_attention_parent.so"
    src = Path(args.parent) / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention.cu"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("flash_attention_wgmma_bf16", "flash_attention_mma_bf16",
                 "flash_attention_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [P] * 5 + [I] * 7 + [ctypes.c_float,
                                           ctypes.POINTER(ctypes.c_longlong),
                                           P]
        fn.restype = I
    dev = torch.device("cuda")
    flush_buf = torch.empty(128 * 2 ** 20 // 4, device=dev)

    def parent(q, k, v, causal, variant):
        o = torch.empty_like(q)
        B, Sq, H, D = q.shape
        Skv, Kv = k.shape[1], k.shape[2]
        st = ops.flash_strides(q, k, v, o)
        fn = getattr(lib, "flash_attention_f32" if variant == "f32" else
                     f"flash_attention_{variant}_bf16")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None, B, H, H // Kv, Sq, Skv, D, int(causal),
                 float(D ** -0.5), (ctypes.c_longlong * 12)(*st),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o

    def cold_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(TIMED_CALLS):
            flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / TIMED_CALLS * 1e3

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for q_shape, kv_shape, dtype, variant, timed in CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                   for s in (q_shape, kv_shape, kv_shape))
        row = {"q": q_shape, "kv": kv_shape, "dtype": dtype,
               "variant": variant}
        for causal in (True, False):
            a = parent(q, k, v, causal, variant)
            b = ops.flash_attention(q, k, v, causal=causal, variant=variant)
            torch.cuda.synchronize()
            row[f"bits_equal_{'causal' if causal else 'non_causal'}"] = \
                torch.equal(a, b)
        if timed:
            def mine():
                return ops.flash_attention(q, k, v, variant=variant)

            def theirs():
                return parent(q, k, v, True, variant)

            row["causal_us"] = {"parent": [], "change": []}
            for side in ("parent", "change", "change", "parent"):
                row["causal_us"][side].append(
                    cold_us(theirs if side == "parent" else mine))
            if variant == "mma":
                row["window_us"] = [cold_us(lambda: ops.flash_attention(
                    q, k, v, window=WINDOW)) for _ in range(2)]
        print(json.dumps(row), flush=True)
        rows.append(row)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "cases": rows,
           "all_bits_equal": all(v for r in rows for key, v in r.items()
                                 if key.startswith("bits_equal"))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
