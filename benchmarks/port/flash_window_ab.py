#!/usr/bin/env python3
"""K6 (`kernels/csrc/flash_attention.cu`) and K6b
(`kernels/csrc/flash_attention_bwd.cu`) of this tree against a parent's
built from its source, on one card: the A/B of a change to the flash
forward or backward that must leave the launches it does not touch as
they were.

    # the parent's source unpacked in a directory .gitignore lists:
    #   git archive <parent> src | tar -x -C build/ab/parent
    python3 benchmarks/port/flash_window_ab.py --parent build/ab/parent/src \
        [--kernels fwd,bwd]

The parent's source is compiled with this tree's nvcc flags into
`build/ab/` and bound through its entries' interface since the sliding
window: K6's (q, k, v, o, lse, B, H, G, Sq, Skv, D, causal, window,
scale, 12 strides, stream), K6b's (q, k, v, o, dO, lse, the scratch, dq,
dk, dv, B, H, G, Sq, Skv, D, causal, window, scale, 24 strides, stream);
this tree's kernels run through `ops.flash_attention` and
`ops.flash_attention_bwd`, each case on the variant it names (K6b's
recurrentgemma-2b case on `simt`, which takes bf16 at D 256 by name
since `wgmma` took it over by the rule). On the same inputs (seeded,
model layout), for each case and each of causal and non-causal, window
0 and, for K6b, recurrentgemma-2b's window of 2048: the two outputs
(K6b: dq, dk and dv, from this tree's K6 out and lse) bit-equal. At the
long bf16 cases (K6: qwen2-0.5b's, deepseek-moe-16b's,
pixtral-12b's and recurrentgemma-2b's prefill shapes; K6b: the train
steps' shapes, qwen2-0.5b's and the ftrain runs' moe, vlm and hybrid
ones) the causal launch's device us by CUDA events with L2 flushed
before each call (a 128 MB write), interleaved parent, change, change,
parent; at recurrentgemma's shape also the change with its window of
2048 (K6b: with this tree's rule's variant, and the parent's `simt` with
the window, interleaved). With `--sass`, each parent kernel's machine
code (`cuobjdump -sass` of the two libraries) against the change's
kernel of the same name, or its instantiation without the window (`<D,
false>`), the constant-bank operands (the kernel parameters' offsets)
and the instructions' addresses left out: equal streams mean a launch
runs the parent's instructions. Prints a line a case, then one JSON line
with every reading and the card's name and power limit. Imports neither
jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
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
# K6b: (q shape, kv shape, dtype, variant, timed)
BWD_CASES = [((4, 4096, 14, 64), (4, 4096, 2, 64), "bfloat16", "wgmma", True),
             ((1, 4096, 16, 128), (1, 4096, 16, 128), "bfloat16", "wgmma",
              True),
             ((1, 4352, 32, 128), (1, 4352, 8, 128), "bfloat16", "wgmma",
              True),
             ((1, 4096, 10, 256), (1, 4096, 1, 256), "bfloat16", "simt",
              True),
             ((1, 1000, 16, 256), (1, 1500, 16, 256), "float32", "simt",
              False),
             ((1, 777, 6, 64), (1, 777, 2, 64), "bfloat16", "wgmma", False)]
WINDOW = 2048      # recurrentgemma-2b's
TIMED_CALLS = 30
BWD_TIMED_CALLS = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the parent tree's src directory")
    ap.add_argument("--kernels", default="fwd,bwd",
                    help="fwd (K6), bwd (K6b) or both")
    ap.add_argument("--sass", action="store_true",
                    help="also compare the parent's kernels' machine code "
                         "with the change's without the window")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        raise SystemExit("flash_window_ab: needs a CUDA card")
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    P, I = ctypes.c_void_p, ctypes.c_int

    def parent_lib(name, entries, n_ptr, n_int):
        lib_path = out_dir / f"lib{name}_parent.so"
        src = Path(args.parent) / "repro_torch" / "kernels" / "csrc" / \
            f"{name}.cu"
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = [P] * n_ptr + [I] * n_int + [
                ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), P]
            fn.restype = I
        return lib

    dev = torch.device("cuda")
    flush_buf = torch.empty(128 * 2 ** 20 // 4, device=dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card}
    libs = {}
    if "fwd" in kernels:
        lib = libs["flash_attention"] = parent_lib("flash_attention", (
            "flash_attention_wgmma_bf16", "flash_attention_mma_bf16",
            "flash_attention_f32"), 5, 8)
        out["cases"] = forward_ab(torch, ops, lib, flush_buf)
    if "bwd" in kernels:
        lib = libs["flash_attention_bwd"] = parent_lib(
            "flash_attention_bwd", (
            "flash_attention_bwd_wgmma_bf16", "flash_attention_bwd_simt_bf16",
            "flash_attention_bwd_simt_f32"), 10, 8)
        out["bwd_cases"] = backward_ab(torch, ops, lib, flush_buf)
    out["all_bits_equal"] = all(
        v for r in out.get("cases", []) + out.get("bwd_cases", [])
        for key, v in r.items() if key.startswith("bits_equal"))
    if args.sass:
        out["sass"] = {name: sass_ab(out_dir / f"lib{name}_parent.so",
                                     build.load(name)._name)
                       for name in libs}
        print(json.dumps({"sass": out["sass"]}), flush=True)
    print(json.dumps(out), flush=True)
    return out


def _sass(lib_path) -> dict:
    """{kernel: [instruction, ...]} of a library's `cuobjdump -sass`, the
    kernel named by its demangled base name and template arguments, each
    instruction without its address and encoding, every constant-bank
    operand as c[param]."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            demangled = subprocess.run(
                ["c++filt", m.group(1)], capture_output=True,
                text=True).stdout.strip()
            # the anonymous namespace's name differs between the files
            name = re.sub(r"\(anonymous namespace\)::", "", demangled)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            out[name].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[param]",
                                    m.group(1)))
    return out


def sass_ab(parent_path, change_path) -> dict:
    """Each parent kernel against the change's instantiation without the
    window: {parent kernel: {"change": name, "instructions": (n parent, n
    change), "equal": bool}}; a kernel the change does not template on a
    window is matched by name."""
    parent, change = _sass(parent_path), _sass(change_path)
    out = {}
    for name, code in parent.items():
        base = re.sub(r"\(.*$", "", name)
        twin = name if name in change else None
        if twin is None and base.endswith(">"):
            want = base[:-1] + ", false>"
            twin = next((n for n in change
                         if re.sub(r"\(.*$", "", n) == want), None)
        mine = change.get(twin, [])
        out[base] = {"change": twin and re.sub(r"\(.*$", "", twin),
                     "instructions": (len(code), len(mine)),
                     "equal": code == mine}
    return out


def cold_us(torch, fn, flush_buf, calls=TIMED_CALLS) -> float:
    """Mean device us of fn by CUDA events, L2 flushed before each call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls):
        flush_buf.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / calls * 1e3


def forward_ab(torch, ops, lib, flush_buf) -> list:
    """K6 of the parent (`lib`) against this tree's, case by case."""
    dev = flush_buf.device

    def parent(q, k, v, causal, variant):
        o = torch.empty_like(q)
        B, Sq, H, D = q.shape
        Skv, Kv = k.shape[1], k.shape[2]
        st = ops.flash_strides(q, k, v, o)
        fn = getattr(lib, "flash_attention_f32" if variant == "f32" else
                     f"flash_attention_{variant}_bf16")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None, B, H, H // Kv, Sq, Skv, D, int(causal), 0,
                 float(D ** -0.5), (ctypes.c_longlong * 12)(*st),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o

    def cold(fn):
        return cold_us(torch, fn, flush_buf)

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
                    cold(theirs if side == "parent" else mine))
            if variant == "mma":
                row["window_us"] = [cold(lambda: ops.flash_attention(
                    q, k, v, window=WINDOW)) for _ in range(2)]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def backward_ab(torch, ops, lib, flush_buf) -> list:
    """K6b of the parent (`lib`) against this tree's, case by case, from
    this tree's K6 out and lse."""
    dev = flush_buf.device

    def parent(q, k, v, out, lse, do, causal, variant, window=0):
        B, Sq, H, D = q.shape
        Skv, Kv = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        st = ops.flash_strides(q, k, v, out) + \
            ops.flash_strides(do, dq, dk, dv)
        delta = torch.empty((B, H, Sq) if variant == "simt" else
                            (2, B, H, -(-Sq // 64) * 64),
                            dtype=torch.float32, device=dev)
        fn = getattr(lib, f"flash_attention_bwd_{variant}_"
                          f"{'f32' if q.dtype == torch.float32 else 'bf16'}")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, H // Kv,
                 Sq, Skv, D, int(causal), window if window < Sq else 0,
                 float(D ** -0.5),
                 (ctypes.c_longlong * 24)(*st),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return dq, dk, dv

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for q_shape, kv_shape, dtype, variant, timed in BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                   for s in (q_shape, kv_shape, kv_shape))
        do = torch.randn(q_shape, generator=gen, device=dev).to(dt)
        row = {"kernel": "K6b", "q": q_shape, "kv": kv_shape,
               "dtype": dtype, "variant": variant}
        for causal in (True, False):
            out, lse = ops._flash_forward(q, k, v, causal, None, None, True)
            a = parent(q, k, v, out, lse, do, causal, variant)
            b = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, variant=variant)
            torch.cuda.synchronize()
            row[f"bits_equal_{'causal' if causal else 'non_causal'}"] = \
                all(torch.equal(x, y) for x, y in zip(a, b))
            del a, b
            wout, wlse = ops._flash_forward(q, k, v, causal, None, None,
                                            True, WINDOW)
            a = parent(q, k, v, wout, wlse, do, causal, variant, WINDOW)
            b = ops.flash_attention_bwd(q, k, v, wout, wlse, do,
                                        causal=causal, variant=variant,
                                        window=WINDOW)
            torch.cuda.synchronize()
            row[f"bits_equal_{'causal' if causal else 'non_causal'}"
                f"_window"] = all(torch.equal(x, y) for x, y in zip(a, b))
            del a, b, wout, wlse
        if timed:
            out, lse = ops._flash_forward(q, k, v, True, None, None, True)

            def mine():
                return ops.flash_attention_bwd(q, k, v, out, lse, do,
                                               variant=variant)

            def theirs():
                return parent(q, k, v, out, lse, do, True, variant)

            row["causal_us"] = {"parent": [], "change": []}
            for side in ("parent", "change", "change", "parent"):
                row["causal_us"][side].append(cold_us(
                    torch, theirs if side == "parent" else mine, flush_buf,
                    BWD_TIMED_CALLS))
            if variant == "simt" and dtype == "bfloat16":
                # the train step's launch: the rule's variant with the
                # window, against the parent's (simt) with it
                wout, wlse = ops._flash_forward(q, k, v, True, None, None,
                                                True, WINDOW)
                row["window_variant"] = ops.flash_bwd_variant(dt, q.shape[-1])
                row["window_us"] = {"parent": [], "change": []}
                for side in ("parent", "change", "change", "parent"):
                    row["window_us"][side].append(cold_us(
                        torch, (lambda: parent(q, k, v, wout, wlse, do, True,
                                               "simt", WINDOW))
                        if side == "parent" else
                        (lambda: ops.flash_attention_bwd(
                            q, k, v, wout, wlse, do, window=WINDOW)),
                        flush_buf, BWD_TIMED_CALLS))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
