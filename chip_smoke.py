#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # build + kernel check only
    python3 chip_smoke.py --phases serve     # build + the serving path
    python3 chip_smoke.py --phases lm        # build + the LM serving path

Phases:
  0. device   -- the card's name, count, power limit (nvidia-smi).
  1. build    -- nvcc builds the seven kernels from kernels/csrc
                 (sm_90a); always runs.
  2. kernels  -- K1 pcdn_bundle (the whole support step of a real-sim
                 bundle, from one carry cloned twice, and the same bundle
                 with the search forced past its first chunk and with
                 nothing passing), K2 pcdn_sparse_direction (with delta)
                 and K3 pcdn_direction (with the slab gather and delta, on
                 a full bundle and gisette's ragged last one) against
                 their plain PyTorch versions on the card, at the shapes
                 the solves below give them; K4a
                 serve_margins_dense, K4b serve_margins_csc and K5
                 pcdn_linesearch at the serve phase's shapes; K6
                 flash_attention at the lm phase's prefill shape and at
                 yi-6b's and gemma-7b's head widths, tails, non-causal and
                 float32, per query row, with planted faults as controls,
                 each check naming the variant that ran (wgmma, mma,
                 f32); errors, kernel, plain and library times (CUDA
                 events), the bound, K6's TFLOP/s and share of it, its
                 mma variant's time at the prefill shape and the host time
                 of its tensor-map encodes.
  3. support  -- real-sim at its published shape (57,848 x 20,958, ~139 nnz
                 a column, k_max 278) in padded-CSC, P = 32: the support
                 scope, so every bundle is one K1 launch (the traced
                 iteration must show no other device op a bundle).
  4. full     -- the same data at P = 512: the full scope, K2.
  5. dense    -- gisette at its published shape (6,000 x 5,000, dense and
                 correlated), P = 512: K3 (the traced iteration must show
                 it once a bundle, and no slab gather or matrix-vector
                 product a bundle).
  6. cli      -- `repro_torch.launch.solve.main` on a9a, padded-CSC,
                 --use-kernels, through the normal entry point.
  7. serve    -- real-sim at its published width (72,310 x 20,958, the
                 first 57,848 rows train, the other 14,462 are requests):
                 an 8-point regularization path solved on the card and
                 saved with `save_model`, then `repro_torch.launch.
                 predict.main` through K4a (dense requests) and K4b
                 (padded-CSC requests), for the c* model and the path
                 family, `--serve` with a mid-stream hot-swap, and one
                 dense chunk traced in a child process (`--chunk-profile`).
  8. lm       -- `repro_torch.launch.serve.main` for qwen2-0.5b at full
                 width (24 layers, bf16, random weights from a seed): a
                 4096-token prefill of 4 prompts, which runs K6 once a
                 layer, then 32 greedy tokens; the same at 32 tokens (the
                 dense route: no K6). Then the prefill's logits and four
                 decode steps through K6 against its plain version, from
                 the same weights, in bf16 (three seeds) and in float32,
                 with the readings of faults planted in the plain version
                 beside them, and one prefill and one decode step traced
                 in a child process (`--lm-profile`).

Each solve phase sets the launch counts to 0, solves with the kernels,
reads the counts, then solves again with the plain versions from the same
generator seed (the same partitions) and prints how far the two objectives
drift apart. The gate on agreement is the lockstep check that follows: for
every one of the phase's outer iterations, a kernel iteration and a plain
iteration from one shared carry and one partition must agree on F.
Nothing is caught: a failed phase exits
non-zero. With no card, or without the repository's `src/repro_torch`
beside this file, the script exits 1 before printing any result. The last
line is {"ok": true, "device": {...}}; the line before it the card's name
and power limit, and before that one JSON line of per-kernel numbers.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"
PHASES = ("build", "kernels", "support", "full", "dense", "cli",
          "serve", "lm")  # in order

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12   # dense, tensor cores

# solve-phase tolerance: kernel vs plain objective after one outer
# iteration from a shared carry (f32 sums in another order, atomics in K1)
F_RTOL = 1e-4
# kernel-phase tolerance on d/g/h/delta and K1's w and z: max |kernel -
# plain| over max |plain| (f32 reductions in another order; K1's and K2's
# atomic scatters; K4b's shared-memory atomics; K5's block partials)
KERNEL_RTOL = 1e-4
# K4a sums in a fixed order with no atomics: held closer
K4A_RTOL = 1e-5
# outer iterations of each solve phase (and of its lockstep check), and
# the seed of every dataset
N_OUTER = 10
DATA_SEED = 0
# the solve phases: (design, labels) at these places of make_data's tuple,
# c, layout, P, the kernel they launch, the line-search scope
SOLVES = {"support": (0, 1, 4.0, "padded_csc", 32, "pcdn_bundle", "support"),
          "full": (0, 1, 4.0, "padded_csc", 512, "pcdn_sparse_direction",
                   "full"),
          "dense": (2, 3, 0.25, "dense", 512, "pcdn_direction", "full")}
# objective non-increase, up to f32 rounding of the 57,848-term loss sum
F_MONOTONE_RTOL = 1e-6

SOURCES = {
    "pcdn_bundle": ("src/repro_torch/kernels/csrc/pcdn_bundle.cu",
                    "src/repro/kernels/pcdn_bundle.py:144"),
    "pcdn_sparse_direction": (
        "src/repro_torch/kernels/csrc/pcdn_sparse_direction.cu",
        "src/repro/kernels/pcdn_sparse_direction.py:85"),
    "pcdn_direction": ("src/repro_torch/kernels/csrc/pcdn_direction.cu",
                       "src/repro/kernels/pcdn_direction.py:68"),
    "serve_margins_dense": (
        "src/repro_torch/kernels/csrc/serve_margins_dense.cu",
        "src/repro/kernels/pcdn_margin.py:74"),
    "serve_margins_csc": (
        "src/repro_torch/kernels/csrc/serve_margins_csc.cu",
        "src/repro/kernels/pcdn_margin.py:121"),
    "pcdn_linesearch": ("src/repro_torch/kernels/csrc/pcdn_linesearch.cu",
                        "src/repro/kernels/pcdn_linesearch.py:62"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
}

# the serve phase: real-sim at its published width, with the published
# s rows for training and a fifth more as requests (the paper's split)
SERVE_ROWS = 72_310
SERVE_TRAIN = 57_848
SERVE_FEATURES = 20_958
SERVE_NNZ_PER_COL = 278
# planted support of the labels' model: at the generator's default of 2%
# a request row meets ~0.8 planted features and even the planted w scores
# 0.513 on the request rows; at 20% it scores 0.584 (numpy, from the seed)
SERVE_W_NNZ_FRAC = 0.2
SERVE_C_STAR = 4.0
SERVE_GRID = 8            # path points, c* downward by SERVE_GRID_RATIO
SERVE_GRID_RATIO = 0.5 ** 0.5
SERVE_OUTER = 5           # outer iterations per path point
SERVE_P = 512
SERVE_MAX_BATCH = 256
# --serve traffic (one H100; picked from the first runs, see PERF.md: at
# 4000 rps the open-loop generator fell 210-311 ms behind its schedule,
# so the latencies measured its bursts; at 2000 rps it kept up apart from
# an occasional single stall, whose cause is still open)
SERVE_RATE = 2000.0
SERVE_REQUESTS = 4000
SERVE_SLO_MS = 50.0

# the lm phase: qwen2-0.5b at its published width, 4 prompts of 4096
# tokens (BLOCKWISE_MIN_KV = 2048 or more: K6 in every layer) and 32 new
# tokens; 32-token prompts take the dense route
LM_ARCH = "qwen2-0.5b"
LM_BATCH = 4
LM_PROMPT = 4096
LM_SHORT_PROMPT = 32
LM_NEW = 32
LM_DECODE_CHECK = 4       # decode steps held kernel route vs plain route
LM_SEED = 0
LM_GATE_SEEDS = (0, 1, 2)  # bf16 weights and prompts the LM gate reads
# K6 against its plain version on the same inputs: the largest over query
# rows of the row's max abs error over its max |plain| (a row's size falls
# with the keys it averages). bf16: inputs and output in bf16, K6 casts p
# to bf16 before p v (as the Pallas kernel does), the plain version keeps
# it in float32; both round the output to bf16, so a sound kernel differs
# by an ulp (2^-7 of the value) where the two roundings fall apart
FLASH_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the prefill's last-position logits and the decode steps through K6
# against the plain route: max abs error over max |plain|. bf16: the 24
# bf16 layers carry K6's one-ulp differences to the logits; on an H100
# the kernel route read 1.45e-2 to 2.15e-2 over LM_GATE_SEEDS and the
# plain route with p in fp8 4.15e-2, a dropped KV tile 0.60 (PERF.md):
# the limit sits between
LM_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
# planted faults in the plain version, held by the gates above: one KV
# tile (keys 64-127) dropped, keys 8 j + 6 and 8 j + 7 left out of the
# softmax's normaliser (one lane of the quad that shares a row in K6's
# bf16 kernel), p rounded to fp8 e4m3 before p v (a precision control)
FLASH_FAULTS = ("tile", "quad", "fp8 p")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- timing ---------------------------------------------------------------

def host_ms(torch, fn, n: int) -> float:
    """Mean wall ms per call, n calls back to back then one synchronize,
    after 3 warm-up calls: what the host loop pays for the call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def enqueue_us(torch, fn, n: int) -> float:
    """Mean host us per call of n calls queued back to back, timed before
    the synchronize: what the wrapper costs the host, device time apart."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / n


def device_ms(torch, fn, n: int, flush=None) -> float:
    """Mean device ms per call from CUDA events around each call.

    A spin kernel holds the card while the host queues all n calls (it
    spins about twice the measured host time), so the events see device
    time only, not the host's launch gaps. With `flush`, a 128 MB write
    evicts L2 before every call (cold cache)."""
    per_call = host_ms(torch, fn, 3)
    if flush is not None:
        per_call += host_ms(torch, flush, 3)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * per_call * n * 2e6))  # cycles, <= 2 GHz
    for i in range(n):
        if flush is not None:
            flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / n


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float(torch.max(torch.abs(got.float() - want.float())))
    scale = float(torch.max(torch.abs(want.float())))
    return err, err / max(scale, 1e-30)


def row_rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, the largest over rows (all dims but the last) of
    the row's max abs error over its max |want|)."""
    err = torch.abs(got.float() - want.float()).amax(dim=-1)
    scale = torch.abs(want.float()).amax(dim=-1).clamp_min(1e-30)
    return float(err.max()), float((err / scale).max())


# -- data -----------------------------------------------------------------

def make_data(seed: int):
    from repro_torch.data import make_sparse_classification, paper_like
    t0 = time.perf_counter()
    csc, y_rs, _ = make_sparse_classification(57_848, 20_958,
                                              nnz_per_col=278, seed=seed)
    Xg, y_g, spec_g = paper_like("gisette", scale=1.0, seed=seed)
    log(f"[data] real-sim s={csc.shape[0]} n={csc.shape[1]} "
        f"k_max={csc.k_max} nnz={csc.nnz} "
        f"sparsity={1 - csc.nnz / (csc.shape[0] * csc.shape[1]):.5f}; "
        f"gisette {Xg.shape}; {time.perf_counter() - t0:.1f}s")
    return csc, y_rs, Xg, y_g, spec_g


# -- phases ---------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f}s (parallel nvcc)")
    for lib in built.values():
        log(f"[build] {lib.name}: {lib.seconds:.1f}s -> {lib.path.name}")
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"[ptxas] {line.strip()}")


def timings(torch, kernel, plain, flush) -> dict:
    """Device times (L2-cold, L2-warm) and host time per call of a kernel
    wrapper and of its plain version."""
    return dict(ms=device_ms(torch, kernel, 100, flush),
                warm_ms=device_ms(torch, kernel, 100),
                host_ms=host_ms(torch, kernel, 200),
                plain_ms=device_ms(torch, plain, 10, flush),
                plain_host_ms=host_ms(torch, plain, 50))


def phase_kernels(torch, data, serve, card: str) -> dict:
    """Each kernel against its plain version: K1-K3 at the solves' shapes,
    K4a/K4b/K5 at the serve phase's."""
    from repro_torch.core import bundles as B
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    csc, y_rs, Xg, y_g, _ = data
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(1)
    flush_buf = torch.empty((128 * 1024 * 1024 // 4,), device=dev)

    def flush():
        flush_buf.zero_()

    out = {}
    # a realistic iterate: sparse w, its margins
    sparse = make_problem(csc, y_rs, c=4.0, layout="padded_csc", device=dev)
    n = sparse.n_features
    w = torch.zeros((n,), device=dev)
    on = torch.randperm(n, generator=gen)[: n // 10].to(dev)
    w[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(dev)
    z = sparse.margins(w)

    # K1 at P = 32 (support scope): the whole step of one real-sim bundle,
    # from one carry cloned for the kernel and for its plain version; then
    # the same bundle with the search forced past its first chunk (sigma
    # 0.99 asks for nearly all of the predicted decrease) and with nothing
    # passing (sigma 1e6)
    design = sparse.design
    s = sparse.n_samples
    idx = B.partition(gen, n, 32, device=dev)[0]
    alphas = candidate_alphas(ArmijoParams(), torch.float32, dev)
    P, K, Q = idx.shape[0], design.k_max, alphas.shape[0]
    live = idx[idx < n].long()
    rows = design.col_rows[live]
    touched = torch.unique(rows[rows < s])
    n_live = int(touched.numel())
    out_w = torch.ones(n, dtype=torch.bool, device=dev)
    out_w[live] = False
    out_z = torch.ones(s, dtype=torch.bool, device=dev)
    out_z[touched] = False
    errs = []
    for label, sigma in (("real-sim bundle", 0.01),
                         ("first chunk fails", 0.99),
                         ("nothing passes", 1e6)):
        launch = ops.BundleLaunch(design.col_rows, design.col_vals, sparse.y,
                                  alphas, 4.0, P, 1, sigma=sigma)
        w_k, z_k, w_p, z_p = w.clone(), z.clone(), w.clone(), z.clone()
        ops.pcdn_bundle(launch, w_k, z_k, idx, 0)
        q_p, a_p = ref.pcdn_bundle_step_ref(
            design.col_rows, design.col_vals, idx, z_p, sparse.y, w_p,
            alphas, 4.0, sigma=sigma)
        torch.cuda.synchronize()
        q_k, a_k = int(launch.n_steps[0]), float(launch.alpha[0])
        e_w = rel_err(torch, w_k, w_p)
        e_z = rel_err(torch, z_k, z_p)
        kept = torch.equal(w_k[out_w], w[out_w]) and \
            torch.equal(z_k[out_z], z[out_z])
        R = P * K
        reset = bool(torch.all(launch.workspace[:s + R] == -1)) and \
            bool(torch.all(launch.workspace[s + R:s + 2 * R] == 0))
        log(f"[kernels] pcdn_bundle {label}: P={P} K={K} s={s} R={P * K} "
            f"live rows {n_live} Q={Q} (cluster {launch.plan.cluster} x "
            f"{ops.BUNDLE_THREADS} threads, {launch.plan.nseg} warps a "
            f"column, chunk {ops.BUNDLE_CHUNK}): w err {e_w[0]:.3e} (rel "
            f"{e_w[1]:.2e}), z err {e_z[0]:.3e} (rel {e_z[1]:.2e}), alpha "
            f"{a_k} vs {a_p}, n_steps {q_k} vs {int(q_p)}; outside the "
            f"bundle bit-equal {kept}; slot map reset {reset}; tolerance rel "
            f"{KERNEL_RTOL}, alpha/n_steps equal")
        assert e_w[1] <= KERNEL_RTOL and e_z[1] <= KERNEL_RTOL, (e_w, e_z)
        assert a_k == float(a_p) and q_k == int(q_p), (a_k, a_p, q_k, q_p)
        assert kept and reset, (kept, reset)
        if label == "first chunk fails":
            assert q_k > ops.BUNDLE_CHUNK, q_k
        if label == "nothing passes":
            assert (q_k, a_k) == (1, 0.0), (q_k, a_k)
        errs += [e_w[0], e_z[0]]
    # timed as the support solve calls it: each call the next bundle of a
    # partition, in turn, from a carry the calls evolve (the timings below
    # take about one pass over the partition: about one outer iteration)
    bundles = B.partition(gen, n, P, device=dev).unbind(0)

    def stepper(fn):
        wc, zc, it = w.clone(), z.clone(), [0]

        def call():
            t = it[0] % len(bundles)
            it[0] += 1
            fn(wc, zc, bundles[t], t)
        return call

    def plain(wc, zc, idx_t, t):
        ref.pcdn_bundle_step_ref(design.col_rows, design.col_vals, idx_t, zc,
                                 sparse.y, wc, alphas, 4.0)

    launch = ops.BundleLaunch(design.col_rows, design.col_vals, sparse.y,
                              alphas, 4.0, P, len(bundles))
    k1 = stepper(lambda wc, zc, idx_t, t: ops.pcdn_bundle(
        launch, wc, zc, idx_t, t))
    top = device_ops(torch, k1)
    log(f"[kernels] pcdn_bundle, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    r = dict(max_abs_err=max(errs),
             **timings(torch, k1, stepper(plain), flush),
             enqueue_us=enqueue_us(torch, k1, 200), library_ms=None)
    # bytes: idx, each live column's rows and values, w_B read and
    # written, z/y read and z written at the live rows, the outputs;
    # operations: ~20 a slab entry (the loss factors, g, h), 12 a live
    # row for each candidate up to the accepted one; the mean over the
    # timed bundles, at the step counts their last calls accepted
    n_steps = launch.n_steps.tolist()
    nbytes = nops = 0.0
    timed = [(idx_t, q_t) for idx_t, q_t in zip(bundles, n_steps) if q_t]
    n_steps = [q_t for _, q_t in timed]
    for idx_t, q_t in timed:
        live_t = idx_t[idx_t < n].long()
        rows_t = design.col_rows[live_t]
        rows_live = int(torch.unique(rows_t[rows_t < s]).numel())
        nbytes += (P * 4 + int(live_t.numel()) * K *
                   (4 + design.col_vals.element_size()) +
                   8 * int(live_t.numel()) + 12 * rows_live + q_t * 4 + 8)
        nops += P * K * 20 + rows_live * q_t * 12
    r["bound"] = bound(nbytes / len(timed), nops / len(timed))
    log(f"[kernels] pcdn_bundle over the {len(timed)} timed bundles: mean "
        f"n_steps {sum(n_steps) / len(n_steps):.3f}, bound "
        f"{r['bound'][0] * 1e3:.4f} us ({r['bound'][1]})")
    out["pcdn_bundle"] = r

    # K2 at P = 512 (full scope): the loss factors and delta inside
    idx = B.partition(gen, n, 512, device=dev)[0]
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    args = (slab.rows, slab.vals, z, sparse.y, w_B, 4.0)
    got = ops.pcdn_sparse_direction(*args)
    want = ref.pcdn_sparse_direction_ref(*args)
    errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
    P, K = slab.rows.shape
    log(f"[kernels] pcdn_sparse_direction P={P} K={K} s={s} ("
        f"{ops.sparse_direction_warps(K)} warps a column): "
        + ", ".join(f"{nm} err {e[0]:.3e} (rel {e[1]:.2e})"
                    for nm, e in zip(("d", "g", "h", "delta"), errs))
        + f"; tolerance rel {KERNEL_RTOL}")
    assert all(e[1] <= KERNEL_RTOL for e in errs), errs
    valid = slab.rows < s
    n_rows = int(torch.unique(slab.rows[valid]).numel())
    top = device_ops(torch, lambda: ops.pcdn_sparse_direction(*args))
    log(f"[kernels] pcdn_sparse_direction, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    # bytes: the slab, z/y at its distinct rows, w_B, d/g/h and the (s,)
    # delta written; operations: ~24 a live entry (the loss factors, g, h,
    # the scatter)
    nbytes = P * K * 8 + n_rows * 8 + P * 4 + 3 * P * 4 + s * 4
    nops = 24 * int(valid.sum())
    out["pcdn_sparse_direction"] = dict(
        max_abs_err=max(e[0] for e in errs),
        **timings(torch, lambda: ops.pcdn_sparse_direction(*args),
                  lambda: ref.pcdn_sparse_direction_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.pcdn_sparse_direction(
            *args), 200),
        bound=bound(nbytes, nops), library_ms=None)

    # K3 at s = 6,000, P = 512 (dense layout), the slab gather, the loss
    # factors and delta inside: a full bundle and gisette's ragged last
    # one (392 live columns, 120 sentinels)
    dense = make_problem(Xg, y_g, c=0.25, layout="dense", device=dev)
    nd = dense.n_features
    wd = torch.zeros((nd,), device=dev)
    on = torch.randperm(nd, generator=gen)[: nd // 10].to(dev)
    wd[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(dev)
    zd = dense.margins(wd)
    XT = dense.design.feature_major()
    parts = B.partition(gen, nd, 512, device=dev)
    s = dense.n_samples
    max_clusters = ops.direction_max_clusters(XT.device)
    plan = ops.direction_plan(s, 512, XT.element_size(), max_clusters)
    errs = []
    for label, idx in (("full bundle", parts[0]),
                       ("ragged last bundle", parts[-1])):
        w_B, _ = B.gather_vec(wd, idx)
        args = (XT, idx, zd, dense.y, w_B, 0.25)
        got = ops.pcdn_direction(*args)
        want = ref.pcdn_direction_ref(*args)
        e = [rel_err(torch, a, b) for a, b in zip(got, want)]
        n_live = int((idx < nd).sum())
        sentinel_zero = not torch.any(got[0][idx >= nd])
        log(f"[kernels] pcdn_direction {label} s={s} P={idx.shape[0]} "
            f"(live {n_live}; plan: {plan.ctas} CTAs in {plan.clusters} "
            f"clusters of {ops.DIRECTION_CLUSTER}, the card holding "
            f"{max_clusters} at once, {plan.cc} columns a cluster, "
            f"{plan.sl} rows a CTA, resident {plan.resident}, "
            f"{plan.smem_bytes} B shared): "
            + ", ".join(f"{nm} err {x[0]:.3e} (rel {x[1]:.2e})"
                        for nm, x in zip(("d", "g", "h", "delta"), e))
            + f"; sentinel d = 0 {sentinel_zero}; tolerance rel "
              f"{KERNEL_RTOL}")
        assert all(x[1] <= KERNEL_RTOL for x in e), e
        assert sentinel_zero
        errs += [x[0] for x in e]
    idx = parts[0]
    w_B, _ = B.gather_vec(wd, idx)
    args = (XT, idx, zd, dense.y, w_B, 0.25)
    top = device_ops(torch, lambda: ops.pcdn_direction(*args))
    log(f"[kernels] pcdn_direction, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    assert sum(c for _, c, _ in top) <= 1, top
    # bytes: the bundle's live columns once, z and y, delta written, idx,
    # w_B, d/g/h; operations: ~7 a value (g, h, delta)
    P = idx.shape[0]
    n_live = int((idx < nd).sum())
    nbytes = n_live * s * XT.element_size() + 3 * s * 4 + 2 * P * 4 + \
        3 * P * 4
    out["pcdn_direction"] = dict(
        max_abs_err=max(errs),
        **timings(torch, lambda: ops.pcdn_direction(*args),
                  lambda: ref.pcdn_direction_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.pcdn_direction(*args),
                              200),
        bound=bound(nbytes, 7 * s * n_live), library_ms=None)
    out.update(serve_kernel_checks(torch, serve, flush))
    out.update(flash_kernel_checks(torch, flush))
    for name, r in out.items():
        enq = (f", the wrapper's enqueue {r['enqueue_us']:.2f} us"
               if "enqueue_us" in r else "")
        log(f"[kernels] {name}: device {r['ms'] * 1e3:.2f} us L2-cold, "
            f"{r['warm_ms'] * 1e3:.2f} us L2-warm; plain version device "
            f"{r['plain_ms'] * 1e3:.2f} us; host {r['host_ms'] * 1e3:.2f} us "
            f"a call (plain {r['plain_host_ms'] * 1e3:.2f} us){enq}; bound "
            f"{r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}); library "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.2f} us") + f" on {card}")
    return out


def prepare_serve(torch) -> dict:
    """The serve phase's data and models, from DATA_SEED: real-sim at its
    published width, split into the published training rows and request
    rows (written as .libsvm from their CSR rows: they are 1.2 GB dense);
    an 8-point geometric path from c* down, each point warm-started from
    the previous w, solved on the card through the kernels; and the
    artifacts `launch.predict` serves, written with `save_model` under
    build/ (listed in .gitignore)."""
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.data import (csr_to_padded_csc,
                                  make_sparse_classification,
                                  save_libsvm_csr)
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.serve import artifact as art

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    csc, y, _ = make_sparse_classification(
        SERVE_ROWS, SERVE_FEATURES, nnz_per_col=SERVE_NNZ_PER_COL,
        w_nnz_frac=SERVE_W_NNZ_FRAC, seed=DATA_SEED)
    csr = csc.to_csr()
    train = csr_to_padded_csc(csr.rows(0, SERVE_TRAIN))
    requests = csr.rows(SERVE_TRAIN, SERVE_ROWS)
    req_path = work / "requests.libsvm"
    save_libsvm_csr(str(req_path), requests, y[SERVE_TRAIN:])
    log(f"[serve] data: {SERVE_ROWS} x {SERVE_FEATURES}, nnz {csr.nnz}; "
        f"train {SERVE_TRAIN} rows (k_max {train.k_max}), requests "
        f"{requests.shape[0]} rows (nnz {requests.nnz}, max column nnz "
        f"{requests.max_col_nnz()}) -> {req_path.name}; "
        f"{time.perf_counter() - t0:.1f}s")

    prob = make_problem(train, y[:SERVE_TRAIN], c=SERVE_C_STAR,
                        layout="padded_csc", device=DEVICE)
    backend = LocalBackend(prob, PCDNConfig(
        P=SERVE_P, use_kernels=True, tol_kkt=0.0, max_outer=SERVE_OUTER,
        seed=0))
    cs = [SERVE_C_STAR * SERVE_GRID_RATIO ** i for i in range(SERVE_GRID)]
    ws, metas = [], []
    w = None
    t0 = time.perf_counter()
    for c in cs:
        res = engine_loop.solve(backend, c, w, max_outer=SERVE_OUTER,
                                tol_kkt=0.0)
        w = backend.host_weights(res.w)
        assert np.isfinite(res.objective), res.objective
        ws.append(w)
        metas.append({"objective": float(res.objective),
                      "kkt": float(res.history.kkt[-1]),
                      "n_outer": int(res.n_outer),
                      "nnz": int(np.count_nonzero(w))})
        log(f"[serve] path c={c:g}: F={res.objective:.6f} kkt="
            f"{metas[-1]['kkt']:.3e} nnz={metas[-1]['nnz']}")
    torch.cuda.synchronize()
    log(f"[serve] path of {SERVE_GRID} points x {SERVE_OUTER} outer "
        f"iterations at P={SERVE_P}, warm-started: "
        f"{time.perf_counter() - t0:.1f}s")
    order = np.argsort(cs)        # an artifact path family: ascending c
    prov = art.solver_provenance(solver="pcdn", dataset="real-sim profile",
                                 P=SERVE_P, seed=0, package="repro_torch")
    family = art.path_family(np.stack([ws[i] for i in order]),
                             [cs[i] for i in order], "logistic",
                             metas=[metas[i] for i in order],
                             provenance=prov)
    paths = {"family": work / "family.json", "star": work / "star.json",
             "swap": work / "swap.json"}
    art.save_model(str(paths["family"]), family)
    # the c* model alone, and the next grid point as the hot-swap target
    for key, i in (("star", 0), ("swap", 1)):
        art.save_model(str(paths[key]), art.ModelFamily(
            kind="binary", provenance=prov,
            models=(art.artifact_from_solution(ws[i], "logistic", cs[i],
                                               meta=metas[i]),)))
    return {"family": family, "paths": paths, "requests": requests,
            "requests_path": req_path, "problem": prob,
            "w_star": ws[0], "w_next": ws[1]}


def serve_kernel_checks(torch, serve, flush) -> dict:
    """K4a, K4b at the serve phase's shapes (one full bucket of requests,
    the K = 8 path family's bank) and K5 at the training set's (the
    margins of the c* model and their change to the next path point)."""
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.data import csr_to_padded_csc
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.predict import ModelBank

    out = {}
    bank = ModelBank.from_family(serve["family"], device=DEVICE)
    req = serve["requests"]
    B = SERVE_MAX_BATCH
    head = req.rows(0, B)
    n = bank.n_features
    K, A = bank.idx.shape
    live = bank.idx < n
    live_idx = bank.idx[live].long()
    U = int(torch.unique(live_idx).numel())
    W = bank.dense_matrix()

    # K4a: (B, n) dense requests
    X = torch.as_tensor(head.to_dense(), device=DEVICE)
    args = (X, bank.idx, bank.val)
    got = ops.serve_margins_dense(*args)
    want = ref.serve_margins_dense_ref(*args)
    again = ops.serve_margins_dense(*args)
    lib = torch.matmul(X, W.T)
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    e_lib = rel_err(torch, lib, want)
    width = ops.dense_tile_width(B, n, K, ops._sm_count(X.device))
    log(f"[kernels] serve_margins_dense B={B} n={n} K={K} A={A} U={U}: "
        f"err {e[0]:.3e} (rel {e[1]:.2e}), tolerance rel {K4A_RTOL}; "
        f"two calls bit-equal {torch.equal(got, again)}; one variant, "
        f"column tiles of {width} ({-(-n // width)} tiles x "
        f"{-(-B // 32)} row tiles); library matmul vs plain rel "
        f"{e_lib[1]:.2e}")
    assert e[1] <= K4A_RTOL, e
    assert torch.equal(got, again)
    out["serve_margins_dense"] = dict(
        max_abs_err=e[0],
        **timings(torch, lambda: ops.serve_margins_dense(*args),
                  lambda: ref.serve_margins_dense_ref(*args), flush),
        # the union's columns of X once, idx/val, the output
        bound=bound(B * U * 4 + K * A * 8 + B * K * 4,
                    2 * B * int(live.sum())),
        library_ms=device_ms(torch, lambda: torch.matmul(X, W.T), 100,
                             flush))

    # K4b: the same bucket in padded-CSC, packed as the batcher packs it:
    # at the chunk's own column width
    pc = csr_to_padded_csc(head)
    k_max = pc.k_max
    rows = torch.as_tensor(pc.col_rows, device=DEVICE)
    vals = torch.as_tensor(pc.col_vals, device=DEVICE)
    args = (rows, vals, bank.idx, bank.val, B)
    got = ops.serve_margins_csc(*args)
    want = ref.serve_margins_csc_ref(*args)
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(head.indptr, device=DEVICE),
        torch.as_tensor(head.indices.astype(np.int64), device=DEVICE),
        torch.as_tensor(head.data, device=DEVICE), size=(B, n))
    Wt = W.T.contiguous()
    lib = torch.sparse.mm(A_csr, Wt)
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    e_lib = rel_err(torch, lib, want)
    # the bytes the function needs: of each of the union's request columns
    # its row ids up to the first sentinel (packed last) and its live
    # values, each column once over all models; idx/val; the output
    col_nnz = torch.sum(rows < B, dim=1)
    nnz_u = col_nnz[torch.unique(live_idx)]
    need = int((4 * torch.clamp(nnz_u + 1, max=k_max) + 4 * nnz_u).sum())
    plan = ops.csc_plan(B, K, A, k_max)
    log(f"[kernels] serve_margins_csc B={B} n={n} k_max={k_max} (the "
        f"stream's {req.max_col_nnz()}) K={K} A={A} (plan: {plan.ctas} "
        f"CTAs, a cluster of {plan.cluster} a model, {plan.ranges} row "
        f"range): err {e[0]:.3e} (rel {e[1]:.2e}), tolerance rel "
        f"{KERNEL_RTOL}; library sparse.mm vs plain rel {e_lib[1]:.2e}; "
        f"the union's {U} columns hold {int(nnz_u.sum())} live entries, "
        f"{need} bytes needed of them")
    assert e[1] <= KERNEL_RTOL, e
    top = device_ops(torch, lambda: ops.serve_margins_csc(*args))
    log(f"[kernels] serve_margins_csc, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    assert sum(c for _, c, _ in top) <= 1, top
    out["serve_margins_csc"] = dict(
        max_abs_err=e[0],
        **timings(torch, lambda: ops.serve_margins_csc(*args),
                  lambda: ref.serve_margins_csc_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.serve_margins_csc(*args),
                              200),
        bound=bound(need + K * A * 8 + B * K * 4,
                    2 * int(col_nnz[live_idx].sum())),
        library_ms=device_ms(torch, lambda: torch.sparse.mm(A_csr, Wt), 100,
                             flush))
    # the request stream's fixed column width (the JAX policy's) against
    # the chunk's own, L2-cold
    wide = csr_to_padded_csc(head, k_max=req.max_col_nnz())
    wide_args = (torch.as_tensor(wide.col_rows, device=DEVICE),
                 torch.as_tensor(wide.col_vals, device=DEVICE),
                 bank.idx, bank.val, B)
    e = rel_err(torch, ops.serve_margins_csc(*wide_args), want)
    assert e[1] <= KERNEL_RTOL, e
    t_wide = device_ms(torch, lambda: ops.serve_margins_csc(*wide_args),
                       100, flush)
    log(f"[kernels] serve_margins_csc, L2-cold: at the stream's width (k_max "
        f"{wide.k_max}) {t_wide * 1e3:.2f} us")

    # K5: the candidates' loss deltas over the training set
    prob = serve["problem"]
    dev = torch.device(DEVICE)
    w0 = torch.as_tensor(serve["w_star"], device=dev)
    w1 = torch.as_tensor(serve["w_next"], device=dev)
    z = prob.margins(w0)
    delta = prob.margins(w1) - z
    alphas = candidate_alphas(ArmijoParams(), torch.float32, dev)
    args = (z, delta, prob.y, alphas)
    got = ops.pcdn_linesearch(*args)
    want = ref.pcdn_linesearch_ref(*args)
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    s = z.shape[0]
    Q = alphas.shape[0]
    s_live = int(torch.count_nonzero(delta))
    log(f"[kernels] pcdn_linesearch s={s} (delta != 0: {s_live}) Q={Q}: "
        f"err {e[0]:.3e} (rel {e[1]:.2e}), tolerance rel {KERNEL_RTOL}")
    assert e[1] <= KERNEL_RTOL, e
    out["pcdn_linesearch"] = dict(
        max_abs_err=e[0],
        **timings(torch, lambda: ops.pcdn_linesearch(*args),
                  lambda: ref.pcdn_linesearch_ref(*args), flush),
        # delta everywhere, z and y where delta != 0, alphas, the output;
        # ~10 flops per (sample, candidate) loss term
        bound=bound(4 * s + 8 * s_live + 8 * Q, 10 * s_live * Q),
        library_ms=None)
    return out


def flash_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through, per head: what the
    attention's work depends on."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)          # rows i < Skv see i + 1 keys, later rows Skv
    return n * (n + 1) // 2 + max(Sq - Skv, 0) * Skv


def flash_fault(torch, q, k, v, causal=True, sm_scale=None, *, fault):
    """The plain version (model layout) with one of FLASH_FAULTS planted:
    what the gates read for a wrong kernel."""
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qg = q.reshape(B, Sq, Kv, H // Kv, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    kj = torch.arange(Skv, device=q.device)
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= torch.arange(Sq, device=q.device)[:, None] >= kj
    if fault == "tile":
        ok &= (kj < 64) | (kj >= 128)
    s = torch.where(ok, s, -torch.inf)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = (e * (kj % 8 < 6) if fault == "quad" else e).sum(-1, keepdim=True)
    if fault == "fp8 p":
        e = e.to(torch.float8_e4m3fn).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", e / l, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_work(q, k, causal: bool) -> tuple[float, float]:
    """(bytes, flops) one K6 call needs: each input read once, the output
    written once; 4 D flops for each (query, key) pair the mask lets
    through. Either layout ((B, S, H, D) or (BH, S, D))."""
    D = q.shape[-1]
    Sq, Skv = q.shape[1], k.shape[1]
    heads = q.numel() // (Sq * D)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * D * flash_pairs(Sq, Skv, causal) * heads


def flash_rate(torch, q, k, causal: bool, ms: float) -> str:
    """A K6 time's TFLOP/s and its share of the bound (bf16 tensor-core
    peak, or fp32 on the CUDA cores)."""
    nbytes, nops = flash_work(q, k, causal)
    peak = FP32_OPS_PER_S if q.dtype == torch.float32 else \
        BF16_TENSOR_OPS_PER_S
    b = bound(nbytes, nops, peak)[0]
    return (f"{nops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {b / ms:.3f} of its "
            f"bound")


def flash_kernel_checks(torch, flush) -> dict:
    """K6 against its plain version on the same inputs: at the lm phase's
    prefill shape (bf16, causal, the model's (B, S, H, D) layout with its
    2 kv heads), timed with the bound, the library call
    (scaled_dot_product_attention, timed only), the mma.sync variant at
    the same shape (the wgmma kernel's first step) and the host time of a
    call's tensor-map encodes, and the planted faults' readings there;
    then yi-6b's and gemma-7b's head widths, tails, Sq != Skv,
    non-causal and float32. Every time with its TFLOP/s and share of the
    bound; every check names the variant that ran."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(q_shape, kv_shape, dtype):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in (q_shape, kv_shape, kv_shape)]

    def check(label, q, k, v, causal):
        before = ops.flash_variant_counts()
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ran = [n for n, c in ops.flash_variant_counts().items()
               if c != before[n]]
        e = row_rel_err(torch, got, want)
        tol = FLASH_RTOL[str(q.dtype).removeprefix("torch.")]
        ms = device_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal), 20)
        log(f"[kernels] flash_attention {label} q {tuple(q.shape)} k/v "
            f"{tuple(k.shape)} {str(q.dtype).removeprefix('torch.')} "
            f"{'causal' if causal else 'non-causal'}, variant "
            f"{'/'.join(ran)}: err {e[0]:.3e} (row rel {e[1]:.2e}), "
            f"tolerance row rel {tol}; {ms * 1e3:.2f} us L2-warm, "
            f"{flash_rate(torch, q, k, causal, ms)}")
        assert e[1] <= tol, (label, e)
        assert ran == [ops.flash_variant(q.dtype, q.shape[-1])], ran
        return e, want

    cfg = get_config(LM_ARCH)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = inputs((LM_BATCH, LM_PROMPT, H, D), (LM_BATCH, LM_PROMPT, Kv, D),
                     torch.bfloat16)
    e, want = check(f"{LM_ARCH} prefill", q, k, v, True)
    tol = FLASH_RTOL["bfloat16"]
    for fault in FLASH_FAULTS:
        r = row_rel_err(torch, flash_fault(torch, q, k, v, fault=fault),
                        want)[1]
        log(f"[kernels] flash_attention control, plain version with "
            f"{fault!r} planted: row rel {r:.2e} (limit {tol})")
        if fault != "fp8 p":
            assert r > tol, (fault, r)
    # the first step of the redesign, the mma.sync variant, at this shape
    e_mma = row_rel_err(torch, ops.flash_attention(q, k, v, variant="mma"),
                        want)
    assert e_mma[1] <= tol, e_mma
    del want
    # the library call: heads first, contiguous, kv heads grouped inside
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    e_lib = row_rel_err(torch, library().transpose(1, 2),
                        ref.attention_ref(q, k, v))
    log(f"[kernels] flash_attention library scaled_dot_product_attention "
        f"vs plain row rel {e_lib[1]:.2e} (timed only)")
    nbytes, nops = flash_work(q, k, True)
    r = dict(max_abs_err=e[0],
             **timings(torch, lambda: ops.flash_attention(q, k, v),
                       lambda: ref.attention_ref(q, k, v), flush),
             bound=bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
             library_ms=device_ms(torch, library, 20, flush))
    mma_ms = device_ms(torch, lambda: ops.flash_attention(
        q, k, v, variant="mma"), 20, flush)
    r["variant_ms"] = {"wgmma": r["ms"], "mma": mma_ms}
    encode_us = []
    for _ in range(50):
        ops.flash_attention(q, k, v)
        encode_us.append(ops.flash_encode_us())
    torch.cuda.synchronize()
    log(f"[kernels] flash_attention {LM_ARCH} prefill, L2-cold: wgmma "
        f"{r['ms'] * 1e3:.2f} us ({flash_rate(torch, q, k, True, r['ms'])})"
        f"; the mma.sync variant {mma_ms * 1e3:.2f} us "
        f"({flash_rate(torch, q, k, True, mma_ms)}; row rel "
        f"{e_mma[1]:.2e}); library {r['library_ms'] * 1e3:.2f} us "
        f"({flash_rate(torch, q, k, True, r['library_ms'])})")
    log(f"[kernels] flash_attention host time encoding a call's three "
        f"tensor maps: mean {sum(encode_us) / len(encode_us):.3f} us, max "
        f"{max(encode_us):.3f} us over {len(encode_us)} calls (host "
        f"{r['host_ms'] * 1e3:.2f} us a call in all)")
    out = {"flash_attention": r}
    del q, k, v, qt, kt, vt

    for label, arch, B, S in (("yi-6b heads", "yi-6b", 1, 2048),
                              ("gemma-7b heads", "gemma-7b", 2, 2048)):
        c = get_config(arch)
        D = c.resolved_head_dim
        check(label, *inputs((B, S, c.n_heads, D), (B, S, c.n_kv_heads, D),
                             torch.bfloat16), True)
    check("tail", *inputs((1, 4000, H, 64), (1, 4000, Kv, 64),
                          torch.bfloat16), True)
    check("Sq != Skv", *inputs((8, 200, 64), (8, 328, 64), torch.bfloat16),
          True)
    check("non-causal", *inputs((1, 2048, H, 64), (1, 2048, Kv, 64),
                                torch.bfloat16), False)
    check("float32", *inputs((1, 2048, H, 64), (1, 2048, Kv, 64),
                             torch.float32), True)
    check("float32 gemma-7b heads, Sq != Skv", *inputs(
        (1, 1000, 16, 256), (1, 1500, 16, 256), torch.float32), False)
    return out


def lm_model(torch, dtype: str, seed: int = LM_SEED):
    """The lm phase's model (random weights from `seed`, on the card) and
    its prompts, made as `launch.serve` makes them."""
    from repro_torch.configs import get_config
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    cfg = get_config(LM_ARCH).replace(dtype=dtype)
    model = Model(cfg, DEVICE)
    init_params(model, torch.Generator(device=DEVICE).manual_seed(seed))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))
    return model, torch.as_tensor(prompts, device=DEVICE)


def lm_agreement(torch, dtype: str, seed: int, faults=()) -> list:
    """Prefill through K6 and through its plain version, from the same
    weights and prompts (from `seed`), then LM_DECODE_CHECK decode steps
    from each cache on the kernel route's greedy tokens; then a prefill
    through the plain version with each of `faults` planted. -> the
    readings: [prefill, each decode step] rel of the kernel route, then
    one prefill rel a fault, against the plain route. In float32 the
    greedy first tokens are equal."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import decode as dec
    model, tokens = lm_model(torch, dtype, seed)
    n_layers = model.cfg.n_layers
    steps, firsts, feed = {}, {}, []
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        ops.reset_launch_counts()
        logits, cache = dec.prefill(model, tokens,
                                    LM_PROMPT + LM_DECODE_CHECK)
        torch.cuda.synchronize()
        n = ops.launch_counts()["flash_attention"]
        assert n == (n_layers if use_kernels else 0), (use_kernels, n)
        firsts[use_kernels] = torch.argmax(logits[:, -1], dim=-1)
        if not feed:
            feed.append(firsts[True][:, None])
        steps[use_kernels] = [logits]
        for i in range(LM_DECODE_CHECK):
            logits, cache = dec.decode_step(model, cache, feed[i])
            steps[use_kernels].append(logits)
            if len(feed) < LM_DECODE_CHECK:
                feed.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
        del cache
    rels = [rel_err(torch, a, b)[1]
            for a, b in zip(steps[True], steps[False])]
    finite = all(bool(torch.isfinite(t).all())
                 for t in steps[True] + steps[False])
    same_first = torch.equal(firsts[True], firsts[False])
    log(f"[lm] {dtype} seed {seed}: prefill logits through K6 ({n_layers} "
        f"launches) vs its plain version rel {rels[0]:.2e}; "
        f"{LM_DECODE_CHECK} decode steps rel "
        + " ".join(f"{r:.2e}" for r in rels[1:])
        + f"; greedy first tokens {'equal' if same_first else 'differ'} "
        f"({firsts[True].tolist()} vs {firsts[False].tolist()})")
    assert finite, "non-finite logits"
    if dtype == "float32":
        assert same_first, (firsts[True], firsts[False])
    plain_ref = ref.attention_ref
    model.use_kernels = False
    for fault in faults:
        def planted(q, k, v, causal=True, sm_scale=None, _fault=fault):
            return flash_fault(torch, q, k, v, causal, sm_scale,
                               fault=_fault)
        ref.attention_ref = planted
        try:
            logits, _ = dec.prefill(model, tokens, LM_PROMPT)
        finally:
            ref.attention_ref = plain_ref
        rels.append(rel_err(torch, logits, steps[False][0])[1])
        log(f"[lm] {dtype} seed {seed}: control, plain route with "
            f"{fault!r} planted: prefill logits rel {rels[-1]:.2e}")
    del model, steps
    gc.collect()
    torch.cuda.empty_cache()
    return rels


def phase_lm(torch, card: str) -> dict:
    """The LM serving path through `repro_torch.launch.serve.main`:
    qwen2-0.5b at full width, a 4096-token prefill (K6 in each of its 24
    layers: checked) and greedy decode, twice (the second run warm), then a
    32-token prompt (the dense route: no K6); K6 against its plain version
    inside the whole prefill, in bf16 and float32; one prefill and one
    decode step traced in a child process. -> K6's launches in the first
    4096-token run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli

    cfg = get_config(LM_ARCH)
    launches = None
    for prompt, want in ((LM_PROMPT, cfg.n_layers), (LM_PROMPT, cfg.n_layers),
                         (LM_SHORT_PROMPT, 0)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = serve_cli.main([
            "--arch", LM_ARCH, "--full", "--batch", str(LM_BATCH),
            "--prompt-len", str(prompt), "--new-tokens", str(LM_NEW),
            "--seed", str(LM_SEED), "--device", DEVICE])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        variants = ops.flash_variant_counts()
        toks = out["tokens"]
        assert counts["flash_attention"] == want, counts
        assert sum(counts.values()) == want, counts
        # the variant the dispatcher's rule gives bf16 at this head dim
        rule = ops.flash_variant(torch.bfloat16, cfg.resolved_head_dim)
        assert variants[rule] == want == sum(variants.values()), variants
        assert toks.shape == (LM_BATCH, LM_NEW), toks.shape
        assert np.all((toks >= 0) & (toks < cfg.vocab_size)), toks
        if launches is None:
            launches = counts["flash_attention"]
            by_variant = variants
        log(f"[lm] launch.serve {LM_ARCH} --full batch {LM_BATCH} prompt "
            f"{prompt} new {LM_NEW} on {card}: prefill "
            f"{out['prefill_ms']:.2f} ms, first decode step "
            f"{out['first_step_ms']:.3f} ms, then "
            f"{out['decode_ms_per_token']:.3f} ms a token "
            f"({out['tok_per_s']:.1f} tok/s); flash_attention launches "
            f"{counts['flash_attention']} (expected {want}; by variant "
            f"{variants}); {wall:.1f}s "
            f"wall with the model's init")
    # the agreement gate: the kernel route's readings at each seed, the
    # planted faults' (not gated) at the first
    for dtype, seeds in (("bfloat16", LM_GATE_SEEDS), ("float32", (LM_SEED,))):
        tol = LM_RTOL[dtype]
        kernel = []
        for seed in seeds:
            rels = lm_agreement(torch, dtype, seed, FLASH_FAULTS
                                if seed == seeds[0] and dtype == "bfloat16"
                                else ())
            kernel += rels[:1 + LM_DECODE_CHECK]
        log(f"[lm] {dtype}: kernel route's largest rel {max(kernel):.2e} "
            f"over {len(seeds)} seed(s), tolerance rel {tol}")
        assert max(kernel) <= tol, (dtype, kernel)

    # traced in a fresh process: the profiler loses records late in a
    # long one (PERF.md)
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--lm-profile"],
        capture_output=True, text=True, check=True, timeout=600)
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    for name in ("prefill", "decode"):
        r = prof[name]
        if r["busy_ms"] > 0:
            log(f"[lm] one {name} traced by torch.profiler in a fresh "
                f"process: {r['traced_ms']:.3f} ms wall traced "
                f"({r['wall_ms']:.3f} untraced), device busy "
                f"{r['busy_ms']:.3f} ms (idle share "
                f"{1 - r['busy_ms'] / r['traced_ms']:.3f}); top device ops:")
            for key, calls, us in r["top"]:
                log(f"[lm]   {us:10.2f} us  {calls:5d} calls  {key[:90]}")
        else:
            log(f"[lm] one {name}: {r['wall_ms']:.3f} ms wall; idle share "
                f"not measured (the profiler saw no device time)")
    return {"flash_attention": launches,
            "flash_attention variants": by_variant}


def lm_profile() -> dict:
    """One prefill (LM_BATCH x LM_PROMPT) and one decode step of the lm
    phase's bf16 model, after a warm-up prefill and two decode steps: the
    untraced wall (host_ms), then one traced call each ->
    {"prefill"|"decode": {"wall_ms", "traced_ms", "busy_ms", "top"}}.
    Run by the lm phase in a child process (`--lm-profile`)."""
    import torch
    from repro_torch.models import decode as dec
    model, tokens = lm_model(torch, "bfloat16")
    max_len = LM_PROMPT + 16
    logits, cache = dec.prefill(model, tokens, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(2):
        dec.decode_step(model, cache, tok)
    out = {}
    for name, fn in (("prefill", lambda: dec.prefill(model, tokens, max_len)),
                     ("decode", lambda: dec.decode_step(model, cache, tok))):
        wall = host_ms(torch, fn, 3)
        busy, top, traced = device_profile(torch, fn)
        out[name] = {"wall_ms": wall, "traced_ms": traced * 1e3,
                     "busy_ms": busy * 1e3,
                     "top": [(k, c, t * 1e6) for k, c, t in top if t > 0]}
    return out


def phase_serve(torch, serve, card: str) -> dict:
    """The serving path through `repro_torch.launch.predict.main`: the
    synchronous batcher for the c* model and the K = 8 path family in
    both request layouts, then `--serve` with a mid-stream hot-swap.
    Checks the first-batch guard, the launch counts against the chunks
    scored, accuracy, the swap's versions and storage. -> launch counts
    of K4a and K4b summed over the phase's runs."""
    from repro_torch.kernels import ops
    from repro_torch.launch import predict as predict_cli
    from repro_torch.serve.artifact import load_model
    from repro_torch.serve.batcher import MicroBatcher
    from repro_torch.serve.predict import ModelBank, margins_dense

    req_path = str(serve["requests_path"])
    paths = serve["paths"]
    total = {"serve_margins_dense": 0, "serve_margins_csc": 0}
    for name, model in (("c*", paths["star"]), ("path", paths["family"])):
        for layout, kernel in (("dense", "serve_margins_dense"),
                               ("padded_csc", "serve_margins_csc")):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            payload = predict_cli.main([
                "--model", str(model), "--dataset", req_path,
                "--layout", layout, "--use-kernels",
                "--max-batch", str(SERVE_MAX_BATCH), "--device", DEVICE])
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            st = payload["stats"]
            # the batcher's chunks and the first-batch guard's one
            chunks = st["calls"] + 1
            assert payload["kernel_guard_max_abs_err"] is not None
            assert counts[kernel] == chunks, (counts, chunks)
            assert sum(counts.values()) == chunks, counts
            accs = payload.get("per_point", [payload.get("accuracy")])
            assert all(a is not None and np.isfinite(a) for a in accs), accs
            acc = payload.get("accuracy", payload.get("best_accuracy"))
            assert acc > 0.5, acc
            total[kernel] += counts[kernel]
            K = len(payload["per_point"]) if "per_point" in payload else 1
            log(f"[serve] sync {name} {layout}: K={K}, "
                f"{payload['n_requests']} requests, accuracy {acc:.4f}, "
                f"{kernel} launches {counts[kernel]} = {chunks} chunks, "
                f"guard err {payload['kernel_guard_max_abs_err']:.2e}, "
                f"steady {st['steady_rows_per_s']:.0f} rows/s, p50 "
                f"{st['latency_p50_s'] * 1e3:.3f} ms p99 "
                f"{st['latency_p99_s'] * 1e3:.3f} ms a chunk; {wall:.1f}s "
                f"wall (parse + densify + score)")
            for b in st["buckets"]:
                log(f"[serve]   bucket {b['bucket']:>4}: calls "
                    f"{b['calls']}, rows {b['rows']}, pad {b['pad_rows']}, "
                    f"warm-up {b['warmup_seconds'] * 1e3:.2f} ms, steady "
                    + (f"{b['rows_per_s']:.0f} rows/s"
                       if b["rows_per_s"] else "n/a"))

    # the interpreter's garbage-collection pauses during --serve, to set
    # beside the request generator's worst lag
    pauses = []

    def gc_pause(phase, info, _start=[0.0]):
        if phase == "start":
            _start[0] = time.perf_counter()
        else:
            pauses.append((time.perf_counter() - _start[0],
                           info["generation"]))

    gc.callbacks.append(gc_pause)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    payload = predict_cli.main([
        "--model", str(paths["star"]), "--dataset", req_path, "--serve",
        "--use-kernels", "--max-batch", str(SERVE_MAX_BATCH),
        "--rate", str(SERVE_RATE), "--serve-requests", str(SERVE_REQUESTS),
        "--slo-ms", str(SERVE_SLO_MS), "--swap-model", str(paths["swap"]),
        "--device", DEVICE])
    wall = time.perf_counter() - t0
    gc.callbacks.remove(gc_pause)
    counts = ops.launch_counts()
    st = payload["stats"]
    slot = st["models"]["default"]
    flushes = sum(slot["flushes"].values())
    warm = 2 * len(st["buckets"])            # two warm-up calls a bucket
    assert counts["serve_margins_dense"] == warm + flushes, (counts, warm,
                                                             flushes)
    assert payload["swap"]["response_versions"] == [1, 2], payload["swap"]
    assert payload["bank_storage_kept"], payload
    assert payload["libraries_loaded_after_warmup"] == [], payload
    assert payload["responses"] + payload["rejects"] == SERVE_REQUESTS
    total["serve_margins_dense"] += counts["serve_margins_dense"]
    log(f"[serve] --serve at {SERVE_RATE:g} rps target "
        f"({payload['offered_rps']:.0f} offered), {SERVE_REQUESTS} "
        f"requests, slo {SERVE_SLO_MS:g} ms on {card}: responses "
        f"{payload['responses']}, rejects {payload['rejects']}, p50 "
        f"{payload['p50_s'] * 1e3:.3f} ms, p99 {payload['p99_s'] * 1e3:.3f} "
        f"ms, max {payload['max_s'] * 1e3:.3f} ms, slo violations "
        f"{payload['slo_violations']}, padding efficiency "
        f"{payload['padding_efficiency']:.3f}, flushes {slot['flushes']}, "
        f"generator lag {payload['generator_lag_s'] * 1e3:.2f} ms at "
        f"{payload['generator_lag_at_s']:.3f} s (swap called at "
        f"{payload['swap']['fired_at_s']:.3f} s, held its thread "
        f"{payload['swap']['queue_s'] * 1e3:.2f} ms); "
        f"serve_margins_dense launches {counts['serve_margins_dense']} = "
        f"{warm} warm-up + {flushes} flushes; swap -> versions "
        f"{payload['swap']['response_versions']}, bank storage kept, no "
        f"library loaded after warm-up; {wall:.1f}s wall")
    worst = max(pauses, default=(0.0, None))
    log(f"[serve] garbage collection during the --serve run: "
        f"{len(pauses)} collections, {sum(p[0] for p in pauses) * 1e3:.2f} "
        f"ms in all, the longest {worst[0] * 1e3:.2f} ms (generation "
        f"{worst[1]}), against the generator's worst lag "
        f"{payload['generator_lag_s'] * 1e3:.2f} ms")

    # one full dense chunk as the batcher scores it, traced in a child
    # process: in this long process torch.profiler has recorded nothing
    # for it after the earlier phases (see PERF.md), in a fresh one it
    # records every copy and kernel
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--chunk-profile",
         str(paths["family"]), req_path], capture_output=True, text=True,
        check=True, timeout=300)
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    if prof["busy_ms"] > 0:
        log(f"[serve] one {SERVE_MAX_BATCH}-row dense chunk, K=8, traced "
            f"by torch.profiler in a fresh process: {prof['traced_ms']:.3f} "
            f"ms wall traced ({prof['wall_ms']:.3f} untraced); device busy "
            f"{prof['busy_ms']:.3f} ms (idle share "
            f"{1 - prof['busy_ms'] / prof['traced_ms']:.3f}), of it copies "
            f"{prof['copy_ms']:.3f} ms (the host stages the pageable rows: "
            f"{prof['copy_in_gbps']:.2f} GB/s in) and kernels "
            f"{prof['kernel_ms']:.3f} ms (SM idle share "
            f"{1 - prof['kernel_ms'] / prof['traced_ms']:.3f}); device "
            f"ops:")
        for key, calls, us in prof["top"]:
            log(f"[serve]   {us:9.2f} us  {calls:4d} calls  {key[:90]}")
    else:
        log(f"[serve] one {SERVE_MAX_BATCH}-row dense chunk: "
            f"{prof['wall_ms']:.3f} ms wall; idle share not measured (the "
            f"profiler saw no device time)")
    log(f"[serve] the chunk's rows alone, host-timed copy in: pageable "
        f"{prof['pageable_gbps']:.2f} GB/s, pinned {prof['pinned_gbps']:.2f}"
        f" GB/s")

    # padded-CSC packing, end to end (pack + copy + score): each chunk at
    # its own column width (the batcher's default) against the request
    # stream's fixed width (the JAX policy's); alternating, after a first
    # pass that loads each bucket
    req = serve["requests"]
    fam_bank = ModelBank.from_family(serve["family"], device=DEVICE)
    walls = {None: [], req.max_col_nnz(): []}
    for km in (req.max_col_nnz(), None, None, req.max_col_nnz()):
        mb = MicroBatcher(fam_bank, max_batch=SERVE_MAX_BATCH,
                          layout="padded_csc", use_kernels=True, k_max=km)
        mb.predict(req)
        t0 = time.perf_counter()
        mb.predict(req)
        walls[km].append(time.perf_counter() - t0)
    cells = []
    for km, ws in walls.items():
        label = "own width" if km is None else f"width {km}"
        cells.append(label + " " + ", ".join(
            f"{w * 1e3:.1f} ms ({req.shape[0] / w:.0f} rows/s)" for w in ws))
    log(f"[serve] padded-CSC requests, K=8, wall of MicroBatcher.predict "
        f"over {req.shape[0]} rows (pack + copy + score): "
        + "; ".join(cells))

    # the dense-layout route crossover on the card: union-gather vs the
    # densified matmul, device ms a call at each bucket
    Xall = torch.as_tensor(
        serve["requests"].rows(0, SERVE_MAX_BATCH).to_dense(), device=DEVICE)
    star = ModelBank.from_family(load_model(str(paths["star"])),
                                 device=DEVICE)
    for label, rbank in (("c*", star), ("path", fam_bank)):
        rbank.dense_matrix()
        cells = []
        b = 1
        while b <= SERVE_MAX_BATCH:
            Xb = Xall[:b]
            t_s = device_ms(torch, lambda: margins_dense(
                rbank, Xb, route="sparse"), 30)
            t_d = device_ms(torch, lambda: margins_dense(
                rbank, Xb, route="dense"), 30)
            cells.append(f"B={b}: {t_s * 1e3:.1f}/{t_d * 1e3:.1f}")
            b *= 2
        log(f"[serve] route crossover, {label} bank (K={rbank.n_models},"
            f" sparsity {rbank.sparsity():.5f}), union-gather/densified "
            f"us a call: " + ", ".join(cells))
    return total


def chunk_profile(family_path: str, requests_path: str) -> dict:
    """One dense chunk of the serve phase (its first SERVE_MAX_BATCH
    request rows against the family's bank, host rows -> device -> K4a ->
    host) timed on the host and traced once with torch.profiler ->
    {"wall_ms", "traced_ms", "busy_ms", "copy_ms", "kernel_ms",
    "copy_in_gbps", "pageable_gbps", "pinned_gbps", "top"}: wall_ms
    untraced, traced_ms the wall of the traced call, whose busy time the
    trace splits into copies and kernels; the pageable and pinned rates
    time a copy of the rows alone. Run by the serve phase in a child
    process (`--chunk-profile`)."""
    import torch
    from repro_torch.data import load_libsvm
    from repro_torch.serve.artifact import load_model
    from repro_torch.serve.predict import ModelBank, margins_dense

    bank = ModelBank.from_family(load_model(family_path), device=DEVICE)
    csr, _ = load_libsvm(requests_path, n_features=bank.n_features,
                         layout="csr")
    Xh = csr.rows(0, SERVE_MAX_BATCH).to_dense()

    def chunk():
        return margins_dense(bank, Xh, use_kernels=True).cpu()

    wall_ms = host_ms(torch, chunk, 20)
    # the rows' copy in alone, from pageable memory and from pinned
    page_ms = host_ms(torch, lambda: torch.as_tensor(Xh, device=DEVICE), 20)
    pinned = torch.from_numpy(Xh).pin_memory()
    pin_ms = host_ms(torch, lambda: pinned.to(DEVICE, non_blocking=True),
                     20)
    busy, rows, traced = device_profile(torch, chunk, n_top=None)
    copy_in = sum(t for k, _, t in rows if k.startswith("Memcpy HtoD"))
    copy = sum(t for k, _, t in rows if k.startswith(("Memcpy", "Memset")))
    return {"wall_ms": wall_ms, "traced_ms": traced * 1e3,
            "busy_ms": busy * 1e3,
            "copy_ms": copy * 1e3, "kernel_ms": (busy - copy) * 1e3,
            "copy_in_gbps": Xh.nbytes / copy_in / 1e9 if copy_in else 0.0,
            "pageable_gbps": Xh.nbytes / page_ms / 1e6,
            "pinned_gbps": Xh.nbytes / pin_ms / 1e6,
            "top": [(k, c, t * 1e6) for k, c, t in rows[:6] if t > 0]}


def device_profile(torch, fn, n_top: int = 8):
    """Run fn once under torch.profiler (CUDA activity only) -> (device-busy
    seconds summed over what the card ran, the n_top ops by device time as
    (name, calls, seconds), the wall seconds of the traced call); busy 0.0
    and no ops when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e6)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows[:n_top], wall  # n_top None: all


def device_ops(torch, fn) -> list:
    """The ops that ran on the card in one traced call of fn, as
    device_profile's (name, calls, seconds), those with device time only."""
    return [r for r in device_profile(torch, fn, n_top=None)[1] if r[2] > 0]


def log_top(name: str, top, per: int, unit: str) -> None:
    for key, calls, secs in top:
        log(f"[{name}]   {secs / per * 1e6:9.2f} us/{unit}  "
            f"{calls // max(per, 1):4d} calls/{unit}  {key[:90]}")


def solve_profile(name: str) -> dict:
    """One outer iteration of solve phase `name` from the initial state,
    traced after an untraced run of the same iteration, in a process of its
    own (`--solve-profile`): -> {"busy_s", "rows": [(op, calls, seconds)],
    "launches": the kernel's count in the traced iteration}."""
    import torch
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    data = make_data(DATA_SEED)
    i_x, i_y, c, layout, P, kernel, _ = SOLVES[name]
    prob = make_problem(data[i_x], data[i_y], c=c, layout=layout,
                        device=DEVICE)
    backend = LocalBackend(prob, PCDNConfig(P=P, use_kernels=True,
                                            tol_kkt=0.0, seed=0))

    def iteration():
        st = backend.init_state()
        backend.outer(st.w, st.z, st.gen, st.active, True, c)

    iteration()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    busy, rows, _ = device_profile(torch, iteration, n_top=None)
    return {"busy_s": busy, "rows": rows,
            "launches": ops.launch_counts()[kernel]}


def lockstep(torch, prob, P, c, n_iter: int) -> list:
    """Kernel and plain outer iterations from one shared carry: each
    iteration runs both from the kernel run's carry with the same
    partition, so an Armijo decision that flips on the last bit moves one
    iteration's F only and cannot compound along the trajectory.
    -> per-iteration rel diff of F."""
    from repro_torch.core import PCDNConfig
    from repro_torch.engine import LocalBackend
    outers = {k: LocalBackend(prob, PCDNConfig(P=P, use_kernels=k,
                                               tol_kkt=0.0, seed=0))
              for k in (True, False)}
    w, z, gen, active = outers[True].init_state()
    rels = []
    for _ in range(n_iter):
        twin = torch.Generator().set_state(gen.get_state())
        out_p = outers[False].outer(w, z, twin, active, True, c)
        w, z, gen, f_k, _, _, _, active, _ = outers[True].outer(
            w, z, gen, active, True, c)
        rels.append(abs(float(f_k) - float(out_p[3])) / abs(float(out_p[3])))
    return rels


def run_solve(torch, name, data, n_outer, fused=False):
    """Solve phase `name` (SOLVES): the kernel solve (launch counts read
    around it), the plain solve from the same seed (its drift printed), one
    iteration traced in a child process, then the lockstep gate over
    n_outer iterations; returns the launch counts. `fused`: the traced
    iteration must show one K1 launch a bundle and no other per-bundle
    device op."""
    from repro_torch.core import PCDNConfig, resolve_ls_scope
    from repro_torch.core.bundles import num_bundles
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import ops

    i_x, i_y, c, layout, P, kernel, expect = SOLVES[name]
    prob = make_problem(data[i_x], data[i_y], c=c, layout=layout,
                        device=DEVICE)
    results = {}
    for use_kernels in (True, False):
        # tol 0: both solves run exactly n_outer iterations
        cfg = PCDNConfig(P=P, use_kernels=use_kernels, tol_kkt=0.0,
                         max_outer=n_outer, seed=0)
        scope = resolve_ls_scope(cfg, prob)
        assert scope == expect, (name, scope, expect)
        backend = LocalBackend(prob, cfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = engine_loop.solve(backend, c, max_outer=n_outer, tol_kkt=0.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        results[use_kernels] = (res, dt, counts)
        F = res.history.objective
        assert np.all(np.isfinite(F)) and res.n_outer == n_outer, F
        assert np.all(np.diff(F) <= F_MONOTONE_RTOL * np.abs(F[:-1])), F
        b = num_bundles(prob.n_features, P)
        log(f"[{name}] use_kernels={use_kernels} scope={scope} P={P} "
            f"bundles/iter={b} iters={res.n_outer} F0={F[0]:.6f} "
            f"F={F[-1]:.6f} kkt={res.history.kkt[-1]:.3e} "
            f"mean_q={res.history.ls_steps.mean():.3f} wall={dt:.2f}s "
            f"({dt / n_outer * 1e3:.1f} ms/iter, "
            f"{dt / (n_outer * b) * 1e6:.1f} us/bundle) launches={counts}")
    res_k, dt_k, counts = results[True]
    res_p = results[False][0]
    b = num_bundles(prob.n_features, P)
    assert counts[kernel] == b * n_outer, (counts, b, n_outer)
    # traced in a fresh process: late in a long one the profiler loses
    # records (PERF.md)
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--solve-profile",
         name], capture_output=True, text=True, check=True, timeout=300)
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    assert prof["launches"] == b, (name, prof["launches"], b)
    busy = prof["busy_s"]
    top = [tuple(r) for r in prof["rows"] if r[2] > 0]
    wall = dt_k / n_outer
    if busy > 0:
        log(f"[{name}] device busy {busy * 1e3:.2f} ms of {wall * 1e3:.2f} "
            f"ms wall per outer iteration (idle share "
            f"{1 - busy / wall:.3f}); per bundle {busy / b * 1e6:.1f} us "
            f"device, {(wall - busy) / b * 1e6:.1f} us host overhead; top "
            f"device ops:")
        log_top(name, top[:8], b, "bundle")
        n_ops = sum(r[1] for r in top)
        per_bundle = [r for r in top if r[1] >= b]
        log(f"[{name}] {n_ops} device ops in the traced iteration "
            f"({kernel} launched {prof['launches']} times in it), "
            f"{n_ops / b:.2f} a bundle; launched at least once a bundle: "
            + "; ".join(f"{k[:70]} x{n}" for k, n, _ in per_bundle))
        if fused:
            # the fused step is one K1 launch a bundle and nothing else
            assert len(per_bundle) == 1 and per_bundle[0][1] == b and \
                "bundle_step_kernel" in per_bundle[0][0], per_bundle
            assert n_ops - b < b // 2, (n_ops, b)
        if name == "dense":
            # K3 once a bundle, and no slab gather (index_select) or
            # matrix-vector product (X_B d) a bundle around it
            k3 = [n for k, n, _ in top if "dense_direction_kernel" in k]
            assert k3 == [b], (k3, b)
            around = [k for k, _, _ in per_bundle
                      if any(w in k.lower() for w in
                             ("indexselect", "index_select", "gemv",
                              "gemm"))]
            assert not around, around
    else:
        log(f"[{name}] device busy: not measured (profiler saw no "
            f"device time)")
    # two free runs: an Armijo flip on the last bit compounds, so this
    # drift is reported, not held to a limit
    rel = abs(res_k.objective - res_p.objective) / abs(res_p.objective)
    per_iter = np.abs(res_k.history.objective - res_p.history.objective) / \
        np.abs(res_p.history.objective)
    log(f"[{name}] free runs, same seed: F kernels {res_k.objective:.6f} vs "
        f"plain {res_p.objective:.6f}: rel {rel:.2e} (not gated); per "
        f"iteration {' '.join(f'{r:.1e}' for r in per_iter)}")
    steps = lockstep(torch, prob, P, c, n_outer)
    log(f"[{name}] lockstep from a shared carry: F rel per iteration "
        f"{' '.join(f'{r:.1e}' for r in steps)} (tolerance {F_RTOL})")
    assert max(steps) <= F_RTOL, steps
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES[1:]),
                    help=f"comma-separated subset of {PHASES[1:]}")
    ap.add_argument("--lm-profile", action="store_true",
                    help="trace one LM prefill and decode step and print "
                         "their JSON line (the lm phase runs this in a "
                         "child process)")
    ap.add_argument("--solve-profile", choices=tuple(SOLVES),
                    help="trace one outer iteration of a solve phase and "
                         "print its JSON line (the solve phases run this in "
                         "a child process)")
    ap.add_argument("--chunk-profile", nargs=2,
                    metavar=("FAMILY", "REQUESTS"),
                    help="trace one dense serve chunk and print its JSON "
                         "line (the serve phase runs this in a child "
                         "process)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if args.chunk_profile:
        print(json.dumps(chunk_profile(*args.chunk_profile)), flush=True)
        return 0
    if args.lm_profile:
        print(json.dumps(lm_profile()), flush=True)
        return 0
    if args.solve_profile:
        print(json.dumps(solve_profile(args.solve_profile)), flush=True)
        return 0

    # full-precision float32 products on the plain paths (the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {card} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    phase_build()  # every later phase needs the kernels
    data = None
    if set(phases) & {"kernels", "support", "full", "dense"}:
        data = make_data(DATA_SEED)
    serve = None
    if set(phases) & {"kernels", "serve"}:
        serve = prepare_serve(torch)
    kernels = {}
    if "kernels" in phases:
        kernels = phase_kernels(torch, data, serve, f"{card} ({smi})")
    launches = {}
    for name in SOLVES:
        if name in phases:
            kernel = SOLVES[name][5]
            launches[kernel] = run_solve(torch, name, data, N_OUTER,
                                         fused=name == "support")[kernel]
    if "cli" in phases:
        from repro_torch.kernels import ops
        from repro_torch.launch import solve as solve_cli
        ops.reset_launch_counts()
        f = solve_cli.main(["--dataset", "a9a", "--layout", "padded_csc",
                            "--use-kernels", "--max-outer", "20",
                            "--device", DEVICE])
        counts = ops.launch_counts()
        log(f"[cli] F={f:.6f} launches={counts}")
        assert np.isfinite(f) and counts["pcdn_sparse_direction"] > 0, counts
    if "serve" in phases:
        launches.update(phase_serve(torch, serve, f"{card} ({smi})"))
    if "lm" in phases:
        launches.update(phase_lm(torch, f"{card} ({smi})"))

    if kernels:
        rows = []
        for name, r in kernels.items():
            src, replaces = SOURCES[name]
            row = {
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches.get(name),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
            if f"{name} variants" in launches:
                row["launches_by_variant"] = launches[f"{name} variants"]
            if "variant_ms" in r:
                row["variant_ms"] = r["variant_ms"]
            rows.append(row)
        print(json.dumps({"kernels": rows}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
