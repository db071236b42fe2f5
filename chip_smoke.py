#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # build + kernel check only
    python3 chip_smoke.py --phases tune      # build + the autotuner
    python3 chip_smoke.py --phases serve     # build + the serving path
    python3 chip_smoke.py --phases lm        # build + the LM serving path
    python3 chip_smoke.py --phases train     # build + LM training
    python3 chip_smoke.py --phases moe       # build + serving the moe family
    python3 chip_smoke.py --phases ssm       # build + serving the ssm family
    python3 chip_smoke.py --phases hybrid,vlm,encdec  # the other three
    python3 chip_smoke.py --phases ftrain    # build + training the five
    python3 chip_smoke.py --phases dtrain    # build + training over a mesh
    python3 chip_smoke.py --lm-profiles      # + the LM phases' traces
    python3 chip_smoke.py --phases path      # build + the regularization path
    python3 chip_smoke.py --phases fault     # build + diagnostics, faults
    python3 chip_smoke.py --phases sharded   # build + the sharded backend
    python3 chip_smoke.py --solve-wall support   # a solve's wall, for A/Bs

Phases:
  0. device   -- the card's name, count, power limit (nvidia-smi).
  1. build    -- nvcc builds the ten kernel sources from kernels/csrc
                 (sm_90a); always runs.
  2. kernels  -- K1 pcdn_bundle (the whole support step of a real-sim
                 bundle, from one carry cloned twice, and the same bundle
                 with the search forced past its first chunk and with
                 nothing passing; two launches bit-equal), K2
                 pcdn_sparse_direction (with delta; two calls bit-equal)
                 and its sharded entries (the partials, and the scatter,
                 bit-equal to its plain version on the CPU), and K3
                 pcdn_direction (with the slab gather and delta, on a full
                 bundle and gisette's ragged last one) and its partials
                 entry, against
                 their plain PyTorch versions on the card, at the shapes
                 the solves below give them; K5's batch entry scdn_batch
                 on one real-sim SCDN batch (P_bar 8, Q 40) from a carry
                 solved by one round, with a duplicate index and a column
                 holding a duplicate row (loss deltas, alpha, w and z, two
                 calls bit-equal, and the early-exit call SCDN makes
                 bit-equal to them); K5's dense batch entry
                 scdn_dense_batch the same way on gisette's batch (P_bar
                 64, s 6,000) from a carry solved by one round, and on
                 a9a's (P_bar 8, s 8,192: the CLI's dense SCDN); K5's
                 rows entry pcdn_linesearch (off the main path since the
                 dense batch entry) at gisette's shape (64 x 6,000: the
                 kernels line's row) and on a real-sim batch's 8 rows of
                 per-coordinate deltas; K4a
                 serve_margins_dense and K4b
                 serve_margins_csc at the serve phase's shapes, and K5's
                 single row there; K6
                 flash_attention at the lm phase's prefill shape and at
                 yi-6b's and gemma-7b's head widths, tails, non-causal and
                 float32, per query row, with planted faults as controls,
                 each check naming the variant that ran (wgmma, mma,
                 f32); errors, kernel, plain and library times (CUDA
                 events), the bound, K6's TFLOP/s and share of it, its
                 mma variant's time at the prefill shape and the host time
                 of its tensor-map encodes; K6's sliding window at the
                 hybrid phase's prefill shape (recurrentgemma-2b: B 4 x
                 10 heads over 1, S 4096, D 256, window 2048, `mma`) per
                 row against the plain version, the band planted one key
                 wide as a control, the causal launch's bits unchanged,
                 timed with the band's bound, the causal launch and SDPA
                 with the band as a mask; then float32 and `wgmma` (D 128
                 and 64) with a window; K6b flash_attention_bwd
                 (from K6's out and lse, each variant's lse held to the
                 plain version's) at the train phase's shape in bf16 and
                 float32, ragged, at D 128 and 256, per row, two calls
                 bit-equal, planted faults as controls, timed with its
                 bound, the plain version and the library's backward;
                 K6b's sliding window at the hybrid train run's shape
                 (B 1 x 10 heads over 1, S 4096, D 256, window 2048,
                 `wgmma`, `simt` held beside it) per row, the band
                 planted one key wide as a control, a window of S
                 bit-equal to the causal launch, timed with the band's
                 bound, the plain version, `simt` and SDPA's backward
                 with the band as a mask; then bf16 D 256 ragged with a
                 window of 777, float32 and `wgmma` (D 128 and 64) with
                 a window; K6b at gemma-7b's train shape (B 1 x 16 heads
                 over 16, S 4096, D 256, causal) beside `simt` and SDPA's
                 backward; K6b at the moe and vlm train runs' shapes (G
                 1 at D 128; 32 heads over 8 at 4352), timed beside
                 SDPA's backward; K6 and K6b at the split hybrid's rank
                 shape (B 1 x 5 heads over 1, S 4096, D 256, window 2048:
                 G 5, `mma` and `wgmma`) per row against their plain
                 versions, timed L2-cold and warm beside the bound and
                 SDPA with the band as a mask.
  3. tune     -- the autotuner (`kernels.autotune`) at benchmarks/port/
                 bench_kernels.py's full cells (the shapes above; K1-K3
                 also in bf16): every key tuned into a cache of the run's
                 own (exhaustive up to 40 candidates, else the hillclimb),
                 a line a cell (the default's and the winner's L2-cold us,
                 the candidates measured and skipped as infeasible), each
                 winner no slower than its default, each plan other than
                 the rule's held against the plain version (the winners
                 and the runner-ups); warm caches (the winners', the
                 runner-ups') against cold from shared carries: 3 support
                 iterations, a full-scope iteration, a gisette dense SCDN
                 round (F rel 1e-4, both walls); K1 and K2 bit-equal twice
                 under each warm cache. Every other phase reads a cold
                 cache of the run's own (REPRO_AUTOTUNE_CACHE).
  4. support  -- real-sim at its published shape (57,848 x 20,958, ~139 nnz
                 a column, k_max 278) in padded-CSC, P = 32: the support
                 scope, so every bundle is one K1 launch (the traced
                 iteration must show no other device op a bundle).
  5. full     -- the same data at P = 512: the full scope, K2.
  6. dense    -- gisette at its published shape (6,000 x 5,000, dense and
                 correlated), P = 512: K3 (the traced iteration must show
                 it once a bundle, and no slab gather or matrix-vector
                 product a bundle).
  7. scdn     -- the Shotgun baseline (`core.scdn.solve`) on the same
                 real-sim data in padded-CSC, c = 4, P_bar = 8: 2 rounds
                 of 2,620 batches, each batch one launch of K5's batch
                 entry (scdn_batch) and no other kernel; one round from one
                 carry and one set of indices through it and through its
                 plain version (F rel <= 1e-4); a slice of a round traced
                 in a child process (`--baseline-profile scdn`: at most 4
                 device ops a batch); then gisette dense at P_bar = 64 for
                 up to 30 rounds through both routes (K5's dense batch
                 entry scdn_dense_batch once a batch and no other kernel,
                 and its plain version), which must agree on whether and
                 at which round the divergence guard trips; one gisette
                 round from one carry and one set of indices through both
                 (F rel <= 1e-4); a slice of gisette rounds traced in a
                 child process (`--baseline-profile scdn-dense`: at most 3
                 device ops a batch).
  8. tron     -- the TRON baseline (`core.tron.solve`) on real-sim in
                 padded-CSC for 5 outer iterations (no kernel: the
                 design's matvec / rmatvec); F finite, not rising; one
                 iteration traced in a child process.
  9. bf16     -- the support (K1), full (K2) and dense (K3) solves with the
                 design stored in bf16, 10 iterations each: the kernels'
                 launches; F against the same float32 solve, printed; F
                 against float32 from a shared iterate each iteration
                 (rel <= 1e-3, the reference's bf16 envelope) and the
                 lockstep gate.
  10. cli     -- `repro_torch.launch.solve.main` on a9a, padded-CSC,
                 --use-kernels, through the normal entry point; then
                 `--solver scdn` (dense: K5's dense batch entry),
                 `--solver scdn --layout padded_csc` (K5's batch entry),
                 `--solver tron`
                 (no kernel) and `--dtype bf16 --use-kernels` (K2).
  11. serve   -- real-sim at its published width (72,310 x 20,958, the
                 first 57,848 rows train, the other 14,462 are requests):
                 an 8-point regularization path solved on the card and
                 saved with `save_model`, then `repro_torch.launch.
                 predict.main` through K4a (dense requests) and K4b
                 (padded-CSC requests), for the c* model and the path
                 family, `--serve` with a mid-stream hot-swap, and one
                 dense chunk traced in a child process (`--chunk-profile`);
                 `--serve --route auto` without kernels: each bucket's
                 route equal to `pick_route` under the committed H100
                 table (benchmarks/port/results/BENCH_serve_h100.json),
                 beside both routes' device times.
  12. path    -- the serve phase's rows (training rows train, request
                 rows validate): `path.run_path` at P = 32 (the support
                 scope: K1 every bundle), 8 points at span 100 to KKT 1e-3
                 or 20 iterations, with record_aux and the metrics and
                 trace planes on (the files validate; K1's launch counter
                 = its launch count = the bundles run = bundle_q's count,
                 1 <= q <= 40; one `path.point` span a point; the per-point
                 walls printed); `repro_torch.launch.path.main` on the
                 training rows as .libsvm, a sweep and `--mode batch` (each
                 batch problem's F against a solo solve from its seed, rel
                 1e-4); `serve.ovr.fit_ovr` on 4 seeded classes, 5
                 iterations; the support iteration's wall with telemetry
                 off, metrics, metrics + trace and record_aux, interleaved;
                 one iteration with record_aux traced in a child process
                 (`--solve-profile support --record-aux`: K1 alone once a
                 bundle).
  13. fault   -- diagnostics and fault tolerance through the CLIs, on the
                 support cell's real-sim as .libsvm (c 4), each CLI run a
                 child process: REPRO_FAULT_PLAN puts a NaN into the
                 margins at iteration 3 of a P 64 solve (full scope: K2),
                 which rolls back and backs off to P 32 (support: K1),
                 its metrics counters = iterations x bundles of each
                 attempt; with --retries 0 the post-mortem, the
                 --diag-out report and its re-rendering by `python -m
                 repro_torch.diag.report`; a P 32 solve SIGKILLed at
                 iteration 7 with --ckpt-every 3 and resumed at 6 (F rel
                 1e-6 of an uninterrupted run and w bit-equal to it,
                 asserted),
                 its checkpoint restored on the CPU bit for bit and one
                 iteration from it through the plain versions there and
                 K1 here (F rel 1e-4); the path phase's rows swept (4
                 points, 10 iterations) with a SIGKILL after point 1 and
                 resumed; `diag.safep.certify` on the card's design (omega
                 against the CSR rows; rho at its defaults below scipy's
                 eigsh, the shortfall printed; the power iteration run
                 3000 steps with no early stop against eigsh at rel
                 1e-3); the iteration wall with the --diag-out planes and
                 with a checkpoint every 3 iterations against neither,
                 interleaved, and one snapshot's write time.
  14. sharded -- the sharded backend (`engine.sharded`) on the support
                 and full cells' real-sim and the dense cell's gisette:
                 (a) a world of 1 on NCCL with the kernels (K2's partials
                 and scatter entries, K3's partials entry), real-sim full
                 P 512 and support P 32, gisette dense P 512, 10
                 iterations each (support 3) from shared carries and partitions
                 against the local backend with the kernels (F rel
                 1e-4), the walls, the reductions a bundle, the entries'
                 launches; (b) two ranks sharing the card over gloo in a
                 torchrun child (`--sharded-ranks`), 5 iterations: (2 x
                 1) at P 512 against (a)'s carries and partitions, (1 x
                 2) the kernel route against the plain route; (c) the
                 CLIs on real-sim as .libsvm: torchrun with 2 ranks, a
                 world-1 P 32 solve SIGKILLed at 5 and resumed (w
                 bit-equal to the uninterrupted run, asserted),
                 checkpoints crossing between the local and sharded
                 backends (the restored carry's F within 1e-6 of its
                 writer's) and both resumes run.
  15. lm      -- `repro_torch.launch.serve.main` for qwen2-0.5b at full
                 width (24 layers, bf16, random weights from a seed): a
                 4096-token prefill of 4 prompts, which runs K6 once a
                 layer, then 32 greedy tokens; the same at 32 tokens (the
                 dense route: no K6). Then the prefill's logits and four
                 decode steps through K6 against its plain version, from
                 the same weights, in bf16 (three seeds) and in float32,
                 with the readings of faults planted in the plain version
                 beside them, and one prefill and one decode step traced
                 in a child process (`--lm-profile`, with --lm-profiles).
  16. train   -- LM training, qwen2-0.5b at full width, batch 4 x 4096
                 tokens: `python -m repro_torch.launch.train --full --lr
                 3e-4` for 12 steps in a child process (finite, falling
                 loss; K6 2 x 24 launches a step with remat, K6b 24; step
                 wall, tokens/s, peak memory), with a crash injected at
                 step 11 and checkpoints every 6: restored at 6, steps 6
                 to 10 run again bit-equal to the same steps before the
                 crash; one train step through K6/K6b against the plain
                 route from shared carries, float32 and bf16 (two seeds),
                 with a fault planted in the plain backward as a control;
                 one step traced in a child process (`--train-profile`,
                 with --lm-profiles).
  17. moe     -- `repro_torch.launch.serve.main` for deepseek-moe-16b at
                 full width (28 layers: a dense first layer, then 27 with
                 64 routed experts top-6 and 2 shared; bf16, random weights
                 from a seed), 4 prompts of 4096 tokens and 32 new: K6
                 once an attention layer of the prefill
                 (28, all wgmma), the capacity dispatch in every MoE layer
                 of it, every expert in decode. Then two bf16 prefills
                 bit-equal; the prefill's logits and four decode steps
                 through K6 against the plain route from the same weights,
                 in bf16 at full width and in float32 at 4 layers, with
                 the routing pinned to the kernel route's (gated) and free
                 (printed, with its flips); grok-1-314b's reduced config
                 served (a 1024-token prompt: the dense route); K6 timed at
                 the prefill's shape (B 4 x 16 heads x 4096, D 128) with
                 its bound, plain version and SDPA; one prefill and one
                 decode step traced in a child process
                 (`--family-profile`, with --lm-profiles).
  18. ssm     -- `launch.serve.main` for falcon-mamba-7b at full width (64
                 Mamba layers, d_inner 8192, d_state 16; bf16), 4 prompts
                 of 2048 tokens and 32 new: no kernel launch, finite
                 logits; in float32 at full width and 4 layers, a prefill
                 of 1024 tokens and one decode step against a prefill of
                 1025 (the gate: there is no kernel); the decode state's
                 bytes after prompts of 512 and 2048, equal; one prefill
                 traced in a child process (with --lm-profiles).
  19. hybrid  -- `launch.serve.main` for recurrentgemma-2b at full width
                 (26 layers: 8 (rec, rec, attn) triples and 2 tail rec
                 layers; bf16), 4 prompts of 4096 tokens and 32 new: K6
                 (`mma`) with its window of 2048 in each of the 8
                 attention layers of the prefill, a ring of 2048 slots in
                 decode. The bf16 gate at full depth, K6's route against
                 the plain route from shared carries and end to end, with
                 faults planted in the plain version; in float32 at 5
                 layers a prefill of 4100 tokens and 3 decode steps on the
                 ring, each against a prefill one token longer (the ring
                 filled unrolled as a control); the decode state's bytes
                 after prompts of 2048 and 4096, equal; one prefill and
                 one decode step traced in a child process (with
                 --lm-profiles).
  20. vlm     -- `launch.serve.main` for pixtral-12b at full width (40
                 layers, bf16), 256 patch embeddings ahead of 4 prompts of
                 4096 tokens, 32 new: K6 (`wgmma`, D 128, 32 heads over 8,
                 4352 positions) in each of the 40 layers. The bf16 gate
                 as the hybrid's; in float32 at 4 layers one decode step
                 against a prefill one token longer (a cache length short
                 of the patches as a control); K6 timed at the prefill's
                 shape; one prefill and one decode step traced (with
                 --lm-profiles).
  21. encdec  -- `launch.serve.main` for whisper-small at full width (12
                 + 12 layers), 1500 frames, 4 prompts of 384 tokens and 32
                 new: no kernel launch (no attention reaches 2048 keys, as
                 in the reference); the CLI's refusal past 448 target
                 positions; float32 and bf16 at full depth, a prefill and
                 one decode step against a prefill one token longer, with
                 a position one late and the cross-attention left out
                 planted as controls; both routes bit-equal; one prefill
                 and one decode step traced (with --lm-profiles).
  22. ftrain  -- training the moe, ssm, hybrid, vlm and encdec families:
                 `launch.train --full` a family (the five one after the
                 other in one child process), bf16,
                 remat, 8 steps at lr 3e-4 (falcon-mamba 16), at full
                 width with the depth cut by the child's `--family-train`
                 wrapper (recurrentgemma-2b 5 of 26 layers: a triple and
                 2 tail rec layers, 1 x 4096: K6 `mma` and K6b `wgmma`
                 with the window 2048; deepseek-moe-16b 2 of 28, 1 x
                 4096; pixtral-12b 2 of 40, 1 x 4096 text after 256
                 patches; falcon-mamba-7b 4 of 64, 1 x 2048; whisper-small
                 whole, 4 x 384): finite losses, the mean of the last 3
                 below the first, K6/K6b launches by variant, step wall,
                 tokens/s, peak under 75 GiB; whisper-small's run crashed
                 at step 6 with checkpoints every 4, its replayed steps 4-5
                 bit-equal to the same steps before the crash; each run's
                 checkpoints removed after it; one step from shared
                 carries through K6/K6b against the plain route for the
                 hybrid (one triple), moe (2 layers) and vlm (1 layer),
                 TRAIN_RTOL's bf16 limits (the hybrid's grad_norm 5e-5),
                 a fault planted in the plain backward as a control.
  23. dtrain  -- LM training over a (data, model) mesh: qwen2-0.5b at
                 full width (24 layers, bf16, remat), batch 2 x 4096,
                 `launch.train --full --data D --model-parallel M` in
                 torchrun children: (a) a world of 1 on NCCL, 4 steps,
                 bit-equal to the same command without torchrun; (b) two
                 ranks sharing the card over gloo, 4 steps at (2, 1)
                 crashed at step 3 with checkpoints every 2, losses
                 within TRAIN_RTOL's bf16 loss limit of (a)'s, the
                 replayed step 2 bit-equal to the one before the crash;
                 its step-2 checkpoint resumed at (1, 2) for 2 steps, the
                 compute split along "model" (7 of the 14 heads, G 7,
                 half of d_ff and of the vocabulary a rank), its loss at
                 step 2 within the same limit of (a)'s, its peak a rank
                 within DTRAIN_SPLIT_PEAK_GIB; (c) one float32 step at
                 full width and 2 layers from a shared carry, (2, 1) and
                 (1, 2) against (1, 1) within TRAIN_RTOL's float32
                 limits, a per-shard mean planted as a control and read
                 past them; then one float32 step a family at (1, 2)
                 against (1, 1) from a shared carry, full width, the
                 depth cut (DSPLIT:
                 deepseek-moe-16b 2 layers, falcon-mamba-7b 2,
                 recurrentgemma-2b a triple, pixtral-12b 1, whisper-small
                 2 + 2; 1 x 2048, whisper 4 x 384), TRAIN_RTOL's float32
                 limits; (d) one bf16 step of recurrentgemma-2b (a
                 triple, 1 x 4096) at (1, 2) against (1, 1), FLOCK_RTOL's
                 hybrid limits: K6 `mma` and K6b `wgmma` at G 5, D 256,
                 window 2048 on each rank; K6 and K6b in every attention
                 layer of every rank's steps; each rank's peak memory,
                 the step walls (gloo stages every collective through
                 the host) and the launches by rank printed; checkpoints
                 removed after their runs.

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
import contextlib
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"
PHASES = ("build", "kernels", "tune", "support", "full", "dense", "scdn",
          "tron", "bf16", "cli", "serve", "path", "fault", "sharded",
          "lm", "train", "moe", "ssm", "hybrid", "vlm", "encdec",
          "ftrain", "dtrain")  # in order

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12   # dense, tensor cores

# solve-phase tolerance: kernel vs plain objective after one outer
# iteration from a shared carry (f32 sums in another order)
F_RTOL = 1e-4
# kernel-phase tolerance on d/g/h/delta and K1's w and z: max |kernel -
# plain| over max |plain| (f32 reductions in another order; K4b's
# shared-memory atomics; K5's block partials)
KERNEL_RTOL = 1e-4
# K4a sums in a fixed order with no atomics: held closer
K4A_RTOL = 1e-5
# outer iterations of each solve phase (and of its lockstep check), and
# the seed of every dataset
N_OUTER = 5     # 10 before the ftrain phase
DATA_SEED = 0
# the solve phases: (design, labels) at these places of make_data's tuple,
# c, layout, P, the kernel they launch, the line-search scope
SOLVES = {"support": (0, 1, 4.0, "padded_csc", 32, "pcdn_bundle", "support"),
          "full": (0, 1, 4.0, "padded_csc", 512, "pcdn_sparse_direction",
                   "full"),
          "dense": (2, 3, 0.25, "dense", 512, "pcdn_direction", "full")}
# objective non-increase, up to f32 rounding of the 57,848-term loss sum
F_MONOTONE_RTOL = 1e-6
# bf16 storage against float32 storage, one outer iteration from a shared
# iterate: the reference's bf16 equivalence envelope
# (repro.launch.common.BF16_MIN_TOL). Free runs are printed, not held to
# it: on gisette (dense, P 512) they part by 1.8e-2 in 10 iterations
# through Armijo decisions that flip (PERF.md, section 6)
BF16_F_RTOL = 1e-3

# the scdn phase: real-sim (make_data's) in padded-CSC at the support
# solve's c, the paper's P_bar (section 5.1); SCDN_PROFILE_BATCHES of a
# round traced in a child process; gisette at P_bar 64 for the guard
SCDN_C = 4.0
SCDN_P_BAR = 8
SCDN_ROUNDS = 2
SCDN_PROFILE_BATCHES = 200
GISETTE_P_BAR = 64
GISETTE_ROUNDS = 30
# K5's batch entry against its plain version: w and z after one batch,
# max abs error over max |plain| (float32 sums in another order: a row's
# coordinates' terms in coordinate order in both, phi's sums by distinct
# row in the kernel's fixed tree); its bound, averaged over this many
# batches of a round
SCDN_WZ_RTOL = 1e-5
SCDN_BOUND_BATCHES = 100
# device ops a traced SCDN batch may show (one launch, and the round's
# clones, objective and KKT spread over its batches)
SCDN_MAX_OPS = 4
# gisette's traced slice: batches of P_bar 64, each K5's dense batch
# launch and its update launch, the round's other ops spread over them
GISETTE_PROFILE_BATCHES = 200
SCDN_DENSE_MAX_OPS = 3
TRON_OUTER = 5

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
    "scdn_batch": ("src/repro_torch/kernels/csrc/scdn_batch.cu",
                   "src/repro/kernels/pcdn_linesearch.py:62"),
    "scdn_dense_batch": ("src/repro_torch/kernels/csrc/scdn_dense_batch.cu",
                         "src/repro/kernels/pcdn_linesearch.py:62"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/attention.py:258 (no Pallas kernel: the "
        "reference's flash backward _flash_mha_bwd)"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:78"),
    # the sharded backend's entries: K3's and K2's shard-local partials
    # (the reference calls its Pallas K3/K2 with l2 = 0 for them), and
    # K2's scatter, which replaces the reference's jnp scatter of X_B d
    "pcdn_direction_partials": (
        "src/repro_torch/kernels/csrc/pcdn_direction.cu",
        "src/repro/kernels/pcdn_direction.py:68"),
    "pcdn_sparse_direction_partials": (
        "src/repro_torch/kernels/csrc/pcdn_sparse_direction.cu",
        "src/repro/kernels/pcdn_sparse_direction.py:85"),
    "pcdn_sparse_scatter": (
        "src/repro_torch/kernels/csrc/pcdn_sparse_direction.cu",
        "src/repro/engine/sharded.py:240"),
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
# --route auto through the serving loop without kernels (plain routes)
SERVE_AUTO_REQUESTS = 1000

# the path phase: `serve_data`'s training rows (the published real-sim
# shape) and its request rows as the validation split. (a) run_path at P
# 32 (auto -> the support scope: K1 every bundle), 8 points at the
# reference's default span, to KKT 1e-3 or 20 outer iterations a point,
# with record_aux and both telemetry planes on; (b) `launch.path.main` on
# the training rows written as .libsvm, a sweep and a batch; (c) fit_ovr
# on 4 classes for 5 outer iterations; then the support phase's iteration
# (its real-sim, c 4, P 32) timed with telemetry off and on,
# PATH_TIMING_ITERS iterations a reading
PATH_P = 32
PATH_POINTS = 8
PATH_TOL = 1e-3
PATH_MAX_OUTER = 20
PATH_Q = 40                # candidates the search allows (ArmijoParams)
PATH_CLI_SWEEP = ("2", "3")     # --points, --max-outer
PATH_CLI_BATCH = ("4", "5")
PATH_BATCH_RTOL = 1e-4     # batch problem F against its solo solve
PATH_OVR_CLASSES = 4
PATH_OVR_OUTER = 5
PATH_TIMING_ITERS = 20

# the sharded phase: (label, design and labels at these places of
# make_data's tuple, c, layout, P, scope), each at a world of 1 on NCCL
# for SHARDED_OUTER iterations in lockstep with the local backend (both
# with the kernels); the first SHARDED_RANK_OUTER of real-sim's full
# scope recorded for two ranks on the one card over gloo ((2 x 1) against
# them, and (1 x 2) kernel route against plain route); then the CLIs on
# real-sim as .libsvm: torchrun with two ranks, a world-1 support solve
# (P 32, c 4) SIGKILLed at SHARDED_CRASH_AT with a checkpoint every 2 and
# resumed (w bit-equal to the uninterrupted run), and checkpoints crossing
# between the local and sharded backends (the restored carry's F within
# SHARDED_CROSS_RTOL of the F its writer recorded)
SHARDED_CASES = (("real-sim full", 0, 1, 4.0, "padded_csc", 512, "full"),
                 ("real-sim support", 0, 1, 4.0, "padded_csc", 32,
                  "support"),
                 ("gisette dense", 2, 3, 0.25, "dense", 512, "full"))
SHARDED_OUTER = 10
# the support scope's cell, unfused on the sharded backend (~2.4 s an
# iteration; 10 before the hybrid, vlm and encdec phases): fewer
# lockstep iterations
SHARDED_SUPPORT_OUTER = 3
SHARDED_RANK_OUTER = 5
SHARDED_CLI_OUTER = 8
SHARDED_CRASH_AT = 5
SHARDED_CROSS_RTOL = 1e-6
SHARDED_ENTRIES = ("pcdn_sparse_direction_partials", "pcdn_sparse_scatter",
                   "pcdn_direction_partials")

# the fault phase: the support cell's real-sim (make_data's, c 4) as
# .libsvm through the port's CLIs. A NaN into the margins at iteration 3
# of a P 64 solve (4 * 64 * k_max > s: the full scope, K2) backs off to P
# 32 (the support scope, K1); the solve that is killed at iteration 7
# checkpoints every 3 (resumes at 6); the path sweep is the path phase's
# rows, killed after point 1. Resumed runs against uninterrupted ones: F
# rel 1e-6, and the resumed solve's w bit-equal (K1 and K2 sum each row's
# margin delta in a fixed order; the sweep's per-point margin refresh is
# an index_add_, whose float atomics may move z's last bits). rho against
# eigsh: rel 1e-3 for the power iteration run FAULT_POWER_STEPS steps with
# no early stop. certify at its (the reference's) defaults is held only to
# stay below the top eigenvalue, and its shortfall is printed: on this data
# the top two eigenvalues are 3e-3 apart and the start vector barely meets
# the top one, so the Rayleigh quotient sits near the second for ~1000 steps,
# where float32 noise meets the 1e-9 stop test (an H100 run: stopped at
# 278 steps, 3.0e-3 low; 3000 steps with no stop, 1.3e-6; PERF.md).
# Costs: FAULT_COST_ITERS support iterations a reading
FAULT_P = 64
FAULT_NAN_AT = 3
FAULT_MAX_OUTER = 12
FAULT_CRASH_AT = 7
FAULT_CKPT_EVERY = 3
FAULT_SOLVE_OUTER = 10
FAULT_PATH_POINTS = 4
FAULT_PATH_OUTER = 10
FAULT_RESUME_RTOL = 1e-6
FAULT_RHO_RTOL = 1e-3
FAULT_POWER_STEPS = 3000
FAULT_COST_ITERS = 10

# the tune phase: benchmarks/port/bench_kernels.py's full cells (K1-K3
# in float32 and bf16, K4a, K4b, K5's three entries) tuned into a cache
# of the run's own (CACHES["tuned"]), each winner that is not the default
# held against the plain version at the kernels phase's limits. Where
# the rule's plan wins, the tuned cache sends the solver down the rule's
# launches again, so CACHES["alt"] holds each float32 cell's runner-up
# (the fastest other plan, also held against the plain version): warm
# caches (tuned, alt) against cold from shared carries, TUNE_SUPPORT_ITERS
# support iterations (K1), one full-scope iteration (K2), one gisette
# dense SCDN round (K5's dense entry), F rel F_RTOL each; K1 and K2
# bit-equal twice under each warm cache. Every other phase, and every
# child process, reads CACHES["cold"], which nothing writes (main sets
# all three)
TUNE_REPEATS = 7
TUNE_SUPPORT_ITERS = 3
CACHES: dict = {}

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
# K6b against its plain version on the same (q, k, v, out, lse, do): dq,
# dk, dv per row (`bwd_row_rel_err`: the row's max abs error over the
# larger of its own and the median row's max |plain|). Both compute in
# float32 from the same inputs: f32 sums in another order; bf16 adds the
# output's rounding, one ulp (2^-7 of the value at most) where the two
# roundings fall apart: the limits are K6's
BWD_RTOL = FLASH_RTOL
# K6's lse (m + log l, natural units) against the plain version's
# logsumexp: the bf16 variants keep m in base 2 and sum 2^x on the
# special-function unit (relative error ~2^-22 a term): 1e-4 absolute on
# values of ~10
LSE_ATOL = 1e-4
# planted in the plain backward, held by BWD_RTOL: one key tile (keys
# 64-127) dropped from dk, the delta term left out of ds; with a window,
# the band one key too wide (a key j counts when i - j <= window)
BWD_FAULTS = ("key tile", "delta")
BWD_WINDOW_FAULT = "band"
# K6b at D 256 without a window, G 1: the kernels phase times it at this
# config's train shape (B 1 x 4096)
GEMMA_ARCH = "gemma-7b"

# the train phase: qwen2-0.5b at its published width, batch 4 x 4096
# tokens (the lm phase's prefill shape: K6 and K6b in every layer),
# TRAIN_STEPS steps of `launch.train`, a crash at TRAIN_CRASH_AT with a
# checkpoint every TRAIN_CKPT_EVERY steps (20 steps with a checkpoint
# every 5 before the hybrid, vlm and encdec phases: the crashed run
# wrote 5 checkpoints of ~6 GB and took 87 s of the phase's 182-209;
# now 2). One run since the ftrain phase: its steps up to the crash are
# the uninterrupted run's, the steps TRAIN_CKPT_EVERY .. TRAIN_CRASH_AT -
# 1 run again from the checkpoint (a separate uninterrupted run took
# 38.5 s of the phase's 150.3)
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
TRAIN_STEPS = 12
TRAIN_CRASH_AT = 11
TRAIN_CKPT_EVERY = 6
# the rate of the CLI runs and of the lockstep. launch.train's default,
# 3e-3 (the reference's, set for the reduced configs), makes the
# published width's loss climb for its first 10 steps (12.108 -> 12.58 at
# step 10, 12.24 at 19); at 3e-4 the last 5 steps' mean sits below the
# first step's loss (PERF.md, PR 24)
TRAIN_LR = 3e-4
TRAIN_SEED = 0
TRAIN_GATE_SEEDS = (0, 1)  # bf16 weights and batches the lockstep reads
# one train step through the kernels against the plain route from a
# shared carry (`train_readings`): loss and grad_norm relative, "update"
# ||new_kernel - new_plain|| / ||new_plain - carry|| over all parameters.
# float32: f32 sums in another order through 24 layers and Adam's
# division by sqrt(v); bf16: K6 rounds p to bf16 before p v and both
# routes round every layer's output to bf16, so the gradients part by
# ~1e-3 and Adam's normalised step by more where a gradient is small
# against that. On an H100 at lr 3e-4 (PR 24) the kernel route read loss
# 0, grad_norm 9.5e-8, update 1.6e-5 in float32 and at most 6.3e-6,
# 5.0e-4, 8.9e-2 in bf16 over TRAIN_GATE_SEEDS; the delta fault in the
# plain backward grad_norm 0.55 and update 0.50 / 0.54 (the loss, a
# forward reading, does not see it): the limits sit between
TRAIN_RTOL = {"float32": {"loss": 1e-6, "grad_norm": 1e-5, "update": 1e-3},
              "bfloat16": {"loss": 1e-4, "grad_norm": 2e-2,
                           "update": 0.25}}
TRAIN_FAULTS = ("delta",)

# the moe phase: deepseek-moe-16b at its published width (28 layers, 64
# routed experts top-6 and 2 shared, a dense first layer; bf16, 32.8 GB),
# the lm phase's prompt shape: 4 prompts of 4096 tokens (K6 in each of its
# 28 attention layers, D 128) and 32 new tokens; grok-1-314b (633 GB in
# bf16) at its reduced config, with a prompt under BLOCKWISE_MIN_KV (its
# head dim, 16, is no K6 variant's)
MOE_ARCH = "deepseek-moe-16b"
MOE_BATCH = 4
MOE_PROMPT = 4096
MOE_NEW = 32
MOE_DECODE_CHECK = 4      # decode steps held kernel route vs plain route
MOE_SEED = 0
MOE_F32_LAYERS = 4        # float32 at 28 layers (65.5 GB) does not fit
MOE_REDUCED_ARCH = "grok-1-314b"
MOE_REDUCED_PROMPT = 1024
# the moe model's prefill logits and decode steps through K6 against the
# plain route with the kernel route's routing replayed (`moe_agreement`,
# "pinned"). float32 at MOE_F32_LAYERS: LM_RTOL's. bf16 at 28 layers: the
# reference's expert init (w_gate and w_up at fan-in E = 64, std 1/8, not
# 1/45.3 at fan-in d) lets each MoE layer amplify its input's rounding, so
# LM_RTOL's 3e-2 holds a layer at a time (`moe_lockstep`), not end to
# end: on an H100 (PERF.md §6) the kernel route read 0.140 at the
# prefill's logits and 0.061-0.086 at the decode steps, 2.29e-2 with the
# expert weights at fan-in d (`--moe-fan-in-d`), a dropped KV tile 1.13
# and a quad lane 1.17 (MOE_E2E_FAULTS in the plain route): the limit
# sits between
MOE_E2E_RTOL = {"float32": LM_RTOL["float32"], "bfloat16": 0.2}
MOE_E2E_FAULTS = ("tile", "quad")
# the ssm phase: falcon-mamba-7b at its published width (64 Mamba layers,
# d 4096, d_inner 8192, d_state 16; bf16, 14.5 GB), 4 prompts of 2048
# tokens (4096 before the hybrid, vlm and encdec phases: the prefill,
# ~17 s at 4096 and run twice, halves; the scan is linear in S) and 32
# new tokens; no kernel on its
# path. The gate: float32 at full width and SSM_F32_LAYERS layers, one
# prompt of SSM_GATE_PROMPT tokens then one decode step against a prefill
# of one token more
SSM_ARCH = "falcon-mamba-7b"
SSM_BATCH = 4
SSM_PROMPT = 2048
SSM_NEW = 32
SSM_SEED = 0
SSM_F32_LAYERS = 4
SSM_GATE_PROMPT = 1024
SSM_STATE_PROMPTS = (512, 2048)
# the gate's limit: the two ways run the same float32 arithmetic but for
# the chunking (_chunk_size(1024) = 256, _chunk_size(1025) = 205) and
# the scan's tree, float32 sums in another order: the LM's float32 limit
SSM_RTOL = LM_RTOL["float32"]
# the hybrid phase: recurrentgemma-2b at its published width (26 layers:
# 8 (rec, rec, attn) triples and 2 tail rec layers; d 2560, 10 heads over
# 1, head_dim 256, window 2048; bf16, 7.1 GB), 4 prompts of 4096 tokens
# and 32 new: K6 (`mma`, D 256) with its window in each of the 8
# attention layers of the prefill, a ring of 2048 slots in decode. The
# float32 gate at HYBRID_F32_LAYERS layers (one triple and the two tail
# rec layers): a prefill of HYBRID_GATE_PROMPT tokens, past twice the
# window, then HYBRID_GATE_STEPS decode steps on the ring, each against
# a prefill one token longer (the LM's float32 limit: the ring's dense
# scores against K6's f32 band, float32 sums in another order)
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_BATCH = 4
HYBRID_PROMPT = 4096
HYBRID_NEW = 32
HYBRID_SEED = 0
HYBRID_F32_LAYERS = 5
HYBRID_GATE_PROMPT = 4100
HYBRID_GATE_STEPS = 3
HYBRID_STATE_PROMPTS = (2048, 4096)
# the hybrid's bf16 gate: each attention layer from shared carries within
# LM_RTOL's 3e-2; end to end the 26 bf16 layers (18 of them recurrent,
# identical in both routes) carry the 8 attention layers' one-ulp
# differences to the logits: on an H100 (PERF.md §6) the layers read
# 3.3e-3 to 4.0e-3, the free plain route's carry drifted from the kernel
# route's by 8e-3 after the first triple to 4.1e-2 after the last layer
# (a sum, not a blow-up), the logits 3.69e-2 to 4.21e-2; the planted
# "near tile" 0.197 and "quad" 1.15 end to end: the limit sits between
HYBRID_E2E_RTOL = 0.1
# the vlm phase: pixtral-12b at its published width (40 layers, d 5120,
# 32 heads over 8, D 128; bf16, 24.5 GB), 256 patch embeddings ahead of 4
# prompts of 4096 tokens (4352 positions: K6 `wgmma` at D 128, G 4 in
# each of the 40 layers) and 32 new; the float32 gate at VLM_F32_LAYERS
# layers, one decode step against a prefill one token longer
VLM_ARCH = "pixtral-12b"
VLM_BATCH = 4
VLM_PROMPT = 4096
VLM_NEW = 32
VLM_SEED = 0
VLM_F32_LAYERS = 4
# the encdec phase: whisper-small at its published width (12 encoder and
# 12 decoder layers, d 768; bf16), 1500 frames and 4 prompts of 384
# tokens with 32 new (416 of its 448 target positions): no attention
# reaches BLOCKWISE_MIN_KV keys, so no kernel launches, as in the
# reference. Its gates: a prefill of ENCDEC_GATE_PROMPT tokens and one
# decode step against a prefill one token longer, float32 and bf16 at
# full depth (bf16: the LM's limit, both ways rounding every layer)
ENCDEC_ARCH = "whisper-small"
ENCDEC_BATCH = 4
ENCDEC_PROMPT = 384
ENCDEC_NEW = 32
ENCDEC_SEED = 0
ENCDEC_GATE_PROMPT = 383
# planted in the encdec decode step, held by its gates: the sinusoid of
# the next position (one late), the cross-attention's branch left out
ENCDEC_FAULTS = ("position", "cross")
# the ftrain phase: one `launch.train --full` run a family at its
# published width, bf16, remat on, at TRAIN_LR, the depth cut by the
# smoke's child wrapper (`--family-train`) to what one card holds beside
# AdamW's float32 moments (~20 bytes a parameter at the step's peak):
# arch -> (layers, or 0 for the published depth, batch, seq, steps). The
# hybrid's 5 of 26 layers are a (rec, rec, attn) triple and 2 tail rec
# layers; moe's 2 of 28 the dense first layer and a MoE layer (4 took
# ~25 s more: their checkpoint 22.7 GB, not 10.9; vlm's 4 24.3, not
# 18.9, ~11 s); vlm's seq
# is its text, after 256 patches (4352 positions); whisper-small trains
# whole. A checkpoint is 10 bytes a parameter (bf16 params, float32
# moments; the embeddings most of it), written at ~0.5 GB/s, and a call
# may write 45 GiB to the machine's disk: at 8 layers (2.01 B
# parameters) the hybrid's crashed run held two 20 GB checkpoints, at 5
# (1.75 B) two of 17.5 GB. falcon-mamba trains 16 steps: over 8 its losses moved
# less than one batch's noise (H100: at 1 x 2048 11.5792 first, 11.5798
# the last 3's mean; at 2 x 2048 11.5596, 11.5842), over 16 the last
# 3's mean is 11.5525
FTRAIN = {HYBRID_ARCH: (5, 1, 4096, 8),
          MOE_ARCH: (2, 1, 4096, 8),
          VLM_ARCH: (2, 1, 4096, 8),
          SSM_ARCH: (4, 1, 2048, 16),
          ENCDEC_ARCH: (0, 4, 384, 8)}
FTRAIN_LABEL = {HYBRID_ARCH: "hybrid", MOE_ARCH: "moe", VLM_ARCH: "vlm",
                SSM_ARCH: "ssm", ENCDEC_ARCH: "encdec"}
# FTRAIN_CRASH_ARCH's run crashes at FTRAIN_CRASH_AT with a checkpoint
# every FTRAIN_CKPT_EVERY steps: its steps up to the crash are an
# uninterrupted run's, and the replayed steps must equal them bit for bit.
# whisper-small's (a 2.8 GB checkpoint: its enc_layers / dec_layers
# tree), for the whole run's time: the hybrid's crashed run (two 17.5 GB
# checkpoints and a restore) took 79.1 s of ftrain's 206.2 on an H100
# (PERF.md §4); the hybrid's triples / tail_rec<j> restore stays held on
# the CPU (tests/test_torch_train_families_cli.py)
FTRAIN_CRASH_ARCH = ENCDEC_ARCH
FTRAIN_CKPT_EVERY = 4
FTRAIN_CRASH_AT = 6
FTRAIN_PEAK_GIB = 75.0
# the caching allocator's setting for the ftrain runs: with fixed
# segments the hybrid's run failed at step 6 on a 3.91 GiB block (its
# float32 logits over the 256,000-token vocabulary) with 38.65 GiB
# allocated and 37.26 GiB reserved but free between blocks
FTRAIN_ALLOC = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
# the lockstep a family (hybrid, moe, vlm): one train step through K6/K6b
# against the plain route from a shared carry, at the smallest depth
# that holds an attention layer (the hybrid's one triple, moe's dense
# first layer and one MoE layer, one vlm layer), bf16, the train run's
# batch and seq; the control planted in the plain route's backward: the
# hybrid's band one key too wide, moe's and vlm's delta term left out
FLOCK_LAYERS = {HYBRID_ARCH: 3, MOE_ARCH: 2, VLM_ARCH: 1}
FLOCK_FAULT = {HYBRID_ARCH: "band", MOE_ARCH: "delta", VLM_ARCH: "delta"}
# the lockstep's limits: TRAIN_RTOL's bf16 ones, with a grad_norm limit
# between the kernel route's reading and the control's. On an H100 (700
# W), grad_norm and update rel: the hybrid's kernel route 1.03e-5 and
# 4.20e-2, the band one key wide 2.36e-4 and 3.63e-2 (one pair more a
# row past the window moves the gradient's norm, not Adam's normalised
# step past its bf16 noise); moe's kernel route 1.53e-4 and 8.04e-2 with
# the plain routes replaying its experts (`moe_routing`; its routing
# free, 1.69e-4 and 0.188 with the loss 1.05e-4 apart: top-k flips), the
# delta term dropped 1.18e-2 and 0.106; vlm's kernel route 1.10e-5 and
# 2.72e-2, the delta term dropped 3.31e-3 and 5.44e-2
FLOCK_RTOL = {HYBRID_ARCH: {**TRAIN_RTOL["bfloat16"], "grad_norm": 5e-5},
              MOE_ARCH: {**TRAIN_RTOL["bfloat16"], "grad_norm": 2e-3},
              VLM_ARCH: {**TRAIN_RTOL["bfloat16"], "grad_norm": 5e-4}}
# the dtrain phase: the train phase's qwen2-0.5b at its published width
# (bf16, remat, TRAIN_LR) over a (data, model) mesh, `launch.train --data
# D --model-parallel M` in torchrun children, batch DTRAIN_BATCH x
# DTRAIN_SEQ. (a) a world of 1 on NCCL runs DTRAIN_ONE_STEPS steps, and
# the same command without torchrun must give its losses bit for bit;
# (b) two ranks sharing the card over gloo: (2, 1) for DTRAIN_STEPS
# steps with a crash at DTRAIN_CRASH_AT and a checkpoint every
# DTRAIN_CKPT_EVERY, its losses within TRAIN_RTOL["bfloat16"]'s loss
# limit of (a)'s and the steps replayed from the checkpoint (from
# DTRAIN_RESUME_AT) bit-equal to the same steps before the crash; then
# (1, 2) resumes that run's checkpoint at DTRAIN_RESUME_AT (the later
# one removed), its loss at that step within the same limit of (a)'s.
# The crashed run holds its own replay, as ftrain's does. The rates of
# steps 0-2 do not depend on --steps (warm-up 2, then the cosine's first
# value), and a step's loss is taken before its update, so the resumed
# run's first loss reads against (a)'s. (c) one float32 step at full
# width and DTRAIN_F32_LAYERS layers from a shared carry, (2, 1)
# and (1, 2) against (1, 1), TRAIN_RTOL["float32"], with a planted
# control: each shard's loss its own mean in place of its share of the
# batch's. The two-rank child starts with (a) and waits, its process
# group up, until this process has run (a) and its command: no two runs
# share the card. The restores (the crash's, the resume's) are held to
# RESTORE_RATIO on every rank
DTRAIN_BATCH = 2
DTRAIN_SEQ = 4096
DTRAIN_STEPS = 4
DTRAIN_ONE_STEPS = DTRAIN_STEPS
DTRAIN_CKPT_EVERY = 2
DTRAIN_CRASH_AT = 3
DTRAIN_RESUME_AT = 2
DTRAIN_F32_LAYERS = 2
DTRAIN_MESHES = ((2, 1), (1, 2))
DTRAIN_FAULT = "per-shard mean"
DTRAIN_GO_S = 300       # how long the two-rank child waits for (a)
# the (1, 2) run resumes the (2, 1) checkpoint for 2 steps: the second's
# wall is the split step's (the first's holds its warm-up)
DTRAIN_RESUME_STEPS = 2
# (c) beyond qwen2 and (d): one step a family at (1, 2) against (1, 1)
# from a shared carry (`split_lockstep`), the published width with the
# depth cut, arch -> (layers, batch, seq); whisper's layers are its
# encoder's and its decoder's, 4 x 384 (no attention reaches 2048 keys,
# as in ftrain); the others 1 x 2048, where K6 / K6b run their float32
# variants. (d): the hybrid in bf16 at one triple, 1 x 4096: each rank
# attends with 5 of the 10 heads over the one kv head, K6 `mma` and K6b
# `wgmma` at G 5, D 256, window 2048
DSPLIT = {MOE_ARCH: (2, 1, 2048), SSM_ARCH: (2, 1, 2048),
          HYBRID_ARCH: (3, 1, 2048), VLM_ARCH: (1, 1, 2048),
          ENCDEC_ARCH: (2, 4, 384)}
DSPLIT_BF16 = (HYBRID_ARCH, 3, 1, 4096)
# the peak a rank that the split (1, 2) qwen2 run must stay under (on an
# H100 27.81 GiB with the state split and the compute whole; 11.79 split)
DTRAIN_SPLIT_PEAK_GIB = 22.0
# a restore on the card adds the state it restores and nothing more: what
# it adds to the device's allocation at its peak stays within
# RESTORE_RATIO of that state's bytes there (`launch.train`'s
# `restore_bytes_by_rank`). Before PR 28 the restore's template was
# stacked from the live leaves, a second copy of the state on the card
RESTORE_RATIO = 1.1
# the band planted in K6's plain version: a key j counts when i - j <=
# window (one key too many a row past the window)
WINDOW_FAULT = "band"
# planted in K6's plain version for the hybrid and vlm gates: the keys 64
# to 127 places below each row's own dropped (a kernel skipping the KV
# tile next to the diagonal: with a window, FLASH_FAULTS' "tile", keys 64
# to 127 absolute, leaves the last positions untouched), and "quad"
FAMILY_FAULTS = ("near tile", "quad")
NEAR_TILE_FAULT = FAMILY_FAULTS[0]


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


def _port_bench(name: str):
    """A module of benchmarks/port (the kernels' work counts, the kernel
    benchmark's cells), imported from this checkout."""
    import importlib
    bench = str(ROOT / "benchmarks" / "port")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    return importlib.import_module(name)


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" | "operations"), `benchmarks/port/work.py`'s bound:
    the kernels line and bench_kernels' cells share it and its counts."""
    return _port_bench("work").bound(nbytes, nops, ops_per_s)


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float(torch.max(torch.abs(got.float() - want.float())))
    scale = float(torch.max(torch.abs(want.float())))
    return err, err / max(scale, 1e-30)


def logits_rel(torch, cfg, got, want) -> float:
    """rel_err's relative reading over the vocabulary's logits: the pad
    columns past vocab_size (whisper's 51,865 padded to 51,968) hold
    -1e9 in both and would set the scale."""
    V = cfg.vocab_size
    return rel_err(torch, got[..., :V], want[..., :V])[1]


def row_rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, the largest over rows (all dims but the last) of
    the row's max abs error over its max |want|)."""
    err = torch.abs(got.float() - want.float()).amax(dim=-1)
    scale = torch.abs(want.float()).amax(dim=-1).clamp_min(1e-30)
    return float(err.max()), float((err / scale).max())


# -- data -----------------------------------------------------------------

def make_realsim(seed: int):
    """real-sim at its published shape, padded-CSC: (csc, y)."""
    from repro_torch.data import make_sparse_classification
    csc, y, _ = make_sparse_classification(57_848, 20_958, nnz_per_col=278,
                                           seed=seed)
    return csc, y


def make_data(seed: int):
    from repro_torch.data import paper_like
    t0 = time.perf_counter()
    csc, y_rs = make_realsim(seed)
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
        ws = launch.workspace
        reset = bool(torch.all(ws[:s] == 2 ** 31 - 1)) and \
            bool(torch.all(ws[s:2 * s] == 0)) and \
            bool(torch.all(ws[2 * s:2 * s + R] == -1))
        # a second launch on the same inputs: bit-equal (fixed-order sums)
        w_2, z_2 = w.clone(), z.clone()
        launch_2 = ops.BundleLaunch(design.col_rows, design.col_vals,
                                    sparse.y, alphas, 4.0, P, 1, sigma=sigma)
        ops.pcdn_bundle(launch_2, w_2, z_2, idx, 0)
        torch.cuda.synchronize()
        same = (torch.equal(w_2, w_k) and torch.equal(z_2, z_k) and
                torch.equal(launch_2.n_steps, launch.n_steps) and
                torch.equal(launch_2.alpha, launch.alpha))
        log(f"[kernels] pcdn_bundle {label}: P={P} K={K} s={s} R={P * K} "
            f"live rows {n_live} Q={Q} (cluster {launch.plan.cluster} x "
            f"{ops.BUNDLE_THREADS} threads, {launch.plan.nseg} warps a "
            f"column, chunk {ops.BUNDLE_CHUNK}): w err {e_w[0]:.3e} (rel "
            f"{e_w[1]:.2e}), z err {e_z[0]:.3e} (rel {e_z[1]:.2e}), alpha "
            f"{a_k} vs {a_p}, n_steps {q_k} vs {int(q_p)}; outside the "
            f"bundle bit-equal {kept}; workspace reset {reset}; two launches "
            f"bit-equal {same}; tolerance rel {KERNEL_RTOL}, alpha/n_steps "
            f"equal")
        assert e_w[1] <= KERNEL_RTOL and e_z[1] <= KERNEL_RTOL, (e_w, e_z)
        assert a_k == float(a_p) and q_k == int(q_p), (a_k, a_p, q_k, q_p)
        assert kept and reset and same, (kept, reset, same)
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
    all_steps = launch.n_steps.tolist()
    n_steps = [q_t for q_t in all_steps if q_t]
    r["bound"] = bound(*_port_bench("work").bundle_work(
        torch, design.col_rows, design.col_vals.element_size(), bundles,
        all_steps, n, s))
    log(f"[kernels] pcdn_bundle over the {len(n_steps)} timed bundles: mean "
        f"n_steps {sum(n_steps) / len(n_steps):.3f}, bound "
        f"{r['bound'][0] * 1e3:.4f} us ({r['bound'][1]})")
    out["pcdn_bundle"] = r

    # K2 at P = 512 (full scope): the loss factors and delta inside
    idx = B.partition(gen, n, 512, device=dev)[0]
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    args = (slab.rows, slab.vals, z, sparse.y, w_B, 4.0)
    got = ops.pcdn_sparse_direction(*args)
    again = ops.pcdn_sparse_direction(*args)
    want = ref.pcdn_sparse_direction_ref(*args)
    errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    P, K = slab.rows.shape
    log(f"[kernels] pcdn_sparse_direction P={P} K={K} s={s} ("
        f"{ops.sparse_direction_warps(K)} warps a column): "
        + ", ".join(f"{nm} err {e[0]:.3e} (rel {e[1]:.2e})"
                    for nm, e in zip(("d", "g", "h", "delta"), errs))
        + f"; two calls bit-equal {same}; tolerance rel {KERNEL_RTOL}")
    assert all(e[1] <= KERNEL_RTOL for e in errs), errs
    assert same
    top = device_ops(torch, lambda: ops.pcdn_sparse_direction(*args))
    log(f"[kernels] pcdn_sparse_direction, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    out["pcdn_sparse_direction"] = dict(
        max_abs_err=max(e[0] for e in errs),
        **timings(torch, lambda: ops.pcdn_sparse_direction(*args),
                  lambda: ref.pcdn_sparse_direction_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.pcdn_sparse_direction(
            *args), 200),
        bound=bound(*_port_bench("work").sparse_direction_work(
            torch, slab.rows, s)), library_ms=None)
    out.update(sharded_entry_checks(torch, slab, z, sparse.y, got[0], s,
                                    flush))

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
    P = idx.shape[0]
    n_live = int((idx < nd).sum())
    out["pcdn_direction"] = dict(
        max_abs_err=max(errs),
        **timings(torch, lambda: ops.pcdn_direction(*args),
                  lambda: ref.pcdn_direction_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.pcdn_direction(*args),
                              200),
        bound=bound(*_port_bench("work").direction_work(
            torch, idx, nd, s, XT.element_size())), library_ms=None)
    # K3's partials entry (the sharded dense step), the same bundle
    pargs = (XT, idx, zd, dense.y, 0.25)
    out["pcdn_direction_partials"] = entry_check(
        torch, "pcdn_direction_partials",
        lambda: ops.pcdn_direction_partials(*pargs),
        lambda: ref.pcdn_direction_partials_ref(*pargs), flush,
        f"s={s} P={P} (live {n_live}; K3's plan)",
        # the live columns once, z and y, idx, g and h; ~5 a value
        bound(n_live * s * XT.element_size() + 2 * s * 4 + P * 4 + 2 * P * 4,
              5 * s * n_live))
    # K5's rows entry: the row's numbers at gisette's shape, the dense SCDN
    # path whose launches the row counts; real-sim's and the one-row
    # serve-shape check kept beside them
    real_sim = linesearch_check(torch, sparse, w, z, gen, flush)
    out["pcdn_linesearch"] = linesearch_check(
        torch, dense, wd, zd, gen, flush, P=GISETTE_P_BAR, label="gisette")
    out["pcdn_linesearch"]["real_sim"] = real_sim
    out["scdn_batch"] = scdn_batch_check(torch, sparse, gen, flush)
    out["scdn_dense_batch"] = scdn_dense_batch_check(torch, dense, gen,
                                                     flush)
    serve_out = serve_kernel_checks(torch, serve, flush)
    out["pcdn_linesearch"]["one_row"] = serve_out.pop("pcdn_linesearch row")
    out.update(serve_out)
    out.update(flash_kernel_checks(torch, flush))
    out.update(flash_bwd_checks(torch, flush))
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
    log(f"[kernels] pcdn_linesearch above is at gisette's shape "
        f"({GISETTE_P_BAR} x 6000); at real-sim's ({SCDN_P_BAR} x 57848): "
        f"device {real_sim['ms'] * 1e3:.2f} us L2-cold, "
        f"{real_sim['warm_ms'] * 1e3:.2f} us L2-warm; plain version device "
        f"{real_sim['plain_ms'] * 1e3:.2f} us; the wrapper's enqueue "
        f"{real_sim['enqueue_us']:.2f} us; bound "
        f"{real_sim['bound'][0] * 1e3:.3f} us ({real_sim['bound'][1]}) on "
        f"{card}")
    return out


def entry_check(torch, name, kernel, plain, flush, shape: str, bnd,
                library=None) -> dict:
    """A kernel entry against its plain version (rel KERNEL_RTOL), two
    calls bit-equal, and its timings."""
    got, again, want = kernel(), kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[kernels] {name} {shape}: "
        + ", ".join(f"err {e[0]:.3e} (rel {e[1]:.2e})" for e in errs)
        + f"; two calls bit-equal {same}; tolerance rel {KERNEL_RTOL}")
    assert all(e[1] <= KERNEL_RTOL for e in errs), errs
    assert same
    return dict(max_abs_err=max(e[0] for e in errs),
                **timings(torch, kernel, plain, flush),
                enqueue_us=enqueue_us(torch, kernel, 200), bound=bnd,
                library_ms=(None if library is None
                            else device_ms(torch, library, 100, flush)))


def sharded_entry_checks(torch, slab, z, y, d, s, flush) -> dict:
    """K2's two sharded entries at the full-scope real-sim bundle: the
    partials over the slab, and the scatter of K2's own d, whose plain
    version on the CPU (index_add_ in entry order) it equals bit for
    bit. The scatter's library call: one index_add_ of the products."""
    from repro_torch.kernels import ops, ref
    P, K = slab.rows.shape
    valid = slab.rows < s
    n_live = int(valid.sum())
    n_rows = int(torch.unique(slab.rows[valid]).numel())
    out = {"pcdn_sparse_direction_partials": entry_check(
        torch, "pcdn_sparse_direction_partials",
        lambda: ops.pcdn_sparse_direction_partials(slab.rows, slab.vals, z,
                                                   y, 4.0),
        lambda: ref.pcdn_sparse_direction_partials_ref(slab.rows, slab.vals,
                                                       z, y, 4.0), flush,
        f"P={P} K={K} s={s}",
        # the slab, z/y at its distinct rows, g and h; ~20 a live entry
        bound(P * K * 8 + n_rows * 8 + 2 * P * 4, 20 * n_live))}
    cpu = ref.pcdn_sparse_scatter_ref(slab.rows.cpu(), slab.vals.cpu(),
                                      d.cpu(), s)
    exact = torch.equal(ops.pcdn_sparse_scatter(slab.rows, slab.vals, d,
                                                s).cpu(), cpu)
    log(f"[kernels] pcdn_sparse_scatter equals its plain version on the "
        f"CPU bit for bit: {exact}")
    assert exact
    flat = torch.where(valid, slab.rows, s).reshape(-1).long()
    prod = (slab.vals * d[:, None]).reshape(-1)
    out["pcdn_sparse_scatter"] = entry_check(
        torch, "pcdn_sparse_scatter",
        lambda: ops.pcdn_sparse_scatter(slab.rows, slab.vals, d, s),
        lambda: ref.pcdn_sparse_scatter_ref(slab.rows, slab.vals, d, s),
        flush, f"P={P} K={K} s={s}",
        # the slab and d read, the (s,) delta written; 2 a live entry
        bound(P * K * 8 + P * 4 + s * 4, 2 * n_live),
        library=lambda: torch.zeros((s + 1,), device=d.device).index_add_(
            0, flat, prod))
    return out


def linesearch_check(torch, prob, w, z, gen, flush, P=SCDN_P_BAR,
                     label="real-sim") -> dict:
    """K5's rows entry at an SCDN batch's shape: P random features from the
    carry (w, z), their (P, s) per-coordinate margin deltas (on real-sim's
    padded-CSC layout the first s columns of a (P, s + 1) buffer; on
    gisette's dense layout, the dense SCDN path's input, all live) and the
    Q = 40 candidates, against the plain version; timed, with the bound
    counted from these deltas."""
    from repro_torch.core import bundles as B
    from repro_torch.core.direction import newton_direction
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.kernels import ops, ref

    design = prob.design
    dev = z.device
    idx = torch.randint(0, prob.n_features, (P,), generator=gen,
                        dtype=torch.int32).to(dev)
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    g, h = prob.bundle_grad_hess(z, slab, w_B)
    deltas = design.slab_coordinate_deltas(slab, newton_direction(g, h, w_B))
    alphas = candidate_alphas(ArmijoParams(), torch.float32, dev)
    args = (z, deltas, prob.y, alphas)
    got = ops.pcdn_linesearch(*args)
    want = ref.pcdn_linesearch_ref(*args)
    torch.cuda.synchronize()
    e = rel_err(torch, got, want)
    P, s = deltas.shape
    Q = alphas.shape[0]
    live = deltas != 0
    n_live = int(live.sum())
    rows_live = int(live.any(dim=0).sum())
    log(f"[kernels] pcdn_linesearch {label} P={P} s={s} (row stride "
        f"{deltas.stride(0)}) Q={Q}, live (row, sample) pairs {n_live} "
        f"({n_live / (P * s):.5f} of the rows; per row "
        f"{live.sum(dim=1).tolist()}), {rows_live} samples live in any "
        f"row: err {e[0]:.3e} (rel {e[1]:.2e}), tolerance rel "
        f"{KERNEL_RTOL}; {ops.linesearch_blocks(s, P, ops._sm_count(dev))} "
        f"blocks a row")
    assert e[1] <= KERNEL_RTOL, e
    assert got.shape == (P, Q)
    return dict(
        max_abs_err=e[0],
        **timings(torch, lambda: ops.pcdn_linesearch(*args),
                  lambda: ref.pcdn_linesearch_ref(*args), flush),
        enqueue_us=enqueue_us(torch, lambda: ops.pcdn_linesearch(*args),
                              200),
        bound=bound(*_port_bench("work").linesearch_work(torch, deltas, Q)),
        library_ms=None)


def scdn_batch_check(torch, prob, gen, flush) -> dict:
    """K5's batch entry at the scdn phase's shape: real-sim, P_bar 8, Q 40.
    A carry solved by one SCDN round from 0, then one batch that holds a
    duplicate index and a column with a duplicate row (of a coordinate
    with w_j != 0, so its d is likely != 0), through the kernel (with the
    (P, Q) loss deltas, twice: the same bits; and without them, the
    early-exit branch SCDN runs: the same bits as with them) and through
    `ref.scdn_batch_ref` from clones of the carry: alpha equal, loss deltas
    rel <= 1e-4, w and z rel <= 1e-5. Timed as the round calls it (each
    call the next batch of a round, on a carry the calls evolve), with the
    bound counted from the plain version's run over the same batches."""
    from repro_torch.core import scdn
    from repro_torch.kernels import ops, ref

    dev = torch.device(DEVICE)
    design = prob.design
    n, s, K = prob.n_features, prob.n_samples, design.k_max
    round_ = scdn.make_round(prob, scdn.SCDNConfig(P_bar=SCDN_P_BAR))
    launch = round_.launch()
    w, z, _, f, _ = round_(torch.zeros((n,), device=dev),
                           torch.zeros((s,), device=dev), gen)
    assert bool(torch.isfinite(f)) and bool(torch.all(torch.isfinite(z)))
    rows = design.col_rows.cpu().numpy()
    w_np = w.cpu().numpy()
    dup = [j for j in np.flatnonzero(w_np)
           if np.unique(rows[j][rows[j] < s]).size < int((rows[j] < s).sum())]
    assert dup, "no column of the carry's support holds a duplicate row"
    idx = torch.randint(0, n, (SCDN_P_BAR,), generator=gen,
                        dtype=torch.int32)
    idx[0] = int(dup[0])
    idx[3] = idx[1]                                   # a duplicate index
    idx = idx.to(dev)
    P, Q = SCDN_P_BAR, launch.plan.Q
    runs = []
    for _ in range(2):
        w_k, z_k = w.clone(), z.clone()
        a_k = torch.empty((P,), device=dev)
        lo_k = torch.empty((P, Q), device=dev)
        ops.scdn_batch(launch, w_k, z_k, idx, a_k, lo_k)
        runs.append((w_k, z_k, a_k, lo_k))
    # the branch SCDN runs: no loss deltas, the search stops at the first
    # pass that holds a passing candidate
    w_e, z_e = w.clone(), z.clone()
    a_e = torch.empty((P,), device=dev)
    ops.scdn_batch(launch, w_e, z_e, idx, a_e)
    w_p, z_p = w.clone(), z.clone()
    a_p, lo_p = ref.scdn_batch_ref(design.col_rows, design.col_vals, idx,
                                   w_p, z_p, prob.y, launch.alphas, prob.c)
    torch.cuda.synchronize()
    w_k, z_k, a_k, lo_k = runs[0]
    e_lo = rel_err(torch, lo_k, lo_p)
    e_w = rel_err(torch, w_k, w_p)
    e_z = rel_err(torch, z_k, z_p)
    e_we = rel_err(torch, w_e, w_p)
    e_ze = rel_err(torch, z_e, z_p)
    same = all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
    same_early = (torch.equal(w_e, w_k) and torch.equal(z_e, z_k)
                  and torch.equal(a_e, a_k))
    live_d = int(torch.count_nonzero(lo_p.abs().sum(dim=1)))
    log(f"[kernels] scdn_batch P={P} k_max={K} s={s} Q={Q} (cluster "
        f"{launch.plan.cluster} x {ops.SCDN_THREADS} threads, "
        f"{launch.plan.cpc} coordinate a CTA, {launch.plan.smem_bytes} B "
        f"shared) on a carry after one round (F {float(f):.6f}), idx "
        f"{idx.tolist()} (duplicate index {int(idx[1])}, column "
        f"{int(dup[0])} with a duplicate row; {live_d} coordinates with d "
        f"!= 0): loss deltas err {e_lo[0]:.3e} (rel {e_lo[1]:.2e}), w err "
        f"{e_w[0]:.3e} (rel {e_w[1]:.2e}), z err {e_z[0]:.3e} (rel "
        f"{e_z[1]:.2e}), alpha {a_k.tolist()} vs {a_p.tolist()}; two calls "
        f"bit-equal {same}; without loss deltas (early exit): w rel "
        f"{e_we[1]:.2e}, z rel {e_ze[1]:.2e}, alpha {a_e.tolist()}, "
        f"bit-equal to the full scan {same_early}; tolerance rel "
        f"{KERNEL_RTOL} (loss deltas), {SCDN_WZ_RTOL} (w, z), alpha equal")
    assert torch.equal(a_k, a_p), (a_k, a_p)
    assert torch.equal(a_e, a_p), (a_e, a_p)
    assert e_lo[1] <= KERNEL_RTOL, e_lo
    assert e_w[1] <= SCDN_WZ_RTOL and e_z[1] <= SCDN_WZ_RTOL, (e_w, e_z)
    assert e_we[1] <= SCDN_WZ_RTOL and e_ze[1] <= SCDN_WZ_RTOL, (e_we, e_ze)
    assert same
    assert same_early
    top = device_ops(torch, lambda: ops.scdn_batch(launch, w_k, z_k, idx,
                                                   a_k))
    log(f"[kernels] scdn_batch, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    assert sum(c for _, c, _ in top) == 1, top

    # timed as the round calls it: each call the next batch of a round
    batches = torch.randint(0, n, (round_.n_batches, P), generator=gen,
                            dtype=torch.int32).to(dev).unbind(0)
    alpha_buf = torch.empty((P,), device=dev)

    def stepper(fn):
        wc, zc, it = w.clone(), z.clone(), [0]

        def call():
            t = it[0] % len(batches)
            it[0] += 1
            fn(wc, zc, batches[t])
        return call

    def plain(wc, zc, idx_t):
        ref.scdn_batch_ref(design.col_rows, design.col_vals, idx_t, wc, zc,
                           prob.y, launch.alphas, prob.c)

    k5 = stepper(lambda wc, zc, idx_t: ops.scdn_batch(launch, wc, zc, idx_t,
                                                      alpha_buf))
    r = dict(max_abs_err=max(e_lo[0], e_w[0], e_z[0]),
             **timings(torch, k5, stepper(plain), flush),
             enqueue_us=enqueue_us(torch, k5, 200), library_ms=None)
    # the bound, over the round's first SCDN_BOUND_BATCHES batches from the
    # carry (the plain version's run)
    r["bound"] = bound(*_port_bench("work").scdn_batch_work(
        torch, launch, w, z, batches[:SCDN_BOUND_BATCHES]))
    log(f"[kernels] scdn_batch over the round's first {SCDN_BOUND_BATCHES} "
        f"batches: bound {r['bound'][0] * 1e3:.4f} us ({r['bound'][1]})")
    return r


def dense_batch_agreement(torch, prob, P, gen, label: str) -> dict:
    """K5's dense batch entry on one batch of P coordinates of `prob` (a
    dense problem) from a carry solved by one SCDN round from 0 through
    the kernel, the batch holding a duplicate index: the kernel with the
    (P, Q) loss deltas twice (the same bits) and without them (the
    early-exit search SCDN runs: the same bits as with them), against
    `ref.scdn_dense_batch_ref` from clones of the carry: alpha equal, loss
    deltas rel <= KERNEL_RTOL, w and z rel <= SCDN_WZ_RTOL. -> the round,
    its launch, the carry and the largest error."""
    from repro_torch.core import scdn
    from repro_torch.kernels import ops, ref

    dev = torch.device(DEVICE)
    n, s = prob.n_features, prob.n_samples
    round_ = scdn.make_round(prob, scdn.SCDNConfig(P_bar=P))
    launch = round_.launch()
    w, z, _, f, _ = round_(torch.zeros((n,), device=dev),
                           torch.zeros((s,), device=dev), gen)
    assert bool(torch.isfinite(f)) and bool(torch.all(torch.isfinite(z)))
    idx = torch.randint(0, n, (P,), generator=gen, dtype=torch.int32)
    idx[-1] = idx[1]                                  # a duplicate index
    idx = idx.to(dev)
    Q = launch.plan.Q
    runs = []
    for _ in range(2):
        w_k, z_k = w.clone(), z.clone()
        a_k = torch.empty((P,), device=dev)
        lo_k = torch.empty((P, Q), device=dev)
        ops.scdn_dense_batch(launch, w_k, z_k, idx, a_k, lo_k)
        runs.append((w_k, z_k, a_k, lo_k))
    w_e, z_e = w.clone(), z.clone()
    a_e = torch.empty((P,), device=dev)
    ops.scdn_dense_batch(launch, w_e, z_e, idx, a_e)
    w_p, z_p = w.clone(), z.clone()
    a_p, lo_p = ref.scdn_dense_batch_ref(
        *launch.design_args, idx, w_p, z_p, launch.y, launch.alphas,
        launch.c, kind=launch.kind, sigma=launch.sigma, gamma=launch.gamma,
        l2=launch.l2)
    torch.cuda.synchronize()
    w_k, z_k, a_k, lo_k = runs[0]
    e_lo = rel_err(torch, lo_k, lo_p)
    e_w = rel_err(torch, w_k, w_p)
    e_z = rel_err(torch, z_k, z_p)
    e_we = rel_err(torch, w_e, w_p)
    e_ze = rel_err(torch, z_e, z_p)
    same = all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
    same_early = (torch.equal(w_e, w_k) and torch.equal(z_e, z_k)
                  and torch.equal(a_e, a_k))
    moved = int(torch.count_nonzero(lo_p.abs().sum(dim=1)))
    plan = launch.plan
    log(f"[kernels] scdn_dense_batch {label} P={P} s={s} n={n} Q={Q} "
        f"(plan: {plan.clusters} clusters of {plan.cluster} x "
        f"{ops.SCDN_DENSE_THREADS} threads, {plan.cpc} coordinate(s) a "
        f"cluster, {plan.sl} rows a CTA, resident {plan.resident}, tile "
        f"{plan.tile}, {plan.smem_bytes} B shared) on a carry after one "
        f"round (F {float(f):.6f}), duplicate index {int(idx[1])}, {moved} "
        f"coordinates with d != 0, alphas {sorted(set(a_p.tolist()))}: "
        f"loss deltas err {e_lo[0]:.3e} (rel {e_lo[1]:.2e}), w err "
        f"{e_w[0]:.3e} (rel {e_w[1]:.2e}), z err {e_z[0]:.3e} (rel "
        f"{e_z[1]:.2e}), alpha equal {torch.equal(a_k, a_p)}; two calls "
        f"bit-equal {same}; without loss deltas (early exit): w rel "
        f"{e_we[1]:.2e}, z rel {e_ze[1]:.2e}, bit-equal to the full scan "
        f"{same_early}; tolerance rel {KERNEL_RTOL} (loss deltas), "
        f"{SCDN_WZ_RTOL} (w, z), alpha equal")
    assert torch.equal(a_k, a_p), (a_k, a_p)
    assert torch.equal(a_e, a_p), (a_e, a_p)
    assert e_lo[1] <= KERNEL_RTOL, e_lo
    assert e_w[1] <= SCDN_WZ_RTOL and e_z[1] <= SCDN_WZ_RTOL, (e_w, e_z)
    assert e_we[1] <= SCDN_WZ_RTOL and e_ze[1] <= SCDN_WZ_RTOL, (e_we, e_ze)
    assert same and same_early
    return dict(round_=round_, launch=launch, w=w, z=z,
                err=max(e_lo[0], e_w[0], e_z[0]))


def scdn_dense_batch_check(torch, dense, gen, flush) -> dict:
    """K5's dense batch entry at gisette's batch (`dense`, the dense cell's
    problem; P_bar 64, Q 40) and at a9a's (its CPU-budget profile, 8,192 x
    123, the CLI's dense SCDN; P_bar 8), each by `dense_batch_agreement`;
    two stream ops a call (the batch and the update launch). Timed at
    gisette's as the round calls it (each call the next batch of a round,
    on a carry the calls evolve), with the bound counted from the plain
    version's run over the same batches."""
    from repro_torch.core.problem import make_problem
    from repro_torch.data import paper_like
    from repro_torch.kernels import ops, ref

    dev = torch.device(DEVICE)
    X9, y9, spec9 = paper_like("a9a", seed=DATA_SEED)
    a9a = make_problem(X9, y9, c=spec9.c_logistic, layout="dense",
                       device=dev)
    err9 = dense_batch_agreement(torch, a9a, 8, gen, "a9a")["err"]
    P = GISETTE_P_BAR
    g = dense_batch_agreement(torch, dense, P, gen, "gisette")
    launch, w, z = g["launch"], g["w"], g["z"]
    n = dense.n_features
    idx = torch.randint(0, n, (P,), generator=gen, dtype=torch.int32).to(dev)
    wc, zc = w.clone(), z.clone()
    top = device_ops(torch, lambda: ops.scdn_dense_batch(launch, wc, zc,
                                                         idx))
    log(f"[kernels] scdn_dense_batch, device ops of one call ("
        f"{sum(c for _, c, _ in top)} stream ops):")
    log_top("kernels", top, 1, "call")
    assert sum(c for _, c, _ in top) == 2, top

    batches = torch.randint(0, n, (g["round_"].n_batches, P), generator=gen,
                            dtype=torch.int32).to(dev).unbind(0)
    alpha_buf = torch.empty((P,), device=dev)

    def stepper(fn):
        wc, zc, it = w.clone(), z.clone(), [0]

        def call():
            t = it[0] % len(batches)
            it[0] += 1
            fn(wc, zc, batches[t])
        return call

    def plain(wc, zc, idx_t):
        return ref.scdn_dense_batch_ref(
            *launch.design_args, idx_t, wc, zc, launch.y, launch.alphas,
            launch.c, kind=launch.kind, sigma=launch.sigma,
            gamma=launch.gamma, l2=launch.l2)

    k5 = stepper(lambda wc, zc, idx_t: ops.scdn_dense_batch(
        launch, wc, zc, idx_t, alpha_buf))
    r = dict(max_abs_err=max(g["err"], err9),
             **timings(torch, k5, stepper(plain), flush),
             enqueue_us=enqueue_us(torch, k5, 200), library_ms=None)
    # the bound, over the round's first SCDN_BOUND_BATCHES batches from the
    # carry (the plain version's run)
    counted = batches[:SCDN_BOUND_BATCHES]
    nbytes, nops = _port_bench("work").scdn_dense_work(torch, launch, w, z,
                                                       counted)
    r["bound"] = bound(nbytes, nops)
    log(f"[kernels] scdn_dense_batch over the gisette round's first "
        f"{len(counted)} batches: bound {r['bound'][0] * 1e3:.4f} us "
        f"({r['bound'][1]}; {nbytes:.0f} B, {nops:.0f} operations a "
        f"batch)")
    return r


@contextlib.contextmanager
def autotune_cache(name: str):
    """The tuner reads (and `tune` writes) CACHES[name] in the block, the
    cold cache after it; each switch drops the memoised plans."""
    from repro_torch.kernels import autotune
    os.environ["REPRO_AUTOTUNE_CACHE"] = CACHES[name]
    autotune.invalidate_cache()
    try:
        yield
    finally:
        os.environ["REPRO_AUTOTUNE_CACHE"] = CACHES["cold"]
        autotune.invalidate_cache()


def _memo_plans(kernel: str) -> list:
    """The plans `ops` resolved for `kernel` since the last switch."""
    from repro_torch.kernels import ops
    return sorted({repr(v) for k, v in ops._PLANS.items() if k[0] == kernel})


def phase_tune(torch, data, rows, card: str) -> dict:
    """The tuner on the card: every key of `autotune.DEFAULTS` tuned at
    bench_kernels' full cells into CACHES["tuned"] (exhaustive for a space
    of at most 40 candidates, else the hillclimb; a line a cell: the
    default's and the winner's L2-cold us, the candidates measured and
    skipped as infeasible, the margin), each winner no slower than the
    default and, where it is not the default, faster than it by more than
    the tuner's noise margin and agreeing with the plain version; then
    `tune_lockstep` and `tune_determinism`. -> the cells."""
    from repro_torch.kernels import autotune

    bk = _port_bench("bench_kernels")
    csc, y_rs, Xg, y_g, _ = data
    t0 = time.perf_counter()
    out = {}
    with autotune_cache("tuned"):
        cells = bk.make_cells(torch, {"realsim": (csc, y_rs),
                                      "gisette": (Xg, y_g),
                                      "requests": rows["requests"]})
        t_cells = time.perf_counter() - t0
        for cell in cells:
            r = bk.run_cell(torch, cell, "auto", TUNE_REPEATS, persist=True)
            log(f"[tune] {bk.cell_line(r)} on {card}")
            assert r["tuned"]["us"] <= r["default"]["us"], r
            if r["tuned"]["config"] != r["default"]["config"]:
                assert r["tuned"]["us"] < r["default"]["us"] * (
                    1 - r["margin"]), r
            assert r.get("agreement", {"ok": True})["ok"], r["agreement"]
            out[f"{r['kernel']} {r['dtype']}"] = r
        entries = json.loads(Path(CACHES["tuned"]).read_text())["entries"]
    keys = {r["kernel"] for r in out.values()}
    assert keys == set(autotune.DEFAULTS), keys
    assert len(entries) == len(out), (len(entries), len(out))
    log(f"[tune] {len(out)} cells of {len(keys)} keys tuned in "
        f"{time.perf_counter() - t0:.1f}s ({t_cells:.1f}s building the "
        f"cells), {len(entries)} entries in the run's tuned cache; "
        f"backend {autotune.backend_tag()}")
    with autotune_cache("alt"):
        for cell in cells:
            r = out[f"{cell.kernel} {cell.dtype}"]
            ru = r["runner_up"]
            if cell.dtype != "float32" or ru is None:
                continue
            agree = cell.agree(ru["config"])
            log(f"[tune] {cell.kernel} runner-up {ru['config']} "
                f"{ru['us']:.2f} us (the rule's {r['default']['us']:.2f}), "
                f"{ru['plan']}: agreement "
                f"{'ok' if agree['ok'] else 'FAILED'} (max rel "
                f"{max(agree['err'].values()):.2e}, {agree['limit']})")
            assert agree["ok"], agree
            assert autotune.record(cell.kernel,
                                   autotune.shape_bucket(**cell.shape),
                                   torch.float32, ru["config"], us=ru["us"],
                                   default_us=r["default"]["us"])
    tune_lockstep(torch, data, card)
    for label in ("tuned", "alt"):
        tune_determinism(torch, data, label)
    log(f"[tune] phase {time.perf_counter() - t0:.1f}s; child processes "
        f"inherit REPRO_AUTOTUNE_CACHE, so a resume reads the cache of the "
        f"run it resumes (the fault and sharded phases' resumes: the cold "
        f"cache)")
    return out


def tune_lockstep(torch, data, card: str) -> None:
    """Warm caches against cold from shared carries, in lockstep: each
    step runs under the tuned cache and under the runner-ups' (alt), then
    under the cold one from the same carry and generator state, and the
    next step starts from the cold run's carry, so a last-bit Armijo flip
    moves one step only. The plans each run resolved, F rel <= F_RTOL
    against cold, and the walls."""
    from repro_torch.core import PCDNConfig, scdn
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend

    for name, iters in (("support", TUNE_SUPPORT_ITERS), ("full", 1)):
        i_x, i_y, c, layout, P, kernel, _ = SOLVES[name]
        prob = make_problem(data[i_x], data[i_y], c=c, layout=layout,
                            device=DEVICE)
        backend = LocalBackend(prob, PCDNConfig(P=P, use_kernels=True,
                                                tol_kkt=0.0, seed=0))
        w, z, gen, active = backend.init_state()
        for it in range(iters):
            runs = {}
            for label in ("tuned", "alt", "cold"):
                g = gen if label == "cold" else \
                    torch.Generator().set_state(gen.get_state())
                with autotune_cache(label):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    o = backend.outer(w, z, g, active, True, c)
                    f = float(o[3])
                    runs[label] = (o, f, time.perf_counter() - t0,
                                   _memo_plans(kernel))
            f_c = runs["cold"][1]
            for label in ("tuned", "alt"):
                f_w = runs[label][1]
                rel = abs(f_w - f_c) / abs(f_c)
                log(f"[tune] {name} iteration {it} from a shared carry: F "
                    f"{label} {f_w:.6f} ({runs[label][2] * 1e3:.2f} ms wall, "
                    f"plans {runs[label][3]}) vs cold {f_c:.6f} "
                    f"({runs['cold'][2] * 1e3:.2f} ms, plans "
                    f"{runs['cold'][3]}): rel {rel:.2e} (tolerance "
                    f"{F_RTOL}) on {card}")
                assert rel <= F_RTOL, (name, it, label, f_w, f_c)
            o = runs["cold"][0]
            w, z, gen, active = o[0], o[1], o[2], o[7]

    # one gisette dense SCDN round from a carry solved by one round
    gprob = make_problem(data[2], data[3], c=SOLVES["dense"][2],
                         layout="dense", device=DEVICE)
    gcfg = scdn.SCDNConfig(P_bar=GISETTE_P_BAR)
    n, s = gprob.n_features, gprob.n_samples
    w, z, _, _, _ = scdn.make_round(gprob, gcfg)(
        torch.zeros((n,), device=DEVICE), torch.zeros((s,), device=DEVICE),
        torch.Generator().manual_seed(7))
    round_ = scdn.make_round(gprob, gcfg)
    idxs = torch.randint(0, n, (round_.n_batches, GISETTE_P_BAR),
                         generator=torch.Generator().manual_seed(8),
                         dtype=torch.int32)
    runs = {}
    for label in ("tuned", "alt", "cold"):
        with autotune_cache(label):
            round_ = scdn.make_round(gprob, gcfg)
            plan = round_.launch().plan
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = float(round_(w, z, torch.Generator(), idxs=idxs)[3])
            runs[label] = (f, time.perf_counter() - t0, plan)
    for label in ("tuned", "alt"):
        rel = abs(runs[label][0] - runs["cold"][0]) / abs(runs["cold"][0])
        log(f"[tune] gisette dense SCDN round (P_bar {GISETTE_P_BAR}) from "
            f"a shared carry and indices: F {label} {runs[label][0]:.6f} "
            f"({runs[label][1] * 1e3:.2f} ms, {runs[label][2]}) vs cold "
            f"{runs['cold'][0]:.6f} ({runs['cold'][1] * 1e3:.2f} ms, "
            f"{runs['cold'][2]}): rel {rel:.2e} (tolerance {F_RTOL}) on "
            f"{card}")
        assert rel <= F_RTOL, runs


def tune_determinism(torch, data, label: str) -> None:
    """Under one fixed cache (CACHES[label]), two K1 launches and two K2
    calls on the same inputs are bit-equal (fixed-order sums)."""
    from repro_torch.core import bundles as B
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops

    csc, y_rs = data[0], data[1]
    prob = make_problem(csc, y_rs, c=4.0, layout="padded_csc", device=DEVICE)
    design = prob.design
    gen = torch.Generator().manual_seed(9)
    n = prob.n_features
    w = torch.zeros((n,), device=DEVICE)
    on = torch.randperm(n, generator=gen)[: n // 10].to(DEVICE)
    w[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(DEVICE)
    z = prob.margins(w)
    alphas = candidate_alphas(ArmijoParams(), torch.float32, w.device)
    with autotune_cache(label):
        idx = B.partition(gen, n, 32, device=w.device)[0]
        runs = []
        for _ in range(2):
            launch = ops.BundleLaunch(design.col_rows, design.col_vals,
                                      prob.y, alphas, 4.0, 32, 1)
            wc, zc = w.clone(), z.clone()
            ops.pcdn_bundle(launch, wc, zc, idx, 0)
            runs.append((wc, zc, launch.n_steps, launch.alpha, launch.plan))
        same_k1 = all(torch.equal(a, b) for a, b in
                      zip(runs[0][:4], runs[1][:4]))
        idx = B.partition(gen, n, 512, device=w.device)[0]
        slab = design.gather_slab(idx)
        w_B, _ = B.gather_vec(w, idx)
        args = (slab.rows, slab.vals, z, prob.y, w_B, 4.0)
        got = ops.pcdn_sparse_direction(*args)
        again = ops.pcdn_sparse_direction(*args)
        same_k2 = all(torch.equal(a, b) for a, b in zip(got, again))
        plans = _memo_plans("pcdn_sparse_direction")
    log(f"[tune] under the {label} cache: two K1 launches ({runs[0][4]}) "
        f"bit-equal {same_k1}; two K2 calls (warps {plans}) bit-equal "
        f"{same_k2}")
    assert same_k1 and same_k2


def serve_data() -> dict:
    """The serve and path phases' data, from DATA_SEED: real-sim at its
    published width, split into the published training rows (padded-CSC)
    and the request rows (CSR, also written as .libsvm from their rows:
    they are 1.2 GB dense), under build/ (listed in .gitignore)."""
    from repro_torch.data import (csr_to_padded_csc,
                                  make_sparse_classification,
                                  save_libsvm_csr)

    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    csc, y, _ = make_sparse_classification(
        SERVE_ROWS, SERVE_FEATURES, nnz_per_col=SERVE_NNZ_PER_COL,
        w_nnz_frac=SERVE_W_NNZ_FRAC, seed=DATA_SEED)
    csr = csc.to_csr()
    train_csr = csr.rows(0, SERVE_TRAIN)
    train = csr_to_padded_csc(train_csr)
    requests = csr.rows(SERVE_TRAIN, SERVE_ROWS)
    req_path = work / "requests.libsvm"
    save_libsvm_csr(str(req_path), requests, y[SERVE_TRAIN:])
    log(f"[serve] data: {SERVE_ROWS} x {SERVE_FEATURES}, nnz {csr.nnz}; "
        f"train {SERVE_TRAIN} rows (k_max {train.k_max}), requests "
        f"{requests.shape[0]} rows (nnz {requests.nnz}, max column nnz "
        f"{requests.max_col_nnz()}) -> {req_path.name}; "
        f"{time.perf_counter() - t0:.1f}s")
    return {"train": train, "train_csr": train_csr, "y": y,
            "requests": requests, "requests_path": req_path, "work": work}


def prepare_serve(torch, data: dict) -> dict:
    """The serve phase's models on `serve_data`'s rows: an 8-point
    geometric path from c* down, each point warm-started from the previous
    w, solved on the card through the kernels; and the artifacts
    `launch.predict` serves, written with `save_model` under build/."""
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.serve import artifact as art

    work, train, y = data["work"], data["train"], data["y"]
    requests, req_path = data["requests"], data["requests_path"]
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
    the K = 8 path family's bank) and K5's single row at the training
    set's (the margins of the c* model and their change to the next path
    point; checked and timed, reported in the log only: K5's row of the
    kernels line is the scdn shape's)."""
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
        bound=bound(*_port_bench("work").dense_margins_work(
            torch, bank.idx, n, B)),
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
    # the bytes the function needs (benchmarks/port/work.py)
    csc_work = _port_bench("work").csc_margins_work(torch, rows, bank.idx,
                                                    n, B)
    need = csc_work[0] - K * A * 8 - B * K * 4
    nnz_u = torch.sum(rows < B, dim=1)[torch.unique(live_idx)]
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
        bound=bound(*csc_work),
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
    assert e[1] <= KERNEL_RTOL, e
    # delta everywhere, z and y where delta != 0, alphas, the output;
    # ~10 flops per (sample, candidate) loss term
    b_ms = bound(4 * s + 8 * s_live + 8 * Q, 10 * s_live * Q)[0]
    t = device_ms(torch, lambda: ops.pcdn_linesearch(*args), 100, flush)
    log(f"[kernels] pcdn_linesearch, one row at the serve phase's shape: "
        f"s={s} (delta != 0: {s_live}) Q={Q}: err {e[0]:.3e} (rel "
        f"{e[1]:.2e}), tolerance rel {KERNEL_RTOL}; {t * 1e3:.2f} us "
        f"L2-cold, bound {b_ms * 1e3:.3f} us")
    out["pcdn_linesearch row"] = dict(ms=t, bound_ms=b_ms,
                                      max_abs_err=e[0])
    return out


def flash_fault(torch, q, k, v, causal=True, sm_scale=None, *, fault,
                window=0):
    """The plain version (model layout) with one of FLASH_FAULTS (or
    WINDOW_FAULT) planted: what the gates read for a wrong kernel."""
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qg = q.reshape(B, Sq, Kv, H // Kv, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    kj = torch.arange(Skv, device=q.device)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qi >= kj
    if 0 < window < Sq:
        ok &= (qi - kj <= window) if fault == WINDOW_FAULT else \
            (qi - kj < window)
    if fault == "tile":
        ok &= (kj < 64) | (kj >= 128)
    if fault == NEAR_TILE_FAULT:
        ok &= (qi - kj < 64) | (qi - kj >= 128)
    s = torch.where(ok, s, -torch.inf)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = (e * (kj % 8 < 6) if fault == "quad" else e).sum(-1, keepdim=True)
    if fault == "fp8 p":
        e = e.to(torch.float8_e4m3fn).float()
    o = torch.einsum("bkgqs,bskd->bqkgd", e / l, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


@contextlib.contextmanager
def planted(torch, fault: str):
    """Inside the block K6's plain version (`ref.attention_ref`) has
    `fault` planted (`flash_fault`): the plain route is a wrong kernel."""
    from repro_torch.kernels import ref
    plain_ref = ref.attention_ref
    ref.attention_ref = functools.partial(flash_fault, torch, fault=fault)
    try:
        yield
    finally:
        ref.attention_ref = plain_ref


def flash_work(q, k, causal: bool, window: int = 0) -> tuple[float, float]:
    """(bytes, flops) one K6 call needs: each input read once, the output
    written once; 4 D flops for each (query, key) pair the mask (with its
    window) lets through. Either layout ((B, S, H, D) or (BH, S, D))."""
    D = q.shape[-1]
    Sq, Skv = q.shape[1], k.shape[1]
    heads = q.numel() // (Sq * D)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * D * _port_bench("work").attention_pairs(
        Sq, Skv, causal, window) * heads


def flash_rate(torch, q, k, causal: bool, ms: float, window: int = 0) -> str:
    """A K6 time's TFLOP/s and its share of the bound (bf16 tensor-core
    peak, or fp32 on the CUDA cores)."""
    nbytes, nops = flash_work(q, k, causal, window)
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
    non-causal and float32; then the sliding window (`flash_window_checks`).
    Every time with its TFLOP/s and share of the bound; every check names
    the variant that ran."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(q_shape, kv_shape, dtype):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in (q_shape, kv_shape, kv_shape)]

    def check(label, q, k, v, causal, window=0):
        before = ops.flash_variant_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ran = [n for n, c in ops.flash_variant_counts().items()
               if c != before[n]]
        e = row_rel_err(torch, got, want)
        tol = FLASH_RTOL[str(q.dtype).removeprefix("torch.")]
        ms = device_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window), 20)
        log(f"[kernels] flash_attention {label} q {tuple(q.shape)} k/v "
            f"{tuple(k.shape)} {str(q.dtype).removeprefix('torch.')} "
            f"{'causal' if causal else 'non-causal'}"
            f"{f', window {window}' if window else ''}, variant "
            f"{'/'.join(ran)}: err {e[0]:.3e} (row rel {e[1]:.2e}), "
            f"tolerance row rel {tol}; {ms * 1e3:.2f} us L2-warm, "
            f"{flash_rate(torch, q, k, causal, ms, window)}")
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
    out["flash_attention"]["window"] = flash_window_checks(
        torch, flush, check, inputs)
    out["flash_attention"]["g5"] = flash_g5_checks(torch, flush, check,
                                                   inputs)
    return out


def g5_shape():
    """The rank shape of the split hybrid train step (DSPLIT_BF16 at (1,
    2)): recurrentgemma-2b's heads halved over its one kv head -> (B, S,
    H, Kv, D, window)."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    _, _, B, S = DSPLIT_BF16
    return (B, S, cfg.n_heads // 2, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.hybrid.window)


def band_sdpa(torch, q, k, v, window: int):
    """-> library(): scaled_dot_product_attention of (q, k, v) heads first
    and contiguous, the causal band of `window` as a boolean mask (the
    library call K6's window is timed against)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qi = torch.arange(q.shape[1], device=q.device)
    band = (qi[:, None] >= qi[None, :]) & (qi[:, None] - qi[None, :] < window)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)


def flash_g5_checks(torch, flush, check, inputs) -> dict:
    """K6 at the split hybrid train step's rank shape (`g5_shape`: B 1 x 5
    heads over 1, S 4096, D 256, window 2048, bf16, `mma`; G 5, which no
    unsplit run launches), per row against its plain version, timed
    L2-cold and warm beside the band's bound, the plain version and SDPA
    with the band as a mask (timed only). -> its readings."""
    from repro_torch.kernels import ops, ref
    B, S, H, Kv, D, W = g5_shape()
    q, k, v = inputs((B, S, H, D), (B, S, Kv, D), torch.bfloat16)
    e, want = check("split hybrid rank (G 5)", q, k, v, True, window=W)
    del want
    nbytes, nops = flash_work(q, k, True, W)
    r = dict(max_abs_err=e[0], row_rel=e[1],
             **timings(torch, lambda: ops.flash_attention(q, k, v, window=W),
                       lambda: ref.attention_ref(q, k, v, window=W), flush),
             bound=bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
             library_ms=device_ms(torch, band_sdpa(torch, q, k, v, W), 20,
                                  flush),
             shape=f"B {B} x H {H} (kv {Kv}), S {S}, D {D}, window {W}, "
                   f"bf16, causal")
    log(f"[kernels] flash_attention at the split hybrid's rank shape "
        f"({r['shape']}, variant {ops.flash_variant(q.dtype, D)}): L2-cold "
        f"{r['ms'] * 1e3:.2f} us ({flash_rate(torch, q, k, True, r['ms'], W)}"
        f"), warm {r['warm_ms'] * 1e3:.2f} us; bound "
        f"{r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}); plain "
        f"{r['plain_ms'] * 1e3:.2f} us; library (SDPA with the band as a "
        f"mask) {r['library_ms'] * 1e3:.2f} us")
    del q, k, v
    free_card(torch)
    return r


def flash_window_checks(torch, flush, check, inputs) -> dict:
    """K6's sliding window, held per row to `ref.attention_ref(window=)`:
    at the hybrid phase's prefill shape (recurrentgemma-2b: B 4 x 10 heads
    over 1, S 4096, D 256, window 2048, bf16: `mma`), with the band
    planted one key too wide (WINDOW_FAULT) in the plain version as a
    control; the causal launch's bits unchanged (a window of S, and the
    rows a window of S - 1 leaves whole); timed L2-cold and warm beside
    its bound (the band's pairs), the plain version, the causal launch
    at the same shape and the library call (scaled_dot_product_attention
    with the band as a boolean mask, timed only); then float32 (`f32`)
    at a shorter S still past the window, and `wgmma` at D 128 and 64.
    -> the windowed shape's row of readings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(HYBRID_ARCH)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W, S = cfg.hybrid.window, HYBRID_PROMPT
    q, k, v = inputs((HYBRID_BATCH, S, H, D), (HYBRID_BATCH, S, Kv, D),
                     torch.bfloat16)
    e, want = check(f"{HYBRID_ARCH} prefill", q, k, v, True, window=W)
    tol = FLASH_RTOL["bfloat16"]
    r_fault = row_rel_err(torch, flash_fault(
        torch, q, k, v, fault=WINDOW_FAULT, window=W), want)[1]
    log(f"[kernels] flash_attention window control, plain version with "
        f"the band planted one key wide (i - j <= {W}): row rel "
        f"{r_fault:.2e} (limit {tol})")
    assert r_fault > tol, r_fault
    causal = ops.flash_attention(q, k, v)
    whole = torch.equal(ops.flash_attention(q, k, v, window=S), causal)
    edge = ops.flash_attention(q, k, v, window=S - 1)
    rows = torch.equal(edge[:, :-1], causal[:, :-1])
    last = torch.equal(edge[:, -1], causal[:, -1])
    log(f"[kernels] flash_attention window of S ({S}) bit-equal to the "
        f"causal launch: {whole}; window S - 1: rows 0..{S - 2} bit-equal "
        f"{rows}, the last row (which loses key 0) equal {last}")
    assert whole and rows and not last
    del edge, causal
    library = band_sdpa(torch, q, k, v, W)
    e_lib = row_rel_err(torch, library().transpose(1, 2), want)
    del want
    nbytes, nops = flash_work(q, k, True, W)
    r = dict(max_abs_err=e[0], row_rel=e[1], fault_row_rel=r_fault,
             **timings(torch, lambda: ops.flash_attention(q, k, v, window=W),
                       lambda: ref.attention_ref(q, k, v, window=W), flush),
             bound=bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
             library_ms=device_ms(torch, library, 20, flush),
             causal_ms=device_ms(torch, lambda: ops.flash_attention(
                 q, k, v), 20, flush),
             launches_per_prefill=cfg.n_layers // 3,
             shape=f"B {HYBRID_BATCH} x H {H} (kv {Kv}), S {S}, D {D}, "
                   f"window {W}, bf16, causal",
             pairs=_port_bench("work").attention_pairs(S, S, True, W),
             causal_pairs=_port_bench("work").attention_pairs(S, S, True))
    log(f"[kernels] flash_attention window at {r['shape']} (variant mma): "
        f"L2-cold {r['ms'] * 1e3:.2f} us "
        f"({flash_rate(torch, q, k, True, r['ms'], W)}), warm "
        f"{r['warm_ms'] * 1e3:.2f} us; the causal launch at this shape "
        f"{r['causal_ms'] * 1e3:.2f} us; bound {r['bound'][0] * 1e3:.3f} "
        f"us ({r['bound'][1]}; {r['pairs']} pairs a head against causal's "
        f"{r['causal_pairs']}); plain {r['plain_ms'] * 1e3:.2f} us; library "
        f"scaled_dot_product_attention with the band as a mask "
        f"{r['library_ms'] * 1e3:.2f} us (row rel {e_lib[1]:.2e} against "
        f"the plain version, timed only)")
    del q, k, v, library
    check("float32, window", *inputs((1, 3072, H, D), (1, 3072, Kv, D),
                                     torch.float32), True, window=W)
    check("wgmma D 128, window", *inputs((2, 4096, 8, 128), (2, 4096, 2, 128),
                                         torch.bfloat16), True, window=1000)
    check("wgmma D 64, window", *inputs((1, 2500, 14, 64), (1, 2500, 2, 64),
                                        torch.bfloat16), True, window=333)
    return r


def bwd_row_rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, the largest over rows (all dims but the last) of
    the row's max abs error over the larger of its own max |want| and the
    median row's). A gradient row can cancel to near zero (dq of query 0
    is ds_00 k_0 with ds_00 = p_00 (dp_00 - delta_0) ~ 0: its terms are
    a typical row's size, its value their rounding): the median row's
    size is then the scale its error is read against."""
    err = torch.abs(got.float() - want.float()).amax(dim=-1)
    row = torch.abs(want.float()).amax(dim=-1)
    scale = torch.maximum(row, row.median()).clamp_min(1e-30)
    return float(err.max()), float((err / scale).max())


def flash_bwd_fault(torch, q, k, v, out, lse, do, causal=True,
                    sm_scale=None, *, fault, window=0):
    """The plain backward (model layout) with one of BWD_FAULTS, or
    BWD_WINDOW_FAULT, planted: what the K6b gate reads for a wrong
    kernel."""
    from repro_torch.kernels import ref
    if fault == BWD_WINDOW_FAULT:
        return ref.attention_bwd_ref(q, k, v, out, lse, do, causal,
                                     sm_scale, window=window + 1)
    if fault == "key tile":
        dq, dk, dv = ref.attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           sm_scale)
        dk[:, 64:128] = 0
        return dq, dk, dv
    # "delta": ds = p dp, the delta_i term left out
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    scale = D ** -0.5 if sm_scale is None else sm_scale
    qf = q.float().reshape(B, Sq, Kv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    p = torch.exp(s - lse.float().reshape(B, Kv, G, Sq)[..., None])
    if causal:
        ok = torch.arange(Sq, device=q.device)[:, None] >= \
            torch.arange(Skv, device=q.device)[None, :]
        p = torch.where(ok, p, 0.0)
    del s
    dof = do.float().reshape(B, Sq, Kv, G, D)
    ds = p * torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bwd_cases(torch):
    """-> (inputs, case): K6b's seeded inputs on the card, and one check
    of K6b against its plain version (`flash_bwd_checks` and the window
    and family checks after it share them)."""
    from repro_torch.kernels import ops, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(q_shape, kv_shape, dtype):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in (q_shape, kv_shape, kv_shape, q_shape)]

    def case(label, q, k, v, do, causal, faults=(), variants=(None,),
             window=0):
        """K6b on the rule's variant (None) and any named in `variants`,
        each held to the plain version, with `window`; -> (the largest max
        abs error, out, lse)."""
        dtype = str(q.dtype).removeprefix("torch.")
        tol = BWD_RTOL[dtype]
        before = ops.flash_variant_counts()
        with torch.no_grad():
            out, lse = ops._flash_forward(q, k, v, causal, None, None, True,
                                          window)
        ran = [n for n, c in ops.flash_variant_counts().items()
               if c != before[n]]
        _, lse_ref = ref.attention_ref(q, k, v, causal=causal,
                                       return_lse=True, window=window)
        e_lse = float(torch.max(torch.abs(lse - lse_ref)))
        del lse_ref
        assert e_lse <= LSE_ATOL, (label, e_lse)
        want = ref.attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                     window=window)
        rule = ops.flash_bwd_variant(q.dtype, q.shape[-1])
        worst = 0.0
        for variant in variants:
            n0 = ops.launch_counts()["flash_attention_bwd"]
            v0 = ops.flash_bwd_variant_counts()
            got = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                          causal=causal, variant=variant,
                                          window=window)
            again = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                            causal=causal, variant=variant,
                                            window=window)
            torch.cuda.synchronize()
            errs = [bwd_row_rel_err(torch, a, b) for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            n = ops.launch_counts()["flash_attention_bwd"] - n0
            by = {nm: c - v0[nm]
                  for nm, c in ops.flash_bwd_variant_counts().items()
                  if c != v0[nm]}
            del got, again
            name = variant or rule
            log(f"[kernels] flash_attention_bwd {label} q {tuple(q.shape)} "
                f"k/v {tuple(k.shape)} {dtype} "
                f"{'causal' if causal else 'non-causal'}"
                f"{f', window {window}' if window else ''}, K6b variant "
                f"{name}{' (the rule)' if name == rule else ' (named)'} "
                f"(out, lse from K6 {'/'.join(ran)}: lse err {e_lse:.2e}, "
                f"limit {LSE_ATOL}): "
                + ", ".join(f"{nm} err {e[0]:.3e} (row rel {e[1]:.2e})"
                            for nm, e in zip(("dq", "dk", "dv"), errs))
                + f"; tolerance row rel {tol}; two calls bit-equal {same}; "
                f"launches {n} {by}")
            assert all(e[1] <= tol for e in errs), (label, name, errs)
            assert same and n == 2 and by == {name: 2}, \
                (label, name, same, n, by)
            worst = max([worst] + [e[0] for e in errs])
        for fault in faults:
            bad = flash_bwd_fault(torch, q, k, v, out, lse, do, causal,
                                  fault=fault, window=window)
            r = max(bwd_row_rel_err(torch, a, b)[1]
                    for a, b in zip(bad, want))
            del bad
            log(f"[kernels] flash_attention_bwd control, plain version "
                f"with {fault!r} planted: row rel {r:.2e} (limit {tol})")
            assert r > tol, (fault, r)
        return worst, out, lse

    return inputs, case


def flash_bwd_checks(torch, flush) -> dict:
    """K6b against its plain version (`ref.attention_bwd_ref`) on the same
    (q, k, v, out, lse, do), out and lse from K6's forward (whose lse is
    held first to the plain version's, LSE_ATOL): at the train phase's
    shape (qwen2-0.5b, B 4 x S 4096, 14 heads over 2, D 64) in bf16 and
    float32, ragged (S 4000), at D 128 (yi-6b's heads) and D 256
    (gemma-7b's heads in bf16; bf16 and float32 with Sq != Skv,
    non-causal). dq, dk, dv per row (`bwd_row_rel_err`, BWD_RTOL); two
    calls bit-equal, counted under the variant the rule picks
    (`ops.flash_bwd_variant`: wgmma for bf16, simt for float32), which
    each case logs; at the train shape and in each bf16 D 256 case the
    simt variant is held too; the planted BWD_FAULTS read at the train
    shape and in each bf16 D 256 case. Timed at the train shape in bf16
    (L2-cold and warm; simt L2-cold beside it, `variant_ms`), with its
    bound (`work.flash_bwd_work`), the plain version and the library's
    backward (scaled_dot_product_attention, timed only); then the window
    (`flash_bwd_window_checks`), gemma-7b's train shape
    (`flash_bwd_gemma_timing`) and the moe and vlm train runs' shapes."""
    from repro_torch.kernels import ops, ref

    inputs, case = bwd_cases(torch)

    H, Kv, D = 14, 2, 64          # qwen2-0.5b
    shape_q = (TRAIN_BATCH, TRAIN_SEQ, H, D)
    shape_kv = (TRAIN_BATCH, TRAIN_SEQ, Kv, D)
    q, k, v, do = inputs(shape_q, shape_kv, torch.bfloat16)
    err, out, lse = case(f"{LM_ARCH} train", q, k, v, do, True, BWD_FAULTS,
                         variants=(None, "simt"))
    gc.collect()
    torch.cuda.empty_cache()

    def kernel(variant=None):
        return ops.flash_attention_bwd(q, k, v, out, lse, do,
                                       variant=variant)

    def plain():
        return ref.attention_bwd_ref(q, k, v, out, lse, do)

    # the library's backward: heads first, contiguous, GQA inside
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    r = dict(max_abs_err=err, ms=device_ms(torch, kernel, 10, flush),
             warm_ms=device_ms(torch, kernel, 10),
             host_ms=host_ms(torch, kernel, 10),
             plain_ms=device_ms(torch, plain, 3, flush),
             plain_host_ms=host_ms(torch, plain, 3),
             bound=bound(*_port_bench("work").flash_bwd_work(q, k, True),
                         BF16_TENSOR_OPS_PER_S),
             library_ms=device_ms(torch, library, 10, flush))
    simt_ms = device_ms(torch, lambda: kernel("simt"), 3, flush)
    r["variant_ms"] = {"wgmma": r["ms"], "simt": simt_ms}
    nbytes, nops = _port_bench("work").flash_bwd_work(q, k, True)
    log(f"[kernels] flash_attention_bwd {LM_ARCH} train, L2-cold: wgmma "
        f"{r['ms'] * 1e3:.2f} us ({nops / (r['ms'] * 1e-3) / 1e12:.2f} "
        f"TFLOP/s of the five products, {r['bound'][0] / r['ms']:.4f} of "
        f"its bound {r['bound'][0] * 1e3:.1f} us), warm "
        f"{r['warm_ms'] * 1e3:.2f} us; the simt variant {simt_ms * 1e3:.2f}"
        f" us ({nops / (simt_ms * 1e-3) / 1e12:.2f} TFLOP/s); library (SDPA"
        f" backward) {r['library_ms'] * 1e3:.2f} us; plain "
        f"{r['plain_ms'] * 1e3:.2f} us; {nbytes / 1e6:.1f} MB, "
        f"{nops / 1e9:.2f} GFLOP")
    del q, k, v, do, out, lse, qt, kt, vt, ot, dot
    gc.collect()
    torch.cuda.empty_cache()
    case(f"{LM_ARCH} train float32", *inputs(shape_q, shape_kv,
                                              torch.float32), True)
    gc.collect()
    torch.cuda.empty_cache()
    case("ragged", *inputs((1, 4000, H, D), (1, 4000, Kv, D),
                           torch.bfloat16), True)
    case("yi-6b heads (D 128)", *inputs((1, 2048, 32, 128), (1, 2048, 4, 128),
                                        torch.bfloat16), True)
    case("gemma-7b heads (D 256)", *inputs(
        (1, 2048, 16, 256), (1, 2048, 16, 256), torch.bfloat16), True,
        BWD_FAULTS, variants=(None, "simt"))
    case("bf16 D 256, Sq != Skv", *inputs(
        (1, 1000, 16, 256), (1, 1500, 16, 256), torch.bfloat16), False,
        BWD_FAULTS, variants=(None, "simt"))
    case("float32 D 256, Sq != Skv", *inputs(
        (1, 1000, 16, 256), (1, 1500, 16, 256), torch.float32), False)
    gc.collect()
    torch.cuda.empty_cache()
    r["window"] = flash_bwd_window_checks(torch, flush, case, inputs)
    r["gemma"] = flash_bwd_gemma_timing(torch, flush, case, inputs)
    r["g5"] = flash_bwd_g5_timing(torch, flush, case, inputs)
    for arch in (MOE_ARCH, VLM_ARCH):
        r[FTRAIN_LABEL[arch]] = flash_bwd_family_timing(torch, flush, case,
                                                        inputs, arch)
    return {"flash_attention_bwd": r}


def flash_bwd_timings(torch, flush, q, k, v, out, lse, do, window=0):
    """K6b's L2-cold and warm device times at one shape, the plain
    version's, the library's backward (scaled_dot_product_attention's,
    heads first and contiguous; with a window the band as a boolean
    mask; timed only) and the bound (`work.flash_bwd_work`, the band's
    pairs)."""
    from repro_torch.kernels import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    if window:
        qi = torch.arange(q.shape[1], device=q.device)
        band = (qi[:, None] >= qi[None, :]) & \
            (qi[:, None] - qi[None, :] < window)
        ot = sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()

    def kernel():
        return ops.flash_attention_bwd(q, k, v, out, lse, do, window=window)

    def library():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    nbytes, nops = _port_bench("work").flash_bwd_work(q, k, True, window)
    r = dict(ms=device_ms(torch, kernel, 10, flush),
             warm_ms=device_ms(torch, kernel, 10),
             plain_ms=device_ms(torch, lambda: ref.attention_bwd_ref(
                 q, k, v, out, lse, do, window=window), 3, flush),
             library_ms=device_ms(torch, library, 10, flush),
             bound=bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
             gflop=nops / 1e9, variant=ops.flash_bwd_variant(q.dtype,
                                                             q.shape[-1]))
    B, S, H, D = q.shape
    r["shape"] = (f"B {B} x H {H} (kv {k.shape[2]}), S {S}, D {D}, bf16, "
                  f"causal" + (f", window {window}" if window else ""))
    del qt, kt, vt, ot, dot
    free_card(torch)
    return r


def flash_bwd_window_checks(torch, flush, case, inputs) -> dict:
    """K6b's sliding window (the flash backward of recurrentgemma-2b's
    local attention), per row against `ref.attention_bwd_ref(window=)`:
    at the hybrid train run's shape (B 1 x 10 heads over 1, S 4096, D 256,
    window 2048, bf16: `wgmma`, and `simt` held beside it), the band
    planted one key too wide in the plain version as a control
    (BWD_WINDOW_FAULT), two calls bit-equal, a window of S bit-equal to
    the causal launch; timed L2-cold and warm with the band's bound, the
    plain version, `simt` (`variant_ms`) and SDPA's backward with the
    band as a boolean mask; then bf16 at D 256 with a ragged S and a
    window off the tiles, float32 (`simt`, a shorter S still past the
    window) and `wgmma` at D 64 and 128 with a window. -> the hybrid
    shape's readings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config(HYBRID_ARCH)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W = cfg.hybrid.window
    _, B, S, _ = FTRAIN[HYBRID_ARCH]
    q, k, v, do = inputs((B, S, H, D), (B, S, Kv, D), torch.bfloat16)
    err, out, lse = case(f"{HYBRID_ARCH} train", q, k, v, do, True,
                         (BWD_WINDOW_FAULT,), variants=(None, "simt"),
                         window=W)
    causal_out, causal_lse = ops._flash_forward(q, k, v, True, None, None,
                                                True)
    whole = all(torch.equal(a, b) for a, b in zip(
        ops.flash_attention_bwd(q, k, v, causal_out, causal_lse, do,
                                window=S),
        ops.flash_attention_bwd(q, k, v, causal_out, causal_lse, do)))
    log(f"[kernels] flash_attention_bwd window of S ({S}) bit-equal to the "
        f"causal launch: {whole}")
    assert whole
    del causal_out, causal_lse
    r = flash_bwd_timings(torch, flush, q, k, v, out, lse, do, W)
    r["max_abs_err"] = err
    r["variant_ms"] = {r["variant"]: r["ms"], "simt": device_ms(
        torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, do,
                                               variant="simt", window=W),
        3, flush)}
    work = _port_bench("work")
    r["pairs"] = work.attention_pairs(S, S, True, W)
    r["causal_pairs"] = work.attention_pairs(S, S, True)
    log(f"[kernels] flash_attention_bwd window at {r['shape']} (variant "
        f"{r['variant']}): L2-cold {r['ms'] * 1e3:.2f} us "
        f"({r['gflop'] / r['ms']:.2f} TFLOP/s of the five products, "
        f"{r['bound'][0] / r['ms']:.4f} of its bound "
        f"{r['bound'][0] * 1e3:.1f} us, {r['bound'][1]}; {r['pairs']} "
        f"pairs a head against causal's {r['causal_pairs']}), warm "
        f"{r['warm_ms'] * 1e3:.2f} us; simt "
        f"{r['variant_ms']['simt'] * 1e3:.2f} us; plain "
        f"{r['plain_ms'] * 1e3:.2f} us; library (SDPA backward with the "
        f"band as a mask) {r['library_ms'] * 1e3:.2f} us")
    del q, k, v, do, out, lse
    free_card(torch)
    case("bf16 D 256, ragged, window 777", *inputs(
        (2, 3000, H, D), (2, 3000, Kv, D), torch.bfloat16), True,
        (BWD_WINDOW_FAULT,), variants=(None, "simt"), window=777)
    case("float32, window", *inputs((1, 3072, H, D), (1, 3072, Kv, D),
                                    torch.float32), True, window=W)
    case("wgmma D 128, window", *inputs((2, 4096, 8, 128), (2, 4096, 2, 128),
                                        torch.bfloat16), True, window=1000)
    case("wgmma D 64, window", *inputs((1, 2500, 14, 64), (1, 2500, 2, 64),
                                       torch.bfloat16), True, window=333)
    free_card(torch)
    return r


def flash_bwd_gemma_timing(torch, flush, case, inputs) -> dict:
    """K6b at gemma-7b's train shape (B 1 x 16 heads over 16, S 4096, D
    256, causal, bf16: `wgmma`), per row against the plain version with
    `simt` held beside it and BWD_FAULTS read past the limit, then timed
    with `simt` (`variant_ms`), SDPA's causal backward, the plain version
    and the bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config(GEMMA_ARCH)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v, do = inputs((1, TRAIN_SEQ, H, D), (1, TRAIN_SEQ, Kv, D),
                         torch.bfloat16)
    err, out, lse = case(f"{GEMMA_ARCH} train", q, k, v, do, True,
                         BWD_FAULTS, variants=(None, "simt"))
    r = flash_bwd_timings(torch, flush, q, k, v, out, lse, do)
    r["max_abs_err"] = err
    r["variant_ms"] = {r["variant"]: r["ms"], "simt": device_ms(
        torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, do,
                                               variant="simt"), 3, flush)}
    log(f"[kernels] flash_attention_bwd at {GEMMA_ARCH}'s train shape "
        f"({r['shape']}, variant {r['variant']}): L2-cold "
        f"{r['ms'] * 1e3:.2f} us ({r['gflop'] / r['ms']:.2f} TFLOP/s, "
        f"{r['bound'][0] / r['ms']:.4f} of its bound "
        f"{r['bound'][0] * 1e3:.1f} us, {r['gflop']:.1f} GFLOP), warm "
        f"{r['warm_ms'] * 1e3:.2f} us; simt "
        f"{r['variant_ms']['simt'] * 1e3:.2f} us; plain "
        f"{r['plain_ms'] * 1e3:.2f} us; library (SDPA's causal backward) "
        f"{r['library_ms'] * 1e3:.2f} us")
    del q, k, v, do, out, lse
    free_card(torch)
    return r


def flash_bwd_g5_timing(torch, flush, case, inputs) -> dict:
    """K6b at the split hybrid train step's rank shape (`g5_shape`: G 5,
    D 256, window 2048, bf16, `wgmma`), per row against its plain version
    (out and lse from K6), then timed (`flash_bwd_timings`: L2-cold and
    warm, the band's bound, the plain version, SDPA's backward with the
    band as a mask)."""
    B, S, H, Kv, D, W = g5_shape()
    q, k, v, do = inputs((B, S, H, D), (B, S, Kv, D), torch.bfloat16)
    err, out, lse = case("split hybrid rank (G 5)", q, k, v, do, True,
                         window=W)
    r = flash_bwd_timings(torch, flush, q, k, v, out, lse, do, W)
    r["max_abs_err"] = err
    log(f"[kernels] flash_attention_bwd at the split hybrid's rank shape "
        f"({r['shape']}, variant {r['variant']}): L2-cold "
        f"{r['ms'] * 1e3:.2f} us ({r['gflop'] / r['ms']:.2f} TFLOP/s, "
        f"{r['bound'][0] / r['ms']:.4f} of its bound "
        f"{r['bound'][0] * 1e3:.1f} us), warm {r['warm_ms'] * 1e3:.2f} us; "
        f"plain {r['plain_ms'] * 1e3:.2f} us; library (SDPA backward with "
        f"the band as a mask) {r['library_ms'] * 1e3:.2f} us")
    del q, k, v, do, out, lse
    free_card(torch)
    return r


def flash_bwd_family_timing(torch, flush, case, inputs, arch) -> dict:
    """K6b without a window at a family train run's shape (moe: B 1 x 16
    heads over 16, S 4096, D 128, G 1; vlm: B 1 x 32 over 8, S 4352, D
    128), per row against the plain version, then timed beside SDPA's
    backward and the bound."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    _, B, S, _ = FTRAIN[arch]
    S += family_prefix_len(cfg)
    q, k, v, do = inputs((B, S, H, D), (B, S, Kv, D), torch.bfloat16)
    err, out, lse = case(f"{arch} train", q, k, v, do, True)
    r = flash_bwd_timings(torch, flush, q, k, v, out, lse, do)
    r["max_abs_err"] = err
    log(f"[kernels] flash_attention_bwd at the {arch} train run's shape "
        f"({r['shape']}, variant {r['variant']}): L2-cold "
        f"{r['ms'] * 1e3:.2f} us ({r['gflop'] / r['ms']:.2f} TFLOP/s, "
        f"{r['bound'][0] / r['ms']:.4f} of its bound "
        f"{r['bound'][0] * 1e3:.1f} us), warm {r['warm_ms'] * 1e3:.2f} us; "
        f"plain {r['plain_ms'] * 1e3:.2f} us; library (SDPA backward) "
        f"{r['library_ms'] * 1e3:.2f} us")
    del q, k, v, do, out, lse
    free_card(torch)
    return r


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
    """The lm phase's model (from `seed`) end to end through K6 and
    through its plain version (`family_agreement`), with each of `faults`
    planted in the plain version. -> the readings: [prefill, each decode
    step] rel of the kernel route, then the largest rel a fault, against
    the plain route. In float32 the greedy first tokens are equal."""
    model, tokens = lm_model(torch, dtype, seed)
    out = family_agreement(torch, f"[lm] {dtype} seed {seed}", model, tokens,
                           {}, LM_PROMPT + LM_DECODE_CHECK,
                           model.cfg.n_layers, faults)
    if dtype == "float32":
        assert out["first_equal"], out
    del model, tokens
    free_card(torch)
    return out["kernel"] + out["faults"]


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
    if not LM_PROFILES:
        log("[lm] the traced prefill and decode: not run (--lm-profiles)")
        return {"flash_attention": launches,
                "flash_attention variants": by_variant}
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


def _train_parts(torch, dtype: str, seed: int):
    """The train phase's model (qwen2-0.5b at full width in `dtype`,
    random weights from `seed`, on the card), its train step (AdamW as
    `launch.train` configures it, at the constant rate TRAIN_LR: under
    warmup the first step's rate is 0) and its batches."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step
    cfg = get_config(LM_ARCH).replace(dtype=dtype)
    model = Model(cfg, DEVICE)
    init_params(model, torch.Generator(device=DEVICE).manual_seed(seed))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.01)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed)

    def batch(i):
        return {k: torch.as_tensor(v, device=DEVICE)
                for k, v in pipe.batch_at(i).items()}

    return model, make_train_step(model, opt_cfg), opt_cfg, batch


def train_readings(torch, base, a, b) -> dict:
    """Route a against route b from the shared params `base`: {"loss",
    "grad_norm"} relative differences; "update", ||new_a - new_b|| /
    ||new_b - base|| over all parameters together (2-norms in float32);
    and, not gated, the largest such ratio of a single parameter
    ("param_update", "param"). A parameter whose true gradient is zero
    makes that one noise: a bias of k (q . (k_j + b) shifts every score of
    a row alike, and the softmax does not see it) gets Adam's normalised
    step of its rounding noise, which differs between any two routes."""
    (pa, ma), (pb, mb) = a, b
    d2 = {k: float(torch.linalg.vector_norm(pa[k].float() - pb[k].float()))
          ** 2 for k in base}
    s2 = {k: float(torch.linalg.vector_norm(pb[k].float() - p0.float()))
          ** 2 for k, p0 in base.items()}
    return update_readings(ma, mb, d2, s2)


def update_readings(ma, mb, d2: dict, s2: dict) -> dict:
    """`train_readings` from route a's and route b's metrics and, a
    parameter each, the squared norms ||new_a - new_b||^2 (`d2`) and
    ||new_b - base||^2 (`s2`)."""
    out = {k: abs(float(ma[k]) - float(mb[k])) / abs(float(mb[k]))
           for k in ("loss", "grad_norm")}
    out["update"] = (sum(d2.values()) / sum(s2.values())) ** 0.5
    worst, name = max((((d2[k] / s2[k]) ** 0.5, k) for k in d2
                       if s2[k] > 0), default=(0.0, None))
    out["param_update"], out["param"] = worst, name
    return out


def train_lockstep(torch, dtype: str, seed: int, faults=()) -> list:
    """One train step through the kernel route (K6 forward, K6b backward)
    and one through the plain route (`use_kernels=False`: the plain
    attention under torch's autograd), from one shared (params, AdamW
    state, batch): the carry is the params and moments after one
    kernel-route step from the seeded init, the batch the pipeline's
    second. Then the plain route with each of `faults` planted in its
    attention's backward (a Function: the plain forward, `flash_bwd_fault`
    backward). -> [the kernel route's readings, then one a fault], each
    against the plain route (`train_readings`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.optim.adamw import adamw_init
    model, step, opt_cfg, batch = _train_parts(torch, dtype, seed)
    L = model.cfg.n_layers
    params = {k: p.detach() for k, p in model.named_parameters()}
    params, opt, _ = step(params, adamw_init(params, opt_cfg), batch(0))
    b1 = batch(1)
    res = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        ops.reset_launch_counts()
        new, _, met = step(params, opt, b1)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        assert (n["flash_attention"], n["flash_attention_bwd"]) == \
            ((2 * L, L) if use_kernels else (0, 0)), (use_kernels, n)
        res[use_kernels] = (new, met)
    readings = [train_readings(torch, params, res[True], res[False])]
    model.use_kernels = False
    for fault in faults:
        with planted_backward(torch, fault):
            new, _, met = step(params, opt, b1)
        readings.append(train_readings(torch, params, (new, met),
                                       res[False]))
        del new
    r = readings[0]
    log(f"[train] lockstep {dtype} seed {seed}: loss "
        f"{float(res[True][1]['loss']):.6f} (kernel route) vs "
        f"{float(res[False][1]['loss']):.6f} (plain route): rel "
        f"{r['loss']:.2e}; grad_norm rel {r['grad_norm']:.2e}; update rel "
        f"{r['update']:.2e} (one parameter's at most {r['param_update']:.2e}"
        f", {r['param']})"
        + "".join(f"; control {f!r} in the plain backward: loss "
                  f"{x['loss']:.2e}, grad_norm {x['grad_norm']:.2e}, update "
                  f"{x['update']:.2e} ({x['param_update']:.2e}, "
                  f"{x['param']})"
                  for f, x in zip(faults, readings[1:])))
    del model, params, opt, res
    gc.collect()
    torch.cuda.empty_cache()
    return readings


@contextlib.contextmanager
def planted_backward(torch, fault: str):
    """Inside the block the plain route's attention (`ref.attention_ref`,
    which `attend_full` calls with `use_kernels=False`) is a Function: the
    plain forward, and the plain backward with `fault` (BWD_FAULTS or
    BWD_WINDOW_FAULT) planted, the window passed through."""
    from repro_torch.kernels import ref
    plain_ref = ref.attention_ref

    class Planted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, sm_scale, window):
            out, lse = plain_ref(q, k, v, causal, sm_scale, return_lse=True,
                                 window=window)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, sm_scale)
            ctx.window = window
            return out

        @staticmethod
        def backward(ctx, do):
            return (*flash_bwd_fault(torch, *ctx.saved_tensors, do,
                                     *ctx.args, fault=fault,
                                     window=ctx.window),
                    None, None, None)

    ref.attention_ref = lambda q, k, v, causal=True, sm_scale=None, *, \
        window=0: Planted.apply(q, k, v, causal, sm_scale, window)
    try:
        yield
    finally:
        ref.attention_ref = plain_ref


def _train_cli(args, env=None, timeout=900, runs=None, label="train",
               ranks=None):
    """`python -m repro_torch.launch.train args` in a child process (with
    `ranks`, under torchrun with that many ranks) -> its `[train] result`
    dict (rank 0's); or with `runs` [(arch, layers, args, fault plan or
    None), ...] the same `main` once a run, one after the other in one
    child process, through this script's `--family-train` wrapper ->
    their results."""
    if runs is None:
        cmd = ["repro_torch.launch.train", *args]
        if ranks is not None:
            cmd = ["torch.distributed.run", "--standalone",
                   "--nproc-per-node", str(ranks), "-m", *cmd]
    else:
        cmd = ["chip_smoke", "--family-train"]
        for i, (arch, layers, run_args, plan) in enumerate(runs):
            cmd += (["--and"] if i else []) + [f"{arch}:{layers}"]
            if plan is not None:
                cmd += ["--fault-plan", json.dumps(plan)]
            cmd += run_args
    proc = _child(cmd, env=env, timeout=timeout)
    out = _finish(f"{label} CLI", proc)
    for line in out.splitlines():
        if line.startswith("step ") or line.startswith("[train] ") and \
                not line.startswith("[train] result "):
            log(f"[{label}]   {line}")
    results = [json.loads(x[len("[train] result "):])
               for x in out.splitlines() if x.startswith("[train] result ")]
    return results[-1] if runs is None else results


def train_trace() -> None:
    """One train step traced in a fresh process (`--train-profile`), its
    readings logged."""
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-profile"],
        capture_output=True, text=True, timeout=600)
    log(f"[train] the traced child: {time.perf_counter() - t0:.1f} s with "
        f"the process start")
    assert child.returncode == 0, (child.returncode, child.stdout[-2000:],
                                   child.stderr[-4000:])
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    if prof["busy_ms"] > 0:
        log(f"[train] one step traced by torch.profiler in a fresh process: "
            f"{prof['traced_ms']:.1f} ms wall traced ({prof['wall_ms']:.1f} "
            f"untraced), device busy {prof['busy_ms']:.1f} ms (idle share "
            f"{1 - prof['busy_ms'] / prof['traced_ms']:.4f}); top device "
            f"ops:")
        for key, calls, us in prof["top"]:
            log(f"[train]   {us:12.1f} us  {calls:5d} calls  {key[:90]}")
        for key, calls, us in prof["flash"]:
            log(f"[train]   K6/K6b: {us:12.1f} us  {calls:5d} calls "
                f"({us / 1e3 / prof['busy_ms']:.4f} of busy)  {key[:70]}")
    else:
        log(f"[train] one step: {prof['wall_ms']:.1f} ms wall; idle share "
            f"not measured (the profiler saw no device time)")


def phase_train(torch, card: str) -> dict:
    """LM training on the card: (b) `launch.train --full` for TRAIN_STEPS
    steps in a child process (loss finite and falling; K6 2 x 24 launches
    a step, remat recomputing the forward; K6b 24), its step wall,
    tokens/s and peak memory, with (c) a crash injected at TRAIN_CRASH_AT
    and checkpoints every TRAIN_CKPT_EVERY: it restores, and the steps it
    runs again from the checkpoint equal the same steps before the crash
    bit for bit; (a) one train step through the kernels against the plain
    route from shared carries, float32 and bf16, with a planted backward
    fault as a control. One step is traced in a fresh process
    (`--train-profile`) after (c). The children run first, while this
    process holds little of the card's memory. -> the kernels' launches
    in (b)."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    L = cfg.n_layers
    # the children need the card's memory: this process gives back its
    # cached blocks first
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[train] this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
        f" GiB of the card's; {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} "
        f"GiB free")
    args = ["--arch", LM_ARCH, "--full", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS),
            "--lr", str(TRAIN_LR), "--seed", str(TRAIN_SEED), "--device",
            DEVICE, "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    back = (TRAIN_CRASH_AT // TRAIN_CKPT_EVERY) * TRAIN_CKPT_EVERY
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=str(ROOT / "build")) as tmp:
        t0 = time.perf_counter()
        run = _train_cli(
            args + ["--ckpt-dir", os.path.join(tmp, "a")],
            env={"REPRO_FAULT_PLAN": json.dumps(
                {"crash_at_iter": TRAIN_CRASH_AT})})
        wall = time.perf_counter() - t0
    losses = run["losses"]
    n = run["launches"]
    by_variant = run["launches_by_variant"]
    steps = len(losses)           # TRAIN_STEPS and the replayed ones
    first, last5 = losses[0], float(np.mean(losses[-5:]))
    log(f"[train] launch.train {LM_ARCH} --full batch {TRAIN_BATCH} seq "
        f"{TRAIN_SEQ} steps {TRAIN_STEPS} (a crash at {TRAIN_CRASH_AT}, "
        f"checkpoints every {TRAIN_CKPT_EVERY}: {steps} steps run) on "
        f"{card}: loss {first:.4f} -> {losses[-1]:.4f} (mean of the last 5 "
        f"{last5:.4f}); step wall {run['step_wall_s'] * 1e3:.1f} ms (median "
        f"after the first; first {run['step_walls_s'][0]:.2f} s), "
        f"{run['tokens_per_s']:.0f} tokens/s; peak device memory "
        f"{(run['peak_bytes'] or 0) / 2 ** 30:.2f} GiB; flash_attention "
        f"launches {n['flash_attention']} (expected {2 * L * steps}),"
        f" flash_attention_bwd {n['flash_attention_bwd']} (expected "
        f"{L * steps}, all on wgmma); by variant {by_variant}; "
        f"{wall:.1f} s with the process start")
    assert np.all(np.isfinite(losses)) and \
        steps == TRAIN_STEPS + TRAIN_CRASH_AT - back, steps
    assert last5 < first, (first, last5)
    assert n["flash_attention"] == 2 * L * steps, n
    assert n["flash_attention_bwd"] == L * steps, n
    assert sum(n.values()) == 3 * L * steps, n
    assert by_variant["flash_attention_bwd"]["wgmma"] == L * steps, \
        by_variant
    assert by_variant["flash_attention"]["wgmma"] == 2 * L * steps, \
        by_variant
    once = losses[back:TRAIN_CRASH_AT]
    again = losses[TRAIN_CRASH_AT:2 * TRAIN_CRASH_AT - back]
    diff = [back + i for i, (a, b) in enumerate(zip(once, again)) if a != b]
    log(f"[train] crash at step {TRAIN_CRASH_AT}, checkpoints every "
        f"{TRAIN_CKPT_EVERY}: events {run['events']}, restored at {back}, "
        f"steps run {run['loss_steps']}; steps {back}-{TRAIN_CRASH_AT - 1} "
        f"run again from the checkpoint against the same steps before the "
        f"crash: {'bit-equal' if not diff else f'differ at steps {diff}'}")
    assert run["events"] == ["crash", "restore"], run["events"]
    assert run["loss_steps"] == list(range(TRAIN_CRASH_AT)) + \
        list(range(back, TRAIN_STEPS)), run["loss_steps"]
    restore_check("train", run, card)
    assert len(once) == TRAIN_CRASH_AT - back and not diff, \
        (diff, once, again)

    if LM_PROFILES:
        train_trace()
    else:
        log("[train] the traced step: not run (--lm-profiles)")
    for dtype, seeds in (("float32", (TRAIN_SEED,)),
                         ("bfloat16", TRAIN_GATE_SEEDS)):
        tol = TRAIN_RTOL[dtype]
        kernel = []
        for seed in seeds:
            readings = train_lockstep(
                torch, dtype, seed,
                TRAIN_FAULTS if seed == seeds[0] else ())
            kernel.append(readings[0])
            for fault, x in zip(TRAIN_FAULTS, readings[1:]):
                assert x["update"] > tol["update"], (dtype, fault, x)
        worst = {k: max(r[k] for r in kernel) for k in tol}
        log(f"[train] lockstep {dtype}: one parameter's update rel at most "
            f"{max(r['param_update'] for r in kernel):.2e} (not gated)")
        log(f"[train] lockstep {dtype}: the kernel route's largest rel over "
            f"{len(seeds)} seed(s) {worst}, limits {tol}")
        assert all(worst[k] <= tol[k] for k in tol), (dtype, worst, tol)

    return {"flash_attention": n["flash_attention"],
            "flash_attention_bwd": n["flash_attention_bwd"],
            "flash_attention variants": by_variant["flash_attention"],
            "flash_attention_bwd variants": by_variant["flash_attention_bwd"]}


def train_profile() -> dict:
    """One bf16 train step of the train phase (after two warm-up steps):
    the untraced wall, then one traced step -> {"wall_ms", "traced_ms",
    "busy_ms", "top"}. Run by the train phase in a child process
    (`--train-profile`)."""
    import torch
    from repro_torch.optim.adamw import adamw_init
    model, step, opt_cfg, batch = _train_parts(torch, "bfloat16", TRAIN_SEED)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params, opt_cfg)
    b0 = batch(0)
    for _ in range(2):
        params, opt, _ = step(params, opt, b0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, b0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, rows, traced = device_profile(torch, lambda: step(params, opt, b0),
                                        n_top=None)
    rows = [(k, c, t * 1e6) for k, c, t in rows if t > 0]
    return {"wall_ms": wall * 1e3, "traced_ms": traced * 1e3,
            "busy_ms": busy * 1e3, "top": rows[:8],
            # K6 and K6b's kernels, by name, wherever they rank
            "flash": [r for r in rows if "wgmma_kernel" in r[0]]}


def family_model(torch, arch: str, dtype: str, seed: int, batch: int,
                 prompt: int, n_layers: int = 0):
    """A family phase's model at its published width (cut to `n_layers`
    layers when given), random weights from `seed` on the card, and its
    prompts, made as `launch.serve` makes them."""
    from repro_torch.configs import get_config
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    cfg = get_config(arch).replace(dtype=dtype)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg, DEVICE)
    init_params(model, torch.Generator(device=DEVICE).manual_seed(seed))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt))
    return model, torch.as_tensor(prompts, device=DEVICE)


def family_prefix(cfg, batch: int, seed: int) -> dict:
    """vlm's patch embeddings or encdec's frame embeddings on the card, as
    `launch.serve` draws them (`launch.specs.prefix_specs`), or {}."""
    from repro_torch.launch.specs import prefix_specs
    return prefix_specs(cfg, batch, seed, DEVICE)


def family_prefix_len(cfg) -> int:
    """Positions ahead of the prompt: vlm's patches."""
    return cfg.vlm.n_patches if cfg.family == "vlm" else 0


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def serve_family(torch, args: list, label: str, card: str) -> dict:
    """`launch.serve.main(args)` with the launch counts set to 0 before
    and the peak device memory it added read after -> its result, with
    "counts", "variants", "peak_gib" and "wall_s"."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    free_card(torch)
    ops.reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve_cli.main(args + ["--device", DEVICE])
    out["wall_s"] = time.perf_counter() - t0
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    out["counts"] = ops.launch_counts()
    out["variants"] = ops.flash_variant_counts()
    log(f"[{label}] launch.serve {' '.join(args)} on {card}: prefill "
        f"{out['prefill_ms']:.2f} ms, first decode step "
        f"{out['first_step_ms']:.3f} ms, then "
        f"{out['decode_ms_per_token']:.3f} ms a token "
        f"({out['tok_per_s']:.1f} tok/s); peak device memory "
        f"{out['peak_gib']:.2f} GiB; flash_attention launches "
        f"{out['counts']['flash_attention']} (by variant "
        f"{out['variants']}), all launches {sum(out['counts'].values())}; "
        f"logits finite {out['logits_finite']}; {out['wall_s']:.1f} s wall "
        f"with the model's init")
    free_card(torch)
    return out


@contextlib.contextmanager
def moe_routing(torch, mode: str, decisions: list):
    """Inside the block the moe layers' routing decisions (the capacity
    dispatch's top-k experts, the decode route's expert mask) are recorded
    into `decisions` in call order (mode "record"), or replayed from it
    ("replay": each route keeps its own gate values at the recorded
    experts). A top-k is a step function of its input: two routes a few
    ulps apart pick different experts wherever two gates tie to within
    those ulps (a flip), and a flipped expert moves a token's output by a
    whole expert's share. Replaying one route's picks in the other holds
    the rest of their arithmetic to each other."""
    from repro_torch.models import moe
    real_route, real_dense = moe.route, moe.dense_weights
    replay = iter(decisions) if mode == "replay" else None

    def route(cfg, router, xt):
        gates, ids = real_route(cfg, router, xt)
        if replay is None:
            decisions.append(ids)
            return gates, ids
        ids = next(replay)
        probs = moe.router_probs(router, xt)
        return moe.renormalise(probs.gather(-1, ids)), ids

    def dense_weights(cfg, router, x):
        if replay is None:
            w = real_dense(cfg, router, x)
            decisions.append(w > 0)
            return w
        return moe.renormalise(torch.where(
            next(replay), moe.router_probs(router, x), 0.0))

    moe.route, moe.dense_weights = route, dense_weights
    try:
        yield
    finally:
        moe.route, moe.dense_weights = real_route, real_dense


def routing_flips(torch, a: list, b: list) -> tuple:
    """(tokens routed to other experts, tokens routed) over two records
    of the same calls."""
    flips = total = 0
    for x, y in zip(a, b):
        if x.dtype != torch.bool:
            x, y = x.sort(dim=-1).values, y.sort(dim=-1).values
        diff = (x != y).any(dim=-1)
        flips += int(diff.sum())
        total += diff.numel()
    return flips, total


def moe_lockstep(torch, model, tokens, faults=()) -> dict:
    """The moe model's prefill layer by layer from shared carries: each
    layer takes the kernel route's hidden state and runs (a) its
    attention (`attend_full`, after the output projection) through K6 and
    through the plain version, (b) the whole layer through K6 and through
    the plain route with the kernel route's routing replayed (pinned), (c)
    the plain route with its own routing (its flips). Beside them the
    plain route carries its own hidden state from the embedding, free:
    its distance from the kernel route's after each layer is how far the
    two routes diverge. With `faults`, the first MoE layer's (a) and (b)
    again with each one planted in the plain version (`planted`). ->
    {"attn", "layer", "diverge": [rel a layer], "flips": [(n, of) a
    layer], "faults", "layer_faults": [rel a fault]}."""
    from repro_torch.models import attention as attn
    cfg = model.cfg
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    out = {k: [] for k in ("attn", "layer", "flips", "diverge", "faults",
                           "layer_faults")}
    with torch.no_grad():
        x = xp = model.embed.apply_embed(tokens)
        for i, layer in enumerate(model.stack()):
            hn = layer.norm1(x)
            hk = attn.attend_full(cfg, layer.attn, hn, positions)[0]
            hp = attn.attend_full(cfg, layer.attn, hn, positions,
                                  use_kernels=False)[0]
            out["attn"].append(rel_err(torch, hk, hp)[1])
            del hp
            kernel, free = [], []
            with moe_routing(torch, "record", kernel):
                yk = layer(x, positions, True)[0]
            with moe_routing(torch, "replay", kernel):
                yp = layer(x, positions, False)[0]
            with moe_routing(torch, "record", free):
                layer(x, positions, False)
            out["layer"].append(rel_err(torch, yk, yp)[1])
            out["flips"].append(routing_flips(torch, kernel, free))
            del yp
            for fault in faults if i == 1 else ():
                with planted(torch, fault):
                    hf = attn.attend_full(cfg, layer.attn, hn, positions,
                                          use_kernels=False)[0]
                    with moe_routing(torch, "replay", kernel):
                        yf = layer(x, positions, False)[0]
                out["faults"].append(rel_err(torch, hk, hf)[1])
                out["layer_faults"].append(rel_err(torch, yk, yf)[1])
                del hf, yf
            del hn, hk
            xp = layer(xp, positions, False)[0]
            x = yk
            out["diverge"].append(rel_err(torch, x, xp)[1])
    return out


def moe_agreement(torch, model, tokens, bit_equal: bool = False,
                  faults=()) -> dict:
    """The moe model end to end: a prefill through K6, then
    MOE_DECODE_CHECK decode steps on its greedy tokens; the same through
    the plain route, with its own routing ("free") and with the kernel
    route's routing replayed ("pinned", `moe_routing`), and pinned again
    with each of `faults` planted in the plain version. With `bit_equal`,
    two kernel-route prefills first, their logits and caches equal bit for
    bit. -> {"free", "pinned": [rel of the prefill's logits, then each
    step's], "faults": [the largest such rel a fault], "flips": (tokens
    routed apart, tokens routed) free vs kernel, "first_equal": the pinned
    route's greedy first tokens equal the kernel route's}."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode as dec
    n_attn = model.cfg.n_layers
    max_len = MOE_PROMPT + MOE_DECODE_CHECK
    label = f"[moe] {model.cfg.dtype} at {n_attn} layers"
    if bit_equal:
        a, ca = dec.prefill(model, tokens, max_len)
        b, cb = dec.prefill(model, tokens, max_len)
        same = torch.equal(a, b) and all(
            torch.equal(ca[key][kv], cb[key][kv])
            for key in ("kv", "kv0") for kv in ("k", "v"))
        log(f"{label}: two prefills through K6 bit-equal (last-position "
            f"logits and every layer's k/v cache): {same}")
        assert same
        del a, b, ca, cb
    records = {"kernel": [], "free": []}
    steps, feed = {}, []
    runs = [("kernel", True, "record", records["kernel"], None),
            ("free", False, "record", records["free"], None),
            ("pinned", False, "replay", records["kernel"], None)]
    runs += [(f, False, "replay", records["kernel"], f) for f in faults]
    for name, use_kernels, mode, rec, fault in runs:
        model.use_kernels = use_kernels
        with moe_routing(torch, mode, rec), (
                planted(torch, fault) if fault else contextlib.nullcontext()):
            ops.reset_launch_counts()
            logits, cache = dec.prefill(model, tokens, max_len)
            torch.cuda.synchronize()
            n = ops.launch_counts()["flash_attention"]
            assert n == (n_attn if use_kernels else 0), (name, n)
            if not feed:
                feed.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
            steps[name] = [logits]
            for i in range(MOE_DECODE_CHECK):
                logits, cache = dec.decode_step(model, cache, feed[i])
                steps[name].append(logits)
                if len(feed) < MOE_DECODE_CHECK:
                    feed.append(torch.argmax(logits[:, -1],
                                             dim=-1)[:, None])
            del cache
    out = {name: [rel_err(torch, a, b)[1]
                  for a, b in zip(steps["kernel"], steps[name])]
           for name in ("free", "pinned")}
    out["faults"] = [max(rel_err(torch, a, b)[1]
                         for a, b in zip(steps["kernel"], steps[f]))
                     for f in faults]
    out["flips"] = routing_flips(torch, records["kernel"], records["free"])
    firsts = [torch.argmax(steps[k][0][:, -1], dim=-1)
              for k in ("kernel", "pinned")]
    out["first_equal"] = torch.equal(*firsts)
    finite = all(bool(torch.isfinite(t).all())
                 for v in steps.values() for t in v)
    log(f"{label}: prefill logits (K6 in {n_attn} layers) and "
        f"{MOE_DECODE_CHECK} decode steps against the plain route, rel: "
        f"routing pinned " + " ".join(f"{r:.2e}" for r in out["pinned"])
        + "; routing free " + " ".join(f"{r:.2e}" for r in out["free"])
        + f" ({out['flips'][0]} of {out['flips'][1]} token routings "
        f"flipped); greedy first tokens (pinned) "
        f"{'equal' if out['first_equal'] else 'differ'}; finite {finite}")
    for fault, r in zip(faults, out["faults"]):
        log(f"{label}: control, the plain route (routing pinned) with "
            f"{fault!r} planted in every layer: the largest rel {r:.2e}")
    assert finite, "non-finite logits"
    del steps, records
    free_card(torch)
    return out


def flash_timing(torch, arch: str, label: str, batch: int, S: int) -> dict:
    """K6 at a family prefill's shape (B batch x S positions, the arch's
    heads, bf16, causal: moe's B 4 x 4096, 16 heads over 16, D 128; vlm's
    B 4 x 4352, 32 over 8, D 128) against its plain version per row, then
    its L2-cold and warm times, the plain version's, SDPA's (timed only)
    and the bound (`flash_work`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    cfg = get_config(arch)
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, device=DEVICE).to(
        torch.bfloat16) for s in ((batch, S, H, D), (batch, S, Kv, D),
                                  (batch, S, Kv, D)))
    flush_buf = torch.empty((128 * 1024 * 1024 // 4,), device=DEVICE)

    def flush():
        flush_buf.zero_()

    before = ops.flash_variant_counts()
    got = ops.flash_attention(q, k, v)
    want = ref.attention_ref(q, k, v)
    ran = [n for n, c in ops.flash_variant_counts().items()
           if c != before[n]]
    e = row_rel_err(torch, got, want)
    assert e[1] <= FLASH_RTOL["bfloat16"], e
    assert ran == ["wgmma"], ran
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, nops = flash_work(q, k, True)
    r = dict(max_abs_err=e[0], row_rel=e[1],
             **timings(torch, lambda: ops.flash_attention(q, k, v),
                       lambda: ref.attention_ref(q, k, v), flush),
             bound=bound(nbytes, nops, BF16_TENSOR_OPS_PER_S),
             library_ms=device_ms(torch, lambda: sdpa(
                 qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush))
    r["shape"] = (f"B {batch} x H {H} (kv {Kv}), S {S}, D {D}, "
                  f"bf16, causal")
    log(f"[{label}] flash_attention at the prefill's shape ({r['shape']}), "
        f"variant wgmma: err {e[0]:.3e} (row rel {e[1]:.2e}); L2-cold "
        f"{r['ms'] * 1e3:.2f} us ({flash_rate(torch, q, k, True, r['ms'])}"
        f"), warm {r['warm_ms'] * 1e3:.2f} us; bound "
        f"{r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}); plain "
        f"{r['plain_ms'] * 1e3:.2f} us; library scaled_dot_product_attention "
        f"{r['library_ms'] * 1e3:.2f} us")
    del q, k, v, qt, kt, vt, flush_buf
    free_card(torch)
    return r


def run_family_profile(arch: str, label: str, untraced_ms=None) -> None:
    """`family_profile(arch)` in a fresh process (the profiler loses
    records late in a long one: PERF.md), its readings logged; a call the
    child did not time untraced is set beside `untraced_ms`. Only with
    --lm-profiles (LM_PROFILES)."""
    if not LM_PROFILES:
        log(f"[{label}] the traced prefill and decode of {arch}: not run "
            f"(--lm-profiles)")
        return
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--family-profile",
         arch], capture_output=True, text=True, timeout=900)
    assert child.returncode == 0, (child.returncode, child.stdout[-2000:],
                                   child.stderr[-4000:])
    log(f"[{label}] the traced child of {arch}: "
        f"{time.perf_counter() - t0:.1f} s with the process start")
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    for name, r in prof.items():
        whose = ""
        if r["wall_ms"] is None:
            r["wall_ms"], whose = untraced_ms, ", the serve run's"
        if r["busy_ms"] > 0:
            log(f"[{label}] one {name} of {arch} traced by torch.profiler in "
                f"a fresh process: {r['traced_ms']:.3f} ms wall traced "
                f"({r['wall_ms']:.3f} untraced{whose}), device busy "
                f"{r['busy_ms']:.3f} ms (idle share "
                f"{1 - r['busy_ms'] / r['traced_ms']:.4f}), {r['ops']} "
                f"device ops; top device ops:")
            for key, calls, us in r["top"]:
                log(f"[{label}]   {us:12.1f} us  {calls:6d} calls  "
                    f"{key[:90]}")
        else:
            log(f"[{label}] one {name}: {r['wall_ms']:.3f} ms wall; idle "
                f"share not measured (the profiler saw no device time)")


# whether the LM phases (lm, train and the five family phases) trace a
# prefill and a decode step, or a train step, in a child process each
# (--lm-profiles): seven children that gate nothing took ~175 s of a
# whole run on an H100, which the ftrain phase needs
LM_PROFILES = False
# the family phases' serving shapes: (batch, prompt, seed)
FAMILY_SHAPES = {MOE_ARCH: (MOE_BATCH, MOE_PROMPT, MOE_SEED),
                 SSM_ARCH: (SSM_BATCH, SSM_PROMPT, SSM_SEED),
                 HYBRID_ARCH: (HYBRID_BATCH, HYBRID_PROMPT, HYBRID_SEED),
                 VLM_ARCH: (VLM_BATCH, VLM_PROMPT, VLM_SEED),
                 ENCDEC_ARCH: (ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_SEED)}


def family_profile(arch: str) -> dict:
    """One bf16 prefill of a family phase's model (and, but for ssm, one
    decode step): after a warm-up, the untraced wall (the mean of 3
    calls), then one traced call; ssm's prefill (~10 s a call, nearly all
    of it on the card) is traced at once, its untraced wall None (the
    phase's serve run has it) -> {"prefill"|"decode": {"wall_ms",
    "traced_ms", "busy_ms", "ops", "top"}}. Run by the family phases in a
    child process (`--family-profile ARCH`)."""
    import torch
    from repro_torch.models import decode as dec
    ssm = arch == SSM_ARCH
    batch, prompt, seed = FAMILY_SHAPES[arch]
    model, tokens = family_model(torch, arch, "bfloat16", seed, batch,
                                 prompt)
    prefix = family_prefix(model.cfg, batch, seed)
    max_len = prompt + 16 + family_prefix_len(model.cfg)

    def prefill():
        return dec.prefill(model, tokens, max_len, **prefix)

    calls = [("prefill", prefill, 0 if ssm else 3)]
    if not ssm:
        logits, cache = prefill()
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for _ in range(2):
            dec.decode_step(model, cache, tok)
        calls.append(("decode", lambda: dec.decode_step(model, cache, tok),
                      3))
    out = {}
    for name, fn, n in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n if n else None
        busy, rows, traced = device_profile(torch, fn, n_top=None)
        rows = [(k, c, t * 1e6) for k, c, t in rows if t > 0]
        out[name] = {"wall_ms": wall, "traced_ms": traced * 1e3,
                     "busy_ms": busy * 1e3,
                     "ops": sum(c for _, c, _ in rows), "top": rows[:10]}
    return out


def moe_fan_in_d() -> dict:
    """The moe phase's bf16 model end to end (`moe_agreement`) with the
    expert weights w_gate and w_up at fan-in d (std 1/45.3) where the
    reference's init gives them fan-in E (std 1/8): what the bf16
    end-to-end readings come to without the init's amplification. No
    phase runs it (`--moe-fan-in-d`; MOE_E2E_RTOL cites it)."""
    import torch
    model, tokens = family_model(torch, MOE_ARCH, "bfloat16", MOE_SEED,
                                 MOE_BATCH, MOE_PROMPT)
    scale = (model.cfg.moe.n_experts / model.cfg.d_model) ** 0.5
    with torch.no_grad():
        for layer in model.layers:
            layer.moe.w_gate.mul_(scale)
            layer.moe.w_up.mul_(scale)
    e2e = moe_agreement(torch, model, tokens)
    return {"pinned": e2e["pinned"], "free": e2e["free"],
            "flips": e2e["flips"], "card": torch.cuda.get_device_name(0)}


def phase_moe(torch, card: str) -> dict:
    """The moe family on the card: `launch.serve` for deepseek-moe-16b at
    full width, twice (cold, then warm: K6 in each of the 28 attention
    layers of the prefill, all wgmma; tokens in range; logits finite);
    the prefill and MOE_DECODE_CHECK decode steps through K6 against the
    plain route from the same weights, in bf16 at full width (two
    prefills bit-equal first) and in float32 at MOE_F32_LAYERS layers,
    each layer from shared carries (`moe_lockstep`, LM_RTOL) and end to
    end (MOE_E2E_RTOL) with the routing pinned (`moe_routing`), planted
    faults read past both limits, the free routing's readings beside
    them; grok-1-314b's reduced config served; K6 timed at
    the prefill's shape; one prefill and one decode step traced in a
    child process. -> K6's launches in the first serve run, and its
    timing at the moe shape."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    base = ["--arch", MOE_ARCH, "--full", "--batch", str(MOE_BATCH),
            "--prompt-len", str(MOE_PROMPT), "--new-tokens", str(MOE_NEW),
            "--seed", str(MOE_SEED)]
    first = None
    for run in ("cold",):   # and a warm repeat until the ftrain phase
        out = serve_family(torch, base, f"moe, {run}", card)
        counts, variants, toks = out["counts"], out["variants"], out["tokens"]
        assert counts["flash_attention"] == cfg.n_layers == \
            sum(counts.values()), counts
        assert variants["wgmma"] == cfg.n_layers == \
            sum(variants.values()), variants
        assert toks.shape == (MOE_BATCH, MOE_NEW), toks.shape
        assert np.all((toks >= 0) & (toks < cfg.vocab_size)), toks
        assert out["logits_finite"]
        first = first or out
    for dtype, n_layers in (("bfloat16", 0), ("float32", MOE_F32_LAYERS)):
        tol = LM_RTOL[dtype]
        model, tokens = family_model(torch, MOE_ARCH, dtype, MOE_SEED,
                                     MOE_BATCH, MOE_PROMPT, n_layers)
        label = f"[moe] {dtype} at {model.cfg.n_layers} layers"
        lock = moe_lockstep(torch, model, tokens,
                            FLASH_FAULTS if dtype == "bfloat16" else ())
        for i, (a, b, f, d) in enumerate(zip(lock["attn"], lock["layer"],
                                             lock["flips"],
                                             lock["diverge"])):
            log(f"{label}, layer {i} from the kernel route's carry: "
                f"attention K6 vs plain rel {a:.2e}; the layer, routing "
                f"pinned, rel {b:.2e}; the plain route's own routing "
                f"flips {f[0]} of {f[1]}; the free plain route's carry "
                f"from the embedding vs the kernel route's rel {d:.2e}")
        for fault, a, b in zip(FLASH_FAULTS, lock["faults"],
                               lock["layer_faults"]):
            log(f"{label}: control, layer 1 with {fault!r} planted in its "
                f"plain attention: the attention rel {a:.2e}, the layer "
                f"(routing pinned) rel {b:.2e} (limit {tol})")
            if fault != "fp8 p":
                assert a > tol and b > tol, (fault, a, b)
        e2e = moe_agreement(torch, model, tokens,
                            bit_equal=dtype == "bfloat16",
                            faults=MOE_E2E_FAULTS if dtype == "bfloat16"
                            else ())
        limit = MOE_E2E_RTOL[dtype]
        log(f"{label}: from shared carries the largest rel, attention "
            f"{max(lock['attn']):.2e}, a layer (routing pinned) "
            f"{max(lock['layer']):.2e} (tolerance rel {tol}); end to end, "
            f"routing pinned {max(e2e['pinned']):.2e} (tolerance rel "
            f"{limit}), free {max(e2e['free']):.2e} ({e2e['flips'][0]} "
            f"flips, not gated)")
        assert max(lock["attn"]) <= tol and max(lock["layer"]) <= tol, lock
        assert max(e2e["pinned"]) <= limit, e2e
        assert all(r > limit for r in e2e["faults"]), e2e
        if dtype == "float32":
            assert e2e["first_equal"], e2e
        del model, tokens
        free_card(torch)
    small = serve_family(torch, [
        "--arch", MOE_REDUCED_ARCH, "--batch", str(MOE_BATCH),
        "--prompt-len", str(MOE_REDUCED_PROMPT), "--new-tokens", "16",
        "--seed", str(MOE_SEED)], "moe, reduced", card)
    assert sum(small["counts"].values()) == 0, small["counts"]
    assert small["logits_finite"] and small["tokens"].shape == \
        (MOE_BATCH, 16)
    timing = flash_timing(torch, MOE_ARCH, "moe", MOE_BATCH, MOE_PROMPT)
    run_family_profile(MOE_ARCH, "moe")
    return {"flash_attention": first["counts"]["flash_attention"],
            "flash_attention variants": first["variants"],
            "flash_attention moe_prefill": timing}


def phase_ssm(torch, card: str) -> None:
    """The ssm family on the card: `launch.serve` for falcon-mamba-7b at
    full width (no kernel launch; tokens in range; logits finite); in
    float32 at full width and SSM_F32_LAYERS layers, a prefill of
    SSM_GATE_PROMPT tokens and one decode step against a prefill of one
    token more (last-position logits within SSM_RTOL: the gate, there
    being no kernel); the device memory a prefill leaves allocated after
    prompts of SSM_STATE_PROMPTS tokens, equal; one prefill traced in a
    child process."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    out = serve_family(torch, [
        "--arch", SSM_ARCH, "--full", "--batch", str(SSM_BATCH),
        "--prompt-len", str(SSM_PROMPT), "--new-tokens", str(SSM_NEW),
        "--seed", str(SSM_SEED)], "ssm", card)
    check_served(out, cfg, SSM_BATCH, SSM_NEW, 0, None)
    decode_gate(torch, SSM_ARCH, "ssm", "float32", SSM_F32_LAYERS,
                SSM_GATE_PROMPT, 1, SSM_RTOL)
    state_readings(torch, SSM_ARCH, "ssm", SSM_F32_LAYERS, SSM_BATCH,
                   SSM_STATE_PROMPTS, SSM_NEW)
    run_family_profile(SSM_ARCH, "ssm", out["prefill_ms"])


def family_agreement(torch, label: str, model, tokens, prefix: dict,
                     max_len: int, n_attn: int, faults=()) -> dict:
    """A family's model end to end: a prefill through K6, then
    LM_DECODE_CHECK decode steps on its greedy tokens; the same through
    the plain route, and through the plain route with each of `faults`
    planted in K6's plain version (`planted`). -> {"kernel": [rel of the
    prefill's logits, then each step's, against the plain route],
    "faults": [the largest such rel a fault], "first_equal": both routes'
    greedy first tokens equal}."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode as dec
    steps, feed = {}, []
    runs = [("kernel", True, None), ("plain", False, None)]
    runs += [(f, False, f) for f in faults]
    for name, use_kernels, fault in runs:
        model.use_kernels = use_kernels
        with (planted(torch, fault) if fault else contextlib.nullcontext()):
            ops.reset_launch_counts()
            logits, cache = dec.prefill(model, tokens, max_len, **prefix)
            torch.cuda.synchronize()
            n = ops.launch_counts()["flash_attention"]
            assert n == (n_attn if use_kernels else 0), (name, n)
            if not feed:
                feed.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
            steps[name] = [logits]
            for i in range(LM_DECODE_CHECK):
                logits, cache = dec.decode_step(model, cache, feed[i])
                steps[name].append(logits)
                if len(feed) < LM_DECODE_CHECK:
                    feed.append(torch.argmax(logits[:, -1],
                                             dim=-1)[:, None])
            del cache
    model.use_kernels = True
    cfg = model.cfg
    out = {"kernel": [logits_rel(torch, cfg, a, b)
                      for a, b in zip(steps["kernel"], steps["plain"])]}
    out["faults"] = [max(logits_rel(torch, cfg, a, b)
                         for a, b in zip(steps["kernel"], steps[f]))
                     for f in faults]
    out["first_equal"] = torch.equal(
        *[torch.argmax(steps[k][0][:, -1], dim=-1)
          for k in ("kernel", "plain")])
    finite = all(bool(torch.isfinite(t).all())
                 for v in steps.values() for t in v)
    log(f"{label}: prefill logits (K6 in {n_attn} layers) and "
        f"{LM_DECODE_CHECK} decode steps against the plain route, rel "
        + " ".join(f"{r:.2e}" for r in out["kernel"])
        + f"; greedy first tokens "
        f"{'equal' if out['first_equal'] else 'differ'}; finite {finite}")
    for fault, r in zip(faults, out["faults"]):
        log(f"{label}: control, the plain route with {fault!r} planted in "
            f"every attention layer: the largest rel {r:.2e}")
    assert finite, "non-finite logits"
    del steps
    free_card(torch)
    return out


def family_lockstep(torch, label: str, model, tokens, prefix: dict,
                    faults=()) -> dict:
    """A family's prefill layer by layer from shared carries: each
    attention layer's attention (`attend_full`, after the output
    projection) through K6 and through its plain version on the kernel
    route's carry; beside them the plain route's own carry from the
    embedding, free (its distance from the kernel route's after each
    layer: how far the routes drift apart). With `faults`, the first
    attention layer's attention again with each planted in the plain
    version. -> {"attn": [rel an attention layer], "diverge": [rel a
    layer], "faults": [rel a fault]}."""
    from repro_torch.models import attention as attn
    from repro_torch.models.transformer import DenseLayer
    out = {"attn": [], "diverge": [], "faults": []}
    with torch.no_grad():
        x, positions, _ = model.embed_inputs(tokens, **prefix)
        xp = x
        for layer in model.stack():
            if isinstance(layer, DenseLayer):
                hn = layer.norm1(x)
                args = (model.cfg, layer.attn, hn, positions)
                kw = dict(causal=layer.causal, window=layer.window)
                hk = attn.attend_full(*args, **kw)[0]
                hp = attn.attend_full(*args, use_kernels=False, **kw)[0]
                out["attn"].append(rel_err(torch, hk, hp)[1])
                for fault in faults if len(out["attn"]) == 1 else ():
                    with planted(torch, fault):
                        hf = attn.attend_full(*args, use_kernels=False,
                                              **kw)[0]
                    out["faults"].append(rel_err(torch, hk, hf)[1])
                    del hf
                del hn, hk, hp
            x = layer(x, positions, True)[0]
            xp = layer(xp, positions, False)[0]
            out["diverge"].append(rel_err(torch, x, xp)[1])
    log(f"{label}: each attention layer from the kernel route's carry, K6 "
        f"vs plain rel " + " ".join(f"{r:.2e}" for r in out["attn"])
        + "; the free plain route's carry vs the kernel route's after "
        f"each layer rel " + " ".join(f"{r:.1e}" for r in out["diverge"]))
    for fault, r in zip(faults, out["faults"]):
        log(f"{label}: control, the first attention layer with {fault!r} "
            f"planted in its plain version: rel {r:.2e}")
    free_card(torch)
    return out


def family_bf16_gate(torch, arch: str, tag: str, n_attn: int,
                     e2e_tol: float = LM_RTOL["bfloat16"]) -> None:
    """The bf16 gate at full depth: K6's route against the plain route,
    a layer at a time from shared carries (`family_lockstep`, within
    LM_RTOL's bf16 limit) and end to end (`family_agreement`, within
    `e2e_tol`), with FAMILY_FAULTS planted past both."""
    batch, prompt, seed = FAMILY_SHAPES[arch]
    model, tokens = family_model(torch, arch, "bfloat16", seed, batch,
                                 prompt)
    prefix = family_prefix(model.cfg, batch, seed)
    label = f"[{tag}] bfloat16 at {model.cfg.n_layers} layers"
    faults = FAMILY_FAULTS
    tol = LM_RTOL["bfloat16"]
    lock = family_lockstep(torch, label, model, tokens, prefix, faults)
    e2e = family_agreement(
        torch, label, model, tokens, prefix,
        prompt + LM_DECODE_CHECK + family_prefix_len(model.cfg), n_attn,
        faults)
    log(f"{label}: the largest rel, an attention layer from shared "
        f"carries {max(lock['attn']):.2e} (tolerance rel {tol}), end to "
        f"end {max(e2e['kernel']):.2e} (tolerance rel {e2e_tol}); controls "
        + ", ".join(f"{f!r} {a:.2e} / {b:.2e}" for f, a, b in
                    zip(faults, lock["faults"], e2e["faults"])))
    del model, tokens, prefix
    free_card(torch)
    assert max(lock["attn"]) <= tol, lock
    assert max(e2e["kernel"]) <= e2e_tol, e2e
    assert all(r > tol for r in lock["faults"]), lock
    assert all(r > e2e_tol for r in e2e["faults"]), e2e


@contextlib.contextmanager
def decode_fault(torch, fault: str):
    """Inside the block the decode path has `fault` planted: "position"
    (encdec's step adds the sinusoid of the next position), "cross" (its
    cross-attention's branch adds nothing), "ring" (a windowed cache is
    filled with the prompt's last keys unrolled), "length" (vlm's cache
    length leaves out the patches)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import decode as dec
    from repro_torch.models import layers as L
    saved = [(L, "sinusoid_at"), (attn, "cross_decode"),
             (attn, "fill_cache"), (dec, "prefill")]
    saved = [(m, n, getattr(m, n)) for m, n in saved]
    real = {n: f for _, n, f in saved}
    if fault == "position":
        L.sinusoid_at = lambda pos, d, device: \
            real["sinusoid_at"](pos + 1, d, device)
    elif fault == "cross":
        attn.cross_decode = lambda p, x, k, v: torch.zeros_like(x)
    elif fault == "ring":
        def unrolled(k_cache, k):
            S, S_max = k.shape[1], k_cache.shape[1]
            k_cache.copy_(k[:, -S_max:]) if S > S_max else \
                real["fill_cache"](k_cache, k)
        attn.fill_cache = unrolled
    elif fault == "length":
        def short(model, tokens, max_len, **kw):
            logits, cache = real["prefill"](model, tokens, max_len, **kw)
            cache["length"] -= family_prefix_len(model.cfg)
            return logits, cache
        dec.prefill = short
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def decode_gate(torch, arch: str, tag: str, dtype: str, n_layers: int,
                S: int, n_steps: int, tol: float, faults=()) -> list:
    """A prefill of S tokens (after vlm's patches, beside encdec's
    frames), then n_steps decode steps, each step's logits against the
    last position of a prefill one token longer; again with each of
    `faults` planted in the decode path (`decode_fault`), read past `tol`.
    -> the readings."""
    from repro_torch.models import decode as dec
    seed = FAMILY_SHAPES[arch][2]
    model, tokens = family_model(torch, arch, dtype, seed, 1, S + n_steps,
                                 n_layers)
    prefix = family_prefix(model.cfg, 1, seed)
    P = family_prefix_len(model.cfg)
    label = f"[{tag}] {dtype} at {model.cfg.n_layers} layers"

    def run():
        _, cache = dec.prefill(model, tokens[:, :S], P + S + n_steps,
                               **prefix)
        rels = []
        for i in range(n_steps):
            got, cache = dec.decode_step(model, cache,
                                         tokens[:, S + i:S + i + 1])
            want, _ = dec.prefill(model, tokens[:, :S + i + 1],
                                  P + S + i + 1, **prefix)
            rels.append(logits_rel(torch, model.cfg, got, want))
        return rels

    rels = run()
    log(f"{label}: a prefill of {S} tokens{f' after {P} patches' if P else ''}"
        f" and {n_steps} decode step(s), each against a prefill one token "
        f"longer, last-position logits rel "
        + " ".join(f"{r:.2e}" for r in rels) + f" (tolerance rel {tol})")
    controls = []
    for fault in faults:
        with decode_fault(torch, fault):
            controls.append(max(run()))
        log(f"{label}: control, {fault!r} planted in the decode path: the "
            f"largest rel {controls[-1]:.2e}")
    del model, tokens, prefix
    free_card(torch)
    assert max(rels) <= tol, rels
    assert all(r > tol for r in controls), controls
    return rels


def state_readings(torch, arch: str, tag: str, n_layers: int, batch: int,
                   prompts: tuple, new: int) -> list:
    """The device memory a prefill leaves allocated (its logits and decode
    state) after prompts of each length in `prompts`, float32 at
    `n_layers` layers, equal, and the state's own bytes, equal; beside
    them the state's bytes at full depth in bf16, from the cache's shapes.
    -> the ring's slots after each prompt (None without attention)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import Model

    def state_bytes(c):
        return sum(t.numel() * t.element_size() for key, v in c.items()
                   if key != "length"
                   for t in (v.values() if isinstance(v, dict) else (v,)))

    cfg = get_config(arch)
    model, _ = family_model(torch, arch, "float32", 0, 1, 1, n_layers)
    rng = np.random.default_rng(0)
    held, sizes, slots = [], [], []
    for n in prompts:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, n)),
                               device=DEVICE)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        logits, cache = dec.prefill(model, toks, n + new)
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated() - base)
        sizes.append(state_bytes(cache))
        slots.append(cache["kv"]["k"].shape[2] if "kv" in cache else None)
        del logits, cache, toks
    del model
    full = state_bytes(dec.init_cache(Model(cfg, "meta"), batch,
                                      max(prompts) + new))
    log(f"[{tag}] device memory a prefill leaves allocated (its logits and "
        f"decode state), {n_layers} float32 layers, batch {batch}, after "
        f"prompts of {prompts} tokens: {held} bytes (the state's tensors "
        f"{sizes}{f'; ring slots {slots}' if slots[0] else ''}); computed "
        f"from the cache's shapes at full depth in bf16: {full} bytes "
        f"({full / 2 ** 20:.1f} MiB)")
    assert len(set(held)) == 1 and len(set(sizes)) == 1, (held, sizes)
    free_card(torch)
    return slots


def check_served(out: dict, cfg, batch: int, new: int, n_attn: int,
                 variant: str | None) -> None:
    """A family's serve run: K6 launched n_attn times, all under
    `variant`, and nothing else; tokens in range; logits finite."""
    counts, variants, toks = out["counts"], out["variants"], out["tokens"]
    assert counts["flash_attention"] == n_attn == sum(counts.values()), \
        counts
    if variant:
        assert variants[variant] == n_attn == sum(variants.values()), \
            variants
    assert toks.shape == (batch, new), toks.shape
    assert np.all((toks >= 0) & (toks < cfg.vocab_size)), toks
    assert out["logits_finite"]


def phase_hybrid(torch, card: str) -> dict:
    """The hybrid family on the card: `launch.serve` for recurrentgemma-2b
    at full width (K6 `mma` with its window in each of the 8 attention
    layers of the prefill; tokens in range; logits finite); the bf16 gate
    at full depth (`family_bf16_gate`); the float32 gate at
    HYBRID_F32_LAYERS layers past the ring's wrap (`decode_gate`, with the
    ring filled unrolled as a control); the decode state's bytes after
    prompts of HYBRID_STATE_PROMPTS tokens, equal (the ring holds the
    window's 2048 slots either way); one prefill and one decode step
    traced in a child process. -> K6's launches in the serve run."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID_ARCH)
    n_attn = cfg.n_layers // 3
    out = serve_family(torch, [
        "--arch", HYBRID_ARCH, "--full", "--batch", str(HYBRID_BATCH),
        "--prompt-len", str(HYBRID_PROMPT), "--new-tokens", str(HYBRID_NEW),
        "--seed", str(HYBRID_SEED)], "hybrid", card)
    check_served(out, cfg, HYBRID_BATCH, HYBRID_NEW, n_attn, "mma")
    family_bf16_gate(torch, HYBRID_ARCH, "hybrid", n_attn, HYBRID_E2E_RTOL)
    decode_gate(torch, HYBRID_ARCH, "hybrid", "float32", HYBRID_F32_LAYERS,
                HYBRID_GATE_PROMPT, HYBRID_GATE_STEPS, LM_RTOL["float32"],
                ("ring",))
    slots = state_readings(torch, HYBRID_ARCH, "hybrid", HYBRID_F32_LAYERS,
                           HYBRID_BATCH, HYBRID_STATE_PROMPTS, HYBRID_NEW)
    assert slots == [cfg.hybrid.window] * len(slots), slots
    run_family_profile(HYBRID_ARCH, "hybrid")
    return {"flash_attention": out["counts"]["flash_attention"],
            "flash_attention variants": out["variants"]}


def phase_vlm(torch, card: str) -> dict:
    """The vlm family on the card: `launch.serve` for pixtral-12b at full
    width (256 patch embeddings ahead of each 4096-token prompt: K6
    `wgmma` at D 128, G 4 over 4352 positions in each of the 40 layers;
    tokens in range; logits finite); the bf16 gate at full depth
    (`family_bf16_gate`); the float32 gate at VLM_F32_LAYERS layers
    (`decode_gate`, with the cache's length short of the patches as a
    control); K6 timed at the prefill's shape; one prefill and one decode
    step traced in a child process. -> K6's launches in the serve run and
    its timing."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    out = serve_family(torch, [
        "--arch", VLM_ARCH, "--full", "--batch", str(VLM_BATCH),
        "--prompt-len", str(VLM_PROMPT), "--new-tokens", str(VLM_NEW),
        "--seed", str(VLM_SEED)], "vlm", card)
    check_served(out, cfg, VLM_BATCH, VLM_NEW, cfg.n_layers, "wgmma")
    family_bf16_gate(torch, VLM_ARCH, "vlm", cfg.n_layers)
    decode_gate(torch, VLM_ARCH, "vlm", "float32", VLM_F32_LAYERS,
                VLM_PROMPT, 1, LM_RTOL["float32"], ("length",))
    timing = flash_timing(torch, VLM_ARCH, "vlm", VLM_BATCH,
                          VLM_PROMPT + cfg.vlm.n_patches)
    run_family_profile(VLM_ARCH, "vlm")
    return {"flash_attention": out["counts"]["flash_attention"],
            "flash_attention variants": out["variants"],
            "flash_attention vlm_prefill": timing}


def phase_encdec(torch, card: str) -> None:
    """The encdec family on the card: `launch.serve` for whisper-small at
    full width (1500 frames, 4 prompts of 384 tokens, 32 new: no kernel
    launch, as in the reference; tokens in range; logits finite); the
    CLI's refusal past 448 target positions; its gates at full depth
    (`decode_gate`, float32 and bf16, with ENCDEC_FAULTS planted as
    controls), and the kernel and plain routes bit-equal end to end (no
    kernel on the path); one prefill and one decode step traced in a
    child process."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode as dec
    cfg = get_config(ENCDEC_ARCH)
    out = serve_family(torch, [
        "--arch", ENCDEC_ARCH, "--full", "--batch", str(ENCDEC_BATCH),
        "--prompt-len", str(ENCDEC_PROMPT), "--new-tokens", str(ENCDEC_NEW),
        "--seed", str(ENCDEC_SEED)], "encdec", card)
    check_served(out, cfg, ENCDEC_BATCH, ENCDEC_NEW, 0, None)
    try:
        serve_cli.main(["--arch", ENCDEC_ARCH, "--full", "--prompt-len",
                        "440", "--new-tokens", "9", "--device", DEVICE])
        refused = None
    except SystemExit as exc:
        refused = exc.code
    log(f"[encdec] launch.serve past {cfg.encdec.max_target_positions} "
        f"target positions (440 + 9): exit {refused}")
    assert refused == 2, refused
    for dtype in ("float32", "bfloat16"):
        decode_gate(torch, ENCDEC_ARCH, "encdec", dtype, 0,
                    ENCDEC_GATE_PROMPT, 1, LM_RTOL[dtype], ENCDEC_FAULTS)
    model, tokens = family_model(torch, ENCDEC_ARCH, "bfloat16", ENCDEC_SEED,
                                 ENCDEC_BATCH, ENCDEC_PROMPT)
    prefix = family_prefix(model.cfg, ENCDEC_BATCH, ENCDEC_SEED)
    routes = []
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        routes.append(dec.prefill(model, tokens, ENCDEC_PROMPT + 1,
                                  **prefix)[0])
    same = torch.equal(*routes)
    log(f"[encdec] bfloat16 at full depth: the prefill's logits through the "
        f"kernel route and the plain route bit-equal (no kernel on the "
        f"path): {same}")
    assert same
    del model, tokens, prefix, routes
    free_card(torch)
    run_family_profile(ENCDEC_ARCH, "encdec")


def family_train(argv: list) -> None:
    """The ftrain phase's child: `ARCH:LAYERS [--fault-plan JSON]
    TRAIN_ARGS [--and ...]`, each group one `repro_torch.launch.train.
    main(TRAIN_ARGS)` with ARCH's published config cut to LAYERS layers
    (0: its published depth) and the plan in REPRO_FAULT_PLAN for that
    run, one after the other in this process, the card's cached blocks
    returned between them. The cut is made here, on the smoke's side:
    `launch.train` takes no depth flag, as the reference's has none. A
    run's --ckpt-dir is removed after it."""
    import torch
    from repro_torch.launch import train
    published = train.get_config
    groups, group = [], []
    for token in argv:
        if token == "--and":
            groups.append(group)
            group = []
        else:
            group.append(token)
    groups.append(group)
    for head, *args in groups:
        arch, layers = head.split(":")
        os.environ.pop("REPRO_FAULT_PLAN", None)
        if args[:1] == ["--fault-plan"]:
            os.environ["REPRO_FAULT_PLAN"] = args[1]
            args = args[2:]

        def cut(name, reduced=True, arch=arch, layers=int(layers)):
            cfg = published(name, reduced=reduced)
            if name == arch and not reduced and layers:
                cfg = cfg.replace(n_layers=layers)
            return cfg

        train.get_config = cut
        train.main(args)
        # the machine's disk counts every block written: the next run's
        # checkpoint reuses this one's
        if "--ckpt-dir" in args:
            shutil.rmtree(args[args.index("--ckpt-dir") + 1],
                          ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def ftrain_expected(cfg) -> dict:
    """K6 and K6b launches of one remat train step, by variant: K6 twice
    an attention layer that reaches BLOCKWISE_MIN_KV keys (the forward,
    then its recomputation in the backward), K6b once."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import BLOCKWISE_MIN_KV
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // 3
    elif cfg.family in ("ssm", "encdec"):
        n_attn = 0      # no attention; encdec's stay under 2048 keys
        assert cfg.family == "ssm" or max(
            cfg.encdec.encoder_frames, FTRAIN[ENCDEC_ARCH][2]) < \
            BLOCKWISE_MIN_KV
    else:
        n_attn = cfg.n_layers
    D = cfg.resolved_head_dim
    fwd = ops.flash_variant(cfg.torch_dtype, D)
    bwd = ops.flash_bwd_variant(cfg.torch_dtype, D)
    return {"flash_attention": {fwd: 2 * n_attn} if n_attn else {},
            "flash_attention_bwd": {bwd: n_attn} if n_attn else {}}


def ftrain_args(arch: str, ckpt_dir: str, extra=(), plan=None) -> tuple:
    """-> (arch, layers, the `launch.train` arguments, the fault plan or
    None) of one ftrain run: FTRAIN[arch]'s depth, batch, seq and steps
    at TRAIN_LR,
    its published dtype (bf16) and remat."""
    layers, batch, seq, steps = FTRAIN[arch]
    return arch, layers, [
        "--arch", arch, "--full", "--batch", str(batch), "--seq", str(seq),
        "--steps", str(steps), "--lr", str(TRAIN_LR), "--seed",
        str(TRAIN_SEED), "--device", DEVICE, "--ckpt-dir", ckpt_dir,
        *extra], plan


def ftrain_check(arch: str, res: dict, card: str) -> None:
    """One ftrain run's result: finite losses, the mean of the last 3
    below the first, K6 and K6b launches by variant as `ftrain_expected`,
    the peak under FTRAIN_PEAK_GIB."""
    from repro_torch.configs import get_config
    layers, batch, seq, n_steps = FTRAIN[arch]
    label = f"ftrain {FTRAIN_LABEL[arch]}"
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    losses = res["losses"]
    want = ftrain_expected(cfg)
    steps = len(losses)
    got = {k: {v: c for v, c in res["launches_by_variant"][k].items() if c}
           for k in want}
    want = {k: {v: c * steps for v, c in by.items()}
            for k, by in want.items()}
    peak = (res["peak_bytes"] or 0) / 2 ** 30
    n_pos = seq + (cfg.vlm.n_patches if cfg.family == "vlm" else 0)
    log(f"[{label}] launch.train {arch} --full at {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, batch {batch} x seq {seq} "
        f"({n_pos} positions), {n_steps} steps, events "
        f"{res['events']}, on {card}: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (mean of the last 3 {np.mean(losses[-3:]):.4f});"
        f" step wall {res['step_wall_s'] * 1e3:.1f} ms (median after the "
        f"first; first {res['step_walls_s'][0]:.2f} s), "
        f"{res['tokens_per_s']:.0f} tokens/s; peak device memory "
        f"{peak:.2f} GiB (limit {FTRAIN_PEAK_GIB}); K6/K6b launches by "
        f"variant {got} (expected {want})")
    assert np.all(np.isfinite(losses)), losses
    assert float(np.mean(losses[-3:])) < losses[0], losses
    assert got == want, (got, want)
    assert peak < FTRAIN_PEAK_GIB, peak


def family_train_lockstep(torch, arch: str) -> list:
    """One bf16 train step of `arch` at FLOCK_LAYERS[arch] layers (full
    width, the train run's batch and seq) through K6/K6b and through the
    plain route (`use_kernels=False`), from one shared carry (the params
    and moments after one kernel-route step from the seeded init; the
    pipeline's second batch), then the plain route with FLOCK_FAULT[arch]
    planted in its backward; moe's plain routes replay the kernel route's
    experts (`moe_routing`: a top-k flip between two routes a few ulps
    apart moves a token by a whole expert). -> [the kernel route's
    readings, the control's], each against the plain route
    (`train_readings`)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step
    _, B, S, _ = FTRAIN[arch]
    model, _ = family_model(torch, arch, "bfloat16", TRAIN_SEED, 1, 1,
                            FLOCK_LAYERS[arch])
    cfg = model.cfg
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.01)
    step = make_train_step(model, opt_cfg)
    pipe = TokenPipeline(cfg, B, S, seed=TRAIN_SEED)

    def batch(i):   # as launch.train feeds it
        return {k: torch.as_tensor(v, device=DEVICE, dtype=(
                    cfg.torch_dtype if k in ("patches", "frames") else None))
                for k, v in pipe.batch_at(i).items()}

    want = {k: sum(by.values()) for k, by in ftrain_expected(cfg).items()}
    params = {k: p.detach() for k, p in model.named_parameters()}
    params, opt, _ = step(params, adamw_init(params, opt_cfg), batch(0))
    b1 = batch(1)
    experts = []

    def routing(mode):
        if cfg.family != "moe":
            return contextlib.nullcontext()
        return moe_routing(torch, mode, experts)

    res = {}
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        ops.reset_launch_counts()
        with routing("record" if use_kernels else "replay"):
            new, _, met = step(params, opt, b1)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        got = {k: n[k] for k in want}
        assert got == (want if use_kernels else {k: 0 for k in want}), \
            (arch, use_kernels, got, want)
        res[use_kernels] = (new, met)
    readings = [train_readings(torch, params, res[True], res[False])]
    model.use_kernels = False
    fault = FLOCK_FAULT[arch]
    with planted_backward(torch, fault), routing("replay"):
        new, _, met = step(params, opt, b1)
    readings.append(train_readings(torch, params, (new, met), res[False]))
    r, x = readings
    log(f"[ftrain] lockstep {arch} at {cfg.n_layers} layer(s), B {B} x S "
        f"{S}, bf16, K6/K6b launches {want}: loss "
        f"{float(res[True][1]['loss']):.6f} (kernel route) vs "
        f"{float(res[False][1]['loss']):.6f} (plain route): rel "
        f"{r['loss']:.2e}; grad_norm rel {r['grad_norm']:.2e}; update rel "
        f"{r['update']:.2e} (one parameter's at most {r['param_update']:.2e}"
        f", {r['param']}); control {fault!r} in the plain backward: loss "
        f"{x['loss']:.2e}, grad_norm {x['grad_norm']:.2e}, update "
        f"{x['update']:.2e} ({x['param_update']:.2e}, {x['param']})")
    del model, params, opt, res, new
    free_card(torch)
    return readings


def phase_ftrain(torch, card: str) -> dict:
    """Training of the moe, ssm, hybrid, vlm and encdec families on the
    card: (b) one `launch.train --full` run a family (`ftrain_args`,
    `ftrain_check`; the depth cut as FTRAIN says; the five one after the
    other in one child process), FTRAIN_CRASH_ARCH's with
    a crash at FTRAIN_CRASH_AT and checkpoints every FTRAIN_CKPT_EVERY: it
    restores its layer-stacked tree, and the steps it runs
    again from it equal the same steps before the crash bit for bit
    (moe's run is not replayed: its gathers' backward adds with
    atomics); (c) one train step a family from shared carries, kernel
    route against plain route, for the hybrid, moe and vlm, FLOCK_RTOL's
    limits, with a control planted in the plain backward. The
    children run first, while this process holds little of the card. ->
    the K6 and K6b launches of the (b) runs, with their variants."""
    free_card(torch)
    totals = {"flash_attention": 0, "flash_attention_bwd": 0,
              "flash_attention variants": {},
              "flash_attention_bwd variants": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ftrain_",
                                     dir=str(ROOT / "build")) as tmp:
        # the five runs one after the other in one child (one process
        # start and one CUDA context; a child a run took ~18 s more a
        # run), FTRAIN_CRASH_ARCH's with its crash
        archs = (HYBRID_ARCH, MOE_ARCH, VLM_ARCH, SSM_ARCH, ENCDEC_ARCH)
        runs = [ftrain_args(a, os.path.join(tmp, FTRAIN_LABEL[a]))
                if a != FTRAIN_CRASH_ARCH else ftrain_args(
                    a, os.path.join(tmp, FTRAIN_LABEL[a]),
                    ("--ckpt-every", str(FTRAIN_CKPT_EVERY)),
                    plan={"crash_at_iter": FTRAIN_CRASH_AT})
                for a in archs]
        t0 = time.perf_counter()
        results = dict(zip(archs, _train_cli(None, env=FTRAIN_ALLOC,
                                             label="ftrain", runs=runs)))
        log(f"[ftrain] the five runs' child: {time.perf_counter() - t0:.1f}"
            f" s with the process start")
        for arch, res in results.items():
            ftrain_check(arch, res, card)
            for kernel in ("flash_attention", "flash_attention_bwd"):
                by = res["launches_by_variant"][kernel]
                totals[kernel] += sum(by.values())
                prev = totals[f"{kernel} variants"]
                totals[f"{kernel} variants"] = {
                    v: prev.get(v, 0) + by.get(v, 0) for v in {*prev, *by}}
            if arch != FTRAIN_CRASH_ARCH:
                continue
            # restored at `back`, the steps back .. FTRAIN_CRASH_AT - 1 run
            # again: the first time from the uninterrupted state, the
            # second from the checkpoint's
            back = (FTRAIN_CRASH_AT // FTRAIN_CKPT_EVERY) * FTRAIN_CKPT_EVERY
            first = res["losses"][back:FTRAIN_CRASH_AT]
            again = res["losses"][FTRAIN_CRASH_AT:2 * FTRAIN_CRASH_AT - back]
            log(f"[ftrain] {FTRAIN_LABEL[arch]} crash at step "
                f"{FTRAIN_CRASH_AT}, checkpoints every {FTRAIN_CKPT_EVERY}: "
                f"events {res['events']}, restored at {back}, steps run "
                f"{res['loss_steps']}; steps {back}-{FTRAIN_CRASH_AT - 1} "
                f"from the restored layer-stacked tree against the "
                f"same steps before the crash: "
                f"{'bit-equal' if first == again else 'differ'} "
                f"({first} / {again})")
            assert res["events"] == ["crash", "restore"], res["events"]
            assert res["loss_steps"] == list(range(FTRAIN_CRASH_AT)) + \
                list(range(back, FTRAIN[arch][3])), res["loss_steps"]
            restore_check(f"ftrain {FTRAIN_LABEL[arch]}", res, card)
            assert len(first) == FTRAIN_CRASH_AT - back and first == again, \
                (first, again)
    for arch, tol in FLOCK_RTOL.items():
        t0 = time.perf_counter()
        r, x = family_train_lockstep(torch, arch)
        log(f"[ftrain] lockstep {arch}: {time.perf_counter() - t0:.1f} s; "
            f"limits {tol}")
        assert all(r[k] <= tol[k] for k in tol), (arch, r, tol)
        assert any(x[k] > tol[k] for k in tol), (arch, x, tol)
    return totals


def dtrain_args(ckpt_dir: str, steps: int, data: int = 1,
                model: int = 1, extra=()) -> list:
    """`launch.train` arguments of a dtrain run: qwen2-0.5b --full,
    DTRAIN_BATCH x DTRAIN_SEQ, `steps` steps at TRAIN_LR, over a (data,
    model) mesh."""
    return ["--arch", LM_ARCH, "--full", "--batch", str(DTRAIN_BATCH),
            "--seq", str(DTRAIN_SEQ), "--steps", str(steps), "--lr",
            str(TRAIN_LR), "--seed", str(TRAIN_SEED), "--device", DEVICE,
            "--data", str(data), "--model-parallel", str(model),
            "--ckpt-dir", ckpt_dir, *extra]


@contextlib.contextmanager
def per_shard_mean():
    """Inside the block each data shard's loss is its own rows' mean (the
    whole batch's count dropped): the sharded step's gradient is then the
    shards' means summed, D times the batch's mean with equal shards."""
    from repro_torch.models import layers
    real = layers.softmax_xent

    def shard_mean(logits, labels, mask=None, total=None, split=None):
        return real(logits, labels, mask, split=split)

    layers.softmax_xent = shard_mean
    try:
        yield
    finally:
        layers.softmax_xent = real


def split_lockstep(torch, arch: str, dtype: str, layers: int, batch: int,
                   seq: int, meshes=((1, 2),), control: bool = False) -> dict:
    """(c) and (d) of the dtrain phase for one model, on each rank of a
    world of 2: `arch` at its published width cut to `layers` layers (the
    encoder's too for encdec), in `dtype`, one train step over each mesh
    of `meshes` (at (1, 2) the compute split along "model") against the
    same step on one process, from a shared carry: the seeded init and
    the moments of one clipped gradient of the pipeline's first batch (an
    AdamW step at rate 0; from zero moments Adam's first step is g / |g|,
    which turns float32 noise in a gradient near 0 into a whole step), on
    its second batch (a rank's rows of it where "data" splits them). With
    `control`, the first mesh's step again with `per_shard_mean` planted.

    The ranks take turns at the one-process step (moe's routing recorded:
    a top-k flip between two routes a few ulps apart moves a token by a
    whole expert), each keeping only its blocks of the carry and of the
    result for each mesh (at full width pixtral-12b's float32 state is
    6.5 GB a copy, and the step's peak ~52 GiB); then both run each
    mesh's step (the routing replayed) and hold its new parameters to the
    one-process step's on their own blocks (nothing gathered). -> (on
    rank 0; {} elsewhere) {"2x1" / "1x2" / "control": readings}, each
    `train_readings`' keys (the update's sums over every element once),
    the losses, every rank's K6/K6b launches by variant and peak memory,
    the step's collectives and wall, and the laps of rank 0's turn."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, rows_split
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.convert import local_state, state_specs
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, AdamWState, global_norm
    from repro_torch.train.steps import make_loss_and_grads, make_train_step
    cfg = get_config(arch).replace(dtype=dtype, n_layers=layers)
    if cfg.family == "encdec":
        cfg = cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, n_encoder_layers=layers))
    runs = [(f"{d}x{m}", (d, m)) for d, m in meshes]
    if control:
        runs.append(("control", tuple(meshes[0])))
    grids = {}
    for _, shape in runs:
        if shape not in grids:
            grids[shape] = make_host_mesh(*shape, device=DEVICE)
    mesh = next(iter(grids.values()))
    dev = mesh.device
    cuda = dev.type == "cuda"
    model = Model(cfg, "meta")      # the structure: every step binds its own
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.01)
    pipe = TokenPipeline(cfg, batch, seq, seed=TRAIN_SEED)
    f32 = torch.float32
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        if cuda:
            torch.cuda.synchronize()
        laps[name] = laps.get(name, 0.0) + time.perf_counter() - t_lap[0]
        t_lap[0] = time.perf_counter()

    def data(i, shard=0, shards=1):    # as launch.train feeds it
        return {k: torch.as_tensor(v, device=dev, dtype=(
                    cfg.torch_dtype if k in ("patches", "frames") else None))
                for k, v in pipe.batch_at(i, shard, shards).items()}

    def carry():
        m = Model(cfg, dev)
        init_params(m, torch.Generator(device=dev).manual_seed(TRAIN_SEED))
        params = {k: p.detach() for k, p in m.named_parameters()}
        del m
        _, grads = make_loss_and_grads(model)(params, data(0))
        scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(
            global_norm(grads), min=1e-12), max=1.0)
        mu, nu = {}, {}
        for k in list(grads):
            g = grads.pop(k).to(f32) * scale
            mu[k], nu[k] = g * (1 - opt_cfg.b1), torch.square(g) * (
                1 - opt_cfg.b2)
        return params, AdamWState(torch.ones((), dtype=torch.int32,
                                             device=dev), mu, nu, None)

    experts = []

    def routing(mode):
        if cfg.family != "moe":
            return contextlib.nullcontext()
        return moe_routing(torch, mode, experts)

    b1 = data(1)
    one_peak, mine = 0, {}
    for turn in range(mesh.world):
        if mesh.rank == turn:
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            t_lap[0] = time.perf_counter()
            params, opt = carry()
            lap("carry")
            with routing("record"):
                ref = make_train_step(model, opt_cfg)(params, opt, b1)
            # the step's moments are not kept (the split step's peak)
            ref, ref_met = ref[0], {k: float(v) for k, v in ref[2].items()}
            lap("one-process step")
            held = {shape: (local_state(cfg, params, g), AdamWState(
                opt.step, local_state(cfg, opt.mu, g),
                local_state(cfg, opt.nu, g), None), local_state(cfg, ref, g))
                for shape, g in grids.items()}
            del params, opt, ref
            free_card(torch)
            lap("blocks")
            if cuda:
                one_peak = torch.cuda.max_memory_allocated(dev)
        mesh.barrier()
    for name, shape in runs:
        grid = grids[shape]
        local, lopt, ref = held[shape]
        D = grid.size("data")
        split = rows_split(batch, D)
        rows = data(1, grid.index("data"), D) if split else b1
        step = make_train_step(model, opt_cfg, mesh=grid, rows_split=split)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        grid.reset_counts()
        t0 = time.perf_counter()
        with routing("replay"), (per_shard_mean() if name == "control"
                                 else contextlib.nullcontext()):
            new = step(local, lopt, rows)
        new, met = new[0], new[2]
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"flash_attention": ops.flash_variant_counts(),
                  "flash_attention_bwd": ops.flash_bwd_variant_counts()}
        specs = state_specs(cfg, grid)
        got = {"counts": {k: {v: n for v, n in by.items() if n}
                          for k, by in counts.items()},
               "peak": torch.cuda.max_memory_allocated(dev) if cuda else 0,
               "d2": {}, "s2": {}}
        # the update's sums over this rank's blocks, each element once
        for k, t in new.items():
            if sh.counted_once(specs[k], grid):
                got["d2"][k] = float(torch.linalg.vector_norm(
                    t.float() - ref[k].float())) ** 2
                got["s2"][k] = float(torch.linalg.vector_norm(
                    ref[k].float() - local[k].float())) ** 2
        del new
        free_card(torch)
        every = [None] * mesh.world
        dist.all_gather_object(every, got)
        if mesh.rank == 0:
            d2, s2 = {}, {}
            for r in every:
                for k in r["d2"]:
                    d2[k] = d2.get(k, 0.0) + r["d2"][k]
                    s2[k] = s2.get(k, 0.0) + r["s2"][k]
            met = {k: float(v) for k, v in met.items()}
            out = update_readings(met, ref_met, d2, s2)
            out.update(losses=[met["loss"], ref_met["loss"]],
                       launches_by_rank=[r["counts"] for r in every],
                       peak_gib_by_rank=[r["peak"] / 2 ** 30 for r in every],
                       collectives=grid.counts["issued"], step_s=wall)
            mine[name] = out
    del held
    free_card(torch)
    peaks = [None] * mesh.world
    dist.all_gather_object(peaks, one_peak / 2 ** 30)
    for out in mine.values():
        out.update(one_peak_gib_by_rank=peaks, laps_s=laps)
    return mine


def dtrain_ranks(tmp: str, out: str) -> None:
    """The dtrain phase's two-rank child (`--dtrain-ranks DIR OUT`, one
    process a rank under torchrun, gloo on the one card). Its process
    group and CUDA context start, then it waits (DTRAIN_GO_S at most)
    for DIR/go, which the smoke writes once (a) is done. Then (b)
    `launch.train.main` at (2, 1) for DTRAIN_STEPS steps with a crash at
    DTRAIN_CRASH_AT and a checkpoint every DTRAIN_CKPT_EVERY (kept in
    DIR/data), then at (1, 2) resuming its checkpoint before the crash
    (the last one removed) for DTRAIN_RESUME_STEPS steps, each run's
    result with every
    rank's kernel launches and wall; then (c) `split_lockstep` of qwen2
    over DTRAIN_MESHES with its control and of a family of DSPLIT at (1,
    2) (float32), and (d) of DSPLIT_BF16. Rank 0 writes {"runs": {name:
    result}, "lockstep": {name: readings}, "families": {arch: readings},
    "bf16": readings, "lockstep_s", "families_s", "waited_s"} to OUT as
    JSON."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed
    init_distributed(DEVICE)
    torch.zeros(1, device=DEVICE)
    t0 = time.perf_counter()
    go = os.path.join(tmp, "go")
    while not os.path.exists(go):
        if time.perf_counter() - t0 > DTRAIN_GO_S:
            raise TimeoutError(f"no {go} after {DTRAIN_GO_S} s")
        time.sleep(0.1)
    waited = time.perf_counter() - t0
    runs = {}

    def run(name, args, plan=None):
        os.environ.pop("REPRO_FAULT_PLAN", None)
        if plan is not None:
            os.environ["REPRO_FAULT_PLAN"] = json.dumps(plan)
        t0 = time.perf_counter()
        res = train.main(args)
        res["wall_s"] = time.perf_counter() - t0
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, res["launches_by_variant"])
        res["launches_by_rank"] = counts
        runs[name] = res
        os.environ.pop("REPRO_FAULT_PLAN", None)
        free_card(torch)

    def remove(*dirs):
        # the machine's disk counts every block written: the next run's
        # checkpoint reuses these
        if dist.get_rank() == 0:
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)
        dist.barrier()

    data = os.path.join(tmp, "data")
    run("2x1 crash", dtrain_args(data, DTRAIN_STEPS, 2, 1, (
        "--ckpt-every", str(DTRAIN_CKPT_EVERY))),
        plan={"crash_at_iter": DTRAIN_CRASH_AT})
    remove(*(os.path.join(data, f"step_{step:08d}")
             for step in range(DTRAIN_RESUME_AT + 1, DTRAIN_STEPS + 1)))
    run("1x2 resumed", dtrain_args(data, DTRAIN_RESUME_STEPS, 1, 2))
    remove(data)
    t0 = time.perf_counter()
    lock = split_lockstep(torch, LM_ARCH, "float32", DTRAIN_F32_LAYERS,
                          DTRAIN_BATCH, DTRAIN_SEQ, DTRAIN_MESHES,
                          control=True)
    lock_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    families = {arch: split_lockstep(torch, arch, "float32", *shape).get(
        "1x2") for arch, shape in DSPLIT.items()}
    arch, *shape = DSPLIT_BF16
    bf16 = split_lockstep(torch, arch, "bfloat16", *shape).get("1x2")
    families_s = time.perf_counter() - t0
    if dist.get_rank() == 0:
        with open(out, "w") as fh:
            json.dump({"runs": runs, "lockstep": lock, "lockstep_s": lock_s,
                       "families": families, "bf16": bf16,
                       "families_s": families_s, "waited_s": waited}, fh)


def restore_check(label: str, res: dict, card: str) -> None:
    """A run's restores on the card (`launch.train`'s
    `restore_bytes_by_rank`): on every rank, what the largest one added
    to the device's allocation at its peak within RESTORE_RATIO of the
    state it restored there."""
    got = res["restore_bytes_by_rank"]
    assert got and all(r is not None for r in got), (label, got)
    ratios = [added / held for added, held in got]
    log(f"[{label}] restore on the card, every rank: added "
        f"{[round(a / 2 ** 30, 3) for a, _ in got]} GiB at its peak for a "
        f"state of {[round(h / 2 ** 30, 3) for _, h in got]} GiB there: "
        f"{[round(x, 4) for x in ratios]} of it (limit {RESTORE_RATIO}; "
        f"{card})")
    assert max(ratios) <= RESTORE_RATIO, (label, got)


def _train_here(torch, args: list) -> dict:
    """`launch.train.main(args)` in this process (no REPRO_FAULT_PLAN),
    its --ckpt-dir removed after it and the card's cached blocks
    returned -> its result."""
    from repro_torch.launch import train
    os.environ.pop("REPRO_FAULT_PLAN", None)
    res = train.main(args)
    shutil.rmtree(args[args.index("--ckpt-dir") + 1], ignore_errors=True)
    free_card(torch)
    return res


def _dtrain_counts(res: dict) -> dict:
    """K6 and K6b launches of one dtrain run over its ranks:
    {kernel: {variant: launches}}."""
    by_rank = res.get("launches_by_rank") or [res["launches_by_variant"]]
    return {k: {v: sum(r[k][v] for r in by_rank) for v in by_rank[0][k]}
            for k in ("flash_attention", "flash_attention_bwd")}


def phase_dtrain(torch, card: str) -> dict:
    """LM training over a (data, model) mesh on the card (see
    DTRAIN_BATCH): the two-rank child (`--dtrain-ranks`, gloo) starts
    first and waits; (a) a world of 1 on NCCL under torchrun, then the
    same command in this process (no process group), bit-equal; then
    the child runs (b): (2, 1) crashed and replayed, (1, 2) resuming its
    checkpoint before the crash (the compute split along "model"),
    within TRAIN_RTOL["bfloat16"]'s loss limit of (a), the replayed steps
    bit-equal to the same steps before the crash, each restore within
    RESTORE_RATIO; (c) the float32 lockstep and its control, then a
    family's split step a DSPLIT entry within TRAIN_RTOL["float32"]; and
    (d) the hybrid's bf16 split step within FLOCK_RTOL's hybrid limits.
    K6 and K6b launch in every attention layer of every rank's steps, by
    the variants `ftrain_expected` names, and the split (1, 2) run's peak
    stays within DTRAIN_SPLIT_PEAK_GIB on every rank. Each run's
    checkpoints are removed after it. Printed, not gated: each rank's
    peak memory, the step walls (two ranks
    on one card stage every collective through the host over gloo: the
    walls measure that staging, not scaling over cards) and K6/K6b
    launches by rank. -> the K6 and K6b launches of the runs and the
    split steps, with their variants."""
    from repro_torch.configs import get_config
    L = get_config(LM_ARCH).n_layers
    free_card(torch)
    tol = TRAIN_RTOL["bfloat16"]["loss"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dtrain_",
                                     dir=str(ROOT / "build")) as tmp:
        out = os.path.join(tmp, "ranks.json")
        t_child = time.perf_counter()
        # the split steps' float32 logits over 256,000 tokens need the
        # caching allocator's expandable segments, as ftrain's runs do
        proc = _child(["torch.distributed.run", "--standalone",
                       "--nproc-per-node", "2", "-m", "chip_smoke",
                       "--dtrain-ranks", tmp, out], env=FTRAIN_ALLOC,
                      timeout=900, log_to=os.path.join(tmp, "ranks"))
        try:
            t0 = time.perf_counter()
            a = _train_cli(dtrain_args(os.path.join(tmp, "one"),
                                       DTRAIN_ONE_STEPS), ranks=1,
                           label="dtrain")
            shutil.rmtree(os.path.join(tmp, "one"), ignore_errors=True)
            a_wall = time.perf_counter() - t0
            # the same command without torchrun: in this process (no
            # process group starts where WORLD_SIZE is unset)
            t0 = time.perf_counter()
            plain = _train_here(torch, dtrain_args(
                os.path.join(tmp, "plain"), DTRAIN_ONE_STEPS))
            plain_wall = time.perf_counter() - t0
            Path(tmp, "go").touch()
            t0 = time.perf_counter()
            log_lines = _finish("dtrain ranks", proc)
            b_wall = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        child_wall = time.perf_counter() - t_child
        for line in log_lines.splitlines():
            if line.startswith(("[train] ", "step ")) and \
                    not line.startswith("[train] result "):
                log(f"[dtrain]   {line[:300]}")
        with open(out) as fh:
            ranks = json.load(fh)
    runs = dict(ranks["runs"])
    runs["1x1 torchrun"], runs["1x1 plain"] = a, plain
    for name, res in runs.items():
        m = res["mesh"]
        m = m and {k: m[k] for k in ("data", "model", "backend")}
        peaks = [round((p or 0) / 2 ** 30, 2)
                 for p in res["peak_bytes_by_rank"]]
        counts = [{k: {v: n for v, n in c[k].items() if n} for k in c}
                  for c in res.get("launches_by_rank")
                  or [res["launches_by_variant"]]]
        wall = res["step_wall_s"]
        wall = "-" if wall is None else f"{wall * 1e3:.1f} ms"
        log(f"[dtrain] {name}: mesh {m}, steps {res['loss_steps']}, "
            f"losses {res['losses']}, events {res['events']}; step wall "
            f"{wall} (median after the first; first "
            f"{res['step_walls_s'][0]:.2f} s; each "
            f"{[round(w, 2) for w in res['step_walls_s']]} s); peak GiB by "
            f"rank {peaks}; "
            f"collectives a step {res['collectives_per_step']}; K6/K6b "
            f"launches by rank {counts}; run {res.get('wall_s', 0):.1f} s "
            f"({card})")
    log(f"[dtrain] walls: (a) torchrun world of 1 {a_wall:.1f} s with its "
        f"process start, its command in this process {plain_wall:.1f} s; "
        f"the two-rank child {child_wall:.1f} s from its start, of which "
        f"it waited {ranks['waited_s']:.1f} s with its group up, and "
        f"{b_wall:.1f} s after (a) for (b), (c) and (d) (the qwen2 lockstep "
        f"{ranks['lockstep_s']:.1f}, the families' split steps "
        f"{ranks['families_s']:.1f})")
    # (a) a world of 1 on NCCL: the plain process's bits
    assert a["mesh"] == {"data": 1, "model": 1, "world": 1, "backend": (
        "nccl" if DEVICE == "cuda" else "gloo"), "rank": 0,
        "rows_split": False}, a["mesh"]
    assert plain["mesh"] is None and a["collectives_per_step"] == 0
    log(f"[dtrain] (a) world of 1 on NCCL vs no process group: "
        f"{'bit-equal' if a['losses'] == plain['losses'] else 'differ'}")
    assert a["losses"] == plain["losses"], (a["losses"], plain["losses"])
    # (b) two ranks on gloo
    crashed, resumed = runs["2x1 crash"], runs["1x2 resumed"]
    for r in (crashed, resumed):
        assert r["mesh"]["backend"] == "gloo" and r["mesh"]["world"] == 2
    back = (DTRAIN_CRASH_AT // DTRAIN_CKPT_EVERY) * DTRAIN_CKPT_EVERY
    assert back == DTRAIN_RESUME_AT
    assert crashed["events"] == ["crash", "restore"], crashed["events"]
    assert crashed["loss_steps"] == list(range(DTRAIN_CRASH_AT)) + \
        list(range(back, DTRAIN_STEPS)), crashed["loss_steps"]
    rel = [abs(x - a["losses"][k]) / abs(a["losses"][k])
           for k, x in zip(crashed["loss_steps"], crashed["losses"])]
    log(f"[dtrain] (b) 2x1 against (a): loss rel {max(rel):.2e} (limit "
        f"{tol})")
    assert max(rel) <= tol, (crashed["losses"], a["losses"])
    before = crashed["losses"][back:DTRAIN_CRASH_AT]
    again = crashed["losses"][DTRAIN_CRASH_AT:2 * DTRAIN_CRASH_AT - back]
    log(f"[dtrain] (b) 2x1, a crash at step {DTRAIN_CRASH_AT} with "
        f"checkpoints every {DTRAIN_CKPT_EVERY}: events {crashed['events']}"
        f", steps {crashed['loss_steps']}; steps {back}-"
        f"{DTRAIN_CRASH_AT - 1} from the restored checkpoint against the "
        f"same steps before the crash: "
        f"{'bit-equal' if again == before else 'differ'}")
    assert again == before, (again, before)
    restore_check("dtrain 2x1 crash", crashed, card)
    want = a["losses"][back]
    rel = abs(resumed["losses"][0] - want) / abs(want)
    log(f"[dtrain] (b) the 2x1 checkpoint (step {back}) resumed at "
        f"1x2: start {resumed['start_step']}, events {resumed['events']}, "
        f"loss {resumed['losses'][0]:.6f} against (a)'s {want:.6f}: rel "
        f"{rel:.2e} (limit {tol})")
    assert resumed["start_step"] == back and \
        resumed["events"] == ["resume"] and \
        resumed["loss_steps"] == list(range(
            back, back + DTRAIN_RESUME_STEPS)), resumed
    assert rel <= tol, rel
    restore_check("dtrain 1x2 resumed", resumed, card)
    peaks = [p / 2 ** 30 for p in resumed["peak_bytes_by_rank"]]
    log(f"[dtrain] (b) the split (1, 2) step: peak "
        f"{[round(p, 2) for p in peaks]} GiB a rank (limit "
        f"{DTRAIN_SPLIT_PEAK_GIB}; 27.81 with the state split alone), step "
        f"wall {resumed['step_wall_s'] * 1e3:.1f} ms, "
        f"{resumed['collectives_per_step']} collectives a step ({card})")
    assert max(peaks) <= DTRAIN_SPLIT_PEAK_GIB, peaks
    # (c) and (d): a model's step over a mesh against one process
    ftol = TRAIN_RTOL["float32"]
    fams = [(LM_ARCH, "float32", (DTRAIN_F32_LAYERS, DTRAIN_BATCH,
                                  DTRAIN_SEQ), name, r, ftol)
            for name, r in ranks["lockstep"].items()]
    fams += [(arch, "float32", shape, "1x2", ranks["families"][arch], ftol)
             for arch, shape in DSPLIT.items()]
    arch, *shape = DSPLIT_BF16
    fams.append((arch, "bfloat16", shape, "1x2", ranks["bf16"],
                 FLOCK_RTOL[HYBRID_ARCH]))
    split_counts = []
    for arch, dtype, (layers, B, S), name, r, lim in fams:
        cfg = get_config(arch).replace(dtype=dtype, n_layers=layers)
        want = ftrain_expected(cfg)
        what = (f"{DTRAIN_MESHES[0]} with the {DTRAIN_FAULT!r} control"
                if name == "control" else name)
        log(f"[dtrain] ({'c' if dtype == 'float32' else 'd'}) {arch} "
            f"{dtype} at {layers} layer(s), B {B} x S {S}, one step at "
            f"{what} against (1, 1): loss {r['losses'][0]:.6f} vs "
            f"{r['losses'][1]:.6f}, rel {r['loss']:.2e}; grad_norm rel "
            f"{r['grad_norm']:.2e}; update rel {r['update']:.2e} (one "
            f"parameter's at most {r['param_update']:.2e}, {r['param']}); "
            f"limits {lim}; the step {r['step_s']:.2f} s, "
            f"{r['collectives']} collectives a rank, peak GiB by rank "
            f"{[round(p, 2) for p in r['peak_gib_by_rank']]} (the one-process"
            f" step on it {[round(p, 2) for p in r['one_peak_gib_by_rank']]}"
            f"); the turn's laps s "
            f"{ {k: round(v, 2) for k, v in r['laps_s'].items()} }; K6/K6b "
            f"launches by rank {r['launches_by_rank']} (each {want}; "
            f"{card})")
        if name == "control":
            assert any(r[k] > lim[k] for k in lim), r
        else:
            assert all(r[k] <= lim[k] for k in lim), (arch, dtype, r, lim)
        assert all(c == want for c in r["launches_by_rank"]), \
            (arch, name, r["launches_by_rank"], want)
        split_counts += r["launches_by_rank"]
    # K6 and K6b in every layer of every rank's steps
    totals = {"flash_attention": 0, "flash_attention_bwd": 0,
              "flash_attention variants": {},
              "flash_attention_bwd variants": {}}
    for c in split_counts:
        for kernel, by in c.items():
            totals[kernel] += sum(by.values())
            prev = totals[f"{kernel} variants"]
            totals[f"{kernel} variants"] = {
                v: prev.get(v, 0) + by.get(v, 0) for v in {*prev, *by}}
    for name, res in runs.items():
        steps = len(res["losses"]) * (res["mesh"] or {}).get("world", 1)
        got = _dtrain_counts(res)
        assert got["flash_attention"]["wgmma"] == 2 * L * steps and \
            got["flash_attention_bwd"]["wgmma"] == L * steps and \
            sum(got["flash_attention"].values()) == 2 * L * steps and \
            sum(got["flash_attention_bwd"].values()) == L * steps, \
            (name, got, steps)
        for kernel, by in got.items():
            totals[kernel] += sum(by.values())
            prev = totals[f"{kernel} variants"]
            totals[f"{kernel} variants"] = {
                v: prev.get(v, 0) + by.get(v, 0) for v in {*prev, *by}}
    log(f"[dtrain] K6/K6b launches of the runs, every rank: "
        f"{totals['flash_attention']} / {totals['flash_attention_bwd']}")
    return totals


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
    route_us = {}
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
            route_us[label, b] = (t_s * 1e3, t_d * 1e3)
            cells.append(f"B={b}: {t_s * 1e3:.1f}/{t_d * 1e3:.1f}")
            b *= 2
        log(f"[serve] route crossover, {label} bank (K={rbank.n_models},"
            f" sparsity {rbank.sparsity():.5f}), union-gather/densified "
            f"us a call: " + ", ".join(cells))
    serve_route_auto(torch, serve, fam_bank, route_us, card)
    return total


def serve_route_auto(torch, serve, fam_bank, route_us, card: str) -> None:
    """`--route auto` through `launch.predict --serve` (the plain scorers,
    no kernel): the route the serving loop took for each bucket, against
    `pick_route` under the committed H100 table
    (benchmarks/port/results/BENCH_serve_h100.json, the table
    `route_crossover()` loads), and both routes' device times there. Two
    banks: the path family (below the table's sparsities: dense at every
    bucket), and that family cut past the table's sparsest crossover and
    served up to twice it, where both routes must be taken."""
    import dataclasses
    import importlib
    from repro_torch.launch import predict as predict_cli
    from repro_torch.serve import artifact as art
    from repro_torch.serve.predict import ModelBank, margins_dense
    # the module (the package exports a function of the same name)
    sp = importlib.import_module("repro_torch.serve.predict")

    sp.set_route_crossover(None)                  # the committed table
    committed = json.loads(sp.bench_serve_path().read_text())
    assert committed["smoke"] is False, committed.get("meta")
    table = list(sp.route_crossover())
    assert table == committed["route_crossover"], (table, committed)
    payload = predict_cli.main([
        "--model", str(serve["paths"]["family"]), "--dataset",
        str(serve["requests_path"]), "--serve", "--route", "auto",
        "--max-batch", str(SERVE_MAX_BATCH), "--rate", str(SERVE_RATE),
        "--serve-requests", str(SERVE_AUTO_REQUESTS), "--device", DEVICE])
    routes = payload["stats"]["models"]["default"]["routes"]
    sparsity = fam_bank.sparsity()
    assert routes, payload["stats"]
    for bucket, took in sorted(routes.items(), key=lambda kv: int(kv[0])):
        want = sp.pick_route(sparsity, int(bucket))
        t = route_us.get(("path", int(bucket)))
        log(f"[serve] --route auto, path family (sparsity {sparsity:.5f}) "
            f"bucket {bucket}: took {took}, pick_route under the committed "
            f"H100 table {want}; "
            + ("union-gather / densified device us a call not measured"
               if t is None else
               f"union-gather {t[0]:.1f} us, densified {t[1]:.1f} us a "
               f"call") + f" on {card}")
        assert took == want, (bucket, took, want)
    log(f"[serve] --route auto: {payload['responses']} responses, p50 "
        f"{payload['p50_s'] * 1e3:.3f} ms, p99 {payload['p99_s'] * 1e3:.3f} "
        f"ms; the table {table} (committed, {committed['meta']['card']})")

    # each path model cut to its largest |w| (what a stronger l1 penalty
    # leaves) past the table's sparsest crossover, served up to twice that
    # crossover: the buckets below it go dense, those at or above it
    # union-gather, so a wrong table or a broken auto route shows
    top = max((e for e in table if e["min_batch_sparse"] is not None),
              key=lambda e: e["sparsity"])
    fam = serve["family"]
    n = fam.models[0].n_features
    keep = int(n * (1.0 - top["sparsity"]))
    models = []
    for m in fam.models:
        sel = np.sort(np.argsort(-np.abs(m.w_values), kind="stable")[:keep])
        models.append(dataclasses.replace(m, w_indices=m.w_indices[sel],
                                          w_values=m.w_values[sel]))
    cut = dataclasses.replace(fam, models=tuple(models))
    cut_path = serve["paths"]["family"].with_name("family_cut.json")
    art.save_model(str(cut_path), cut)
    max_batch = 2 * top["min_batch_sparse"]
    cut_bank = ModelBank.from_family(cut, device=DEVICE)
    sparsity = cut_bank.sparsity()
    assert sparsity >= top["sparsity"], (sparsity, top)
    payload = predict_cli.main([
        "--model", str(cut_path), "--dataset",
        str(serve["requests_path"]), "--serve", "--route", "auto",
        "--max-batch", str(max_batch), "--rate", str(SERVE_RATE),
        "--serve-requests", str(SERVE_AUTO_REQUESTS), "--device", DEVICE])
    routes = payload["stats"]["models"]["default"]["routes"]
    X = torch.as_tensor(serve["requests"].rows(0, max_batch).to_dense(),
                        device=DEVICE)
    cut_bank.dense_matrix()
    for bucket, took in sorted(routes.items(), key=lambda kv: int(kv[0])):
        b = int(bucket)
        want = sp.pick_route(sparsity, b)
        Xb = X[:b]
        t_s = device_ms(torch, lambda: margins_dense(
            cut_bank, Xb, route="sparse"), 30)
        t_d = device_ms(torch, lambda: margins_dense(
            cut_bank, Xb, route="dense"), 30)
        log(f"[serve] --route auto, path family cut to {keep} weights a "
            f"model (sparsity {sparsity:.5f}) bucket {bucket}: took {took}, "
            f"pick_route under the committed H100 table {want}; "
            f"union-gather {t_s * 1e3:.1f} us, densified {t_d * 1e3:.1f} us "
            f"a call on {card}")
        assert took == want, (bucket, took, want)
    assert sorted(set(routes.values())) == ["dense", "sparse"], routes
    log(f"[serve] --route auto, cut bank up to {max_batch}: "
        f"{payload['responses']} responses, p50 "
        f"{payload['p50_s'] * 1e3:.3f} ms, p99 {payload['p99_s'] * 1e3:.3f} "
        f"ms; both routes taken (union-gather from bucket "
        f"{top['min_batch_sparse']})")


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


def device_busy_s(prof, rows) -> float:
    """Seconds the card was busy in a trace: the union of its device
    events' intervals. A kernel launched programmatically (K5's dense
    update launch) starts while the one before it runs and waits for it,
    so the sum of the ops' times would count the overlap twice; the sum
    of `rows` when the trace holds no device intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return sum(r[2] for r in rows)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def device_profile(torch, fn, n_top: int = 8):
    """Run fn once under torch.profiler (CUDA activity only) -> (device-busy
    seconds (`device_busy_s`), the n_top ops by device time as (name,
    calls, seconds), the wall seconds of the traced call); busy 0.0 and no
    ops when the profiler saw no device time."""
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
    return device_busy_s(prof, rows), rows[:n_top], wall  # n_top None: all


def device_ops(torch, fn, tries: int = 3) -> list:
    """The ops that ran on the card in one traced call of fn, as
    device_profile's (name, calls, seconds), those with device time only.
    A trace in which the profiler recorded no device op at all (it loses
    a process's records now and then: PERF.md) is taken again, up to
    `tries` traces; then [] comes back."""
    for _ in range(tries):
        ops = [r for r in device_profile(torch, fn, n_top=None)[1]
               if r[2] > 0]
        if ops:
            return ops
    return []


def log_top(name: str, top, per: int, unit: str) -> None:
    for key, calls, secs in top:
        log(f"[{name}]   {secs / per * 1e6:9.2f} us/{unit}  "
            f"{calls // max(per, 1):4d} calls/{unit}  {key[:90]}")


def solve_profile(name: str, record_aux: bool = False) -> dict:
    """One outer iteration of solve phase `name` from the initial state,
    traced after an untraced run of the same iteration, in a process of its
    own (`--solve-profile`; with `--record-aux`, the iteration returns the
    per-bundle (q, alpha) plane and copies it to the host, as the engine
    loop does): -> {"busy_s", "rows": [(op, calls, seconds)], "launches":
    the kernel's count in the traced iteration}."""
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
                                            tol_kkt=0.0, seed=0,
                                            record_aux=record_aux))

    def iteration():
        st = backend.init_state()
        out = backend.outer(st.w, st.z, st.gen, st.active, True, c)
        if record_aux:
            q, alpha = out[9]
            q.cpu(), alpha.cpu()

    iteration()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    busy, rows, _ = device_profile(torch, iteration, n_top=None)
    return {"busy_s": busy, "rows": rows,
            "launches": ops.launch_counts()[kernel]}


def solve_wall(name: str, readings: int = 4) -> dict:
    """A solve phase's steady outer-iteration wall with telemetry off, in
    a process of its own (`--solve-wall NAME`): its
    data, c, P and kernel (SOLVES); 3 warm-up iterations, then `readings`
    solves of PATH_TIMING_ITERS iterations each, wall over the
    iterations. Uses only the engine and the kernels, so the same script
    times an older tree's `src` (copied beside it) for a parent / change /
    change / parent A/B. -> {"ms": [per reading], "launches": the phase
    kernel's count in the readings}."""
    import torch
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import ops

    data = make_data(DATA_SEED)
    i_x, i_y, c, layout, P, kernel, _ = SOLVES[name]
    prob = make_problem(data[i_x], data[i_y], c=c, layout=layout,
                        device=DEVICE)
    backend = LocalBackend(prob, PCDNConfig(P=P, use_kernels=True,
                                            tol_kkt=0.0, seed=0))
    engine_loop.solve(backend, c, max_outer=3, tol_kkt=0.0)
    ops.reset_launch_counts()
    walls = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_loop.solve(backend, c, max_outer=PATH_TIMING_ITERS,
                          tol_kkt=0.0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / PATH_TIMING_ITERS * 1e3)
    return {"ms": walls, "launches": ops.launch_counts()[kernel]}


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
        # a process's first solve pays its cold start in iteration 0
        wt = res.history.wall_time
        log(f"[{name}] use_kernels={use_kernels} iteration 0 "
            f"{wt[0] * 1e3:.2f} ms, iterations 1-{n_outer - 1} "
            f"{np.diff(wt).mean() * 1e3:.2f} ms an iteration")
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


def log_profile(name: str, prof: dict, unit: str) -> None:
    """A child's trace (`--baseline-profile`): busy against the untraced
    wall of the same work, the idle share, the top device ops a unit."""
    busy, wall, per = prof["busy_s"], prof["wall_s"], prof["units"]
    if busy > 0:
        log(f"[{name}] traced in a fresh process: {per} {unit}(s), device "
            f"busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms untraced wall "
            f"(idle share {1 - busy / wall:.3f}); {busy / per * 1e6:.1f} us "
            f"device, {(wall - busy) / per * 1e6:.1f} us host a {unit}; "
            f"{sum(r[1] for r in prof['rows']) / per:.2f} device ops a "
            f"{unit}; top device ops:")
        log_top(name, [tuple(r) for r in prof["rows"] if r[2] > 0][:8], per,
                unit)
    else:
        log(f"[{name}] {wall * 1e3:.3f} ms wall for {per} {unit}(s); idle "
            f"share not measured (the profiler saw no device time)")


def run_child_profile(name: str) -> dict:
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--baseline-profile",
         name], capture_output=True, text=True, check=True, timeout=300)
    return json.loads(child.stdout.strip().splitlines()[-1])


def baseline_profile(name: str) -> dict:
    """`--baseline-profile scdn`: SCDN_PROFILE_BATCHES batches of an SCDN
    round on real-sim from the zero carry; `scdn-dense`:
    GISETTE_PROFILE_BATCHES batches at P_bar 64 on gisette (the dense
    cell's problem) from the zero carry; `tron`: one TRON outer iteration
    (tron.solve at max_outer 1) on real-sim. Each run once untraced to warm
    up, timed untraced (wall_s, the mean of 3), then traced once -> {"busy_s",
    "wall_s", "rows", "units", "launches"}. Run in a child process by the
    scdn and tron phases."""
    import torch
    from repro_torch.core import scdn, tron
    from repro_torch.core.problem import make_problem
    from repro_torch.data import paper_like
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    if name == "scdn-dense":
        Xg, y_g, _ = paper_like("gisette", scale=1.0, seed=DATA_SEED)
        prob = make_problem(Xg, y_g, c=SOLVES["dense"][2], layout="dense",
                            device=DEVICE)
        P_bar, units = GISETTE_P_BAR, GISETTE_PROFILE_BATCHES
    else:
        csc, y = make_realsim(DATA_SEED)
        prob = make_problem(csc, y, c=SCDN_C, layout="padded_csc",
                            device=DEVICE)
        P_bar, units = SCDN_P_BAR, SCDN_PROFILE_BATCHES
    if name.startswith("scdn"):
        round_ = scdn.make_round(prob, scdn.SCDNConfig(P_bar=P_bar))
        gen = torch.Generator().manual_seed(1)
        idxs = torch.randint(0, prob.n_features, (units, P_bar),
                             generator=gen, dtype=torch.int32)
        w = torch.zeros((prob.n_features,), device=DEVICE)
        zz = torch.zeros((prob.n_samples,), device=DEVICE)

        def run():
            round_(w, zz, gen, idxs=idxs)
    else:
        def run():
            tron.solve(prob, tron.TRONConfig(max_outer=1, tol_kkt=0.0))
        units = 1
    run()
    wall = host_ms(torch, run, 3) / 1e3
    ops.reset_launch_counts()
    busy, rows, _ = device_profile(torch, run, n_top=None)
    return {"busy_s": busy, "wall_s": wall, "rows": rows, "units": units,
            "launches": {k: v for k, v in ops.launch_counts().items() if v}}


def phase_scdn(torch, data, card: str) -> dict:
    """SCDN through `core.scdn.solve` on real-sim, one launch of K5's batch
    entry a batch; the lockstep round; the traced slice; gisette's
    divergence guard (the dense layout: one call of K5's dense batch entry
    a batch) through both routes, its lockstep round and traced slice.
    -> the launches of each kernel in its main-path run."""
    from repro_torch.core import scdn
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    csc, y_rs, Xg, y_g, _ = data
    prob = make_problem(csc, y_rs, c=SCDN_C, layout="padded_csc",
                        device=DEVICE)
    cfg = scdn.SCDNConfig(P_bar=SCDN_P_BAR, max_rounds=SCDN_ROUNDS,
                          tol_kkt=0.0)
    n_batches = -(-prob.n_features // SCDN_P_BAR)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = scdn.solve(prob, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    F = res.history["objective"]
    log(f"[scdn] real-sim padded-CSC c={SCDN_C} P_bar={SCDN_P_BAR}: "
        f"{res.n_rounds} rounds of {n_batches} batches, F "
        + " ".join(f"{f:.6f}" for f in F)
        + f", kkt {res.history['kkt'][-1]:.3e}, diverged {res.diverged}; "
        f"wall {dt:.3f}s ({dt / res.n_rounds * 1e3:.2f} ms a round, "
        f"{dt / (res.n_rounds * n_batches) * 1e6:.2f} us a batch) on "
        f"{card}; launches {counts}")
    assert res.n_rounds == SCDN_ROUNDS and not res.diverged, res
    assert np.all(np.isfinite(F)), F
    assert counts["scdn_batch"] == SCDN_ROUNDS * n_batches, counts
    assert sum(counts.values()) == counts["scdn_batch"], counts
    launches = {"scdn_batch": counts["scdn_batch"]}

    # lockstep: one round from the solve's carry with one set of indices,
    # through K5's batch entry and through its plain version
    w = res.w
    z = prob.margins(w)
    idxs = torch.randint(0, prob.n_features, (n_batches, SCDN_P_BAR),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out = {}
    for label, fn in (("K5", None), ("plain", ref.scdn_batch_ref)):
        round_ = scdn.make_round(prob, cfg, _batch=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = round_(w, z, torch.Generator(), idxs=idxs)
        f = float(r[3])
        out[label] = (f, time.perf_counter() - t0)
    rel = abs(out["K5"][0] - out["plain"][0]) / abs(out["plain"][0])
    log(f"[scdn] lockstep round from one carry and one set of indices: F "
        f"K5 {out['K5'][0]:.6f} ({out['K5'][1]:.3f}s) vs plain "
        f"{out['plain'][0]:.6f} ({out['plain'][1]:.2f}s): rel {rel:.2e} "
        f"(tolerance {F_RTOL})")
    assert rel <= F_RTOL, out
    prof = run_child_profile("scdn")
    assert prof["launches"] == {"scdn_batch": SCDN_PROFILE_BATCHES}, \
        prof["launches"]
    log_profile("scdn", prof, "batch")
    ops_a_batch = sum(row[1] for row in prof["rows"] if row[2] > 0) / \
        prof["units"]
    assert prof["busy_s"] > 0 and ops_a_batch <= SCDN_MAX_OPS, ops_a_batch

    # gisette dense at P_bar 64: one call of K5's dense batch entry a batch
    # and no other kernel; where and whether the guard trips, the same
    # through both routes; then a lockstep round and a traced slice
    gprob = make_problem(Xg, y_g, c=SOLVES["dense"][2], layout="dense",
                         device=DEVICE)
    gcfg = scdn.SCDNConfig(P_bar=GISETTE_P_BAR, max_rounds=GISETTE_ROUNDS)
    g_batches = -(-gprob.n_features // GISETTE_P_BAR)
    trips = {}
    line_searches = 0
    for label, fn in (("K5", None), ("plain", ref.scdn_dense_batch_ref)):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        g = scdn.solve(gprob, gcfg, _batch=fn)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        trips[label] = (g.diverged, g.n_rounds)
        log(f"[scdn] gisette dense c={SOLVES['dense'][2]} P_bar="
            f"{GISETTE_P_BAR}, {label} route: diverged {g.diverged} after "
            f"{g.n_rounds} rounds (converged {g.converged}), F "
            + " ".join(f"{f:.4g}" for f in g.history["objective"])
            + f"; {dt:.3f}s ({dt / g.n_rounds * 1e3:.2f} ms a round, "
            f"{dt / (g.n_rounds * g_batches) * 1e6:.2f} us a batch of "
            f"{g_batches}) on {card}; launches {counts}")
        if fn is None:
            batches = g.n_rounds * g_batches
            assert counts["scdn_dense_batch"] == batches, counts
            assert sum(counts.values()) == batches, counts
            launches["scdn_dense_batch"] = batches
            line_searches = counts["pcdn_linesearch"]
            g_kernel = g
        else:
            assert sum(counts.values()) == 0, counts
    assert trips["K5"] == trips["plain"], trips
    # K5's rows entry left the dense path: 0 launches in the phase
    launches["pcdn_linesearch"] = line_searches

    # lockstep: one gisette round from the K5 solve's carry with one set of
    # indices, through K5's dense batch entry and through its plain version
    w = g_kernel.w
    z = gprob.margins(w)
    idxs = torch.randint(0, gprob.n_features, (g_batches, GISETTE_P_BAR),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    out = {}
    for label, fn in (("K5", None), ("plain", ref.scdn_dense_batch_ref)):
        round_ = scdn.make_round(gprob, gcfg, _batch=fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = round_(w, z, torch.Generator(), idxs=idxs)
        f = float(r[3])
        out[label] = (f, time.perf_counter() - t0)
    rel = abs(out["K5"][0] - out["plain"][0]) / abs(out["plain"][0])
    log(f"[scdn] gisette lockstep round from one carry and one set of "
        f"indices: F K5 {out['K5'][0]:.6f} ({out['K5'][1]:.3f}s) vs plain "
        f"{out['plain'][0]:.6f} ({out['plain'][1]:.3f}s): rel {rel:.2e} "
        f"(tolerance {F_RTOL})")
    assert rel <= F_RTOL, out
    prof = run_child_profile("scdn-dense")
    assert prof["launches"] == {"scdn_dense_batch":
                                GISETTE_PROFILE_BATCHES}, prof["launches"]
    log_profile("scdn", prof, "batch")
    ops_a_batch = sum(row[1] for row in prof["rows"] if row[2] > 0) / \
        prof["units"]
    log(f"[scdn] gisette: {ops_a_batch:.2f} device ops with device time a "
        f"batch (ceiling {SCDN_DENSE_MAX_OPS}); the update launch's time "
        f"above includes its wait for the batch launch (a programmatic "
        f"launch), busy is the union of the ops' intervals")
    assert prof["busy_s"] > 0 and ops_a_batch <= SCDN_DENSE_MAX_OPS, \
        ops_a_batch
    return launches


def phase_tron(torch, data, card: str) -> None:
    """TRON through `core.tron.solve` on real-sim, padded-CSC, TRON_OUTER
    outer iterations: F finite and not rising; one iteration traced."""
    from repro_torch.core import tron
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops

    csc, y_rs = data[0], data[1]
    prob = make_problem(csc, y_rs, c=SCDN_C, layout="padded_csc",
                        device=DEVICE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = tron.solve(prob, tron.TRONConfig(max_outer=TRON_OUTER,
                                           tol_kkt=0.0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    F = res.history["objective"]
    log(f"[tron] real-sim padded-CSC c={SCDN_C}: {res.n_outer} outer "
        f"iterations, F " + " ".join(f"{f:.6f}" for f in F)
        + f", kkt {res.history['kkt'][-1]:.3e}; wall {dt:.2f}s "
        f"({dt / res.n_outer * 1e3:.1f} ms an iteration) on {card}; "
        f"kernel launches {sum(ops.launch_counts().values())} (none "
        f"expected)")
    assert res.n_outer == TRON_OUTER and np.all(np.isfinite(F)), F
    assert np.all(np.diff(F) <= F_MONOTONE_RTOL * np.abs(F[:-1])), F
    assert sum(ops.launch_counts().values()) == 0
    log_profile("tron", run_child_profile("tron"), "iteration")


def phase_bf16(torch, data, n_outer: int) -> None:
    """The three PCDN solve phases with the design stored in bf16: each
    kernel solve's launches; its F against the float32 solve of the same
    seed, printed (free runs: an Armijo decision that flips compounds, as
    in the solve phases); the gate, bf16 against float32 from a shared
    iterate (the bf16 run's w, each design's own margins of it, one
    partition) at every iteration, F rel <= BF16_F_RTOL; and the lockstep
    gate kernel vs plain at bf16."""
    from repro_torch.core import PCDNConfig
    from repro_torch.core.bundles import num_bundles
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import ops

    f32, b16 = torch.float32, torch.bfloat16
    for name, (i_x, i_y, c, layout, P, kernel, _) in SOLVES.items():
        runs, backends = {}, {}
        for dtype in (f32, b16):
            prob = make_problem(data[i_x], data[i_y], c=c, layout=layout,
                                dtype=dtype, device=DEVICE)
            assert prob.dtype == dtype and prob.solve_dtype == f32
            backends[dtype] = LocalBackend(prob, PCDNConfig(
                P=P, use_kernels=True, tol_kkt=0.0, max_outer=n_outer,
                seed=0))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = engine_loop.solve(backends[dtype], c, max_outer=n_outer,
                                    tol_kkt=0.0)
            torch.cuda.synchronize()
            runs[dtype] = (res, time.perf_counter() - t0,
                           ops.launch_counts())
        res, dt, counts = runs[b16]
        F16 = res.history.objective
        F32 = runs[f32][0].history.objective
        b = num_bundles(prob.n_features, P)
        free = np.abs(F16 - F32) / np.abs(F32)
        log(f"[bf16] {name}: {layout} bf16 storage, P={P}, {n_outer} "
            f"iterations: F {F16[-1]:.6f}; the float32 solve of the same "
            f"seed {F32[-1]:.6f}, free runs rel {free[-1]:.2e} (not gated; "
            f"per iteration " + " ".join(f"{r:.1e}" for r in free)
            + f"); wall {dt / n_outer * 1e3:.2f} ms an iteration (float32 "
            f"{runs[f32][1] / n_outer * 1e3:.2f}); {kernel} launches "
            f"{counts[kernel]}")
        assert np.all(np.isfinite(F16)) and res.n_outer == n_outer, F16
        assert counts[kernel] == b * n_outer, (counts, b)
        # bf16 against float32 from a shared iterate
        w, z, gen, active = backends[b16].init_state()
        shared = []
        for _ in range(n_outer):
            twin = torch.Generator().set_state(gen.get_state())
            out32 = backends[f32].outer(w, backends[f32].problem.margins(w),
                                        twin, active, True, c)
            w, z, gen, f16, _, _, _, active, _ = backends[b16].outer(
                w, z, gen, active, True, c)
            shared.append(abs(float(f16) - float(out32[3])) /
                          abs(float(out32[3])))
        log(f"[bf16] {name}: bf16 vs float32 from a shared iterate: F rel "
            f"per iteration {' '.join(f'{r:.1e}' for r in shared)} "
            f"(tolerance {BF16_F_RTOL}, the reference's bf16 envelope)")
        assert max(shared) <= BF16_F_RTOL, shared
        steps = lockstep(torch, prob, P, c, n_outer)
        log(f"[bf16] {name}: lockstep kernel vs plain at bf16 from a shared "
            f"carry: F rel per iteration "
            f"{' '.join(f'{r:.1e}' for r in steps)} (tolerance {F_RTOL})")
        assert max(steps) <= F_RTOL, steps


def phase_path(torch, rows, data, card: str) -> dict:
    """The regularization path on the card (`serve_data`'s rows): (a)
    `run_path` in-process with the metrics and trace planes on and the
    record_aux plane; (b) `repro_torch.launch.path.main` on the training
    rows as .libsvm, a sweep and a batch, each batch problem's F against a
    solo solve from its seed; (c) `fit_ovr` on a 4-class labelling; the
    support phase's iteration (`data`, as SOLVES["support"] has it) timed
    with telemetry off and on; K1's device ops a bundle with record_aux
    on, traced in a child process. -> the phase's launch counts."""
    from repro_torch import obs
    from repro_torch.core import PCDNConfig, pcdn, resolve_ls_scope
    from repro_torch.core.bundles import num_bundles
    from repro_torch.core.design_matrix import as_design
    from repro_torch.core.problem import make_problem
    from repro_torch.data import (csr_to_padded_csc, load_libsvm,
                                  save_libsvm_csr)
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import ops
    from repro_torch.launch import path as path_cli
    from repro_torch.obs import validate as obs_validate
    from repro_torch.path import PathConfig, run_path
    from repro_torch.serve.ovr import fit_ovr

    work = rows["work"]
    y_train = rows["y"][:SERVE_TRAIN]
    y_val = rows["y"][SERVE_TRAIN:]
    ops.reset_launch_counts()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (a) run_path with telemetry
    prob = make_problem(rows["train"], y_train, c=1.0, layout="padded_csc",
                        device=DEVICE)
    solver = PCDNConfig(P=PATH_P, use_kernels=True, record_aux=True,
                        tol_kkt=PATH_TOL, max_outer=PATH_MAX_OUTER)
    assert resolve_ls_scope(solver, prob) == "support"
    b = num_bundles(prob.n_features, PATH_P)
    val = as_design(csr_to_padded_csc(rows["requests"]), device=DEVICE)
    m_path, t_path = work / "path_a.jsonl", work / "path_a.trace.json"
    m_path.unlink(missing_ok=True)
    obs.registry.reset()
    obs.enable(metrics=True, trace_=True)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_path(prob, PathConfig(solver=solver, n_points=PATH_POINTS),
                   val_design=val, val_y=y_val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    snap = obs.registry.get_registry().snapshot()
    obs.write_metrics(str(m_path), meta={"cli": "chip_smoke path (a)",
                                         "card": card})
    obs.trace.save(str(t_path))
    obs.disable()
    obs.registry.reset()
    add(counts)
    n_events = obs.validate_trace_file(str(t_path))
    assert obs_validate.validate_metrics_file(str(m_path)) == 1
    assert obs_validate.main([str(m_path), str(t_path)]) == 0
    n_outer = sum(p.n_outer for p in res.points)
    ran = n_outer * b
    kc = snap["counters"]
    hq = snap["histograms"]["solver.bundle_q"]
    assert kc["kernels.pcdn_bundle.launches"] == counts["pcdn_bundle"] \
        == ran, (kc, counts, ran)
    assert sum(counts.values()) == counts["pcdn_bundle"], counts
    assert hq["count"] == ran and 1 <= hq["min"] and hq["max"] <= PATH_Q, hq
    assert kc["solver.outer_iters"] == n_outer, (kc, n_outer)
    assert kc["path.points"] == PATH_POINTS
    events = json.load(open(t_path))["traceEvents"]
    point_spans = [e for e in events if e["name"] == "path.point"]
    assert len(point_spans) == PATH_POINTS, len(point_spans)
    assert all(np.isfinite(p.objective) for p in res.points), res.points
    assert res.best_index is not None
    log(f"[path] (a) run_path, real-sim {prob.n_samples} x "
        f"{prob.n_features}, P={PATH_P} (support: K1 every bundle, {b} "
        f"bundles an iteration), {PATH_POINTS} points from c_max "
        f"{res.c_max:.6g} at span 100, tol {PATH_TOL}, max-outer "
        f"{PATH_MAX_OUTER}, record_aux, metrics + trace on: {wall:.2f}s "
        f"wall, {n_outer} outer iterations, {ran} K1 launches = the "
        f"counter = bundle_q's count (q in [{hq['min']:.0f}, "
        f"{hq['max']:.0f}], mean {hq['mean']:.3f}); trace {n_events} "
        f"events; best point {res.best_index} (c={res.best.c:.5g}, val "
        f"accuracy {res.best.val_accuracy:.4f})")
    for i, p in enumerate(res.points):
        log(f"[path]   point {i}: c={p.c:.5g} wall {p.seconds * 1e3:.2f} ms "
            f"n_outer={p.n_outer} converged={p.converged} kkt={p.kkt:.3e} "
            f"F={p.objective:.6f} nnz={p.nnz} val_acc={p.val_accuracy:.4f}")

    # (b) launch.path on the training rows as .libsvm
    train_path = work / "train.libsvm"
    t0 = time.perf_counter()
    save_libsvm_csr(str(train_path), rows["train_csr"], y_train)
    log(f"[path] (b) training rows -> {train_path.name}: "
        f"{time.perf_counter() - t0:.1f}s")
    cli_common = ["--dataset", str(train_path), "--layout", "padded_csc",
                  "--use-kernels", "--P", str(PATH_P), "--device", DEVICE]
    payloads = {}
    for mode, (points, max_outer) in (("sweep", PATH_CLI_SWEEP),
                                      ("batch", PATH_CLI_BATCH)):
        m_cli = work / f"path_{mode}.jsonl"
        t_cli = work / f"path_{mode}.trace.json"
        o_cli = work / f"path_{mode}.json"
        m_cli.unlink(missing_ok=True)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        payloads[mode] = path_cli.main(cli_common + [
            "--mode", mode, "--points", points, "--max-outer", max_outer,
            "--metrics-out", str(m_cli), "--trace-out", str(t_cli),
            "--progress", "--out", str(o_cli)])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        add(counts)
        assert obs_validate.main([str(m_cli), str(t_cli)]) == 0
        rec = json.loads(open(m_cli).read())
        cli_points = payloads[mode]["points"]
        assert all(np.isfinite(p["objective"]) for p in cli_points)
        assert rec["metrics"]["counters"][
            "kernels.pcdn_bundle.launches"] == counts["pcdn_bundle"] > 0
        log(f"[path] (b) launch.path --mode {mode} --points {points} "
            f"--max-outer {max_outer}: {wall:.2f}s wall (load + solve), "
            f"K1 launches {counts['pcdn_bundle']}; F "
            + " ".join(f"{p['objective']:.6f}" for p in cli_points))
    X_file, y_file = load_libsvm(str(train_path), layout="padded_csc")
    file_prob = make_problem(X_file, y_file, c=1.0, layout="padded_csc",
                             device=DEVICE)
    rels = []
    for p in payloads["batch"]["points"]:
        solo = pcdn.solve(file_prob.with_c(p["c"]), PCDNConfig(
            P=PATH_P, use_kernels=True, tol_kkt=PATH_TOL,
            max_outer=int(PATH_CLI_BATCH[1]), seed=0))
        rels.append((abs(p["objective"] - solo.objective)
                     / abs(solo.objective), p["n_outer"], solo.n_outer))
    log(f"[path] (b) batch problems against solo solves from the same "
        f"seed (F rel, batch / solo outer iterations): "
        + "; ".join(f"{r:.1e} ({a}/{s_})" for r, a, s_ in rels)
        + f" (tolerance {PATH_BATCH_RTOL})")
    rels = [r for r, _, _ in rels]
    assert max(rels) <= PATH_BATCH_RTOL, rels

    # (c) fit_ovr on a 4-class labelling of the training rows
    gen = np.random.default_rng(DATA_SEED)
    planes = torch.as_tensor(gen.standard_normal(
        (prob.n_features, PATH_OVR_CLASSES)).astype(np.float32),
        device=DEVICE)
    margins = torch.stack([prob.margins(planes[:, k].contiguous())
                           for k in range(PATH_OVR_CLASSES)], dim=1)
    labels = torch.argmax(margins, dim=1).cpu().numpy()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ovr = fit_ovr(rows["train"], labels, SERVE_C_STAR, PCDNConfig(
        P=PATH_P, use_kernels=True, tol_kkt=PATH_TOL,
        max_outer=PATH_OVR_OUTER), layout="padded_csc", problem=prob,
        device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    add(counts)
    F = ovr.batch.objective.cpu().numpy()
    iters = int(ovr.batch.n_outer.max())
    assert np.all(np.isfinite(F)), F
    assert counts["pcdn_bundle"] == iters * PATH_OVR_CLASSES * b, counts
    log(f"[path] (c) fit_ovr, {PATH_OVR_CLASSES} classes (argmax of "
        f"seeded hyperplanes; class sizes "
        f"{np.bincount(labels, minlength=PATH_OVR_CLASSES).tolist()}), "
        f"c={SERVE_C_STAR}, {iters} outer iterations: {wall:.2f}s, K1 "
        f"launches {counts['pcdn_bundle']}; F "
        + " ".join(f"{f:.6f}" for f in F)
        + f"; train accuracy {ovr.train_accuracy:.4f}")

    # the support phase's iteration, telemetry off and on, interleaved
    i_x, i_y, c_s, layout, P_s, _, _ = SOLVES["support"]
    sprob = make_problem(data[i_x], data[i_y], c=c_s, layout=layout,
                         device=DEVICE)
    b_s = num_bundles(sprob.n_features, P_s)
    off = LocalBackend(sprob, PCDNConfig(P=P_s, use_kernels=True,
                                         tol_kkt=0.0, seed=0))
    aux = LocalBackend(sprob, PCDNConfig(P=P_s, use_kernels=True,
                                         tol_kkt=0.0, seed=0,
                                         record_aux=True))
    modes = {"off": (off, False, False), "metrics": (off, True, False),
             "metrics+trace": (off, True, True), "record_aux": (aux, False,
                                                                False)}
    order = ["off", "metrics", "metrics+trace", "record_aux",
             "record_aux", "metrics+trace", "metrics", "off"] * 2
    readings = {m: [] for m in modes}
    halves = []
    half = PATH_TIMING_ITERS // 2
    for m in order:
        backend, metrics, tracing = modes[m]
        obs.enable(metrics=metrics, trace_=tracing)
        gc2 = gc.get_stats()[2]["collections"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = engine_loop.solve(backend, c_s, max_outer=PATH_TIMING_ITERS,
                              tol_kkt=0.0)
        torch.cuda.synchronize()
        readings[m].append((time.perf_counter() - t0) / PATH_TIMING_ITERS)
        obs.disable()
        obs.registry.reset()
        assert r.n_outer == PATH_TIMING_ITERS and np.isfinite(r.objective)
        # the history's cumulative wall (synced each iteration) split at
        # the half: the support phase times iterations 0-9 alone
        wt, q = r.history.wall_time, r.history.ls_steps
        halves.append((m, wt[half - 1] / half * 1e3,
                       (wt[-1] - wt[half - 1]) / half * 1e3,
                       q[:half].mean(), q[half:].mean(),
                       gc.get_stats()[2]["collections"] - gc2))
    log(f"[path] support phase's iteration wall (real-sim, P={P_s}, "
        f"{b_s} bundles, c={c_s}, {PATH_TIMING_ITERS} iterations a "
        f"reading, interleaved {' / '.join(order[:8])}, twice; {card}): "
        + "; ".join(f"{m} " + ", ".join(f"{v * 1e3:.3f}" for v in vs)
                    + f" ms (mean {np.mean(vs) * 1e3:.3f})"
                    for m, vs in readings.items()))
    log(f"[path]   per reading (ms an iteration over iterations 0-{half - 1}"
        f" / {half}-{PATH_TIMING_ITERS - 1}, mean q over each, gen-2 GC "
        f"collections): "
        + "; ".join(f"{m} {a:.3f} / {b_:.3f}, q {qa:.3f} / {qb:.3f}, "
                    f"gc {g}" for m, a, b_, qa, qb, g in halves))

    # K1's device ops a bundle with record_aux on, in a fresh process
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--solve-profile",
         "support", "--record-aux"], capture_output=True, text=True,
        check=True, timeout=300)
    prof = json.loads(child.stdout.strip().splitlines()[-1])
    assert prof["launches"] == b_s, (prof["launches"], b_s)
    top = [tuple(r) for r in prof["rows"] if r[2] > 0]
    if prof["busy_s"] > 0:
        n_ops = sum(r[1] for r in top)
        per_bundle = [r for r in top if r[1] >= b_s]
        log(f"[path] record_aux on, one support iteration traced in a "
            f"fresh process: {n_ops} device ops, {n_ops / b_s:.2f} a "
            f"bundle, busy {prof['busy_s'] * 1e3:.2f} ms; launched at "
            f"least once a bundle: "
            + "; ".join(f"{k[:70]} x{n}" for k, n, _ in per_bundle))
        assert len(per_bundle) == 1 and per_bundle[0][1] == b_s and \
            "bundle_step_kernel" in per_bundle[0][0], per_bundle
        assert n_ops - b_s < b_s // 2, (n_ops, b_s)
    else:
        log("[path] record_aux device ops: not measured (the profiler saw "
            "no device time)")
    log(f"[path] launches over the phase: {total}")
    return total


def _child(args, env=None, timeout=300, log_to=None):
    """Start `python -m <args>` on the checkout's src, the fault plan (if
    any) in REPRO_FAULT_PLAN. -> the Popen (stdout and stderr piped; with
    `log_to`, a path, written to log_to.out and log_to.err instead, so
    that a child left running while this process works cannot stall on
    a full pipe)."""
    e = dict(os.environ)
    e["PYTHONPATH"] = str(SRC)
    e.pop("REPRO_FAULT_PLAN", None)
    e.update(env or {})
    outs = [subprocess.PIPE] * 2
    if log_to is not None:
        outs = [open(f"{log_to}.{x}", "w") for x in ("out", "err")]
    proc = subprocess.Popen([sys.executable, "-m", *args], stdout=outs[0],
                            stderr=outs[1], text=True, env=e, cwd=str(ROOT))
    if log_to is not None:
        for fh in outs:
            fh.close()
    proc.smoke_timeout = timeout
    proc.smoke_logs = log_to
    return proc


def _finish(name, proc, rc=0):
    """Wait for a child of `_child`; its rc must be `rc`. -> stdout."""
    out, err = proc.communicate(timeout=proc.smoke_timeout)
    logs = getattr(proc, "smoke_logs", None)
    if logs is not None:
        out, err = (Path(f"{logs}.{x}").read_text()
                    for x in ("out", "err"))
    if proc.returncode != rc:
        # the err tail holds every rank's traceback and torchrun's report
        raise AssertionError(f"[fault] {name}: exit {proc.returncode} "
                             f"(expected {rc})\n{out[-3000:]}\n"
                             f"{err[-12000:]}")
    return out


def _counters(path) -> dict:
    """The kernel launch counters of a child's --metrics-out record."""
    rec = json.loads(Path(path).read_text().strip().splitlines()[-1])
    c = rec["metrics"]["counters"]
    return {k: int(c.get(f"kernels.{k}.launches", 0))
            for k in ("pcdn_sparse_direction", "pcdn_bundle")}


def _solve_rows(ck_dir, step):
    from repro_torch.fault import CheckpointManager
    return CheckpointManager(str(ck_dir)).load_raw(step)


def phase_fault(torch, rows, data, card: str) -> dict:
    """Diagnostics and fault tolerance through the port's CLIs, on the
    support cell's real-sim (make_data's, written as .libsvm) at c 4: (1)
    a NaN into the margins at iteration 3 of a P 64 solve (the full scope,
    K2) rolls back and backs off to P 32 (the support scope, K1), the
    launch counters equal to iterations x bundles of each attempt; (2) the
    same with --retries 0: the post-mortem in --out and in the --diag-out
    report, re-rendered from --out by `python -m repro_torch.diag.report`;
    (3) a solve SIGKILLed at iteration 7 (checkpoints every 3) resumed
    against an uninterrupted one, the checkpoint's image restored on the
    CPU bit for bit, and one iteration from it through the plain versions
    on the CPU and through K1 on the card; (4) a path sweep over the path
    phase's rows SIGKILLed after point 1 and resumed; (5) the certified P
    on the card's design against scipy's eigsh; (6) the costs of the
    --diag-out planes and of a checkpoint every 3 iterations, and one
    snapshot's write. The CLI runs are child processes, the independent
    ones started together. -> the K1 / K2 launches the phase counted."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla
    from repro_torch.core import PCDNConfig, resolve_ls_scope
    from repro_torch.core import bundles as B
    from repro_torch.core.bundles import num_bundles
    from repro_torch.core.problem import make_problem
    from repro_torch.data import load_libsvm, save_libsvm_csr
    from repro_torch.diag import safep
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.fault import SolveCheckpointer, next_bundle_size
    from repro_torch.kernels import ops

    work = rows["work"] / "fault"
    if work.exists():
        import shutil
        shutil.rmtree(work)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    c = SOLVES["support"][2]
    csc, y = data[0], data[1]
    t0 = time.perf_counter()
    rs_path = work / "realsim.libsvm"
    save_libsvm_csr(str(rs_path), csc.to_csr(), y)
    path_rows = work / "train.libsvm"
    save_libsvm_csr(str(path_rows), rows["train_csr"], rows["y"][:SERVE_TRAIN])
    X_file, y_file = load_libsvm(str(rs_path), layout="padded_csc")
    prob = make_problem(X_file, y_file, c=c, layout="padded_csc",
                        device=DEVICE)
    n = prob.n_features
    b64, b32 = num_bundles(n, FAULT_P), num_bundles(n, FAULT_P // 2)
    scopes = {P: resolve_ls_scope(PCDNConfig(P=P, use_kernels=True), prob)
              for P in (FAULT_P, FAULT_P // 2)}
    assert scopes == {FAULT_P: "full", FAULT_P // 2: "support"}, scopes
    log(f"[fault] data: real-sim {prob.n_samples} x {n} (k_max "
        f"{X_file.k_max}) -> {rs_path.name}, the path phase's rows -> "
        f"{path_rows.name}: {time.perf_counter() - t0:.1f}s; P {FAULT_P}: "
        f"{scopes[FAULT_P]} scope (K2), {b64} bundles; P {FAULT_P // 2}: "
        f"{scopes[FAULT_P // 2]} scope (K1), {b32} bundles")
    counted = {"pcdn_sparse_direction": 0, "pcdn_bundle": 0}

    def add(counts):
        for k in counted:
            counted[k] += counts.get(k, 0)

    solve = ["repro_torch.launch.solve", "--dataset", str(rs_path),
             "--layout", "padded_csc", "--use-kernels", "--device", DEVICE,
             "--c", str(c), "--tol", "1e-3"]
    nan_plan = {"REPRO_FAULT_PLAN": json.dumps(
        {"nan_at_iter": FAULT_NAN_AT, "nan_target": "margins"})}

    def nan_run(tag, extra):
        return _child(solve + [
            "--P", str(FAULT_P), "--max-outer", str(FAULT_MAX_OUTER),
            "--diag-out", str(work / f"{tag}.md"), "--out",
            str(work / f"{tag}.json"), "--metrics-out",
            str(work / f"{tag}.jsonl")] + extra, env=nan_plan)

    # (1) rollback with P backoff, alone (its timings printed)
    t0 = time.perf_counter()
    out = _finish("rollback", nan_run("rollback", []))
    wall = time.perf_counter() - t0
    rep = json.loads((work / "rollback.json").read_text())
    fl = rep["faults"]
    p_new = next_bundle_size(FAULT_P, fl["p_cert"])
    b_new = num_bundles(n, p_new)
    assert fl["rollbacks"] == 1, fl
    assert fl["p_schedule"] == [FAULT_P, p_new], fl
    assert resolve_ls_scope(PCDNConfig(P=p_new, use_kernels=True),
                            prob) == "support", p_new
    assert np.isfinite(rep["objective"]), rep["objective"]
    it = rep["history"]["outer_iter"]
    assert it == list(range(len(it))), it
    cnt = _counters(work / "rollback.jsonl")
    add(cnt)
    want = {"pcdn_sparse_direction": (FAULT_NAN_AT + 1) * b64,
            "pcdn_bundle": (len(it) - FAULT_NAN_AT) * b_new}
    assert cnt == want, (cnt, want)
    cert_s = float(re.search(r"P_cert=\d+ \(([\d.]+)s\)", out).group(1))
    rebuild_ms = float(re.search(r"rebuilt the backend at P=\d+ in "
                                 r"([\d.]+) ms", out).group(1))
    log(f"[fault] (1) NaN in the margins at iteration {FAULT_NAN_AT}, P "
        f"{FAULT_P}: rollbacks {fl['rollbacks']}, p_schedule "
        f"{fl['p_schedule']}, P_cert {fl['p_cert']}, {len(it)} iterations "
        f"(outer_iter 0..{it[-1]}), F {rep['objective']:.6f}, converged "
        f"{rep['converged']}; K2 launches {cnt['pcdn_sparse_direction']} = "
        f"{FAULT_NAN_AT + 1} x {b64}, K1 launches {cnt['pcdn_bundle']} = "
        f"{len(it) - FAULT_NAN_AT} x {b_new}; lazy certify {cert_s:.3f} s, "
        f"rebuild at P {p_new} {rebuild_ms:.3f} ms; child wall {wall:.1f}s "
        f"(start, load, solve, certify twice: lazily and for --diag-out)")

    # (2) and the uninterrupted / crashing runs of (3) and (4), together
    t0 = time.perf_counter()
    crash = {"REPRO_FAULT_PLAN": json.dumps(
        {"crash_at_iter": FAULT_CRASH_AT, "crash_kind": "sigkill"})}
    solve32 = solve + ["--P", str(FAULT_P // 2), "--max-outer",
                       str(FAULT_SOLVE_OUTER)]
    path = ["repro_torch.launch.path", "--dataset", str(path_rows),
            "--layout", "padded_csc", "--use-kernels", "--device", DEVICE,
            "--P", str(PATH_P), "--points", str(FAULT_PATH_POINTS),
            "--max-outer", str(FAULT_PATH_OUTER), "--tol", str(PATH_TOL)]
    procs = {
        "retries0": nan_run("retries0", ["--retries", "0"]),
        "solve_ref": _child(solve32 + [
            "--out", str(work / "solve_ref.json"), "--metrics-out",
            str(work / "solve_ref.jsonl")]),
        "solve_crash": _child(solve32 + [
            "--ckpt-dir", str(work / "ck_solve"), "--ckpt-every",
            str(FAULT_CKPT_EVERY)], env=crash),
        "path_ref": _child(path + ["--out", str(work / "path_ref.json"),
                                   "--metrics-out",
                                   str(work / "path_ref.jsonl")]),
        "path_crash": _child(path + ["--ckpt-dir", str(work / "ck_path")],
                             env={"REPRO_FAULT_PLAN": json.dumps(
                                 {"crash_at_point": 1,
                                  "crash_kind": "sigkill"})}),
    }
    outs = {k: _finish(k, p, rc=-9 if k.endswith("crash") else 0)
            for k, p in procs.items()}
    for k in ("retries0", "solve_ref", "path_ref"):
        add(_counters(work / f"{k}.jsonl"))
    procs = {
        "solve_resume": _child(solve32 + [
            "--ckpt-dir", str(work / "ck_solve"), "--ckpt-every",
            str(FAULT_CKPT_EVERY), "--resume", "--out",
            str(work / "solve_res.json"), "--metrics-out",
            str(work / "solve_res.jsonl")]),
        "path_resume": _child(path + [
            "--ckpt-dir", str(work / "ck_path"), "--resume", "--out",
            str(work / "path_res.json"), "--metrics-out",
            str(work / "path_res.jsonl")]),
        "report": _child(["repro_torch.diag.report", "--report",
                          str(work / "retries0.json"), "-o",
                          str(work / "retries0_again.md")]),
    }
    outs.update({k: _finish(k, p) for k, p in procs.items()})
    for k in ("solve_res", "path_res"):
        add(_counters(work / f"{k}.jsonl"))
    log(f"[fault] children of (2)-(4): 5 started together, then 3: "
        f"{time.perf_counter() - t0:.1f}s")

    # (2) --retries 0: the post-mortem and the report
    rep = json.loads((work / "retries0.json").read_text())
    pm = rep["postmortem"]
    assert rep["faults"]["rollbacks"] == 1, rep["faults"]
    assert "surfacing post-mortem" in outs["retries0"]
    for key in ("objective_growth", "deepest_mean_q", "heatmap",
                "worst_bundles", "alpha_floor"):
        assert key in pm, key
    k2 = _counters(work / "retries0.jsonl")["pcdn_sparse_direction"]
    assert pm["heatmap"]["bundles_ran"] == k2 == (FAULT_NAN_AT + 1) * b64, \
        (pm["heatmap"]["bundles_ran"], k2)
    md = (work / "retries0.md").read_text()
    sections = {"summary": "## Run summary", "convergence": "## Convergence",
                "attribution": "## Top KKT offenders",
                "backtracks": "## Backtrack forensics",
                "postmortem": "## Divergence post-mortem",
                "safep": "## Certified parallelism"}
    missing = [k for k, v in sections.items() if v not in md]
    assert not missing, missing
    assert (work / "retries0_again.md").read_text() == md
    log(f"[fault] (2) --retries 0: diverged, post-mortem trip_iter "
        f"{pm['trip_iter']}, objective_growth {pm['objective_growth']}, "
        f"deepest_mean_q {pm['deepest_mean_q']}, alpha_floor "
        f"{pm['alpha_floor']}, heatmap bundles_ran "
        f"{pm['heatmap']['bundles_ran']} = K2 launches {k2}; the report has "
        f"{', '.join(sections)}; `python -m repro_torch.diag.report "
        f"--report` re-renders it byte for byte")

    # (3) the solve's crash and resume
    res = json.loads((work / "solve_res.json").read_text())
    ref = json.loads((work / "solve_ref.json").read_text())
    resumed_at = FAULT_CRASH_AT - FAULT_CRASH_AT % FAULT_CKPT_EVERY
    assert f"resuming solve at outer iteration {resumed_at}" in \
        outs["solve_resume"], outs["solve_resume"][-2000:]
    f_rel = abs(res["objective"] - ref["objective"]) / abs(ref["objective"])
    w_equal = (res["w_indices"] == ref["w_indices"]
               and res["w_values"] == ref["w_values"])
    assert f_rel <= FAULT_RESUME_RTOL, (res["objective"], ref["objective"])
    assert w_equal, "the resumed solve's w is not bit-equal"
    log(f"[fault] (3) solve SIGKILLed at iteration {FAULT_CRASH_AT} "
        f"(checkpoints every {FAULT_CKPT_EVERY}), resumed at {resumed_at}: "
        f"F {res['objective']:.9g} against uninterrupted "
        f"{ref['objective']:.9g} (rel {f_rel:.3e}, limit "
        f"{FAULT_RESUME_RTOL}); w bit-equal: {w_equal}")
    ck = SolveCheckpointer(str(work / "ck_solve"))
    step = ck.manager.latest_step()
    leaves = _solve_rows(work / "ck_solve", step)
    cfg = PCDNConfig(P=FAULT_P // 2, use_kernels=True, tol_kkt=0.0, seed=0)
    cpu_prob = make_problem(X_file, y_file, c=c, layout="padded_csc",
                            device="cpu")
    st_cpu, meta = ck.restore_solve(LocalBackend(cpu_prob, cfg))
    for k in ("w", "z", "active"):
        got = getattr(st_cpu, k).numpy()
        assert got.dtype == leaves[k].dtype and \
            np.array_equal(got, leaves[k]), k
    st_gpu, _ = ck.restore_solve(LocalBackend(prob, cfg))
    idxs = B.partition(torch.Generator().set_state(st_cpu.gen.get_state()),
                       n, FAULT_P // 2)
    t0 = time.perf_counter()
    out_cpu = LocalBackend(cpu_prob, cfg).outer(
        st_cpu.w, st_cpu.z, st_cpu.gen, st_cpu.active, True, c, idxs=idxs)
    cpu_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    out_gpu = LocalBackend(prob, cfg).outer(
        st_gpu.w, st_gpu.z, st_gpu.gen, st_gpu.active, True, c,
        idxs=idxs.to(DEVICE))
    torch.cuda.synchronize()
    k1 = ops.launch_counts()["pcdn_bundle"]
    add(ops.launch_counts())
    f_cpu, f_gpu = float(out_cpu[3]), float(out_gpu[3])
    rel = abs(f_gpu - f_cpu) / abs(f_cpu)
    assert k1 == b32, (k1, b32)
    assert rel <= F_RTOL, (f_gpu, f_cpu)
    log(f"[fault] (3) the card-written checkpoint (step {step}, iteration "
        f"{meta['outer_iter']}) restored on the CPU: w, z, active bit-equal "
        f"to its arrays; one iteration from it with one partition: plain "
        f"versions on the CPU F {f_cpu:.9g} ({cpu_s:.1f}s), K1 on the card "
        f"F {f_gpu:.9g} ({k1} launches), rel {rel:.3e} (limit {F_RTOL})")

    # (4) the path sweep's crash and resume
    pres = json.loads((work / "path_res.json").read_text())
    pref = json.loads((work / "path_ref.json").read_text())
    assert f"resuming path sweep at point 2/{FAULT_PATH_POINTS}" in \
        outs["path_resume"]
    assert pres["best_index"] == pref["best_index"]
    rels = [abs(a["objective"] - b["objective"]) / abs(b["objective"])
            for a, b in zip(pres["points"], pref["points"])]
    assert len(rels) == FAULT_PATH_POINTS and \
        max(rels) <= FAULT_RESUME_RTOL, rels
    log(f"[fault] (4) path sweep ({FAULT_PATH_POINTS} points, max-outer "
        f"{FAULT_PATH_OUTER}, P {PATH_P}) SIGKILLed after point 1, resumed "
        f"at point 2: best index {pres['best_index']} (a file dataset has "
        f"no validation split) in both; per-point F rel "
        + ", ".join(f"{r:.3e}" for r in rels)
        + f" (limit {FAULT_RESUME_RTOL}); F "
        + " ".join(f"{p['objective']:.9g}" for p in pres["points"]))

    # (5) the certified P on the card's design against eigsh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cert = safep.certify(prob.design, observed_p=FAULT_P)
    cert_wall = time.perf_counter() - t0
    csr = load_libsvm(str(rs_path), layout="csr")[0]
    nz_rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    omega = int(np.bincount(nz_rows[csr.data != 0],
                            minlength=csr.shape[0]).max())
    assert cert["omega"] == omega, (cert["omega"], omega)
    Xs = sps.csr_matrix((csr.data.astype(np.float64), csr.indices,
                         csr.indptr), shape=csr.shape)
    norms = np.sqrt(np.asarray(Xs.multiply(Xs).sum(axis=0)).ravel())
    scale = np.divide(1.0, norms, out=np.zeros_like(norms),
                      where=norms > 0)
    Xn = (Xs @ sps.diags(scale)).tocsr()
    XnT = Xn.T.tocsr()
    op = spla.LinearOperator((n, n), matvec=lambda v: XnT @ (Xn @ v),
                             dtype=np.float64)
    t0 = time.perf_counter()
    # two Lanczos values: the top pair is 3e-3 apart on this data
    top2 = np.sort(spla.eigsh(op, k=2, which="LA",
                              return_eigenvectors=False))[::-1]
    lam = float(top2[0])
    eig_s = time.perf_counter() - t0
    cert_rel = (lam - cert["rho_normalized"]) / lam
    # a Rayleigh quotient never exceeds the top eigenvalue
    assert cert["rho_normalized"] <= lam * (1 + 1e-6), \
        (cert["rho_normalized"], lam)
    t0 = time.perf_counter()
    deep = safep.power_iteration_rho(prob.design, n_iter=FAULT_POWER_STEPS,
                                     tol=0.0)
    deep_s = time.perf_counter() - t0
    rho_rel = abs(deep["rho"] - lam) / lam
    assert rho_rel <= FAULT_RHO_RTOL, (deep["rho"], lam)
    log(f"[fault] (5) certify at its defaults (n_iter 1000, tol 1e-9) on "
        f"the card's padded-CSC design: rho {cert['rho_normalized']:.9g}, "
        f"power_iters {cert['power_iters']}, converged "
        f"{cert['power_converged']}, {cert_rel:.3e} below eigsh's top "
        f"eigenvalue {lam:.9g} (second {float(top2[1]):.9g}; float64 "
        f"LinearOperator over the column-normalised design, {eig_s:.2f}s); "
        f"P_spectral {cert['P_spectral']} (n / eigsh's: "
        f"{int(np.floor(n / lam))}), omega {cert['omega']} (= the CSR "
        f"rows' count), P_eso {cert['P_eso']}, P_cert {cert['P_cert']}; "
        f"wall {cert_wall:.3f}s. The same power iteration run "
        f"{FAULT_POWER_STEPS} steps with no early stop: rho "
        f"{deep['rho']:.9g}, rel {rho_rel:.3e} to eigsh (limit "
        f"{FAULT_RHO_RTOL}), {deep_s:.2f}s")

    # (6) costs, interleaved in this process
    i_x, i_y, c_s, layout, P_s, _, _ = SOLVES["support"]
    sprob = make_problem(data[i_x], data[i_y], c=c_s, layout=layout,
                         device=DEVICE)
    base = dict(P=P_s, use_kernels=True, tol_kkt=0.0, seed=0)
    off = LocalBackend(sprob, PCDNConfig(**base))
    planes = LocalBackend(sprob, PCDNConfig(**base, record_aux=True,
                                            record_kkt_vec=True))
    ck_cost = SolveCheckpointer(str(work / "ck_cost"), every=3)
    modes = {"off": (off, None), "diag planes": (planes, None),
             "ckpt every 3": (off, ck_cost.solve_callback(off))}
    order = ["off", "diag planes", "ckpt every 3", "ckpt every 3",
             "diag planes", "off"] * 2
    readings = {m: [] for m in modes}
    engine_loop.solve(off, c_s, max_outer=2, tol_kkt=0.0)   # warm
    ops.reset_launch_counts()
    for m in order:
        backend, cb = modes[m]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r = engine_loop.run_outer_loop(
            backend.outer, backend.init_state(), c_s,
            max_outer=FAULT_COST_ITERS, tol_kkt=0.0, state_callback=cb)
        torch.cuda.synchronize()
        readings[m].append((time.perf_counter() - t0) / FAULT_COST_ITERS)
        assert r.n_outer == FAULT_COST_ITERS and np.isfinite(r.objective)
    add(ops.launch_counts())
    assert ops.launch_counts()["pcdn_bundle"] == \
        len(order) * FAULT_COST_ITERS * num_bundles(sprob.n_features, P_s)
    st = off.init_state()
    writes = []
    for k in range(5):
        t0 = time.perf_counter()
        d = ck_cost.save_solve(off, st, outer_iter=100 + k)
        writes.append((time.perf_counter() - t0) * 1e3)
    mb = (Path(d) / "arrays.npz").stat().st_size / 1e6
    log(f"[fault] (6) support iteration wall (real-sim, P {P_s}, c {c_s}, "
        f"{FAULT_COST_ITERS} iterations a reading, interleaved "
        f"{' / '.join(order[:6])}, twice; {card}): "
        + "; ".join(f"{m} " + ", ".join(f"{v * 1e3:.3f}" for v in vs)
                    + f" ms (mean {np.mean(vs) * 1e3:.3f})"
                    for m, vs in readings.items())
        + f"; one snapshot (w, z, active, key: arrays.npz {mb:.3f} MB, "
          f"fsynced, renamed): " + ", ".join(f"{v:.3f}" for v in writes)
        + " ms")
    log(f"[fault] phase wall {time.perf_counter() - t_phase:.1f}s; K1 / K2 "
        f"launches counted (child runs' metrics counters, killed runs "
        f"uncounted, and this process's runs): {counted}")
    return counted


def phase_sharded(torch, data, card: str) -> dict:
    """The sharded backend on the card: (a) a world of 1 on NCCL with the
    kernels (the three new entries), real-sim's full (P 512) and support
    (P 32) scopes and gisette's dense layout (P 512), each outer iteration
    from one shared carry and one partition against the local backend with
    the kernels (F rel F_RTOL), the walls an iteration, the reductions a
    bundle asked and issued, the entries' launches; (b) two ranks on the
    one card over gloo in a torchrun child (`--sharded-ranks`); (c) the
    CLIs. -> the entries' launches in (a), the main path's run."""
    import shutil
    from repro_torch.core import PCDNConfig
    from repro_torch.core import bundles as B
    from repro_torch.core.problem import make_problem
    from repro_torch.data import save_libsvm_csr
    from repro_torch.engine import LocalBackend
    from repro_torch.engine.sharded import ShardedBackend, ShardedPCDNConfig
    from repro_torch.fault import SolveCheckpointer
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    work = ROOT / "build" / "chip_smoke" / "sharded"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=DEVICE)
    log(f"[sharded] (a) mesh {mesh.describe()}")
    # a world of 1 with a card of its own: NCCL (gloo on a CPU rehearsal)
    assert mesh.backend == ("nccl" if DEVICE == "cuda" else "gloo"), \
        mesh.backend
    dev = mesh.device
    counted = {k: 0 for k in SHARDED_ENTRIES}
    ranks_rec = {}
    support = None
    for label, xi, yi, c, layout, P, scope in SHARDED_CASES:
        X, y = data[xi], data[yi]
        t0 = time.perf_counter()
        tb = ShardedBackend(X, y, mesh, ShardedPCDNConfig(
            P_local=P, c=c, use_kernels=True, ls_scope=scope), layout=layout)
        prob = make_problem(X, y, c=c, layout=layout, device=dev)
        lb = LocalBackend(prob, PCDNConfig(P=P, use_kernels=True,
                                           ls_scope=scope))
        assert tb.outer.use_support == (scope == "support")
        place_s = time.perf_counter() - t0
        n = tb.n_features
        gen = torch.Generator().manual_seed(DATA_SEED + 11)
        st = tb.init_state()
        w, z, act = st.w, st.z, st.active
        walls_s, walls_l, rels = [], [], []
        mine = {k: 0 for k in SHARDED_ENTRIES}
        asked = issued = n_bundles = 0
        keep = label == "real-sim full"
        n_outer = SHARDED_SUPPORT_OUTER if scope == "support" else \
            SHARDED_OUTER
        for k in range(n_outer):
            idxs = B.partition(gen, n, P, device=dev)
            if keep and k < SHARDED_RANK_OUTER:
                ranks_rec.update({f"w{k}": w.cpu().numpy(),
                                  f"z{k}": z.cpu().numpy(),
                                  f"idxs{k}": idxs.cpu().numpy()})
            mesh.reset_counts()
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_s = tb.outer(w, z, st.gen, act, True, c, idxs=[idxs])
            torch.cuda.synchronize()
            walls_s.append(time.perf_counter() - t0)
            after = ops.launch_counts()
            for e in SHARDED_ENTRIES:
                mine[e] += after[e] - before[e]
            asked += mesh.counts["asked"]
            issued += mesh.counts["issued"]
            n_bundles += idxs.shape[0]
            t0 = time.perf_counter()
            out_l = lb.outer(w, z, st.gen, act, True, c, idxs=idxs)
            torch.cuda.synchronize()
            walls_l.append(time.perf_counter() - t0)
            f_s, f_l = float(out_s[3]), float(out_l[3])
            rels.append(abs(f_s - f_l) / abs(f_l))
            if keep and k < SHARDED_RANK_OUTER:
                ranks_rec[f"f{k}"] = np.float64(f_s)
            w, z, act = out_s[0], out_s[1], out_s[7]
        for e in SHARDED_ENTRIES:
            counted[e] += mine[e]
        want = (("pcdn_direction_partials",) if layout == "dense" else
                ("pcdn_sparse_direction_partials", "pcdn_sparse_scatter"))
        log(f"[sharded] (a) {label}: P {P}, {scope} scope, "
            f"{n_bundles // n_outer} bundles an iteration; F "
            f"{f_s:.9g}; F rel against the local backend, worst of "
            f"{n_outer} lockstep iterations {max(rels):.3e} (limit "
            f"{F_RTOL}); wall an iteration sharded "
            f"{1e3 * np.mean(walls_s[1:]):.2f} ms, local "
            f"{1e3 * np.mean(walls_l[1:]):.2f} ms (first "
            f"{1e3 * walls_s[0]:.2f} / {1e3 * walls_l[0]:.2f} ms); "
            f"reductions a bundle asked {asked / n_bundles:.2f}, issued "
            f"{issued / n_bundles:.2f}; launches {mine}; placed in "
            f"{place_s:.1f}s on {card}")
        assert max(rels) <= F_RTOL, rels
        assert all(mine[e] > 0 for e in want), mine
        if scope == "support":
            support = (tb, prob, c)

    # (b) two ranks sharing the card over gloo
    csr = data[0].to_csr()
    npz = work / "ranks.npz"
    np.savez(npz, data=csr.data, indices=csr.indices, indptr=csr.indptr,
             shape=np.asarray(csr.shape), y=data[1], c=4.0, P=512,
             steps=SHARDED_RANK_OUTER, **ranks_rec)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(ROOT / "chip_smoke.py"),
         "--sharded-ranks", str(npz), str(work / "ranks.json")],
        capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rk = json.loads((work / "ranks.json").read_text())
    log(f"[sharded] (b) two ranks on one card ({rk['mesh']}), "
        f"{time.perf_counter() - t0:.1f}s with start-up: (2 x 1) at P 512 "
        f"against (a) from its carries and partitions, F rel worst "
        f"{max(rk['2x1']['rels']):.3e}, wall an iteration "
        f"{1e3 * np.mean(rk['2x1']['walls'][1:]):.2f} ms; (1 x 2) kernel "
        f"route against plain route, F rel worst "
        f"{max(rk['1x2']['rels']):.3e}, wall an iteration "
        f"{1e3 * np.mean(rk['1x2']['walls'][1:]):.2f} ms (plain "
        f"{1e3 * np.mean(rk['1x2']['plain_walls'][1:]):.2f} ms), "
        f"launches {rk['1x2']['launches']}; reductions a bundle issued "
        f"{rk['2x1']['issued_per_bundle']:.2f} / "
        f"{rk['1x2']['issued_per_bundle']:.2f}; limit {F_RTOL}")
    assert max(rk["2x1"]["rels"]) <= F_RTOL, rk["2x1"]
    assert max(rk["1x2"]["rels"]) <= F_RTOL, rk["1x2"]
    assert rk["1x2"]["launches"]["pcdn_sparse_direction_partials"] > 0
    assert rk["1x2"]["launches"]["pcdn_sparse_scatter"] > 0

    # (c) the CLIs on real-sim as .libsvm
    t0 = time.perf_counter()
    rs_path = work / "realsim.libsvm"
    save_libsvm_csr(str(rs_path), csr, data[1])
    base = ["repro_torch.launch.solve", "--dataset", str(rs_path),
            "--layout", "padded_csc", "--use-kernels", "--device", DEVICE,
            "--c", "4.0", "--tol", "1e-6", "--P", "32"]
    sh = base + ["--backend", "sharded"]
    ck_s, ck_l = work / "ck_sharded", work / "ck_local"
    every = ["--ckpt-every", "2"]
    outer = ["--max-outer", str(SHARDED_CLI_OUTER)]
    two = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.solve",
         *base[1:], "--backend", "sharded", "--data-parallel", "2",
         "--max-outer", "3", "--out", str(work / "two.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    two.smoke_timeout = 300
    kids = {
        "full": _child(sh + outer + ["--out", str(work / "full.json")]),
        "crash": _child(sh + outer + ["--ckpt-dir", str(ck_s)] + every,
                        env={"REPRO_FAULT_PLAN": json.dumps(
                            {"crash_at_iter": SHARDED_CRASH_AT,
                             "crash_kind": "sigkill"})}),
        "local": _child(base + ["--max-outer", "4", "--ckpt-dir", str(ck_l)]
                        + every)}
    outs = {"two": _finish("two ranks", two)}
    for name, kid in kids.items():
        outs[name] = _finish(name, kid, rc=-9 if name == "crash" else 0)
    assert outs["two"].count("[solve] F=") == 1, outs["two"][-2000:]
    assert "world=2" in outs["two"] and "backend=gloo" in outs["two"]
    # checkpoints crossing: the carry one backend wrote, restored on the
    # other, has the F its writer recorded
    tb_sup, prob_sup, c = support
    crossed = {}
    for name, ck_dir, backend in (("local -> sharded", ck_l, tb_sup),
                                  ("sharded -> local", ck_s,
                                   LocalBackend(prob_sup, PCDNConfig(P=32)))):
        ck = SolveCheckpointer(str(ck_dir))
        st, meta = ck.restore_solve(backend)
        f = float(prob_sup.objective_from_margins(st.z, st.w))
        crossed[name] = (meta["outer_iter"], f, meta["objective"])
        assert abs(f - meta["objective"]) <= \
            SHARDED_CROSS_RTOL * abs(meta["objective"]), crossed
    shutil.copytree(ck_s, work / "ck_sharded_for_local")
    kids = {
        "resume": _child(sh + outer + ["--ckpt-dir", str(ck_s), "--resume",
                                       "--out", str(work / "res.json")]
                         + every),
        "local -> sharded": _child(sh + ["--max-outer", "6", "--ckpt-dir",
                                         str(ck_l), "--resume"] + every),
        "sharded -> local": _child(base + ["--max-outer", "6", "--ckpt-dir",
                                           str(work / "ck_sharded_for_local"),
                                           "--resume"] + every)}
    for name, kid in kids.items():
        outs[name] = _finish(name, kid)
    full = json.loads((work / "full.json").read_text())
    res = json.loads((work / "res.json").read_text())
    w_equal = (res["w_indices"] == full["w_indices"]
               and res["w_values"] == full["w_values"])
    resumed = SHARDED_CRASH_AT - SHARDED_CRASH_AT % 2
    for name in ("resume", "local -> sharded", "sharded -> local"):
        assert "resuming solve at outer iteration" in outs[name], name
    assert f"resuming solve at outer iteration {resumed}" in outs["resume"]
    f_line = [ln for ln in outs["two"].splitlines()
              if ln.startswith("[solve] F=")][0]
    log(f"[sharded] (c) CLIs on {rs_path.name}: torchrun two ranks "
        f"{f_line}; world-1 support solve "
        f"SIGKILLed at {SHARDED_CRASH_AT}, resumed at {resumed}: F "
        f"{res['objective']:.9g} against uninterrupted "
        f"{full['objective']:.9g}, w bit-equal {w_equal}; checkpoints "
        f"crossing (iteration, F restored, F written): {crossed}; "
        f"{time.perf_counter() - t0:.1f}s")
    assert w_equal, "the resumed sharded solve's w is not bit-equal"
    assert res["objective"] == full["objective"]
    import torch.distributed as dist
    dist.destroy_process_group()
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f}s")
    return counted


def sharded_ranks(npz_path: str, out_path: str) -> None:
    """One rank of the sharded phase's (b), under torchrun with two ranks
    on the one card (gloo): (2 x 1) at P 512 from the world-1 run's
    carries and partitions; (1 x 2) the kernel route against the plain
    route from shared carries and partitions. Rank 0 writes the JSON."""
    import torch
    from repro_torch.core import bundles as B
    from repro_torch.data import CSRMatrix
    from repro_torch.engine.sharded import ShardedBackend, ShardedPCDNConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    rec = np.load(npz_path)
    X = CSRMatrix(data=rec["data"], indices=rec["indices"],
                  indptr=rec["indptr"], shape=tuple(int(a)
                                                    for a in rec["shape"]))
    y, c, P = rec["y"], float(rec["c"]), int(rec["P"])
    steps = int(rec["steps"])
    out = {}
    mesh = make_host_mesh(2, 1, device=DEVICE)
    out["mesh"] = mesh.describe()
    b = ShardedBackend(X, y, mesh, ShardedPCDNConfig(
        P_local=P, c=c, use_kernels=True, ls_scope="full"),
        layout="padded_csc")
    rels, walls = [], []
    mesh.reset_counts()
    for k in range(steps):
        st = b.restore_state(rec[f"w{k}"], rec[f"z{k}"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = b.outer(st.w, st.z, st.gen, st.active, True, c,
                    idxs=[rec[f"idxs{k}"]])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        f_ref = float(rec[f"f{k}"])
        rels.append(abs(float(o[3]) - f_ref) / abs(f_ref))
    n_b = steps * (-(-b.n_local // P))
    out["2x1"] = dict(rels=rels, walls=walls,
                      issued_per_bundle=mesh.counts["issued"] / n_b)
    mesh2 = make_host_mesh(1, 2, device=DEVICE)
    kw = dict(P_local=P // 2, c=c, ls_scope="full")
    kb = ShardedBackend(X, y, mesh2, ShardedPCDNConfig(**kw,
                                                       use_kernels=True),
                        layout="padded_csc")
    pb = ShardedBackend(X, y, mesh2, ShardedPCDNConfig(**kw),
                        layout="padded_csc")
    gen = torch.Generator().manual_seed(DATA_SEED + 13)
    st = kb.init_state()
    w, z, act = st.w, st.z, st.active
    rels, walls, plain_walls = [], [], []
    ops.reset_launch_counts()
    mesh2.reset_counts()
    for k in range(steps):
        idxs = [B.partition(gen, kb.n_local, P // 2) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = kb.outer(w, z, st.gen, act, True, c, idxs=idxs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        op = pb.outer(w, z, st.gen, act, True, c, idxs=idxs)
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
        rels.append(abs(float(ok[3]) - float(op[3])) / abs(float(op[3])))
        w, z, act = ok[0], ok[1], ok[7]
    n_b = 2 * steps * (-(-kb.n_local // (P // 2)))
    out["1x2"] = dict(rels=rels, walls=walls, plain_walls=plain_walls,
                      launches={k: ops.launch_counts()[k]
                                for k in SHARDED_ENTRIES},
                      issued_per_bundle=mesh2.counts["issued"] / n_b)
    if mesh.rank == 0:
        Path(out_path).write_text(json.dumps(out))


def phase_cli(torch) -> None:
    """`launch.solve.main` on a9a through the normal entry point: the PCDN
    run with the kernels, then the baselines and bf16 storage."""
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as solve_cli
    for flags, kernel in (
            (["--layout", "padded_csc", "--use-kernels", "--max-outer",
              "20"], "pcdn_sparse_direction"),
            (["--solver", "scdn", "--max-outer", "20"], "scdn_dense_batch"),
            (["--solver", "scdn", "--layout", "padded_csc", "--max-outer",
              "20"], "scdn_batch"),
            (["--solver", "tron", "--max-outer", "20"], None),
            (["--dtype", "bf16", "--use-kernels", "--layout", "padded_csc",
              "--max-outer", "20"], "pcdn_sparse_direction")):
        ops.reset_launch_counts()
        f = solve_cli.main(["--dataset", "a9a", *flags, "--device", DEVICE])
        counts = ops.launch_counts()
        log(f"[cli] {' '.join(flags)}: F={f:.6f} launches={counts}")
        assert np.isfinite(f), f
        if kernel is None:
            assert sum(counts.values()) == 0, counts
        else:
            assert counts[kernel] > 0, counts


def cache_bytecode() -> None:
    """Cache compiled bytecode under build/pycache, for this process and
    every process it starts: where PYTHONDONTWRITEBYTECODE is set and
    site-packages holds no bytecode, Python compiles each module it
    imports from source in every process, torch's thousands included."""
    prefix = str(ROOT / "build" / "pycache")
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES[1:]),
                    help=f"comma-separated subset of {PHASES[1:]}")
    ap.add_argument("--lm-profile", action="store_true",
                    help="trace one LM prefill and decode step and print "
                         "their JSON line (the lm phase runs this in a "
                         "child process)")
    ap.add_argument("--train-profile", action="store_true",
                    help="trace one LM train step and print its JSON line "
                         "(the train phase runs this in a child process)")
    ap.add_argument("--family-profile", choices=tuple(FAMILY_SHAPES),
                    help="trace one LM prefill (and but for ssm one decode "
                         "step) of a family phase's model and print their "
                         "JSON line (those phases run this in a child "
                         "process)")
    ap.add_argument("--family-train", nargs=argparse.REMAINDER,
                    metavar="ARCH:LAYERS TRAIN_ARGS [--and ...]",
                    help="`launch.train.main(TRAIN_ARGS)` with ARCH's "
                         "published config cut to LAYERS layers (0: its "
                         "published depth), a group a run, the groups "
                         "joined by --and run one after the other (the "
                         "ftrain phase runs this in a child process)")
    ap.add_argument("--lm-profiles", action="store_true",
                    help="the lm phase and the moe, ssm, hybrid, vlm and "
                         "encdec phases also trace a prefill and a decode "
                         "step, the train phase a train step, in a child "
                         "process each (off by default: ~175 s)")
    ap.add_argument("--moe-fan-in-d", action="store_true",
                    help="the moe phase's bf16 end-to-end agreement with "
                         "the expert weights at fan-in d, and print its "
                         "JSON line; no phase runs it")
    ap.add_argument("--solve-profile", choices=tuple(SOLVES),
                    help="trace one outer iteration of a solve phase and "
                         "print its JSON line (the solve phases run this in "
                         "a child process)")
    ap.add_argument("--record-aux", action="store_true",
                    help="with --solve-profile: trace the iteration with "
                         "the per-bundle (q, alpha) plane on (the path "
                         "phase runs this in a child process)")
    ap.add_argument("--solve-wall", choices=tuple(SOLVES),
                    help="time a solve phase's steady iteration with "
                         "telemetry off and print its JSON line; no phase "
                         "runs it, it exists for parent / change A/Bs "
                         "(copied beside an older tree's src)")
    ap.add_argument("--baseline-profile", choices=("scdn", "scdn-dense",
                                                   "tron"),
                    help="trace a slice of an SCDN round (real-sim, or "
                         "gisette dense) or one TRON "
                         "iteration and print its JSON line (the scdn and "
                         "tron phases run this in a child process)")
    ap.add_argument("--dtrain-ranks", nargs=2, metavar=("DIR", "OUT"),
                    help="one rank of the dtrain phase's two-rank runs and "
                         "lockstep (the phase starts two under torchrun)")
    ap.add_argument("--sharded-ranks", nargs=2, metavar=("NPZ", "OUT"),
                    help="one rank of the sharded phase's two-rank run "
                         "(the phase starts two under torchrun)")
    ap.add_argument("--chunk-profile", nargs=2,
                    metavar=("FAMILY", "REQUESTS"),
                    help="trace one dense serve chunk and print its JSON "
                         "line (the serve phase runs this in a child "
                         "process)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    global LM_PROFILES
    LM_PROFILES = args.lm_profiles
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if (SRC / "repro_torch").is_dir():
        cache_bytecode()
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
    if args.sharded_ranks:
        sharded_ranks(*args.sharded_ranks)
        return 0
    if args.dtrain_ranks:
        dtrain_ranks(*args.dtrain_ranks)
        return 0
    if args.lm_profile:
        print(json.dumps(lm_profile()), flush=True)
        return 0
    if args.train_profile:
        print(json.dumps(train_profile()), flush=True)
        return 0
    if args.family_profile:
        print(json.dumps(family_profile(args.family_profile)), flush=True)
        return 0
    if args.moe_fan_in_d:
        print(json.dumps(moe_fan_in_d()), flush=True)
        return 0
    if args.family_train:
        family_train(args.family_train)
        return 0
    if args.solve_profile:
        print(json.dumps(solve_profile(args.solve_profile,
                                       record_aux=args.record_aux)),
              flush=True)
        return 0
    if args.solve_wall:
        print(json.dumps(solve_wall(args.solve_wall)), flush=True)
        return 0
    if args.baseline_profile:
        print(json.dumps(baseline_profile(args.baseline_profile)),
              flush=True)
        return 0

    # the tuner reads a cache of the run's own: no cache on the machine
    # steers a phase; only the tune phase writes (its own file)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as tmp:
        CACHES.update(cold=os.path.join(tmp, "cold.json"),
                      tuned=os.path.join(tmp, "tuned.json"),
                      alt=os.path.join(tmp, "alt.json"))
        os.environ["REPRO_AUTOTUNE"] = "on"
        os.environ["REPRO_AUTOTUNE_CACHE"] = CACHES["cold"]
        return run_phases(torch, phases)


def run_phases(torch, phases) -> int:
    # full-precision float32 products on the plain paths (the default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {card} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    laps = [time.perf_counter()]

    def lap(name: str) -> None:
        laps.append(time.perf_counter())
        log(f"[time] {name}: {laps[-1] - laps[-2]:.1f} s")

    phase_build()  # every later phase needs the kernels
    lap("build")
    data = None
    if set(phases) & {"kernels", "tune", "support", "full", "dense", "scdn",
                      "tron", "bf16", "path", "fault", "sharded"}:
        data = make_data(DATA_SEED)
    serve = None
    rows = None
    if set(phases) & {"kernels", "tune", "serve", "path", "fault"}:
        rows = serve_data()
    if set(phases) & {"kernels", "serve"}:
        serve = prepare_serve(torch, rows)
    lap("data")
    kernels = {}
    if "kernels" in phases:
        kernels = phase_kernels(torch, data, serve, f"{card} ({smi})")
        lap("kernels")
    if "tune" in phases:
        phase_tune(torch, data, rows, f"{card} ({smi})")
        lap("tune")
    launches = {}
    by_phase = {}      # kernel -> {phase: launches}, where several add up
    for name in SOLVES:
        if name in phases:
            kernel = SOLVES[name][5]
            launches[kernel] = run_solve(torch, name, data, N_OUTER,
                                         fused=name == "support")[kernel]
            lap(name)
    if "scdn" in phases:
        launches.update(phase_scdn(torch, data, f"{card} ({smi})"))
        lap("scdn")
    if "tron" in phases:
        phase_tron(torch, data, f"{card} ({smi})")
        lap("tron")
    if "bf16" in phases:
        phase_bf16(torch, data, N_OUTER)
        lap("bf16")
    if "cli" in phases:
        phase_cli(torch)
        lap("cli")
    if "serve" in phases:
        launches.update(phase_serve(torch, serve, f"{card} ({smi})"))
        lap("serve")
    if "path" in phases:
        for kernel, n in phase_path(torch, rows, data,
                                    f"{card} ({smi})").items():
            if n:
                by_phase[kernel] = {"path": n}
                if kernel in launches:
                    by_phase[kernel]["earlier phases"] = launches[kernel]
                launches[kernel] = launches.get(kernel, 0) + n
        lap("path")
    fault_launches = {}
    if "fault" in phases:
        fault_launches = phase_fault(torch, rows, data, f"{card} ({smi})")
        lap("fault")
    if "sharded" in phases:
        launches.update(phase_sharded(torch, data, f"{card} ({smi})"))
        lap("sharded")
    if "lm" in phases:
        launches.update(phase_lm(torch, f"{card} ({smi})"))
        by_phase.setdefault("flash_attention", {})["lm"] = \
            launches["flash_attention"]
        lap("lm")
    if "train" in phases:
        for kernel, n in phase_train(torch, f"{card} ({smi})").items():
            if kernel.endswith(" variants"):
                prev = launches.get(kernel, {})
                launches[kernel] = {v: prev.get(v, 0) + n.get(v, 0)
                                    for v in {*prev, *n}}
                continue
            by_phase.setdefault(kernel, {})["train"] = n
            launches[kernel] = launches.get(kernel, 0) + n
        lap("train")
    extra = {}         # kernel -> side fields of its row

    def add_flash(r: dict, phase: str) -> None:
        """A family phase's K6 launches into the run's counts."""
        n = r["flash_attention"]
        by_phase.setdefault("flash_attention", {})[phase] = n
        launches["flash_attention"] = launches.get("flash_attention", 0) + n
        prev = launches.get("flash_attention variants", {})
        launches["flash_attention variants"] = {
            v: prev.get(v, 0) + r["flash_attention variants"].get(v, 0)
            for v in {*prev, *r["flash_attention variants"]}}
        key = f"flash_attention {phase}_prefill"
        if key in r:
            extra.setdefault("flash_attention", {})[f"{phase}_prefill"] = \
                r[key]

    if "moe" in phases:
        add_flash(phase_moe(torch, f"{card} ({smi})"), "moe")
        lap("moe")
    if "ssm" in phases:
        phase_ssm(torch, f"{card} ({smi})")
        lap("ssm")
    if "hybrid" in phases:
        add_flash(phase_hybrid(torch, f"{card} ({smi})"), "hybrid")
        lap("hybrid")
    if "vlm" in phases:
        add_flash(phase_vlm(torch, f"{card} ({smi})"), "vlm")
        lap("vlm")
    if "encdec" in phases:
        phase_encdec(torch, f"{card} ({smi})")
        by_phase.setdefault("flash_attention", {})["encdec"] = 0
        lap("encdec")
    if "ftrain" in phases:
        for kernel, n in phase_ftrain(torch, f"{card} ({smi})").items():
            if kernel.endswith(" variants"):
                prev = launches.get(kernel, {})
                launches[kernel] = {v: prev.get(v, 0) + n.get(v, 0)
                                    for v in {*prev, *n}}
                continue
            by_phase.setdefault(kernel, {})["ftrain"] = n
            launches[kernel] = launches.get(kernel, 0) + n
        lap("ftrain")
    if "dtrain" in phases:
        for kernel, n in phase_dtrain(torch, f"{card} ({smi})").items():
            if kernel.endswith(" variants"):
                prev = launches.get(kernel, {})
                launches[kernel] = {v: prev.get(v, 0) + n.get(v, 0)
                                    for v in {*prev, *n}}
                continue
            by_phase.setdefault(kernel, {})["dtrain"] = n
            launches[kernel] = launches.get(kernel, 0) + n
        lap("dtrain")

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
            if name in by_phase:
                row["launches_by_phase"] = by_phase[name]
            if name in fault_launches:
                # a side field: the fault phase's launches are not part
                # of the main path's count above
                row["fault_phase_launches"] = fault_launches[name]
            if "variant_ms" in r:
                row["variant_ms"] = r["variant_ms"]
            if "window" in r:  # the band at the hybrid's shape
                w = r["window"]
                row["window_train" if name == "flash_attention_bwd"
                    else "window_prefill"] = {
                    "shape": w["shape"], "ms": w["ms"],
                    "warm_ms": w["warm_ms"], "plain_ms": w["plain_ms"],
                    "bound_ms": w["bound"][0], "bound_by": w["bound"][1],
                    "library_ms": w["library_ms"],
                    "causal_ms": w.get("causal_ms"),
                    "variant_ms": w.get("variant_ms"),
                    "max_abs_err": w["max_abs_err"]}
            if "g5" in r:  # the split hybrid's rank shape, G 5
                g = r["g5"]
                row["g5_train" if name == "flash_attention_bwd"
                    else "g5_prefill"] = {
                    "shape": g["shape"], "ms": g["ms"],
                    "warm_ms": g["warm_ms"], "plain_ms": g["plain_ms"],
                    "bound_ms": g["bound"][0], "bound_by": g["bound"][1],
                    "library_ms": g["library_ms"],
                    "max_abs_err": g["max_abs_err"]}
            # K6b at a train run's shape, and at gemma-7b's
            for label in (FTRAIN_LABEL[MOE_ARCH], FTRAIN_LABEL[VLM_ARCH],
                          "gemma"):
                t = r.get(label)
                if t is not None:
                    row[f"{label}_train"] = {
                        "shape": t["shape"], "ms": t["ms"],
                        "warm_ms": t["warm_ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                        "library_ms": t["library_ms"],
                        "variant_ms": t.get("variant_ms"),
                        "max_abs_err": t["max_abs_err"]}
            row.update(extra.get(name, {}))
            if name == "pcdn_linesearch" and "scdn" in phases:
                row["note"] = ("off the main path: dense SCDN runs "
                               "scdn_dense_batch")
            if "real_sim" in r:  # K5's rows entry: the row is at gisette's
                row["real_sim_ms"] = r["real_sim"]["ms"]
                row["real_sim_bound_ms"] = r["real_sim"]["bound"][0]
                row["one_row_ms"] = r["one_row"]["ms"]
                row["one_row_bound_ms"] = r["one_row"]["bound_ms"]
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
