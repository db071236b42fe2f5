#!/usr/bin/env python3
"""Kernel autotuning benchmark of the port on one NVIDIA card: each tuned
kernel's launch plan at the smoke run's main-path shapes, a measured
roofline, and the bf16 storage study.

    python3 benchmarks/port/bench_kernels.py [--smoke] [--strategy auto]
        [--repeats N] [--no-study] [--no-persist]

For every kernel x shape x dtype cell (`make_cells`) it

  1. times the DEFAULT launch plan (the rules of `kernels/ops.py`),
  2. runs `repro_torch.kernels.autotune.tune` over the kernel's search
     space (exhaustive where the space holds at most 40 candidates, else
     the hillclimb; `--strategy` forces one) and persists the winner in
     the tuner's cache (REPRO_AUTOTUNE_CACHE, default
     ~/.cache/repro_torch/autotune.json) unless --no-persist,
  3. holds the winner, where it is not the default, against the plain
     version at the limits of `chip_smoke.py`'s kernels phase,
  4. places the winner on a measured roofline (peak FLOP/s from a float32
     torch.matmul with TF32 off, bytes/s from a streaming triad) and on
     the H100's published one (`work.bound`, the bound of the smoke's
     kernels line, from the same counts).

Times are CUDA-event medians, each call after a 128 MB write that evicts
L2 (L2-cold, what the tuner decides on), the L2-warm median beside it.
Then the bf16-vs-float32 study: a9a through the kernels with tol_kkt=0
and a fixed outer budget, so iteration k of one run lines up with
iteration k of the other.

Cells (full run): K1 real-sim support (P 32, K 278, s 57,848, Q 40), K2
real-sim full (P 512), K3 gisette dense (s 6,000, P 512, n 5,000), K4a
and K4b the serve cell's (B 256 request rows of real-sim at its published
width, a bank of K 8 nested models of A 10,901 ids), K5's rows entry at
gisette's (64, 6,000), its batch entry at real-sim P_bar 8, its dense
batch entry at gisette P_bar 64; K1-K3 also with bf16 storage. Operands
come from the port's paper-profile generators, seeded. `--smoke` keeps
one small cell per kernel and writes only
benchmarks/port/results/BENCH_kernels_h100_smoke.json; a full run writes
benchmarks/port/results/BENCH_kernels_h100.json, with the card's name and
power limit, torch and CUDA versions and the tuner's backend tag in
`meta`. Needs a card; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
RESULTS = HERE / "results"
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import work  # noqa: E402

# limits of the winner's agreement with the plain version (chip_smoke.py's
# kernels phase): max |kernel - plain| over max |plain|
KERNEL_RTOL = 1e-4
K4A_RTOL = 1e-5
SCDN_WZ_RTOL = 1e-5
# a9a's bf16 study: the envelope the --dtype bf16 gate promises
BF16_ENVELOPE = 1e-3
DATA_SEED = 0
DEVICE = "cuda"  # the cells' operands (a CPU rehearsal sets "cpu")
SERVE_ROWS, SERVE_TRAIN, SERVE_FEATURES = 72_310, 57_848, 20_958
SERVE_BATCH, SERVE_MODELS, SERVE_A = 256, 8, 10_901


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(torch, got, want) -> float:
    err = float(torch.max(torch.abs(got.float() - want.float())))
    return err / max(float(torch.max(torch.abs(want.float()))), 1e-30)


# -- peak calibration ---------------------------------------------------------

def _best_ms(torch, fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def calibrate_peak_flops(torch, n: int = 8192, repeats: int = 5) -> float:
    """Measured float32 matmul rate, FLOP/s: an (n, n) x (n, n) product
    (2 n^3 flops) on the CUDA cores, TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.randn((n, n), device=DEVICE)
        ms = _best_ms(torch, lambda: torch.matmul(a, a), repeats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 2.0 * n ** 3 / (ms / 1e3)


def calibrate_peak_bandwidth(torch, mb: int = 1024,
                             repeats: int = 5) -> float:
    """Measured streaming rate, bytes/s: a triad a = b + 2 c of float32
    (12 bytes an element)."""
    n = mb * (1 << 20) // 4
    a, b, c = (torch.empty((n,), device=DEVICE) for _ in range(3))
    b.fill_(1.0)
    c.fill_(2.0)
    ms = _best_ms(torch, lambda: torch.add(b, c, alpha=2.0, out=a), repeats)
    return 12.0 * n / (ms / 1e3)


def roofline_terms(flops, bytes_, us, peaks):
    """Place one measured cell against the calibrated peaks."""
    t_compute_us = flops / peaks["flops_per_s"] * 1e6
    t_memory_us = bytes_ / peaks["bytes_per_s"] * 1e6
    bound_us = max(t_compute_us, t_memory_us)
    return {
        "flops": int(flops), "bytes": int(bytes_),
        "intensity_flops_per_byte": flops / max(bytes_, 1),
        "t_compute_us": t_compute_us, "t_memory_us": t_memory_us,
        "bound": "compute" if t_compute_us >= t_memory_us else "memory",
        "roofline_us": bound_us,
        # fraction of the roofline bound the measured kernel attains
        # (1.0 == at the roof; small == far below it)
        "attained_frac": bound_us / max(us, 1e-9),
    }


# -- cells --------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One tuning cell: the key's bucket axes at this shape, runner(cfg)
    -> a zero-arg call of the kernel with that plan (raises when the
    kernel cannot take it), work() -> (bytes, operations) of one call,
    agree(cfg) -> {"ok", "err", "limit"} against the plain version,
    plan(cfg) -> the launch plan the config gives here (`ops`' plan
    function: configs with one plan are measured once)."""
    kernel: str
    label: str
    dtype: str
    shape: dict
    runner: Callable
    work: Callable
    agree: Callable
    plan: Callable

    @property
    def torch_dtype(self):
        import torch
        return getattr(torch, self.dtype)


def _sms(ops, device) -> int:
    """The card's SMs (the plans' `sms`); 1 for a CPU rehearsal, as the
    launches plan there."""
    return 1 if DEVICE == "cpu" else ops._sm_count(device)


def _sync(torch) -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def _carry(torch, prob, gen):
    """A realistic iterate: a tenth of w nonzero, and its margins (the
    kernels phase's)."""
    n = prob.n_features
    dev = prob.y.device
    w = torch.zeros((n,), device=dev)
    on = torch.randperm(n, generator=gen)[: n // 10].to(dev)
    w[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(dev)
    return w, prob.margins(w)


def _stepper(w, z, items, fn):
    """A call that runs fn(w, z, items[t], t) on a carry of its own, t
    the next item each call (as a solve calls the kernel)."""
    wc, zc, it = w.clone(), z.clone(), [0]

    def call():
        t = it[0] % len(items)
        it[0] += 1
        fn(wc, zc, items[t], t)
    return call


def cell_bundle(torch, csc, y, dtype: str, P: int = 32, c: float = 4.0):
    """K1 at the support scope: each call the next bundle of a partition
    on a carry the calls evolve."""
    from repro_torch.core import bundles as B
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    prob = make_problem(csc, y, c=c, layout="padded_csc", device=DEVICE,
                        dtype=getattr(torch, dtype))
    d = prob.design
    n, s = prob.n_features, prob.n_samples
    gen = torch.Generator().manual_seed(1)
    w, z = _carry(torch, prob, gen)
    alphas = candidate_alphas(ArmijoParams(), torch.float32, w.device)
    bundles = B.partition(gen, n, P, device=w.device).unbind(0)

    def launch(cfg, n_bundles):
        return ops.BundleLaunch(d.col_rows, d.col_vals, prob.y, alphas, c, P,
                                n_bundles, config=cfg)

    def runner(cfg):
        L = launch(cfg, len(bundles))
        return _stepper(w, z, bundles, lambda wc, zc, idx, t:
                        ops.pcdn_bundle(L, wc, zc, idx, t))

    def work_():
        # one pass over the partition: each bundle's step count
        L = launch(None, len(bundles))
        call = _stepper(w, z, bundles, lambda wc, zc, idx, t:
                        ops.pcdn_bundle(L, wc, zc, idx, t))
        for _ in bundles:
            call()
        return work.bundle_work(torch, d.col_rows, d.col_vals.element_size(),
                                bundles, L.n_steps.tolist(), n, s)

    def agree(cfg):
        L = launch(cfg, 1)
        errs, ok = {}, True
        for t in range(3):
            idx = bundles[t]
            w_k, z_k, w_p, z_p = w.clone(), z.clone(), w.clone(), z.clone()
            ops.pcdn_bundle(L, w_k, z_k, idx, 0)
            q_p, a_p = ref.pcdn_bundle_step_ref(
                d.col_rows, d.col_vals, idx, z_p, prob.y, w_p, alphas, c)
            _sync(torch)
            e = max(rel_err(torch, w_k, w_p), rel_err(torch, z_k, z_p))
            same = (int(L.n_steps[0]) == int(q_p) and
                    float(L.alpha[0]) == float(a_p))
            errs[f"bundle {t}"] = e
            ok = ok and same and e <= KERNEL_RTOL
        return {"ok": ok, "err": errs,
                "limit": f"w, z rel {KERNEL_RTOL}; alpha, n_steps equal"}

    Q = int(alphas.shape[0])
    shape = dict(p=P, k=d.k_max, s=s, q=Q)
    return Cell("pcdn_bundle", f"real-sim support P {P}", dtype, shape,
                runner, work_, agree,
                lambda cfg: ops.bundle_plan(P, d.k_max, s, n, Q, config=cfg))


def cell_sparse_direction(torch, csc, y, dtype: str, P: int = 512,
                          c: float = 4.0):
    """K2 at the full scope: one bundle's slab."""
    from repro_torch.core import bundles as B
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    prob = make_problem(csc, y, c=c, layout="padded_csc", device=DEVICE,
                        dtype=getattr(torch, dtype))
    gen = torch.Generator().manual_seed(2)
    w, z = _carry(torch, prob, gen)
    idx = B.partition(gen, prob.n_features, P, device=w.device)[0]
    slab = prob.design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    args = (slab.rows, slab.vals, z, prob.y, w_B, c)

    def agree(cfg):
        got = ops.pcdn_sparse_direction(*args, config=cfg)
        want = ref.pcdn_sparse_direction_ref(*args)
        errs = {k: rel_err(torch, a, b)
                for k, a, b in zip(("d", "g", "h", "delta"), got, want)}
        return {"ok": max(errs.values()) <= KERNEL_RTOL, "err": errs,
                "limit": f"rel {KERNEL_RTOL}"}

    P_, K = slab.rows.shape
    return Cell("pcdn_sparse_direction", f"real-sim full P {P}", dtype,
                dict(p=P_, k=K, s=prob.n_samples),
                lambda cfg: lambda: ops.pcdn_sparse_direction(
                    *args, config=cfg),
                lambda: work.sparse_direction_work(torch, slab.rows,
                                                   prob.n_samples),
                agree, lambda cfg: ops.sparse_direction_warps(K, config=cfg))


def cell_direction(torch, Xg, yg, dtype: str, P: int = 512,
                   c: float = 0.25):
    """K3 on the dense layout: one full bundle of the feature-major copy."""
    from repro_torch.core import bundles as B
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    prob = make_problem(Xg, yg, c=c, layout="dense", device=DEVICE,
                        dtype=getattr(torch, dtype))
    gen = torch.Generator().manual_seed(3)
    w, z = _carry(torch, prob, gen)
    XT = prob.design.feature_major()
    n, s = prob.n_features, prob.n_samples
    idx = B.partition(gen, n, P, device=w.device)[0]
    w_B, _ = B.gather_vec(w, idx)
    args = (XT, idx, z, prob.y, w_B, c)

    def agree(cfg):
        got = ops.pcdn_direction(*args, config=cfg)
        want = ref.pcdn_direction_ref(*args)
        errs = {k: rel_err(torch, a, b)
                for k, a, b in zip(("d", "g", "h", "delta"), got, want)}
        return {"ok": max(errs.values()) <= KERNEL_RTOL, "err": errs,
                "limit": f"rel {KERNEL_RTOL}"}

    return Cell("pcdn_direction", f"gisette dense P {P}", dtype,
                dict(s=s, p=int(idx.shape[0])),
                lambda cfg: lambda: ops.pcdn_direction(*args, config=cfg),
                lambda: work.direction_work(torch, idx, n, s,
                                            XT.element_size()),
                agree, lambda cfg: ops.direction_plan(
                    s, int(idx.shape[0]), XT.element_size(),
                    ops.direction_max_clusters(XT.device), config=cfg))


def serve_bank(torch, n: int, K: int, A: int, seed: int = DATA_SEED):
    """(idx, val) (K, A) of K nested models as a path family's: model k
    the first A - k A / (2 K) ids of one random support of A ids,
    ascending, sentinel n after them; weights from the seed."""
    rng = np.random.default_rng(seed)
    support = np.sort(rng.choice(n, size=A, replace=False))
    idx = np.full((K, A), n, np.int32)
    val = np.zeros((K, A), np.float32)
    for k in range(K):
        keep = np.sort(rng.choice(A, size=A - k * A // (2 * K),
                                  replace=False))
        idx[k, :keep.size] = support[keep]
        val[k, :keep.size] = rng.standard_normal(keep.size)
    return (torch.as_tensor(idx, device=DEVICE),
            torch.as_tensor(val, device=DEVICE))


def cell_margins_dense(torch, head, K: int, A: int):
    """K4a: B dense request rows against a bank of K models."""
    from repro_torch.kernels import ops, ref

    B, n = head.shape
    X = torch.as_tensor(head.to_dense(), device=DEVICE)
    idx, val = serve_bank(torch, n, K, A)
    args = (X, idx, val)

    def agree(cfg):
        e = rel_err(torch, ops.serve_margins_dense(*args, config=cfg),
                    ref.serve_margins_dense_ref(*args))
        return {"ok": e <= K4A_RTOL, "err": {"margins": e},
                "limit": f"rel {K4A_RTOL}"}

    return Cell("serve_margins_dense", f"serve B {B}", "float32",
                dict(b=B, n=n, k=K, a=A),
                lambda cfg: lambda: ops.serve_margins_dense(*args,
                                                            config=cfg),
                lambda: work.dense_margins_work(torch, idx, n, B), agree,
                lambda cfg: ops.dense_tile_width(B, n, K, _sms(ops, X.device),
                                                 config=cfg))


def cell_margins_csc(torch, head, K: int, A: int):
    """K4b: the same rows packed in padded-CSC at their own width."""
    from repro_torch.data import csr_to_padded_csc
    from repro_torch.kernels import ops, ref

    B, n = head.shape
    pc = csr_to_padded_csc(head)
    rows = torch.as_tensor(pc.col_rows, device=DEVICE)
    vals = torch.as_tensor(pc.col_vals, device=DEVICE)
    idx, val = serve_bank(torch, n, K, A)
    args = (rows, vals, idx, val, B)

    def agree(cfg):
        e = rel_err(torch, ops.serve_margins_csc(*args, config=cfg),
                    ref.serve_margins_csc_ref(*args))
        return {"ok": e <= KERNEL_RTOL, "err": {"margins": e},
                "limit": f"rel {KERNEL_RTOL}"}

    return Cell("serve_margins_csc", f"serve B {B}", "float32",
                dict(n=n, kmax=pc.k_max, k=K, a=A, b=B),
                lambda cfg: lambda: ops.serve_margins_csc(*args, config=cfg),
                lambda: work.csc_margins_work(torch, rows, idx, n, B), agree,
                lambda cfg: ops.csc_plan(B, K, A, pc.k_max, config=cfg))


def cell_linesearch(torch, Xg, yg, P: int = 64, c: float = 0.25):
    """K5's rows entry: P coordinates' (P, s) margin deltas of a dense
    problem from a carry, Q 40."""
    from repro_torch.core import bundles as B
    from repro_torch.core.direction import newton_direction
    from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
    from repro_torch.core.problem import make_problem
    from repro_torch.kernels import ops, ref

    prob = make_problem(Xg, yg, c=c, layout="dense", device=DEVICE)
    gen = torch.Generator().manual_seed(4)
    w, z = _carry(torch, prob, gen)
    idx = torch.randint(0, prob.n_features, (P,), generator=gen,
                        dtype=torch.int32).to(w.device)
    slab = prob.design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    g, h = prob.bundle_grad_hess(z, slab, w_B)
    deltas = prob.design.slab_coordinate_deltas(slab,
                                                newton_direction(g, h, w_B))
    alphas = candidate_alphas(ArmijoParams(), torch.float32, w.device)
    args = (z, deltas, prob.y, alphas)
    Q = int(alphas.shape[0])

    def agree(cfg):
        e = rel_err(torch, ops.pcdn_linesearch(*args, config=cfg),
                    ref.pcdn_linesearch_ref(*args))
        return {"ok": e <= KERNEL_RTOL, "err": {"loss deltas": e},
                "limit": f"rel {KERNEL_RTOL}"}

    P_, s = deltas.shape
    return Cell("pcdn_linesearch", f"gisette rows ({P_}, {s})", "float32",
                dict(s=s, p=P_, q=Q),
                lambda cfg: lambda: ops.pcdn_linesearch(*args, config=cfg),
                lambda: work.linesearch_work(torch, deltas, Q), agree,
                lambda cfg: ops.linesearch_blocks(s, P_, _sms(ops, z.device),
                                                  config=cfg))


def _scdn_cell(torch, prob, P: int, kernel: str, label: str, gen_seed: int,
               bound_batches: int = 100):
    """K5's batch entries: each call the next batch of a round on a carry
    the calls evolve, from a carry solved by one SCDN round from 0."""
    from repro_torch.core import scdn
    from repro_torch.kernels import ops, ref

    n, s = prob.n_features, prob.n_samples
    dev = prob.y.device
    gen = torch.Generator().manual_seed(gen_seed)
    round_ = scdn.make_round(prob, scdn.SCDNConfig(P_bar=P))
    base = round_.launch()
    w, z, _, _, _ = round_(torch.zeros((n,), device=dev),
                           torch.zeros((s,), device=dev), gen)
    batches = torch.randint(0, n, (round_.n_batches, P), generator=gen,
                            dtype=torch.int32).to(dev).unbind(0)
    sparse = kernel == "scdn_batch"
    entry = ops.scdn_batch if sparse else ops.scdn_dense_batch
    plain = ref.scdn_batch_ref if sparse else ref.scdn_dense_batch_ref
    kw = dict(kind=base.kind, l2=base.l2, sigma=base.sigma, gamma=base.gamma)

    def launch(cfg):
        if sparse:
            return ops.ScdnBatchLaunch(base.col_rows, base.col_vals, base.y,
                                       base.alphas, base.c, P, config=cfg,
                                       **kw)
        return ops.ScdnDenseBatchLaunch(base.XT, base.y, base.alphas,
                                        base.c, P, config=cfg, **kw)

    def runner(cfg):
        L = launch(cfg)
        alpha = torch.empty((P,), device=dev)
        return _stepper(w, z, batches, lambda wc, zc, idx, t:
                        entry(L, wc, zc, idx, alpha))

    def agree(cfg):
        L = launch(cfg)
        errs, ok = {}, True
        for t in range(3):
            idx = batches[t]
            w_k, z_k, w_p, z_p = w.clone(), z.clone(), w.clone(), z.clone()
            a_k = entry(L, w_k, z_k, idx)
            a_p, _ = plain(*L.design_args, idx, w_p, z_p, L.y, L.alphas,
                           L.c, **{k: v for k, v in kw.items()})
            _sync(torch)
            e = max(rel_err(torch, w_k, w_p), rel_err(torch, z_k, z_p))
            errs[f"batch {t}"] = e
            ok = ok and bool(torch.equal(a_k, a_p)) and e <= SCDN_WZ_RTOL
        return {"ok": ok, "err": errs,
                "limit": f"w, z rel {SCDN_WZ_RTOL}; alpha equal"}

    count = work.scdn_batch_work if sparse else work.scdn_dense_work
    Q = base.plan.Q
    if sparse:
        shape = dict(p=P, k=base.plan.K, q=Q, s=s)

        def plan(cfg):
            return ops.scdn_batch_plan(P, base.plan.K, Q, s, config=cfg)
    else:
        shape = dict(p=P, s=s, q=Q)

        def plan(cfg):
            return ops.scdn_dense_plan(P, s, Q, _sms(ops, dev), config=cfg)
    return Cell(kernel, label, "float32", shape, runner,
                lambda: count(torch, base, w, z, batches[:bound_batches]),
                agree, plan)


def cell_scdn_batch(torch, csc, y, P: int = 8, c: float = 4.0):
    from repro_torch.core.problem import make_problem
    prob = make_problem(csc, y, c=c, layout="padded_csc", device=DEVICE)
    return _scdn_cell(torch, prob, P, "scdn_batch",
                      f"real-sim SCDN P_bar {P}", 5)


def cell_scdn_dense(torch, Xg, yg, P: int = 64, c: float = 0.25):
    from repro_torch.core.problem import make_problem
    prob = make_problem(Xg, yg, c=c, layout="dense", device=DEVICE)
    return _scdn_cell(torch, prob, P, "scdn_dense_batch",
                      f"gisette SCDN P_bar {P}", 6)


def make_cells(torch, data: dict, smoke: bool = False,
               dtypes=("float32", "bfloat16")) -> list:
    """The cells over prebuilt data: data["realsim"] (csc, y),
    data["gisette"] (X, y), data["requests"] (a CSR of request rows)."""
    csc, y = data["realsim"]
    Xg, yg = data["gisette"]
    head = data["requests"].rows(0, min(SERVE_BATCH,
                                        data["requests"].shape[0]))
    K, A = (4, 64) if smoke else (SERVE_MODELS, SERVE_A)
    P1, P2, P3, P5, P5d = (8, 64, 64, 16, 16) if smoke else \
        (32, 512, 512, 64, 64)
    cells = []
    for dt in dtypes:
        cells.append(cell_bundle(torch, csc, y, dt, P=P1))
        cells.append(cell_sparse_direction(torch, csc, y, dt, P=P2))
        cells.append(cell_direction(torch, Xg, yg, dt, P=P3))
        if smoke:
            break
    cells.append(cell_margins_dense(torch, head, K, A))
    cells.append(cell_margins_csc(torch, head, K, A))
    cells.append(cell_linesearch(torch, Xg, yg, P=P5))
    cells.append(cell_scdn_batch(torch, csc, y, P=8))
    cells.append(cell_scdn_dense(torch, Xg, yg, P=P5d))
    return cells


def build_data(smoke: bool) -> dict:
    """The cells' data from the port's generators, seeded: real-sim at its
    published shape, gisette at its published shape, real-sim's request
    rows at its published width (rows 57,848+ of 72,310); smaller
    profiles with --smoke."""
    from repro_torch.data import make_sparse_classification, paper_like
    if smoke:
        csc, y, _ = make_sparse_classification(6000, 600, nnz_per_col=30,
                                               seed=DATA_SEED)
        Xg, yg, _ = paper_like("gisette", seed=DATA_SEED)
        rq, _, _ = make_sparse_classification(2000, 600, nnz_per_col=30,
                                              seed=DATA_SEED + 1)
        return {"realsim": (csc, y), "gisette": (Xg, yg),
                "requests": rq.to_csr().rows(1000, 2000)}
    csc, y, _ = make_sparse_classification(57_848, 20_958, nnz_per_col=278,
                                           seed=DATA_SEED)
    Xg, yg, _ = paper_like("gisette", scale=1.0, seed=DATA_SEED)
    full, _, _ = make_sparse_classification(
        SERVE_ROWS, SERVE_FEATURES, nnz_per_col=278, w_nnz_frac=0.2,
        seed=DATA_SEED)
    return {"realsim": (csc, y), "gisette": (Xg, yg),
            "requests": full.to_csr().rows(SERVE_TRAIN, SERVE_ROWS)}


def run_cell(torch, cell: Cell, strategy: str = "auto", repeats: int = 7,
             persist: bool = True, peaks=None) -> dict:
    """Tune one cell; hold a non-default winner against the plain
    version; the measured roofline where `peaks` are given."""
    from repro_torch.kernels import autotune
    strat = autotune.pick_strategy(cell.kernel) if strategy == "auto" \
        else strategy
    bucket = autotune.shape_bucket(**cell.shape)
    t0 = time.perf_counter()
    def runner(cfg):
        cell.plan(cfg)        # a config the plan refuses is not launched
        return cell.runner(cfg)

    res = autotune.tune(cell.kernel, runner, bucket, cell.torch_dtype,
                        strategy=strat, repeats=repeats, persist=persist,
                        plan=cell.plan, device=DEVICE)
    seconds = time.perf_counter() - t0
    warm = {json.dumps(r["config"], sort_keys=True): r["warm_us"]
            for r in res.table}
    default = autotune.DEFAULTS[cell.kernel]
    nbytes, nops = cell.work()
    b_ms, b_by = work.bound(nbytes, nops)
    out = {
        "kernel": cell.kernel, "label": cell.label, "shape": cell.shape,
        "dtype": cell.dtype, "strategy": strat,
        "default": {"config": default, "us": res.default_us,
                    "warm_us": warm.get(json.dumps(default,
                                                   sort_keys=True))},
        "tuned": {"config": res.config, "us": res.us,
                  "warm_us": warm.get(json.dumps(res.config,
                                                 sort_keys=True))},
        "speedup": res.speedup, "margin": res.margin,
        "n_candidates": len(res.table),
        "skipped": res.skipped, "tune_seconds": seconds,
        "trajectory": list(res.trajectory), "bytes": nbytes, "operations": nops,
        "bound_us": b_ms * 1e3, "bound_by": b_by,
    }
    out["default"]["plan"] = repr(cell.plan(default))
    out["tuned"]["plan"] = repr(cell.plan(res.config))
    out["table"] = [dict(r, plan=repr(cell.plan(r["config"])))
                    for r in res.table]
    # the fastest plan other than the rule's (a launch of another order)
    others = [r for r in out["table"] if r["plan"] != out["default"]["plan"]]
    out["runner_up"] = min(others, key=lambda r: r["us"]) if others else None
    if out["tuned"]["plan"] != out["default"]["plan"]:
        out["agreement"] = cell.agree(res.config)
    if peaks is not None:
        out["roofline"] = roofline_terms(nops, nbytes, res.us, peaks)
    return out


def _us(x) -> str:
    return "n/a" if x is None else f"{x:.2f}"


def cell_line(c: dict) -> str:
    agree = c.get("agreement")
    return (f"{c['kernel']} {c['label']} {c['dtype']} ({c['strategy']}): "
            f"default {c['default']['us']:.2f} us L2-cold "
            f"({_us(c['default']['warm_us'])} warm), winner "
            f"{c['tuned']['config']} {c['tuned']['us']:.2f} us "
            f"({_us(c['tuned']['warm_us'])} warm), x{c['speedup']:.3f} "
            f"(margin {c['margin']:.3f}); "
            f"{c['n_candidates']} measured, {c['skipped']} infeasible, "
            f"{c['tune_seconds']:.1f}s; bound {c['bound_us']:.3f} us "
            f"({c['bound_by']})"
            + ("" if agree is None else
               f"; agreement {'ok' if agree['ok'] else 'FAILED'} "
               f"(max rel {max(agree['err'].values()):.2e}, "
               f"{agree['limit']})"))


# -- bf16 storage study -------------------------------------------------------

def bf16_study(torch, max_outer: int, losses=("logistic", "squared_hinge"),
               scale=None) -> dict:
    """Matched-iteration trajectories on the card, through the kernels
    (padded-CSC, P 128): the same data and config with float32 and bf16
    storage, tol_kkt=0 and a fixed outer budget, so iteration k lines up.
    Reports the largest relative objective difference."""
    from repro_torch.core import PCDNConfig
    from repro_torch.core.problem import make_problem
    from repro_torch.data import paper_like
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    study = {"dataset": "a9a", "max_outer": max_outer, "P": 128,
             "layout": "padded_csc", "use_kernels": True, "losses": {},
             "max_objective_rel_diff": 0.0}
    X, y, _ = paper_like("a9a", seed=0, scale=scale)
    for loss in losses:
        runs = {}
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            prob = make_problem(X, y, c=1.0, loss=loss, layout="padded_csc",
                                dtype=dt, device=DEVICE)
            backend = LocalBackend(prob, PCDNConfig(
                P=128, use_kernels=True, tol_kkt=0.0, max_outer=max_outer,
                seed=0))
            res = engine_loop.solve(backend, 1.0, max_outer=max_outer,
                                    tol_kkt=0.0)
            runs[name] = np.asarray(res.history.objective, np.float64)
        n = min(len(runs["fp32"]), len(runs["bf16"]))
        rel = np.abs(runs["bf16"][:n] - runs["fp32"][:n]) / \
            np.maximum(np.abs(runs["fp32"][:n]), 1e-12)
        study["losses"][loss] = {
            "n_iters": int(n), "final_fp32": float(runs["fp32"][n - 1]),
            "final_bf16": float(runs["bf16"][n - 1]),
            "max_rel_diff": float(rel.max())}
        study["max_objective_rel_diff"] = max(
            study["max_objective_rel_diff"], float(rel.max()))
        print(f"[bench_kernels] bf16 study {loss}: {n} iterations, max rel "
              f"diff {rel.max():.2e}", flush=True)
    study["envelope_rel_diff"] = BF16_ENVELOPE
    study["pass"] = study["max_objective_rel_diff"] <= BF16_ENVELOPE
    return study


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one small cell per kernel; writes only "
                         "BENCH_kernels_h100_smoke.json")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "exhaustive", "hillclimb"])
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--no-study", action="store_true",
                    help="skip the bf16 trajectory study")
    ap.add_argument("--no-persist", action="store_true",
                    help="do not write winners into the tuner's cache")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA device (the port's "
                         "kernels run only on the card)")
    from repro_torch.kernels import autotune, build
    repeats = args.repeats or (3 if args.smoke else 7)
    smi = nvidia_smi_line()
    print(f"[bench_kernels] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; backend {autotune.backend_tag()}",
          flush=True)
    build.build_all()
    peaks = {"flops_per_s": calibrate_peak_flops(
                 torch, 2048 if args.smoke else 8192),
             "bytes_per_s": calibrate_peak_bandwidth(
                 torch, 64 if args.smoke else 1024)}
    print(f"[bench_kernels] peaks {peaks['flops_per_s'] / 1e12:.2f} "
          f"TFLOP/s (f32 matmul, TF32 off), "
          f"{peaks['bytes_per_s'] / 1e12:.3f} TB/s (triad)", flush=True)
    t0 = time.perf_counter()
    data = build_data(args.smoke)
    print(f"[bench_kernels] data {time.perf_counter() - t0:.1f}s",
          flush=True)
    cells = []
    for cell in make_cells(torch, data, smoke=args.smoke):
        c = run_cell(torch, cell, args.strategy, repeats,
                     persist=not args.no_persist, peaks=peaks)
        print(f"[bench_kernels] {cell_line(c)}", flush=True)
        cells.append(c)
    payload = {
        "meta": {"card": smi, "torch": torch.__version__,
                 "cuda": torch.version.cuda,
                 "backend": autotune.backend_tag(),
                 "strategy": args.strategy, "repeats": repeats,
                 "smoke": bool(args.smoke),
                 "timing": "CUDA-event medians; L2-cold: 128 MB written "
                           "before each call",
                 "when": time.strftime("%Y-%m-%dT%H:%M:%S")},
        "peaks": {"flops_tflops": peaks["flops_per_s"] / 1e12,
                  "bandwidth_tbps": peaks["bytes_per_s"] / 1e12},
        "cells": cells,
    }
    if not args.no_study:
        payload["bf16_study"] = bf16_study(
            torch, max_outer=5 if args.smoke else 30,
            scale=0.25 if args.smoke else None)
    payload["headline"] = {
        "best_speedup": max(c["speedup"] for c in cells),
        "all_tuned_at_least_default": all(
            c["tuned"]["us"] <= c["default"]["us"] for c in cells),
        "all_winners_agree": all(c.get("agreement", {"ok": True})["ok"]
                                 for c in cells),
    }
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = RESULTS / ("BENCH_kernels_h100_smoke.json" if args.smoke
                     else "BENCH_kernels_h100.json")
    out.write_text(json.dumps(payload, indent=1, default=float) + "\n")
    print(f"[bench_kernels] wrote {out.relative_to(ROOT)}", flush=True)
    if not payload["headline"]["all_winners_agree"]:
        raise SystemExit("bench_kernels: a tuned plan disagrees with the "
                         "plain version")
    return payload


if __name__ == "__main__":
    main()
