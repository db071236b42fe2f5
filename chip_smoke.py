#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # build + kernel check only

Phases:
  0. device   -- the card's name, count, power limit (nvidia-smi).
  1. build    -- nvcc builds the three kernels from kernels/csrc (sm_90a);
                 always runs.
  2. kernels  -- K1 pcdn_bundle, K2 pcdn_sparse_direction and K3
                 pcdn_direction against their plain PyTorch versions on the
                 card, at the shapes the solves below give them; errors,
                 kernel and plain times (CUDA events), and the bound.
  3. support  -- real-sim at its published shape (57,848 x 20,958, ~139 nnz
                 a column, k_max 278) in padded-CSC, P = 32: the support
                 scope, so every bundle runs K1.
  4. full     -- the same data at P = 512: the full scope, K2.
  5. dense    -- gisette at its published shape (6,000 x 5,000, dense and
                 correlated), P = 512: K3.
  6. cli      -- `repro_torch.launch.solve.main` on a9a, padded-CSC,
                 --use-kernels, through the normal entry point.

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
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"
PHASES = ("build", "kernels", "support", "full", "dense", "cli")  # in order

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# solve-phase tolerance: kernel vs plain objective after one outer
# iteration from a shared carry (f32 sums in another order, atomics in K1)
F_RTOL = 1e-4
# kernel-phase tolerance on d/g/h and upd_*: max |kernel - plain| over
# max |plain| (f32 reductions in another order; K1's atomic scatter)
KERNEL_RTOL = 1e-4
# outer iterations of each solve phase (and of its lockstep check), and
# the seed of every dataset
N_OUTER = 10
DATA_SEED = 0
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
}


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


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float(torch.max(torch.abs(got.float() - want.float())))
    scale = float(torch.max(torch.abs(want.float())))
    return err, err / max(scale, 1e-30)


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


def phase_kernels(torch, data, card: str) -> dict:
    """Each kernel against its plain version at the solves' shapes."""
    from repro_torch.core import bundles as B
    from repro_torch.core.design_matrix import _take_fill
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

    # K1 at P = 32 (support scope)
    idx = B.partition(gen, n, 32, device=dev)[0]
    slab = sparse.design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    support, pos = sparse.design.slab_row_support(slab)
    z_R = _take_fill(z, support, 0.0)
    y_R = _take_fill(sparse.y, support, 1.0)
    alphas = candidate_alphas(ArmijoParams(), torch.float32, dev)
    args = (slab.vals, pos, z_R, y_R, w_B, alphas, 4.0)
    got = ops.pcdn_bundle(*args)
    want = ref.pcdn_bundle_ref(*args)
    torch.cuda.synchronize()
    P, K = slab.vals.shape
    R = z_R.shape[0]
    Q = alphas.shape[0]
    e_w = rel_err(torch, got[0], want[0])
    e_z = rel_err(torch, got[1], want[1])
    a_k, a_p = float(got[2]), float(want[2])
    q_k, q_p = int(got[3]), int(want[3])
    log(f"[kernels] pcdn_bundle P={P} K={K} R={R} Q={Q}: upd_w err "
        f"{e_w[0]:.3e} (rel {e_w[1]:.2e}), upd_z err {e_z[0]:.3e} (rel "
        f"{e_z[1]:.2e}), alpha {a_k} vs {a_p}, n_steps {q_k} vs {q_p}; "
        f"tolerance rel {KERNEL_RTOL}, alpha/n_steps equal")
    assert e_w[1] <= KERNEL_RTOL and e_z[1] <= KERNEL_RTOL, (e_w, e_z)
    assert a_k == a_p and q_k == q_p, (a_k, a_p, q_k, q_p)
    n_live = int(torch.unique(support[support < sparse.n_samples]).numel())
    nbytes = P * K * 8 + R * 8 + P * 4 + Q * 4 + (P + R) * 4 + 8
    nops = P * K * 20 + n_live * Q * 12
    _, top = device_profile(torch, lambda: ops.pcdn_bundle(*args))
    log("[kernels] pcdn_bundle launches, device time of one call:")
    log_top("kernels", top, 1, "call")
    out["pcdn_bundle"] = dict(
        max_abs_err=max(e_w[0], e_z[0]),
        **timings(torch, lambda: ops.pcdn_bundle(*args),
                  lambda: ref.pcdn_bundle_ref(*args), flush),
        bound=bound(nbytes, nops), library_ms=None)

    # K2 at P = 512 (full scope)
    idx = B.partition(gen, n, 512, device=dev)[0]
    slab = sparse.design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    u = sparse.grad_factor(z)
    v = sparse.hess_factor(z)
    args = (slab.rows, slab.vals, u, v, w_B)
    got = ops.pcdn_sparse_direction(*args)
    want = ref.pcdn_sparse_direction_ref(*args)
    errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
    P, K = slab.rows.shape
    log(f"[kernels] pcdn_sparse_direction P={P} K={K} s={u.shape[0]}: "
        + ", ".join(f"{nm} err {e[0]:.3e} (rel {e[1]:.2e})"
                    for nm, e in zip("dgh", errs))
        + f"; tolerance rel {KERNEL_RTOL}")
    assert all(e[1] <= KERNEL_RTOL for e in errs), errs
    valid = slab.rows < sparse.n_samples
    n_rows = int(torch.unique(slab.rows[valid]).numel())
    nbytes = P * K * 8 + n_rows * 8 + P * 4 + 3 * P * 4
    nops = 5 * int(valid.sum())
    out["pcdn_sparse_direction"] = dict(
        max_abs_err=max(e[0] for e in errs),
        **timings(torch, lambda: ops.pcdn_sparse_direction(*args),
                  lambda: ref.pcdn_sparse_direction_ref(*args), flush),
        bound=bound(nbytes, nops), library_ms=None)

    # K3 at s = 6,000, P = 512 (dense layout)
    dense = make_problem(Xg, y_g, c=0.25, layout="dense", device=dev)
    nd = dense.n_features
    wd = torch.zeros((nd,), device=dev)
    on = torch.randperm(nd, generator=gen)[: nd // 10].to(dev)
    wd[on] = 0.05 * torch.randn((on.numel(),), generator=gen).to(dev)
    zd = dense.margins(wd)
    idx = B.partition(gen, nd, 512, device=dev)[0]
    slab = dense.design.gather_slab(idx)
    w_B, _ = B.gather_vec(wd, idx)
    args = (slab.XB, dense.grad_factor(zd), dense.hess_factor(zd), w_B)
    got = ops.pcdn_direction(*args)
    want = ref.pcdn_direction_ref(*args)
    errs = [rel_err(torch, a, b) for a, b in zip(got, want)]
    s, P = slab.XB.shape
    log(f"[kernels] pcdn_direction s={s} P={P}: "
        + ", ".join(f"{nm} err {e[0]:.3e} (rel {e[1]:.2e})"
                    for nm, e in zip("dgh", errs))
        + f"; tolerance rel {KERNEL_RTOL}")
    assert all(e[1] <= KERNEL_RTOL for e in errs), errs
    nbytes = s * P * 4 + 2 * s * 4 + P * 4 + 3 * P * 4
    nops = 5 * s * P
    out["pcdn_direction"] = dict(
        max_abs_err=max(e[0] for e in errs),
        **timings(torch, lambda: ops.pcdn_direction(*args),
                  lambda: ref.pcdn_direction_ref(*args), flush),
        bound=bound(nbytes, nops), library_ms=None)
    for name, r in out.items():
        log(f"[kernels] {name}: device {r['ms'] * 1e3:.2f} us L2-cold, "
            f"{r['warm_ms'] * 1e3:.2f} us L2-warm; plain version device "
            f"{r['plain_ms'] * 1e3:.2f} us; host {r['host_ms'] * 1e3:.2f} us "
            f"a call (plain {r['plain_host_ms'] * 1e3:.2f} us); bound "
            f"{r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}) on {card}")
    return out


def device_profile(torch, fn, n_top: int = 8):
    """Run fn once under torch.profiler (CUDA activity only) -> (device-busy
    seconds summed over what the card ran, the n_top ops by device time as
    (name, calls, seconds)); (0.0, []) when the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e6)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows[:n_top]


def log_top(name: str, top, per: int, unit: str) -> None:
    for key, calls, secs in top:
        log(f"[{name}]   {secs / per * 1e6:9.2f} us/{unit}  "
            f"{calls // max(per, 1):4d} calls/{unit}  {key[:90]}")


def profile_iteration(torch, backend, c):
    """device_profile of one outer iteration from the initial state."""
    st = backend.init_state()
    return device_profile(torch, lambda: backend.outer(
        st.w, st.z, st.gen, st.active, True, c))


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


def run_solve(torch, name, X, y, c, layout, P, kernel, n_outer, expect):
    """Kernel solve (launch counts read around it), the plain solve from
    the same seed (its drift printed), then the lockstep gate over
    n_outer iterations; returns the launch counts."""
    from repro_torch.core import PCDNConfig, resolve_ls_scope
    from repro_torch.core.bundles import num_bundles
    from repro_torch.core.problem import make_problem
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.kernels import ops

    prob = make_problem(X, y, c=c, layout=layout, device=DEVICE)
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
    busy, top = profile_iteration(torch, LocalBackend(prob, PCDNConfig(
        P=P, use_kernels=True, tol_kkt=0.0, seed=0)), c)
    wall = dt_k / n_outer
    if busy > 0:
        log(f"[{name}] device busy {busy * 1e3:.2f} ms of {wall * 1e3:.2f} "
            f"ms wall per outer iteration (idle share "
            f"{1 - busy / wall:.3f}); per bundle {busy / b * 1e6:.1f} us "
            f"device, {(wall - busy) / b * 1e6:.1f} us host overhead; top "
            f"device ops:")
        log_top(name, top, b, "bundle")
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
    kernels = {}
    if "kernels" in phases:
        kernels = phase_kernels(torch, data, f"{card} ({smi})")
    launches = {}
    if "support" in phases:
        csc, y_rs = data[0], data[1]
        c = run_solve(
            torch, "support", csc, y_rs, 4.0, "padded_csc", 32,
            "pcdn_bundle", N_OUTER, "support")
        launches["pcdn_bundle"] = c["pcdn_bundle"]
    if "full" in phases:
        csc, y_rs = data[0], data[1]
        c = run_solve(torch, "full", csc, y_rs, 4.0, "padded_csc", 512,
                      "pcdn_sparse_direction", N_OUTER, "full")
        launches["pcdn_sparse_direction"] = c["pcdn_sparse_direction"]
    if "dense" in phases:
        Xg, y_g = data[2], data[3]
        c = run_solve(torch, "dense", Xg, y_g, 0.25, "dense", 512,
                      "pcdn_direction", N_OUTER, "full")
        launches["pcdn_direction"] = c["pcdn_direction"]
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

    if kernels:
        rows = []
        for name, r in kernels.items():
            src, replaces = SOURCES[name]
            rows.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches.get(name),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": rows}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
