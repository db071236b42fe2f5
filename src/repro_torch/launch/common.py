"""Shared CLI plumbing of the port's solve, path and predict entry points.

The flags mirror `repro.launch.common` for what the port carries:
`--layout / --use-kernels / --dtype / --device`, the solver knobs,
`--warm-start`, the telemetry flags `--metrics-out / --trace-out`, the
diagnostics flags `--diag-out / --progress` and the fault-tolerance flags
`--ckpt-dir / --ckpt-every / --resume / --retries`, with the reference's
defaults and refusals. The port runs on the local backend only, so there
is no `--backend` (and no sharded branch in the bf16 envelope);
`--device` (default cuda) is the explicit device every entry point of the
port takes.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import PCDNConfig
from repro_torch.data import load_libsvm, paper_like

# --dtype values -> storage dtype of the design values / serve bank (the
# solver state and the margins stay float32 either way)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
DTYPE_NAMES = {"fp32": "float32", "bf16": "bfloat16"}

# the reference's bf16 equivalence envelope (its BENCH_kernels.json
# trajectory study): the losses it covers and the tightest stopping
# tolerance its measured objective rel-diff supports
BF16_LOSSES = ("logistic", "squared_hinge")
BF16_MIN_TOL = 1e-3


def check_dtype_envelope(args, ap: argparse.ArgumentParser,
                         loss: str | None = None):
    """Refuse bf16 outside the studied equivalence envelope (the
    reference's rule for its local backend): a loss it did not study, or a
    stopping tolerance tighter than BF16_MIN_TOL."""
    if getattr(args, "dtype", "fp32") != "bf16":
        return
    if loss is not None and loss not in BF16_LOSSES:
        ap.error(f"--dtype bf16 is unstudied for loss {loss!r} "
                 f"(studied envelope: {', '.join(BF16_LOSSES)})")
    tol = getattr(args, "tol", None)
    if tol is not None and tol < BF16_MIN_TOL:
        ap.error(f"--tol {tol:g} is tighter than the bf16 equivalence "
                 f"envelope (max objective rel-diff ~{BF16_MIN_TOL:g}); "
                 f"use --tol >= {BF16_MIN_TOL:g} or --dtype fp32")


def add_backend_args(ap: argparse.ArgumentParser):
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "dense", "padded_csc"],
                    help="design-matrix backend; padded_csc never "
                         "densifies a .libsvm input")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route bundle math through the hand-written CUDA "
                         "kernels (plain PyTorch versions on --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs; cuda raises when no card "
                         "is present")


def add_dtype_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="storage dtype of the design values: bf16 halves "
                         "the design's memory with float32 accumulation "
                         "everywhere; gated to the studied envelope "
                         "(logistic/squared_hinge, --tol >= 1e-3)")


def add_solver_args(ap: argparse.ArgumentParser):
    ap.add_argument("--P", type=int, default=256, help="bundle size")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--max-outer", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shrink", action="store_true",
                    help="active-set shrinking")
    ap.add_argument("--ls-scope", default="auto",
                    choices=["auto", "support", "full"],
                    help="line-search / margin-maintenance scope: "
                         "'support' restricts every per-sample pass of a "
                         "bundle step to the bundle's row support "
                         "(padded_csc layout); 'auto' picks it when "
                         "4 * P * k_max <= s")
    ap.add_argument("--warm-start", default=None, metavar="CKPT",
                    help="w0 from a .npy vector or a JSON file (a dense "
                         "list or the sparse weight record a previous "
                         "--out report carries)")


def add_obs_args(ap: argparse.ArgumentParser):
    """Telemetry flags, identical in the solve / path / predict CLIs."""
    ap.add_argument("--metrics-out", default=None, metavar="JSONL",
                    help="enable the metrics registry and append one "
                         "JSONL run record (counters, gauges, p50/p99 "
                         "histograms) to this file on exit; "
                         "REPRO_METRICS=off force-disables")
    ap.add_argument("--trace-out", default=None, metavar="JSON",
                    help="record a Chrome-trace / Perfetto trace-event "
                         "file of the run (load at ui.perfetto.dev); "
                         "validate with `python -m repro_torch.obs."
                         "validate`")


def add_diag_args(ap: argparse.ArgumentParser):
    """Diagnostics flags, identical in the solve / path CLIs."""
    ap.add_argument("--diag-out", default=None, metavar="MD",
                    help="write a markdown solver-health report here "
                         "(top-k KKT offenders, backtrack forensics, "
                         "certified-P table); turns on the per-feature "
                         "KKT attribution harvest (record_kkt_vec) and "
                         "the per-bundle aux for this run")
    ap.add_argument("--progress", action="store_true",
                    help="live one-line solve status on stderr (iter, "
                         "objective, KKT, mean_q); off by default so logs "
                         "stay clean")


def add_fault_args(ap: argparse.ArgumentParser):
    """Fault-tolerance flags, identical in the solve / path CLIs."""
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="crash-safe checkpoint directory (atomic "
                         "write-then-rename with a COMMITTED marker); "
                         "solve runs snapshot every --ckpt-every "
                         "iterations, path sweeps after every grid "
                         "point; checkpoints are unpadded host arrays in "
                         "the reference's format, so either package "
                         "resumes them")
    ap.add_argument("--ckpt-every", type=int, default=10, metavar="N",
                    help="solve-checkpoint cadence in outer iterations "
                         "(default 10; path sweeps always checkpoint "
                         "per point)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest committed checkpoint "
                         "in --ckpt-dir (incomplete or corrupted steps "
                         "are skipped); on the CPU the resumed run "
                         "reproduces the uninterrupted one bit-for-bit")
    ap.add_argument("--retries", type=int, default=2, metavar="K",
                    help="max non-finite rollbacks before the solve "
                         "surfaces the post-mortem (each retry halves "
                         "the bundle size toward the certified safe P)")


def make_checkpointer(args, ap: argparse.ArgumentParser):
    """The `fault.SolveCheckpointer` behind --ckpt-dir, or None."""
    if getattr(args, "resume", False) and not getattr(args, "ckpt_dir", None):
        ap.error("--resume needs --ckpt-dir")
    if not getattr(args, "ckpt_dir", None):
        return None
    from repro_torch.fault import SolveCheckpointer
    if args.ckpt_every < 1:
        ap.error(f"--ckpt-every must be >= 1, got {args.ckpt_every}")
    return SolveCheckpointer(args.ckpt_dir, every=args.ckpt_every)


def make_progress_callback(args):
    """The engine callback behind `--progress`: one stderr status line,
    rewritten in place (carriage return, no scroll). None when the flag is
    off, so the engine loop skips the call."""
    if not getattr(args, "progress", False):
        return None
    import sys

    def cb(k, w, f, kkt, mean_q):
        print(f"\r[progress] iter {k:4d}  F={f:.6f}  kkt={kkt:.3e}  "
              f"mean_q={mean_q:5.2f}", end="", file=sys.stderr, flush=True)
    return cb


def finish_progress(args) -> None:
    """Terminate the in-place `--progress` line before normal output."""
    if getattr(args, "progress", False):
        import sys
        print(file=sys.stderr, flush=True)


def write_diag(args, report: dict, design=None, tol_kkt=None) -> None:
    """Render the `--diag-out` health report.

    `report` is the payload `--out` writes (history + provenance +
    optional postmortem); given `design` (the CLI's own, on its device)
    the certified-P table is computed here, so the report never reloads
    the dataset.
    """
    if not getattr(args, "diag_out", None):
        return
    from repro_torch import diag
    safep_record = None
    if design is not None:
        safep_record = diag.safep.certify(
            design, seed=getattr(args, "seed", 0),
            observed_p=getattr(args, "P", None))
        report.setdefault("diag", {})["safep"] = safep_record
    payload = diag.build_payload(report=report,
                                 safep_record=safep_record,
                                 tol_kkt=tol_kkt)
    with open(args.diag_out, "w") as fh:
        fh.write(diag.render_markdown(payload))
    print(f"[diag] health report written to {args.diag_out}")


def setup_obs(args) -> None:
    """Switch the telemetry planes on per the CLI flags (before any
    instrumented work runs)."""
    if getattr(args, "metrics_out", None):
        obs.registry.enable()
        obs.registry.reset()
    if getattr(args, "trace_out", None):
        obs.trace.enable(process_name="repro_torch")


def finish_obs(args, meta: dict | None = None) -> None:
    """Flush the telemetry outputs the CLI flags requested."""
    if getattr(args, "metrics_out", None):
        obs.write_metrics(args.metrics_out, meta)
        print(f"[obs] metrics appended to {args.metrics_out}")
        obs.registry.disable()
    if getattr(args, "trace_out", None):
        if obs.trace.save(args.trace_out):
            print(f"[obs] trace written to {args.trace_out}")


def load_dataset(args, with_test: bool = False):
    """-> (X, y, Xte, yte, spec). File datasets have no test split and a
    None spec; profile names go through `paper_like` (at `--scale` where
    the CLI has it)."""
    if os.path.exists(args.dataset):
        layout = "padded_csc" if args.layout == "padded_csc" else "dense"
        X, y = load_libsvm(args.dataset, layout=layout)
        return X, y, None, None, None
    scale = getattr(args, "scale", None)
    if with_test:
        return paper_like(args.dataset, with_test=True, seed=args.seed,
                          scale=scale)
    X, y, spec = paper_like(args.dataset, seed=args.seed, scale=scale)
    return X, y, None, None, spec


def build_pcdn_config(args, **overrides) -> PCDNConfig:
    kw = dict(P=args.P, max_outer=args.max_outer, tol_kkt=args.tol,
              seed=args.seed, shrink=args.shrink,
              use_kernels=args.use_kernels, ls_scope=args.ls_scope,
              dtype=DTYPE_NAMES[getattr(args, "dtype", "fp32")],
              record_aux=_record_aux(args),
              record_kkt_vec=_record_kkt_vec(args))
    kw.update(overrides)
    return PCDNConfig(**kw)


def _record_aux(args) -> bool:
    """The per-bundle (q, alpha) aux outputs ride along exactly when the
    CLI asked for telemetry or diagnostics (the health report's backtrack
    forensics read them); without the flags the outer iteration launches
    what the uninstrumented solver launches."""
    return bool(getattr(args, "metrics_out", None)
                or getattr(args, "trace_out", None)
                or getattr(args, "diag_out", None))


def _record_kkt_vec(args) -> bool:
    """The per-feature KKT attribution rides along exactly when
    `--diag-out` asked for a health report."""
    return bool(getattr(args, "diag_out", None))


def load_warm_start(path: str, n: int) -> np.ndarray:
    """Load a w0 vector (float32 numpy) from .npy, or from JSON: a dense
    list, or the sparse {n_features, w_indices, w_values} record `--out`
    writes (in either package) -- so solve runs chain."""
    if path.endswith(".npy"):
        w = np.asarray(np.load(path), np.float64).reshape(-1)
    else:
        with open(path) as fh:
            obj = json.load(fh)
        if isinstance(obj, dict):
            if "w_indices" not in obj:
                raise ValueError(
                    f"warm start {path!r} has no weight record "
                    f"(w_indices/w_values); re-run the source solve with "
                    f"--out or pass a .npy")
            w = np.zeros((int(obj["n_features"]),), np.float64)
            w[np.asarray(obj["w_indices"], np.int64)] = obj["w_values"]
        else:
            w = np.asarray(obj, np.float64).reshape(-1)
    if w.shape[0] != n:
        raise ValueError(
            f"warm start {path!r} has {w.shape[0]} features, problem "
            f"has {n}")
    return w.astype(np.float32)


def history_dict(history) -> dict:
    """JSON-ready SolveHistory."""
    return {k: np.asarray(v).tolist() for k, v in history._asdict().items()
            if v is not None}


def sparse_weight_record(w) -> dict:
    """JSON-compact (indices, values) form of an l1 solution."""
    w = np.asarray(w, np.float64)
    idx = np.flatnonzero(w)
    return {"n_features": int(w.shape[0]),
            "w_indices": idx.tolist(),
            "w_values": w[idx].tolist()}
