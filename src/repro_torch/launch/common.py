"""Shared CLI plumbing of the port's solve and predict entry points.

The flags mirror `repro.launch.common` for what the port carries:
`--layout / --use-kernels / --dtype / --device`, the solver knobs and
`--warm-start`. The port runs on the local backend only, so there is no
`--backend` (and no sharded branch in the bf16 envelope); `--device`
(default cuda) is the explicit device every entry point of the port takes.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

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


def load_dataset(args, with_test: bool = False):
    """-> (X, y, Xte, yte, spec). File datasets have no test split and a
    None spec; profile names go through `paper_like`."""
    if os.path.exists(args.dataset):
        layout = "padded_csc" if args.layout == "padded_csc" else "dense"
        X, y = load_libsvm(args.dataset, layout=layout)
        return X, y, None, None, None
    if with_test:
        return paper_like(args.dataset, with_test=True, seed=args.seed)
    X, y, spec = paper_like(args.dataset, seed=args.seed)
    return X, y, None, None, spec


def build_pcdn_config(args, **overrides) -> PCDNConfig:
    kw = dict(P=args.P, max_outer=args.max_outer, tol_kkt=args.tol,
              seed=args.seed, shrink=args.shrink,
              use_kernels=args.use_kernels, ls_scope=args.ls_scope,
              dtype=DTYPE_NAMES[getattr(args, "dtype", "fp32")])
    kw.update(overrides)
    return PCDNConfig(**kw)


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
