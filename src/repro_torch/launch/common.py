"""Shared CLI plumbing of the port's solve driver.

The flags mirror `repro.launch.common` for what this slice carries:
`--layout / --use-kernels / --device` and the solver knobs. The port runs
on the local backend only, so there is no `--backend`; `--device`
(default cuda) is the explicit device every entry point of the port takes.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.core import PCDNConfig
from repro_torch.data import load_libsvm, paper_like


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
              use_kernels=args.use_kernels, ls_scope=args.ls_scope)
    kw.update(overrides)
    return PCDNConfig(**kw)
