#!/usr/bin/env python3
"""How `diag.safep`'s power iteration approaches the top eigenvalue of the
column-normalised Gram matrix on the support cell's real-sim profile.

    python3 benchmarks/port/safep_convergence.py [--steps 16000] [--device cuda]
        [--rows 57848 --cols 20958]

Builds real-sim at its published shape (57,848 x 20,958, k_max 278, seed
0; `make_sparse_classification`, as `chip_smoke.py` does; `--rows` and
`--cols` cut it for a run on the CPU) in padded-CSC on `--device`, finds the top eigenvalues with scipy's eigsh (float64, a
LinearOperator over the column-normalised design), then runs the power
iteration of `diag.safep` (float32 products through the design, float64
on the host) beside the same iteration in float64 with scipy, from the
same start vector, printing each one's Rayleigh quotient and its distance
to the top eigenvalue at fixed steps, and the first step at which the
1e-9 relative-change stop test of `power_iteration_rho` fires. Last, one
`safep.certify` at its defaults. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla

ROOT = Path(__file__).resolve().parents[2]
MARKS = (250, 500, 1000, 2000, 3000, 4000, 6000, 8000, 12000, 16000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=57_848)
    ap.add_argument("--cols", type=int, default=20_958)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.design_matrix import as_design
    from repro_torch.data import make_sparse_classification
    from repro_torch.device import resolve_device
    from repro_torch.diag import safep

    dev = resolve_device(args.device)
    csc, _, _ = make_sparse_classification(args.rows, args.cols,
                                           nnz_per_col=278, seed=0)
    d = as_design(csc, layout="padded_csc", device=dev)
    n, s = d.n_features, d.n_samples
    scale = safep._col_scale(d)
    rows, vals = csc.col_rows, csc.col_vals
    keep = rows < s
    cols = np.broadcast_to(np.arange(n)[:, None], rows.shape)
    X = sps.csc_matrix((vals[keep].astype(np.float64),
                        (rows[keep], cols[keep])), shape=(s, n)).tocsr()
    Xn = (X @ sps.diags(scale)).tocsr()
    XnT = Xn.T.tocsr()
    op = spla.LinearOperator((n, n), matvec=lambda u: XnT @ (Xn @ u),
                             dtype=np.float64)
    t0 = time.perf_counter()
    top = np.sort(spla.eigsh(op, k=6, which="LA",
                             return_eigenvectors=False))[::-1]
    lam = float(top[0])
    print(f"eigsh top 6: {', '.join(f'{x:.9f}' for x in top)} "
          f"({time.perf_counter() - t0:.2f}s)", flush=True)

    rng = np.random.default_rng(0)       # power_iteration_rho's start
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    v64 = v.copy()
    rho_prev, first_stop = 0.0, None
    t0 = time.perf_counter()
    for it in range(1, args.steps + 1):
        u = d.matvec(torch.as_tensor((v * scale).astype(np.float32),
                                     device=dev))
        mv = scale * d.rmatvec(u).double().cpu().numpy()
        rho = float(v @ mv)
        v = mv / np.linalg.norm(mv)
        mv64 = XnT @ (Xn @ v64)
        rho64 = float(v64 @ mv64)
        v64 = mv64 / np.linalg.norm(mv64)
        if first_stop is None and \
                abs(rho - rho_prev) <= 1e-9 * max(abs(rho), 1.0):
            first_stop = it
        rho_prev = rho
        if it in MARKS:
            print(f"step {it}: float32 products rho {rho:.9f} (rel "
                  f"{abs(rho - lam) / lam:.3e}); float64 rho {rho64:.9f} "
                  f"(rel {abs(rho64 - lam) / lam:.3e}); the 1e-9 stop first "
                  f"met at step {first_stop}; "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
    cert = safep.certify(d)
    print(json.dumps(cert), flush=True)
    print(f"certify's rho is {abs(cert['rho_normalized'] - lam) / lam:.3e} "
          f"from the top eigenvalue", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
