"""Distributed PCDN: `solve_sharded`, the reference's historical entry
point (`repro.core.sharded`), as a thin caller of `engine.loop.solve` on a
`engine.sharded.ShardedBackend`. Build the backend directly for warm
starts, path sweeps or the full `SolveResult`."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.engine import loop as engine_loop
from repro_torch.engine.sharded import (ShardedBackend,  # noqa: F401
                                        ShardedPCDNConfig,
                                        make_sharded_margins,
                                        make_sharded_outer, shard_problem,
                                        shard_problem_sparse)


def solve_sharded(X, y: np.ndarray, mesh, cfg: ShardedPCDNConfig,
                  max_outer: int = 100, tol_kkt: float = 1e-3,
                  layout: str = "auto", k_max: int = None):
    """`core.pcdn.solve` on a mesh. layout="auto" picks padded_csc for
    CSR-like X and dense for arrays. Returns (w, objective, converged,
    n_outer, hist) with w this rank's (n_local,) block, as the reference
    returns its mesh-placed padded vector (`ShardedBackend.host_weights`
    gives the real-n host copy)."""
    # the un-shrink threshold follows the stop tolerance
    cfg = dataclasses.replace(cfg, tol_kkt=tol_kkt)
    backend = ShardedBackend(X, y, mesh, cfg, layout=layout, k_max=k_max)
    result = engine_loop.solve(backend, cfg.c, max_outer=max_outer,
                               tol_kkt=tol_kkt,
                               recheck_every=cfg.recheck_every)
    hist = {"objective": [float(v) for v in result.history.objective],
            "kkt": [float(v) for v in result.history.kkt]}
    return result.w, result.objective, result.converged, result.n_outer, \
        hist
