"""Solver core of the port: losses, Eq. 5 directions, bundles, design
matrices, the L1 problem, Armijo line searches, the PCDN bundle step, and
the paper's comparison solvers (SCDN, TRON)."""
from repro_torch.core.linesearch import ArmijoParams
from repro_torch.core.pcdn import (PCDNConfig, cdn_config, resolve_ls_scope,
                                   with_bundle_size)
from repro_torch.core.problem import (L1Problem, expected_max_column_norm,
                                      make_problem)
from repro_torch.core import scdn, tron

__all__ = ["ArmijoParams", "PCDNConfig", "cdn_config", "resolve_ls_scope",
           "with_bundle_size", "L1Problem", "make_problem",
           "expected_max_column_norm", "scdn", "tron"]
