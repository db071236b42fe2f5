"""Solver core of the port: losses, Eq. 5 directions, bundles, design
matrices, the L1 problem, Armijo line searches and the PCDN bundle step."""
from repro_torch.core.linesearch import ArmijoParams
from repro_torch.core.pcdn import (PCDNConfig, cdn_config, resolve_ls_scope,
                                   with_bundle_size)
from repro_torch.core.problem import L1Problem, make_problem

__all__ = ["ArmijoParams", "PCDNConfig", "cdn_config", "resolve_ls_scope",
           "with_bundle_size", "L1Problem", "make_problem"]
