"""Local execution backend: the outer iteration of `core.pcdn` over one
`L1Problem` on one device. Port of `repro.engine.local`."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.problem import L1Problem
from repro_torch.engine.loop import EngineState

Tensor = torch.Tensor


class LocalBackend:
    """Execution backend over an `L1Problem` (cfg: a `pcdn.PCDNConfig`)."""

    def __init__(self, problem: L1Problem, cfg, outer=None):
        from repro_torch.core import pcdn
        self.problem = problem
        self.cfg = cfg
        self.outer = (outer if outer is not None
                      else pcdn.make_path_outer(problem, cfg))

    @property
    def n_features(self) -> int:
        return self.problem.n_features

    @property
    def n_samples(self) -> int:
        return self.problem.n_samples

    @property
    def dtype(self):
        return torch.float32

    @property
    def device(self):
        return self.problem.device

    def init_state(self, w0: Optional[Tensor] = None) -> EngineState:
        """Zero (or w0) weights with their margins, a generator seeded
        with cfg.seed, and every feature active."""
        n, s, dev = self.n_features, self.n_samples, self.device
        if w0 is None:
            w = torch.zeros((n,), dtype=self.dtype, device=dev)
            z = torch.zeros((s,), dtype=self.dtype, device=dev)
        else:
            w = torch.as_tensor(np.asarray(w0, np.float32), device=dev)
            z = self.problem.margins(w)
        gen = torch.Generator().manual_seed(self.cfg.seed)
        return EngineState(w=w, z=z, gen=gen,
                           active=torch.ones((n,), dtype=torch.bool,
                                             device=dev))

    def host_weights(self, w: Tensor) -> np.ndarray:
        return w.detach().cpu().numpy()
