"""Local execution backend: the outer iteration of `core.pcdn` over one
`L1Problem` on one device. Port of `repro.engine.local`, with the
checkpoint image's two ends: `host_margins` and `restore_state`."""
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
        """Solver-state dtype: float32 even when the design stores bf16
        values."""
        return self.problem.solve_dtype

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
            w = torch.as_tensor(np.asarray(w0, np.float32), dtype=self.dtype,
                                device=dev)
            z = self.problem.margins(w)
        gen = torch.Generator().manual_seed(self.cfg.seed)
        return EngineState(w=w, z=z, gen=gen,
                           active=torch.ones((n,), dtype=torch.bool,
                                             device=dev))

    def margins(self, w: Tensor) -> Tensor:
        """z = X w, recomputed (the path sweep refreshes z once a point)."""
        return self.problem.margins(w)

    def c_max(self) -> float:
        """The analytic start of a regularization path."""
        return self.problem.c_max()

    def host_weights(self, w: Tensor) -> np.ndarray:
        return w.detach().cpu().numpy()

    def host_margins(self, z: Tensor) -> np.ndarray:
        """(n_samples,) host margins: the checkpoint image of z."""
        return z.detach().cpu().numpy()

    def restore_state(self, w, z=None, active=None, key=None,
                      gen_state=None) -> EngineState:
        """EngineState on the backend's device from host arrays (a
        `fault.checkpoint` snapshot, written by this package or the
        reference). Missing pieces follow `init_state`: z is recomputed
        from w, active is all-True. `gen_state` is a
        `torch.Generator.get_state()` image; without it (a checkpoint the
        reference wrote) the generator is seeded from cfg.seed, the
        reference's own `key=None` rule. `key`, the reference's PRNG key,
        is accepted and unused: the packages draw partitions differently.
        """
        del key
        n, s, dev = self.n_features, self.n_samples, self.device
        w = torch.tensor(np.asarray(w), dtype=self.dtype, device=dev)
        if w.shape[0] != n:
            raise ValueError(f"checkpoint has {w.shape[0]} features, "
                             f"problem has {n}")
        z = (self.problem.margins(w) if z is None
             else torch.tensor(np.asarray(z).reshape(s), dtype=self.dtype,
                               device=dev))
        active = (torch.ones((n,), dtype=torch.bool, device=dev)
                  if active is None
                  else torch.tensor(np.asarray(active).reshape(n),
                                    dtype=torch.bool, device=dev))
        gen = torch.Generator().manual_seed(self.cfg.seed)
        if gen_state is not None:
            gen.set_state(gen_state)
        return EngineState(w=w, z=z, gen=gen, active=active)
