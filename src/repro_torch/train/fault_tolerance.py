"""Deprecated location -- the fault-tolerant step runner lives in
`repro_torch.fault.runner` (the reference's shim
`repro.train.fault_tolerance`).

This shim re-exports the public names and will be removed; import from
`repro_torch.fault` instead.
"""
from __future__ import annotations

import warnings

from repro_torch.fault.runner import (ElasticMeshProvider,  # noqa: F401
                                      FaultTolerantRunner, RunnerConfig,
                                      StepFailure)

warnings.warn(
    "repro_torch.train.fault_tolerance is deprecated; use "
    "repro_torch.fault.runner (promoted in the fault-tolerance subsystem)",
    DeprecationWarning, stacklevel=2)

__all__ = ["FaultTolerantRunner", "RunnerConfig", "StepFailure",
           "ElasticMeshProvider"]
