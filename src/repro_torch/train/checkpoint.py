"""Deprecated location -- the checkpoint machinery lives in
`repro_torch.fault.checkpoint`, where it backs the solver / sweep
checkpoint-resume path as well as LM training (the reference's shim
`repro.train.checkpoint`).

This shim re-exports the public names and will be removed; import from
`repro_torch.fault` instead.
"""
from __future__ import annotations

import warnings

from repro_torch.fault.checkpoint import CheckpointManager, _SEP  # noqa: F401

warnings.warn(
    "repro_torch.train.checkpoint is deprecated; use "
    "repro_torch.fault.checkpoint (promoted in the fault-tolerance "
    "subsystem)", DeprecationWarning, stacklevel=2)

__all__ = ["CheckpointManager"]
