"""Training / serving substrate of the port: the step factories, plus
re-exports of the checkpoint and runner machinery that lives in
`repro_torch.fault` (`train.checkpoint` / `train.fault_tolerance` are the
reference's deprecation shims)."""
from repro_torch.train.steps import make_serve_step, make_train_step
from repro_torch.fault.checkpoint import CheckpointManager
from repro_torch.fault.runner import FaultTolerantRunner

__all__ = ["make_train_step", "make_serve_step", "CheckpointManager",
           "FaultTolerantRunner"]
