"""Fault tolerance of the port (mirrors `repro.fault`).

Crash-safe checkpoint/resume for solves and path sweeps (the on-disk
format is the reference's, so checkpoints cross between the packages),
non-finite rollback with automatic P-backoff toward the certified safe
bundle size, the deterministic fault-injection harness driven by the
same `REPRO_FAULT_PLAN` variable, the atomic writes the serve
artifacts use, and the step-loop runner (`fault.runner`: checkpoints,
crash recovery, straggler re-issue, elastic re-mesh) that drives LM
training.
"""
from repro_torch.fault.atomic import (atomic_write_bytes, atomic_write_json,
                                      atomic_write_text, fsync_dir)
from repro_torch.fault.checkpoint import (CheckpointManager,
                                          SolveCheckpointer, host_state)
from repro_torch.fault.inject import (CRASH_KINDS, ENV_VAR, NAN_TARGETS,
                                      FaultPlan, InjectedCrash,
                                      corrupt_checkpoint, plan_from_env,
                                      wrap_outer)
from repro_torch.fault.resilient import next_bundle_size, resilient_solve
from repro_torch.fault.runner import (ElasticMeshProvider,
                                      FaultTolerantRunner, RunnerConfig,
                                      StepFailure)

__all__ = [
    "atomic_write_bytes", "atomic_write_json", "atomic_write_text",
    "fsync_dir",
    "CheckpointManager", "SolveCheckpointer", "host_state",
    "CRASH_KINDS", "ENV_VAR", "NAN_TARGETS", "FaultPlan", "InjectedCrash",
    "corrupt_checkpoint", "plan_from_env", "wrap_outer",
    "next_bundle_size", "resilient_solve",
    "ElasticMeshProvider", "FaultTolerantRunner", "RunnerConfig",
    "StepFailure",
]
