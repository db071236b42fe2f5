"""Solver engine of the port: the host loop, the local backend and the
sharded backend on torch.distributed."""
from repro_torch.engine.local import LocalBackend
from repro_torch.engine.loop import (EngineState, SolveHistory, SolveResult,
                                     run_lockstep_loop, run_outer_loop,
                                     solve)
from repro_torch.engine.sharded import (ShardedBackend, ShardedPCDNConfig,
                                        shard_problem, shard_problem_sparse)

__all__ = ["LocalBackend", "EngineState", "SolveHistory", "SolveResult",
           "run_lockstep_loop", "run_outer_loop", "solve", "ShardedBackend",
           "ShardedPCDNConfig", "shard_problem", "shard_problem_sparse"]
