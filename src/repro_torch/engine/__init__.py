"""Solver engine of the port: the host loop and the local backend."""
from repro_torch.engine.local import LocalBackend
from repro_torch.engine.loop import (EngineState, SolveHistory, SolveResult,
                                     run_outer_loop, solve)

__all__ = ["LocalBackend", "EngineState", "SolveHistory", "SolveResult",
           "run_outer_loop", "solve"]
