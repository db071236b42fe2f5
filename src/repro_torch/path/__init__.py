"""Regularization paths of the port (port of `repro.path`): warm-started
c-sweeps over a geometric grid from the analytic c_max, and lockstep
multi-problem batch solving over one shared design."""
from repro_torch.path.batch import (BatchSolveResult, make_batch_outer,
                                    solve_batch)
from repro_torch.path.driver import (PathConfig, PathPoint, PathResult,
                                     path_summary, pick_best, run_path)
from repro_torch.path.grid import c_grid, problem_grid

__all__ = [
    "PathConfig", "PathPoint", "PathResult", "run_path", "path_summary",
    "pick_best", "c_grid", "problem_grid",
    "BatchSolveResult", "make_batch_outer", "solve_batch",
]
