"""Fault tolerance, straggler mitigation and elastic re-meshing for step
loops: port of `repro.fault.runner`.

`FaultTolerantRunner` wraps a generic step loop with:
  * periodic checkpointing (every `ckpt_every` steps, atomic via
    CheckpointManager),
  * crash recovery: on any step exception the latest committed checkpoint
    is restored and the loop resumes (with bounded retries per step),
  * straggler mitigation: each step gets a wall-clock deadline derived
    from a running median (deadline = median * `straggler_factor`); a
    straggling step is re-issued from the state before the attempt. That
    is safe because steps are functions of their inputs that change none
    of them (`train.steps.make_train_step`'s step is).
  * elastic re-mesh: `ElasticMeshProvider` recomputes the mesh from the
    ranks running now; checkpoints hold full host arrays, so a restore
    needs no particular mesh.

A step's wall is measured to the end of its device work: the runner
synchronizes the device of the state's first tensor leaf (the reference
blocks on its first leaf). Fault injection hooks (`inject_fault`) let the
tests simulate crashes and stragglers deterministically (see also
`fault.inject.FaultPlan` for the solver/sweep-level harness).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.fault.checkpoint import CheckpointManager, flatten_with_names


@dataclasses.dataclass
class RunnerConfig:
    ckpt_every: int = 50
    max_retries_per_step: int = 3
    straggler_factor: float = 5.0   # deadline = median_step_time * factor
    min_deadline_s: float = 2.0
    warmup_steps: int = 3           # exclude warm-up steps from the median


class StepFailure(RuntimeError):
    pass


def _block_until_ready(state: Any) -> None:
    """Wait for the device work behind `state`: a synchronize of its first
    tensor leaf's device (nothing on the CPU)."""
    for _, leaf in flatten_with_names(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable, state: Any,
                 ckpt: CheckpointManager, cfg: RunnerConfig = RunnerConfig(),
                 inject_fault: Optional[Callable[[int, int], None]] = None):
        """step_fn(state, step_idx) -> (state, metrics). state is any tree
        `CheckpointManager` stores (params + opt state + data cursor).
        inject_fault(step, attempt) may raise to simulate a crash (test
        hook)."""
        self.step_fn = step_fn
        self.state = state
        self.ckpt = ckpt
        self.cfg = cfg
        self.inject_fault = inject_fault
        self.step_times: list[float] = []
        self.events: list[dict] = []      # fault/straggler/restore log
        self.start_step = 0
        # auto-resume if a checkpoint exists
        latest = ckpt.latest_step()
        if latest is not None:
            self.start_step, self.state = ckpt.restore(self.state)
            self.events.append({"kind": "resume", "step": latest})

    # -- deadline logic -----------------------------------------------------
    def _deadline(self) -> float:
        if len(self.step_times) < self.cfg.warmup_steps:
            return float("inf")
        med = float(np.median(self.step_times))
        return max(med * self.cfg.straggler_factor, self.cfg.min_deadline_s)

    def _attempt(self, step: int, attempt: int):
        if self.inject_fault is not None:
            self.inject_fault(step, attempt)
        t0 = time.perf_counter()
        state, metrics = self.step_fn(self.state, step)
        # block so the deadline measures real execution, not dispatch
        _block_until_ready(state)
        dt = time.perf_counter() - t0
        if dt > self._deadline():
            self.events.append({"kind": "straggler", "step": step,
                                "attempt": attempt, "seconds": dt})
            raise StepFailure(f"straggler: step {step} took {dt:.2f}s "
                              f"(deadline {self._deadline():.2f}s)")
        return state, metrics, dt

    # -- main loop -------------------------------------------------------------
    def run(self, n_steps: int, metrics_cb: Optional[Callable] = None):
        step = self.start_step
        end = self.start_step + n_steps
        saved = None
        while step < end:
            ok = False
            last_error = None
            for attempt in range(self.cfg.max_retries_per_step):
                try:
                    # straight into self.state: a local name would keep
                    # this state alive through a later crash's restore,
                    # beside the restored one
                    self.state, metrics, dt = self._attempt(step, attempt)
                    self.step_times.append(dt)
                    if len(self.step_times) > 64:
                        self.step_times.pop(0)
                    ok = True
                    break
                except StepFailure:
                    continue  # re-issue the same step (speculative retry)
                except Exception as e:  # crash: restore + retry
                    last_error = e
                    self.events.append({"kind": "crash", "step": step,
                                        "attempt": attempt,
                                        "error": repr(e)})
                    latest = self.ckpt.latest_step()
                    if latest is not None:
                        restored, self.state = self.ckpt.restore(self.state)
                        step = restored
                        self.events.append({"kind": "restore",
                                            "step": restored})
                    continue
            if not ok:
                raise StepFailure(
                    f"step {step} failed {self.cfg.max_retries_per_step}x"
                    + ("" if last_error is None
                       else f"; last error {last_error!r}")) from last_error
            if metrics_cb is not None:
                metrics_cb(step, metrics)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save(step, self.state)
                saved = step
        if saved != step:   # unless the periodic save just wrote it
            self.ckpt.save(step, self.state)
        return self.state


@dataclasses.dataclass
class ElasticMeshProvider:
    """Recompute the mesh from the ranks running now (one a card; a world
    of 1 when no process group runs). Checkpoints hold full host arrays,
    so a state restores onto any mesh after a change of card count (a
    lost host, an added one)."""
    model_parallel: int = 1

    def make(self, device="cuda"):
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, make_mesh
        init_distributed(device)
        n = dist.get_world_size()
        model = self.model_parallel
        while model > 1 and n % model != 0:
            model //= 2  # degrade TP gracefully if devices were lost
        data = n // model
        return make_mesh((data, model), ("data", "model"), device=device)
