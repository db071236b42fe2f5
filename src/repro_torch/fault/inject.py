"""Deterministic fault injection (port of `repro.fault.inject`).

A `FaultPlan` is a declarative, seed-keyed schedule of faults; the hooks
fire at EXACT iteration / path-point indices, so every failure a test or
the smoke run provokes is reproducible:

* ``crash_at_iter`` / ``crash_at_point`` -- kill the host right there,
  either by raising `InjectedCrash` (in-process tests) or via
  ``os.kill(SIGKILL)`` (subprocess kill-resume runs -- no atexit, no
  flushing, the real thing).
* ``nan_at_iter`` -- poison the iteration's OUTPUT tensors (margins,
  weights or the KKT scalar) with NaNs: a NaN entering z makes the same
  iteration's objective and KKT non-finite while the PREVIOUS carry --
  what the engine rolls back to -- stays clean.
* ``delay_at_iter`` -- sleep `delay_s` inside one iteration.

Every hook fires AT MOST ONCE (the plan remembers what it fired), so a
retried iteration re-executes clean.

`plan_from_env` reads the ``REPRO_FAULT_PLAN`` JSON env var -- the same
variable and keys as the reference, so one plan drives either package's
CLI.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

ENV_VAR = "REPRO_FAULT_PLAN"

NAN_TARGETS = ("margins", "weights", "kkt")
CRASH_KINDS = ("exception", "sigkill")


class InjectedCrash(RuntimeError):
    """An in-process injected crash (crash_kind='exception')."""


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault schedule. Indices are GLOBAL: `crash_at_iter`
    counts solver outer iterations (resume-aware — a run resumed at
    iteration k starts counting there), `crash_at_point` counts path
    grid points and fires AFTER the point's checkpoint is written."""

    crash_at_iter: Optional[int] = None
    crash_at_point: Optional[int] = None
    crash_kind: str = "exception"
    nan_at_iter: Optional[int] = None
    nan_target: str = "margins"
    nan_count: int = 4
    delay_at_iter: Optional[int] = None
    delay_s: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.crash_kind not in CRASH_KINDS:
            raise ValueError(f"crash_kind must be one of {CRASH_KINDS}, "
                             f"got {self.crash_kind!r}")
        if self.nan_target not in NAN_TARGETS:
            raise ValueError(f"nan_target must be one of {NAN_TARGETS}, "
                             f"got {self.nan_target!r}")
        self._fired: set = set()

    # -- firing --------------------------------------------------------------
    def _once(self, tag) -> bool:
        if tag in self._fired:
            return False
        self._fired.add(tag)
        return True

    def _crash(self, what: str) -> None:
        if self.crash_kind == "sigkill":
            # the real thing: no exception propagation, no atexit, no
            # stream flushing — the process is simply gone
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(what)

    def fire_point(self, point_index: int) -> None:
        """Path-driver hook, called after each point's checkpoint."""
        if (self.crash_at_point == point_index
                and self._once(("point", point_index))):
            self._crash(f"injected crash after path point {point_index}")

    def fire_step(self, step: int, attempt: int = 0) -> None:
        """Train-loop hook (`fault.runner.FaultTolerantRunner`'s
        `inject_fault`): `delay_at_iter` and `crash_at_iter` count
        training steps there."""
        if self.delay_at_iter == step and self._once(("delay", step)):
            time.sleep(self.delay_s)
        if self.crash_at_iter == step and self._once(("crash", step)):
            self._crash(f"injected crash at train step {step}")

    # -- outer-iteration wrapper ---------------------------------------------
    def poison(self, out: tuple) -> tuple:
        """Poison one engine 9(+)-tuple according to `nan_target`: NaNs
        at `nan_count` indices drawn from `np.random.default_rng(seed)`
        (the reference's indices), written with torch ops into the
        iteration's output tensors -- the outer iteration's outputs are
        new tensors, so the input carry stays clean."""
        out = list(out)
        w, z, f, kkt = out[0], out[1], out[3], out[4]
        nan = float("nan")
        if self.nan_target == "kkt":
            out[4] = torch.full_like(kkt, nan)
            return tuple(out)
        if self.nan_target == "margins":
            tgt, slot = z, 1
        else:
            tgt, slot = w, 0
        rng = np.random.default_rng(self.seed)
        count = int(min(max(self.nan_count, 1), tgt.shape[0]))
        idx = rng.choice(tgt.shape[0], size=count, replace=False)
        poisoned = tgt.clone()
        poisoned[torch.as_tensor(np.sort(idx), device=tgt.device)] = nan
        out[slot] = poisoned
        # a NaN margin/weight makes the SAME iteration's objective and
        # KKT non-finite (they are reductions over z / w)
        out[3] = torch.full_like(f, nan)
        out[4] = torch.full_like(kkt, nan)
        return tuple(out)


def wrap_outer(outer, plan: FaultPlan, start_iter: int = 0):
    """Wrap a backend `outer` -- the port's `(w, z, gen, active, recheck,
    c, ...)` -- with the plan's iteration-indexed hooks.

    The wrapper counts calls starting at `start_iter` so iteration
    indices stay global across resumes and rollback retries (the
    resilient driver re-wraps from the redo point; one-shot firing keeps
    a retried index from re-poisoning)."""
    counter = {"k": int(start_iter)}

    def wrapped(*args, **kwargs):
        k = counter["k"]
        counter["k"] = k + 1
        if plan.delay_at_iter == k and plan._once(("delay", k)):
            time.sleep(plan.delay_s)
        if plan.crash_at_iter == k and plan._once(("crash", k)):
            plan._crash(f"injected crash at outer iteration {k}")
        out = outer(*args, **kwargs)
        if plan.nan_at_iter == k and plan._once(("nan", k)):
            out = plan.poison(out)
        return out

    return wrapped


def plan_from_env(var: str = ENV_VAR) -> Optional[FaultPlan]:
    """FaultPlan from the `REPRO_FAULT_PLAN` JSON env var, or None.
    Unknown keys are rejected — a typoed fault that silently never fires
    would make a red test green."""
    raw = os.environ.get(var)
    if not raw:
        return None
    obj = json.loads(raw)
    if not isinstance(obj, dict):
        raise ValueError(f"{var} must be a JSON object, got {type(obj)}")
    fields = {f.name for f in dataclasses.fields(FaultPlan)}
    unknown = set(obj) - fields
    if unknown:
        raise ValueError(f"{var} has unknown keys {sorted(unknown)} "
                         f"(known: {sorted(fields)})")
    return FaultPlan(**obj)


def corrupt_checkpoint(directory: str, step: Optional[int] = None,
                       mode: str = "uncommit") -> str:
    """Damage a checkpoint for recovery tests. mode='uncommit' removes
    the COMMITTED marker (simulates a crash between the array write and
    the commit); mode='truncate' overwrites arrays.npz with garbage
    while LEAVING the marker (simulates later corruption of a committed
    step). Returns the damaged step dir."""
    from repro_torch.fault.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = mgr._step_dir(step)
    if mode == "uncommit":
        os.remove(os.path.join(d, "COMMITTED"))
    elif mode == "truncate":
        with open(os.path.join(d, "arrays.npz"), "wb") as fh:
            fh.write(b"not a zip file")
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return d
