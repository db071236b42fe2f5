"""Continuous-batching serving loop, in torch.

Port of `repro.serve.loop`. `ServeLoop` turns the synchronous microbatcher
into a server: requests are admitted into a per-model queue and a single
scheduler thread pops bucket-shaped chunks continuously.

Flush policy: a model's queue is flushed when

  * it holds a full max-size bucket ("full"), or
  * waiting any longer would blow the OLDEST request's latency budget
    ("deadline"): with est(b) the per-bucket EWMA compute estimate
    (`serve.policy.LatencyModel`), the latest safe flush instant is

        flush_at = oldest.deadline - (est(bucket) * safety_factor
                                      + safety_s)

  * the loop is stopping ("drain").

Multi-model routing: the loop serves named models, each in its own
`_ModelSlot` (own queue, own capacity-padded ModelBank, own latency
model); `submit(x, model=...)` routes by name. Slots may differ in
n_features, kind and K.

Zero-downtime hot-swap: every slot's bank is built at FIXED capacity
widths (`a_cap`/`u_cap`, see serve.predict.ModelBank), so an incoming
model is padded to the SAME shapes and installed with an in-place
`copy_` into the slot's existing tensors (and into its densified weight
stack, where the dense route built one). The JAX package donates the old
bank's buffers to a jitted install program and pins "zero recompiles";
the port pins what that protects here: every bank tensor keeps its
storage (`storage_ptrs()`) across warm-up, traffic and swaps, and no
kernel library is loaded after warm-up (`kernels.build.loaded()`).
Installs are applied BY THE SCHEDULER THREAD between flushes, and every
flush ends in a `.cpu()` that waits for the device, so a batch popped
before an install scores on the old weights, a batch popped after it on
the new ones, and `ServeResult.version` says which: no response sees a
torn read. The scheduler thread issues all of the loop's CUDA work after
warm-up, on its own current stream, which is the stream the kernel
wrappers launch on (`kernels.ops._stream`).

Warm start: construction runs every (slot, bucket) scorer twice before
the first request is admitted -- the first call loads the kernel library
and allocates, the second seeds the latency model. Dense-layout routes
are resolved per (slot, bucket) at warm-up (`route="auto"` consults
serve.predict.pick_route) and stay pinned across swaps.

Telemetry, as the JAX loop has it: with the metrics registry on, the
`serve.loop.*` counters (requests, rejects, responses, rows, pad_rows,
flush.<reason>, slo_violations, errors, quarantines, installs),
`serve.batch_retries`, `serve.batch_failures`, `serve.compiles` (in the
port: the first call of each (slot, bucket) at warm-up), the
`serve.queue_depth` gauge and the `serve.latency_s.bucket_<b>` and
`serve.e2e_latency_s` histograms; with the trace on, `serve.warmup`,
`serve.flush` and `serve.install` spans and `serve.quarantine` instants on
the `serve` track.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import sync
from repro_torch.kernels import build
from repro_torch.obs import Histogram
from repro_torch.serve.artifact import ModelFamily, pick_best_c
from repro_torch.serve.policy import (BucketPolicy, LatencyModel,
                                      default_buckets)
from repro_torch.serve.predict import ModelBank, margins_dense, pick_route

Tensor = torch.Tensor


class ServeOverload(RuntimeError):
    """Admission control refused the request: the queue is full."""


class SlotQuarantined(RuntimeError):
    """The model slot was quarantined after repeated batch failures;
    submits are refused until a hot-swap installs a fresh model."""


class SwapCapacityError(ValueError):
    """The incoming model does not fit the slot's fixed capacity shapes."""


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One scored request: its margins row plus full provenance."""

    id: int
    model: str
    margins: np.ndarray            # (K,) this slot's per-model margins
    version: int                   # bank version live at the batch's flush
    bucket: int
    flush_reason: str              # "full" | "deadline" | "drain"
    t_submit: float                # perf_counter seconds
    t_done: float

    @property
    def latency_s(self) -> float:
        """Admission-to-response latency (queue wait + compute)."""
        return self.t_done - self.t_submit


class ServeFuture:
    """Handle returned by submit(); result() blocks for the ServeResult."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"no response within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _set(self, result: ServeResult) -> None:
        self._result = result
        self._event.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


@dataclasses.dataclass
class _Pending:
    id: int
    x: np.ndarray
    t_submit: float
    deadline: float
    future: ServeFuture


@dataclasses.dataclass
class _SwapTicket:
    """swap() receipt: wait on `installed`, then read `version`."""

    model: str
    installed: threading.Event
    version: Optional[int] = None


class _ModelSlot:
    """One served model: queue + capacity bank + pinned routes + stats."""

    def __init__(self, name: str, bank: ModelBank):
        self.name = name
        self.bank = bank
        self.version = 1
        self.installs = 0
        self.latency = LatencyModel()
        self.routes: Dict[int, str] = {}       # bucket -> "sparse"|"dense"
        self.pending: deque = deque()
        self.rows = 0
        self.pad_rows = 0
        self.flushes = {"full": 0, "deadline": 0, "drain": 0}
        self.slo_violations = 0
        # batch-failure resilience
        self.retries = 0               # in-place batch retries that ran
        self.failed_batches = 0        # batches failed after the retry
        self.consecutive_failures = 0  # reset on success and on install
        self.quarantined = False
        self.e2e = Histogram()
        self.compute: Dict[int, Histogram] = {}

    def stats(self) -> dict:
        return {
            "version": self.version, "installs": self.installs,
            "rows": self.rows, "pad_rows": self.pad_rows,
            "queue_depth": len(self.pending),
            "flushes": dict(self.flushes),
            "slo_violations": self.slo_violations,
            "retries": self.retries,
            "failed_batches": self.failed_batches,
            "consecutive_failures": self.consecutive_failures,
            "quarantined": self.quarantined,
            "routes": {str(b): r for b, r in sorted(self.routes.items())},
            "e2e_p50_s": self.e2e.quantile(0.5),
            "e2e_p99_s": self.e2e.quantile(0.99),
            "compute_latency_s": {
                str(b): {"p50": h.quantile(0.5), "p99": h.quantile(0.99),
                         "calls": h.count}
                for b, h in sorted(self.compute.items())},
            "latency_model_s": self.latency.as_dict(),
        }


def _bank_capacity(family: ModelFamily, factor: float) -> tuple:
    """(a_cap, u_cap) for a family with `factor` growth headroom."""
    a_need = max(1, max(m.nnz for m in family.models))
    union = np.unique(np.concatenate(
        [m.w_indices for m in family.models] or [np.zeros(0, np.int64)]))
    u_need = max(1, int(union.shape[0]))
    return (int(np.ceil(factor * a_need)), int(np.ceil(factor * u_need)))


def _bank_storage(bank: ModelBank) -> tuple:
    """The bank's tensors, plus its densified stack where one was built."""
    W = getattr(bank, "_dense_w_cache", None)
    return bank.tensors() + (() if W is None else (W,))


class ServeLoop:
    """Deadline-aware continuous-batching server over named ModelBanks.

    `models`: a ModelBank / ModelFamily (served as "default") or a dict
    name -> bank-or-family. Families are built into capacity-padded banks
    on `device` with `capacity_factor` headroom so later hot-swaps fit;
    prebuilt banks are served at their existing shapes and device (swaps
    must fit them exactly). Construction warms every (slot, bucket)
    scorer, then starts the scheduler thread -- the loop is serving when
    __init__ returns. Use as a context manager or call stop() (which
    drains the queue) when done.
    """

    def __init__(self, models, *, buckets=None, max_batch: int = 64,
                 default_budget_s: float = 0.05,
                 safety_factor: float = 1.2, safety_s: float = 1e-3,
                 max_queue: Optional[int] = None, route: str = "sparse",
                 use_kernels: bool = False, capacity_factor: float = 2.0,
                 dtype=torch.float32, batch_retries: int = 1,
                 quarantine_after: Optional[int] = 3, device="cuda"):
        """batch_retries: bounded in-place retries of a failed batch
        compute before its futures are failed. quarantine_after: after
        this many CONSECUTIVE failed batches the slot is quarantined --
        further submits raise `SlotQuarantined` -- until a hot-swap
        installs a fresh model. None disables quarantine."""
        if route not in ("sparse", "dense", "auto"):
            raise ValueError(f"unknown route {route!r}")
        if batch_retries < 0:
            raise ValueError(f"batch_retries must be >= 0, "
                             f"got {batch_retries}")
        if quarantine_after is not None and quarantine_after < 1:
            raise ValueError(f"quarantine_after must be >= 1 or None, "
                             f"got {quarantine_after}")
        self.batch_retries = int(batch_retries)
        self.quarantine_after = (None if quarantine_after is None
                                 else int(quarantine_after))
        self.policy = BucketPolicy(
            buckets=tuple(buckets or default_buckets(max_batch)),
            layout="dense")
        self.default_budget_s = float(default_budget_s)
        self.safety_factor = float(safety_factor)
        self.safety_s = float(safety_s)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.route = route
        self.use_kernels = bool(use_kernels)

        if not isinstance(models, dict):
            models = {"default": models}
        if not models:
            raise ValueError("ServeLoop needs at least one model")
        self._slots: Dict[str, _ModelSlot] = {}
        for name, m in models.items():
            if isinstance(m, ModelFamily):
                a_cap, u_cap = _bank_capacity(m, capacity_factor)
                bank = ModelBank.from_family(m, dtype=dtype, a_cap=a_cap,
                                             u_cap=u_cap, device=device)
            elif isinstance(m, ModelBank):
                bank = m
            else:
                raise TypeError(f"model {name!r}: expected ModelBank or "
                                f"ModelFamily, got {type(m).__name__}")
            self._slots[name] = _ModelSlot(name, bank)

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._installs: deque = deque()
        self._stop = False
        self._depth = 0
        self._requests = 0
        self._rejects = 0
        self._responses = 0
        self._errors = 0
        self._next_id = 0

        self._warmup()
        self._libraries_at_warmup = build.loaded()
        self._thread = threading.Thread(target=self._scheduler,
                                        name="repro-torch-serve-loop",
                                        daemon=True)
        self._thread.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "ServeLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        """Drain the queue (pending requests flush as "drain") and join
        the scheduler thread. Idempotent; submits after stop raise."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread.is_alive():
            self._thread.join()

    # -- warm start ----------------------------------------------------------
    def _warmup(self) -> None:
        """Run every (slot, bucket) scorer twice so steady-state traffic
        (including across hot-swaps) loads no library and builds no
        densified stack; seed each slot's latency model with the second
        call's time."""
        t0_ns = time.perf_counter_ns()
        first_calls = 0
        for slot in self._slots.values():
            for bucket in self.policy.buckets:
                r = self.route
                if r == "auto":
                    r = pick_route(slot.bank.sparsity(), bucket)
                slot.routes[bucket] = r
                X = np.zeros((bucket, slot.bank.n_features), np.float32)
                self._margins(slot.bank, X, r)                # first call
                first_calls += 1
                t0 = time.perf_counter()
                self._margins(slot.bank, X, r)                # steady call
                slot.latency.observe(bucket, time.perf_counter() - t0)
        if obs.metrics_enabled():
            obs.inc("serve.compiles", first_calls)
        obs.complete("serve.warmup", "serve", t0_ns, time.perf_counter_ns(),
                     args={"compiles": first_calls,
                           "models": len(self._slots),
                           "buckets": list(self.policy.buckets)})

    def _margins(self, bank: ModelBank, X: np.ndarray,
                 route: str) -> np.ndarray:
        # the .cpu() waits for the device: a flush's margins are final
        # before its futures resolve or an install may touch the bank
        return margins_dense(bank, X, use_kernels=self.use_kernels,
                             route=route).cpu().numpy()

    # -- request plane -------------------------------------------------------
    def _resolve(self, model: Optional[str]) -> str:
        if model is None:
            if len(self._slots) == 1:
                return next(iter(self._slots))
            raise ValueError(f"loop serves {sorted(self._slots)}; "
                             f"pick one with model=...")
        if model not in self._slots:
            raise KeyError(f"unknown model {model!r} "
                           f"(serving {sorted(self._slots)})")
        return model

    def submit(self, x, model: Optional[str] = None,
               budget_s: Optional[float] = None) -> ServeFuture:
        """Admit one request row; returns a future for its ServeResult.

        Raises ServeOverload when `max_queue` requests are already pending
        (open-loop admission control -- the caller sheds load).
        """
        name = self._resolve(model)
        slot = self._slots[name]
        x = np.asarray(x, np.float32).reshape(-1)
        if x.shape[0] != slot.bank.n_features:
            raise ValueError(f"request has {x.shape[0]} features, model "
                             f"{name!r} has {slot.bank.n_features}")
        budget = self.default_budget_s if budget_s is None else float(budget_s)
        fut = ServeFuture()
        now = time.perf_counter()
        with self._work:
            if self._stop:
                raise RuntimeError("ServeLoop is stopped")
            if slot.quarantined:
                raise SlotQuarantined(
                    f"model {name!r} is quarantined after "
                    f"{slot.consecutive_failures} consecutive batch "
                    f"failures; hot-swap a fresh model (swap()) to "
                    f"restore it")
            if self.max_queue is not None and self._depth >= self.max_queue:
                self._rejects += 1
                if obs.metrics_enabled():
                    obs.inc("serve.loop.rejects")
                raise ServeOverload(
                    f"queue full ({self._depth}/{self.max_queue})")
            self._next_id += 1
            slot.pending.append(_Pending(self._next_id, x, now,
                                         now + budget, fut))
            self._depth += 1
            self._requests += 1
            if obs.metrics_enabled():
                obs.inc("serve.loop.requests")
                obs.set_gauge("serve.queue_depth", self._depth)
            self._work.notify()
        return fut

    def submit_many(self, X, model: Optional[str] = None,
                    budget_s: Optional[float] = None) -> list:
        return [self.submit(x, model=model, budget_s=budget_s) for x in X]

    # -- model plane ---------------------------------------------------------
    def models(self) -> tuple:
        return tuple(sorted(self._slots))

    def bank(self, model: Optional[str] = None) -> ModelBank:
        return self._slots[self._resolve(model)].bank

    def version(self, model: Optional[str] = None) -> int:
        with self._lock:
            return self._slots[self._resolve(model)].version

    def storage_ptrs(self) -> dict:
        """name -> data_ptr of every bank tensor (and of the densified
        stack where one was built): constant across swaps."""
        with self._lock:
            return {name: tuple(t.data_ptr() for t in
                                _bank_storage(slot.bank))
                    for name, slot in sorted(self._slots.items())}

    def libraries_loaded_since_warmup(self) -> tuple:
        """Kernel libraries loaded into the process after warm-up: () for
        a loop whose traffic and swaps ran on warmed kernels."""
        return build.loaded()[len(self._libraries_at_warmup):]

    def swap(self, model_or_name=None, model=None,
             metric: str = "val_accuracy") -> _SwapTicket:
        """Queue a zero-downtime model install; returns a _SwapTicket.

        `model` is a ModelFamily (a kind="path" family is reduced to its
        best-c member via pick_best_c(metric=...) first) or a prebuilt
        ModelBank at the slot's exact shapes. The install is applied by
        the scheduler thread between flushes: batches popped before it
        score on the old weights, batches popped after on the new ones,
        and `ServeResult.version` records which. Wait on
        ticket.installed to synchronize. Raises SwapCapacityError when
        the incoming model does not fit the slot's capacity shapes.
        """
        if model is None:           # single-model convenience: swap(family)
            model, model_or_name = model_or_name, None
        name = self._resolve(model_or_name)
        slot = self._slots[name]
        if isinstance(model, ModelFamily):
            if model.kind == "path":
                _, best = pick_best_c(model, metric=metric)
                model = ModelFamily(kind="binary", models=(best,),
                                    provenance=model.provenance)
            try:
                new_bank = ModelBank.from_family(
                    model, dtype=slot.bank.val.dtype,
                    a_cap=slot.bank.a_max,
                    u_cap=int(slot.bank.union_idx.shape[0]),
                    device=slot.bank.device)
            except ValueError as e:
                raise SwapCapacityError(str(e)) from None
        elif isinstance(model, ModelBank):
            new_bank = model
        else:
            raise TypeError(f"swap expects ModelFamily or ModelBank, got "
                            f"{type(model).__name__}")
        old = slot.bank
        same = (new_bank.n_models == old.n_models
                and new_bank.n_features == old.n_features
                and new_bank.idx.shape == old.idx.shape
                and new_bank.union_idx.shape == old.union_idx.shape
                and new_bank.val.dtype == old.val.dtype
                and new_bank.device == old.device)
        if not same:
            raise SwapCapacityError(
                f"incoming bank shapes (K={new_bank.n_models}, "
                f"n={new_bank.n_features}, idx={tuple(new_bank.idx.shape)}, "
                f"union={tuple(new_bank.union_idx.shape)}, "
                f"{new_bank.val.dtype}, {new_bank.device}) do not match "
                f"slot {name!r} (K={old.n_models}, n={old.n_features}, "
                f"idx={tuple(old.idx.shape)}, "
                f"union={tuple(old.union_idx.shape)}, {old.val.dtype}, "
                f"{old.device})")
        if getattr(old, "_dense_w_cache", None) is not None:
            new_bank.dense_matrix()     # prebuild off the scheduler thread
        new_bank.sparsity()
        # the incoming tensors are complete before another thread reads
        # them, whatever stream this thread issued their copies on
        sync(new_bank.bias)
        ticket = _SwapTicket(model=name, installed=threading.Event())
        with self._work:
            if self._stop:
                raise RuntimeError("ServeLoop is stopped")
            self._installs.append((name, new_bank, ticket))
            self._work.notify()
        return ticket

    # -- scheduler thread ----------------------------------------------------
    def _scheduler(self) -> None:
        while True:
            chunk = None
            with self._work:
                while True:
                    self._apply_installs_locked()
                    now = time.perf_counter()
                    choice, wait_s = self._next_action_locked(now)
                    if choice is not None:
                        chunk = self._pop_locked(*choice)
                        break
                    if self._stop:
                        self._apply_installs_locked()
                        return
                    self._work.wait(wait_s)
            self._score(*chunk)

    def _next_action_locked(self, now: float):
        """(slot, take, reason) ready to flush, or (None, wait_seconds)."""
        ready = None
        ready_at = None
        soonest = None
        maxb = self.policy.max_bucket
        for slot in self._slots.values():
            r = len(slot.pending)
            if r == 0:
                continue
            if self._stop:
                return (slot, min(r, maxb), "drain"), None
            if r >= maxb:
                at, take, reason = now, maxb, "full"
            else:
                bucket = self.policy.bucket_for(r)
                est = slot.latency.estimate(bucket) * self.safety_factor \
                    + self.safety_s
                at, take, reason = slot.pending[0].deadline - est, r, \
                    "deadline"
            if at <= now:
                if ready is None or at < ready_at:
                    ready, ready_at = (slot, take, reason), at
            elif soonest is None or at < soonest:
                soonest = at
        if ready is not None:
            return ready, None
        return None, (None if soonest is None else max(soonest - now, 0.0))

    def _pop_locked(self, slot: _ModelSlot, take: int, reason: str):
        reqs = [slot.pending.popleft() for _ in range(take)]
        self._depth -= take
        if obs.metrics_enabled():
            obs.set_gauge("serve.queue_depth", self._depth)
        # the version snapshot: installs also run on the scheduler thread,
        # so this batch's compute happens-before any later install
        return slot, reqs, reason, slot.version

    def _score(self, slot: _ModelSlot, reqs, reason: str,
               version: int) -> None:
        bucket = self.policy.bucket_for(len(reqs))
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        z = err = None
        for attempt in range(1 + self.batch_retries):
            try:
                X = self.policy.pad_dense(np.stack([p.x for p in reqs]),
                                          bucket)
                z = self._margins(slot.bank, X, slot.routes[bucket])
                err = None
                break
            except Exception as e:      # bounded in-place retry first
                err = e
                if attempt < self.batch_retries:
                    with self._lock:
                        slot.retries += 1
                    if obs.metrics_enabled():
                        obs.inc("serve.batch_retries")
        if err is not None:                     # serve on: fail the batch
            with self._lock:
                self._errors += len(reqs)
                slot.failed_batches += 1
                slot.consecutive_failures += 1
                if (self.quarantine_after is not None
                        and slot.consecutive_failures
                        >= self.quarantine_after
                        and not slot.quarantined):
                    slot.quarantined = True
                    if obs.metrics_enabled():
                        obs.inc("serve.loop.quarantines")
                    obs.instant("serve.quarantine", "serve",
                                args={"model": slot.name,
                                      "failures":
                                      slot.consecutive_failures})
            if obs.metrics_enabled():
                obs.inc("serve.loop.errors", len(reqs))
                obs.inc("serve.batch_failures")
            for p in reqs:
                p.future._set_error(err)
            return
        t_done = time.perf_counter()
        dt = t_done - t0
        with self._lock:
            slot.consecutive_failures = 0
            slot.latency.observe(bucket, dt)
            slot.rows += len(reqs)
            slot.pad_rows += bucket - len(reqs)
            slot.flushes[reason] += 1
            hist = slot.compute.get(bucket)
            if hist is None:
                hist = slot.compute[bucket] = Histogram()
            hist.observe(dt)
            self._responses += len(reqs)
            late = sum(1 for p in reqs if t_done > p.deadline)
            slot.slo_violations += late
            for p in reqs:
                slot.e2e.observe(t_done - p.t_submit)
        if obs.metrics_enabled():
            obs.inc("serve.loop.responses", len(reqs))
            obs.inc("serve.loop.rows", len(reqs))
            obs.inc("serve.loop.pad_rows", bucket - len(reqs))
            obs.inc(f"serve.loop.flush.{reason}")
            if late:
                obs.inc("serve.loop.slo_violations", late)
            obs.observe(f"serve.latency_s.bucket_{bucket}", dt)
            for p in reqs:
                obs.observe("serve.e2e_latency_s", t_done - p.t_submit)
        obs.complete("serve.flush", "serve", t0_ns, time.perf_counter_ns(),
                     args={"model": slot.name, "bucket": bucket,
                           "rows": len(reqs), "pad_rows": bucket - len(reqs),
                           "reason": reason, "version": version})
        for i, p in enumerate(reqs):
            p.future._set(ServeResult(
                id=p.id, model=slot.name, margins=z[i], version=version,
                bucket=bucket, flush_reason=reason, t_submit=p.t_submit,
                t_done=t_done))

    def _apply_installs_locked(self) -> None:
        while self._installs:
            name, new_bank, ticket = self._installs.popleft()
            slot = self._slots[name]
            t0_ns = time.perf_counter_ns()
            dst = slot.bank
            for d, s in zip(dst.tensors(), new_bank.tensors()):
                d.copy_(s)
            W = getattr(dst, "_dense_w_cache", None)
            if W is not None:
                W.copy_(new_bank.dense_matrix())
            object.__setattr__(dst, "_sparsity_cache", new_bank.sparsity())
            sync(dst.bias)
            slot.version += 1
            slot.installs += 1
            # a fresh model clears the failure streak and any quarantine
            slot.consecutive_failures = 0
            slot.quarantined = False
            ticket.version = slot.version
            if obs.metrics_enabled():
                obs.inc("serve.loop.installs")
            obs.complete("serve.install", "serve", t0_ns,
                         time.perf_counter_ns(),
                         args={"model": name, "version": slot.version})
            ticket.installed.set()

    # -- accounting ----------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self.policy.buckets),
                "route": self.route,
                "use_kernels": self.use_kernels,
                "default_budget_s": self.default_budget_s,
                "max_queue": self.max_queue,
                "requests": self._requests,
                "responses": self._responses,
                "rejects": self._rejects,
                "errors": self._errors,
                "queue_depth": self._depth,
                "libraries_loaded_since_warmup":
                    list(self.libraries_loaded_since_warmup()),
                "models": {name: slot.stats()
                           for name, slot in sorted(self._slots.items())},
            }


def drive_poisson(loop: ServeLoop, X, rate_rps: float, n_requests: int,
                  model: Optional[str] = None,
                  budget_s: Optional[float] = None, seed: int = 0,
                  timeout_s: float = 60.0) -> dict:
    """Open-loop Poisson load: submit `n_requests` rows of X (cycled) at
    exponential inter-arrival gaps of mean 1/rate_rps, never waiting for
    responses (overdue arrivals are submitted immediately and the
    generator lag reported -- offered load, not achieved throughput).
    Returns the results plus latency quantiles at the MEASURED offered
    rate; `generator_lag_at_s` is the time into the run at which the
    largest lag was seen.
    """
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    X = np.asarray(X, np.float32)
    arrive = np.cumsum(np.random.default_rng(seed).exponential(
        1.0 / rate_rps, size=n_requests))
    futures = []
    rejects = 0
    max_lag = lag_at = 0.0
    t0 = time.perf_counter()
    for i in range(n_requests):
        target = t0 + arrive[i]
        now = time.perf_counter()
        if now < target:
            time.sleep(target - now)
        elif now - target > max_lag:
            max_lag, lag_at = now - target, now - t0
        try:
            futures.append(loop.submit(X[i % X.shape[0]], model=model,
                                       budget_s=budget_s))
        except ServeOverload:
            rejects += 1
    t_end = time.perf_counter()
    results = [f.result(timeout=timeout_s) for f in futures]
    lat = np.asarray([r.latency_s for r in results]) if results else \
        np.zeros((0,))
    return {
        "target_rps": float(rate_rps),
        "offered_rps": n_requests / max(t_end - t0, 1e-9),
        "n_requests": n_requests,
        "responses": len(results),
        "rejects": rejects,
        "generator_lag_s": max_lag,
        "generator_lag_at_s": lag_at,
        "p50_s": float(np.percentile(lat, 50)) if lat.size else None,
        "p99_s": float(np.percentile(lat, 99)) if lat.size else None,
        "max_s": float(lat.max()) if lat.size else None,
        "results": results,
    }
