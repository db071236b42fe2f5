"""Chrome-trace / Perfetto trace-event writer (copy of `repro.obs.trace`).

Emits the JSON Object Format of the Trace Event specification --
``{"traceEvents": [...]}`` with complete ("X"), instant ("i"), counter
("C") and metadata ("M") events -- which both ``chrome://tracing`` and
https://ui.perfetto.dev load directly.

Schema subset we emit (and `validate_trace` enforces):

  * every event: ``name`` (str), ``ph`` (one of X/i/C/M), ``ts``
    (microseconds, float, >= 0), ``pid``/``tid`` (ints);
  * "X" events additionally carry ``dur`` (microseconds, >= 0);
  * on one (pid, tid) track, "X" spans are properly nested -- a span
    either encloses another or is disjoint from it; partial overlap is
    a writer bug (it renders as garbage in Perfetto) and validation
    fails on it.

Tracks are named ("engine", "serve", "kernels", "path"): each maps to a
stable tid plus a thread_name metadata event, so Perfetto shows labeled
rows. Span timing uses `time.perf_counter_ns` rebased to the writer's
construction, so ts stays small and float-exact.

Cost contract: module-level `span(...)` returns a shared no-op context
manager when tracing is disabled -- one predicate call, no allocation.
Spans measure HOST time. Around CUDA work, which the host only enqueues,
a span measures the enqueue unless the caller waits for the device: the
engine loop, the path sweep and the serving batcher and loop all wait at
their harvest points, so their spans are true durations; the kernel
dispatchers' `kernels.<name>` spans are enqueue time.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from repro_torch.obs import gate

_PID = os.getpid()


class _NullSpan:
    """Shared disabled-path context manager: enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("writer", "name", "tid", "args", "t0")

    def __init__(self, writer: "TraceWriter", name: str, tid: int, args):
        self.writer = writer
        self.name = name
        self.tid = tid
        self.args = args
        self.t0 = 0

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.writer._complete_ns(self.name, self.tid, self.t0,
                                 time.perf_counter_ns(), self.args)
        return False


class TraceWriter:
    """Collects trace events in memory; `save` writes the JSON file."""

    def __init__(self, process_name: str = "repro_torch"):
        self.events: list = []
        self._t0_ns = time.perf_counter_ns()
        self._tids: dict = {}
        self.events.append({
            "name": "process_name", "ph": "M", "ts": 0.0, "pid": _PID,
            "tid": 0, "args": {"name": process_name}})

    # -- track bookkeeping ---------------------------------------------------
    def track(self, name: str) -> int:
        tid = self._tids.get(name)
        if tid is None:
            tid = self._tids[name] = len(self._tids) + 1
            self.events.append({
                "name": "thread_name", "ph": "M", "ts": 0.0, "pid": _PID,
                "tid": tid, "args": {"name": name}})
        return tid

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._t0_ns) / 1e3

    # -- events --------------------------------------------------------------
    def span(self, name: str, track: str = "main",
             args: Optional[dict] = None) -> _Span:
        return _Span(self, name, self.track(track), args)

    def _complete_ns(self, name: str, tid: int, t0_ns: int, t1_ns: int,
                     args: Optional[dict]) -> None:
        ev = {"name": name, "ph": "X", "ts": self._us(t0_ns),
              "dur": max((t1_ns - t0_ns) / 1e3, 0.0), "pid": _PID,
              "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def complete(self, name: str, track: str, t0_ns: int, t1_ns: int,
                 args: Optional[dict] = None) -> None:
        """Record a finished span from explicit perf_counter_ns stamps --
        for callers that already timestamp (the engine loop), so the
        span matches their recorded wall clock exactly."""
        self._complete_ns(name, self.track(track), t0_ns, t1_ns, args)

    def instant(self, name: str, track: str = "main",
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": self._us(time.perf_counter_ns()),
              "pid": _PID, "tid": self.track(track), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, value: float, track: str = "main") -> None:
        self.events.append({
            "name": name, "ph": "C",
            "ts": self._us(time.perf_counter_ns()), "pid": _PID,
            "tid": self.track(track), "args": {"value": float(value)}})

    # -- output --------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, default=float)


# ---------------------------------------------------------------------------
# module-level default tracer + the zero-cost gate

_tracer: Optional[TraceWriter] = None


def enable(process_name: str = "repro_torch") -> TraceWriter:
    """Install (and return) a fresh default tracer."""
    global _tracer
    _tracer = TraceWriter(process_name)
    gate.refresh()
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None
    gate.refresh()


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[TraceWriter]:
    return _tracer


def span(name: str, track: str = "main", args: Optional[dict] = None):
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, track, args)


def complete(name: str, track: str, t0_ns: int, t1_ns: int,
             args: Optional[dict] = None) -> None:
    t = _tracer
    if t is not None:
        t.complete(name, track, t0_ns, t1_ns, args)


def instant(name: str, track: str = "main",
            args: Optional[dict] = None) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, track, args)


def counter(name: str, value: float, track: str = "main") -> None:
    t = _tracer
    if t is not None:
        t.counter(name, value, track)


def save(path: str) -> bool:
    """Save and clear the default tracer. Returns False if none active."""
    global _tracer
    if _tracer is None:
        return False
    _tracer.save(path)
    _tracer = None
    gate.refresh()
    return True


# ---------------------------------------------------------------------------
# schema validation (the CI gate; also used by the tests and chip_smoke.py)

_PHASES = {"X", "i", "C", "M"}


def validate_trace(obj) -> int:
    """Assert `obj` is valid trace-event JSON per the module contract.

    Returns the number of events checked; raises ValueError with a
    pointed message on the first violation. Checks: top-level shape,
    required fields and types per event, non-negative ts/dur, and
    proper nesting (no partial overlap) of "X" spans per (pid, tid)
    track.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event JSON object "
                         "(missing 'traceEvents')")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    spans: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}) missing "
                                 f"required field {field!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has invalid ts {ev['ts']!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"span event {i} ({ev['name']!r}) has "
                                 f"invalid dur {dur!r}")
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(dur), ev["name"]))
    # proper nesting per track: sweep spans by (start, -end); each span
    # must fit inside the innermost open ancestor.
    for track, ss in spans.items():
        ss.sort(key=lambda t: (t[0], -t[1]))
        stack: list = []
        for t0, t1, name in ss:
            while stack and stack[-1][1] <= t0:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                raise ValueError(
                    f"track {track}: span {name!r} [{t0}, {t1}] partially "
                    f"overlaps {stack[-1][2]!r} [{stack[-1][0]}, "
                    f"{stack[-1][1]}] -- same-track spans must nest or be "
                    f"disjoint")
            stack.append((t0, t1, name))
    return len(events)


def validate_trace_file(path: str) -> int:
    with open(path) as fh:
        return validate_trace(json.load(fh))
