"""Telemetry of the port (copy of `repro.obs`).

Two data planes, one enable story:

  * `repro_torch.obs.registry` -- process-wide metrics (counters, gauges,
    fixed-bucket histograms) for the host-side control plane. One boolean
    check when disabled.
  * `repro_torch.obs.trace`    -- Chrome-trace / Perfetto trace-event
    writer with span helpers ("X" complete events on named tracks) and a
    schema validator.

Device-side solver signals (per-bundle accepted alpha and backtrack depth
q) do not go through host callbacks: the outer iteration returns them as
extra device tensors behind `PCDNConfig.record_aux` -- on the support
scope with the kernels, the (b,) step counts and alphas K1 writes -- and
the engine's host loop folds them into `SolveHistory` (and, when the
registry is on, into histograms) at the per-iteration sync it already
performs. With `record_aux=False` the outer iteration launches exactly
what the uninstrumented solver launches.

Facade: `obs.enable(metrics=..., trace_=...)` switches both planes; the
module-level helpers (`inc`, `observe`, `span`, ...) proxy to the
respective plane's zero-cost gate.
"""
from __future__ import annotations

from repro_torch.obs import registry, trace
from repro_torch.obs.registry import (ALPHA_BOUNDS, LATENCY_BOUNDS_S,
                                      Q_BOUNDS, Histogram, Registry,
                                      get_registry, inc, observe,
                                      observe_many, set_gauge,
                                      write_metrics)
from repro_torch.obs.trace import (TraceWriter, complete, counter, instant,
                                   span, validate_trace, validate_trace_file)

__all__ = [
    "registry", "trace", "Registry", "Histogram", "TraceWriter",
    "LATENCY_BOUNDS_S", "Q_BOUNDS", "ALPHA_BOUNDS",
    "inc", "observe", "observe_many", "set_gauge", "write_metrics",
    "span", "complete", "instant", "counter",
    "validate_trace", "validate_trace_file",
    "enable", "disable", "metrics_enabled", "trace_enabled",
]


def enable(metrics: bool = True, trace_: bool = False,
           process_name: str = "repro_torch") -> None:
    """Switch the telemetry planes on. REPRO_METRICS=off still wins for
    the metrics plane (registry.env_force_off)."""
    if metrics:
        registry.enable()
    if trace_:
        trace.enable(process_name)


def disable() -> None:
    registry.disable()
    trace.disable()


def metrics_enabled() -> bool:
    return registry.enabled()


def trace_enabled() -> bool:
    return trace.enabled()
