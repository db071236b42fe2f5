"""Process-wide metrics registry of the port (copy of `repro.obs.registry`).

Counters, gauges and fixed-bucket histograms for the host-side control
plane: the engine's outer loop, the path sweep, the serving batcher and
loop, and the kernel dispatchers' launch counts. Device-side solver
signals (per-bundle alpha and backtrack depth q) ride the outer
iteration's aux output (`PCDNConfig.record_aux`) and are folded into the
registry at the engine's per-iteration host sync.

Cost contract: disabled (the default), every module-level helper is one
boolean check and an immediate return. Enabled, a counter inc is one dict
lookup and a float add; a histogram observe is a bisect into a static
bound list. No locks: the solver loop is single-threaded on the host and
the serving loop records from its scheduler thread.

`enable()` / `disable()` switch it (the `--metrics-out` flag calls
enable); REPRO_METRICS=off force-disables it even when code calls
enable(). Histograms are fixed-bucket, so a snapshot is O(#buckets) JSON;
`Histogram.quantile` interpolates p50/p99 from the bucket counts, with
exact min/max/sum/count alongside. The serving batcher and loop also keep
private histograms (always on) for their own stats.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import time
from typing import Dict, Optional, Sequence

from repro_torch.obs import gate

# default latency bounds: 1us .. ~100s, quarter-decade log spacing
LATENCY_BOUNDS_S = tuple(
    10.0 ** (e / 4.0) for e in range(-24, 9))
# Armijo backtrack depth q^t: small integers (paper Table 4: mean ~ 1)
Q_BOUNDS = tuple(float(v) for v in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40))
# accepted step size alpha = beta^q in (0, 1]
ALPHA_BOUNDS = tuple(0.5 ** e for e in range(12, -1, -1))


class Histogram:
    """Fixed-bucket histogram: counts[i] = #observations <= bounds[i],
    counts[-1] = overflow. Exact sum/count/min/max on the side."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float] = LATENCY_BOUNDS_S):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"bounds must be strictly increasing: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    def merge(self, other: "Histogram") -> None:
        """Add another histogram's observations (same bounds: exact)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with other bounds")
        self.counts = [a + c for a, c in zip(self.counts, other.counts)]
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile estimate from the bucket counts; exact
        at the tracked min/max endpoints."""
        if not self.count:
            return None
        if q <= 0:
            return self.vmin
        if q >= 1:
            return self.vmax
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                frac = (rank - seen) / c if c else 0.0
                return lo + frac * (hi - lo)
            seen += c
        return self.vmax

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": None if self.count == 0 else self.vmin,
            "max": None if self.count == 0 else self.vmax,
            "mean": self.mean,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
            "bounds": list(self.bounds),
            "counts": list(self.counts),
        }


class Registry:
    """A bag of named counters / gauges / histograms."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, Histogram] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def histogram(self, name: str,
                  bounds: Sequence[float] = LATENCY_BOUNDS_S) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds)
        return h

    def observe(self, name: str, value: float,
                bounds: Sequence[float] = LATENCY_BOUNDS_S) -> None:
        self.histogram(name, bounds).observe(value)

    def observe_many(self, name: str, values,
                     bounds: Sequence[float] = LATENCY_BOUNDS_S) -> None:
        self.histogram(name, bounds).observe_many(values)

    @property
    def empty(self) -> bool:
        return not (self.counters or self.gauges or self.histograms)

    def snapshot(self) -> dict:
        """JSON-ready view of everything recorded so far."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self.histograms.items())},
        }

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


# ---------------------------------------------------------------------------
# module-level default registry + the zero-cost gate

_registry = Registry()
_enabled = False


def env_force_off() -> bool:
    """REPRO_METRICS=off/0/false/no force-disables the registry even when
    code calls enable()."""
    return os.environ.get("REPRO_METRICS", "").strip().lower() in (
        "0", "off", "false", "no")


def enable() -> bool:
    """Turn the default registry on (no-op under REPRO_METRICS=off).
    Returns the resulting enabled state."""
    global _enabled
    _enabled = not env_force_off()
    gate.refresh()
    return _enabled


def disable() -> None:
    global _enabled
    _enabled = False
    gate.refresh()


def enabled() -> bool:
    return _enabled


def get_registry() -> Registry:
    return _registry


def reset() -> None:
    _registry.reset()


# The hot-path helpers: ONE boolean check when disabled. Instrumented
# code calls these, never the Registry methods directly.

def inc(name: str, value: float = 1.0) -> None:
    if _enabled:
        _registry.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    if _enabled:
        _registry.set_gauge(name, value)


def observe(name: str, value: float,
            bounds: Sequence[float] = LATENCY_BOUNDS_S) -> None:
    if _enabled:
        _registry.observe(name, value, bounds)


def observe_many(name: str, values,
                 bounds: Sequence[float] = LATENCY_BOUNDS_S) -> None:
    if _enabled:
        _registry.observe_many(name, values, bounds)


def write_metrics(path: str, meta: Optional[dict] = None) -> dict:
    """Append one JSONL run record: {ts, meta..., metrics: snapshot}."""
    record = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
              **(meta or {}),
              "metrics": _registry.snapshot()}
    with open(path, "a") as fh:
        fh.write(json.dumps(record, default=float) + "\n")
    return record
