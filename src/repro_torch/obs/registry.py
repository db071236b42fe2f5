"""Fixed-bucket latency histogram (copy of `repro.obs.registry.Histogram`).

The serving batcher and loop keep one per bucket (and one for admission-to-
response latency) and report p50/p99 from it. A histogram observe is one
bisect into a static bound list, so it is always on. The process-wide
registry of counters, gauges and spans, and its trace export, belong to the
port's obs slice.
"""
from __future__ import annotations

import bisect
import math
from typing import Optional, Sequence

# default latency bounds: 1us .. ~100s, quarter-decade log spacing
LATENCY_BOUNDS_S = tuple(
    10.0 ** (e / 4.0) for e in range(-24, 9))


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
