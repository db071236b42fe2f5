"""Microbatching front-end: bucket-padded request batches.

Port of `repro.serve.batcher`. A pending chunk of r requests is padded
with empty rows up to the smallest bucket >= r (`serve.policy.
BucketPolicy`, shared with `serve.loop.ServeLoop`). The JAX package
buckets so that XLA compiles once per shape; the port compiles nothing,
and the first call per bucket is its "warm-up" because it pays the
first-use costs instead: the kernel library's load (and build, on a fresh
checkout), the allocator's first blocks. Its time is kept apart from the
steady-state figures.

`route` picks the dense-layout scorer ("sparse" union-gather, "dense"
densified matmul, or "auto" -- see serve.predict.pick_route).

Two request layouts:

  * "dense":      requests are (B, n) float rows; padding appends zero
                  rows (their margins are computed and discarded).
  * "padded_csc": requests arrive as a CSRMatrix (row-major sparse); each
                  bucket chunk is packed into the feature-major padded-CSC
                  layout at its own column width (its largest column
                  nnz), or at a fixed `k_max` when one is given; a chunk
                  whose column nnz overflows a fixed `k_max` raises.

Per bucket the batcher accounts calls, rows, padding, warm-up (first
call) latency and steady-state latency, and keeps a fixed-bucket latency
histogram of its steady-state calls, so `stats()` reports p50/p99 per
bucket. Margins come back to the host with `.cpu()`, which waits for the
device, so the timings are of finished work. The obs counters and spans
the JAX batcher also emits wait for the port's obs slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs import Histogram
from repro_torch.serve.policy import BucketPolicy, default_buckets
from repro_torch.serve.predict import (ModelBank, margins_dense,
                                       margins_padded_csc)


@dataclasses.dataclass
class BucketStats:
    bucket: int
    calls: int = 0                 # total engine invocations at this shape
    rows: int = 0                  # real (unpadded) requests served
    pad_rows: int = 0              # padding rows computed and discarded
    warmup_rows: int = 0           # real rows of the first call
    warmup_seconds: float = 0.0    # first call (first kernel load)
    busy_seconds: float = 0.0      # steady-state time after warm-up
    # steady-state per-call latency distribution (warm-up excluded)
    latency: Histogram = dataclasses.field(default_factory=Histogram)

    @property
    def warm_calls(self) -> int:
        return max(self.calls - 1, 0)

    @property
    def rows_per_s(self) -> Optional[float]:
        """Steady-state REQUEST throughput: real rows only -- padding is
        engine work, not served traffic. None until a bucket has warm
        calls."""
        if self.warm_calls == 0 or self.busy_seconds <= 0:
            return None
        return (self.rows - self.warmup_rows) / self.busy_seconds

    def as_dict(self) -> dict:
        return {"bucket": self.bucket, "calls": self.calls,
                "rows": self.rows, "pad_rows": self.pad_rows,
                "warmup_rows": self.warmup_rows,
                "warmup_seconds": self.warmup_seconds,
                "busy_seconds": self.busy_seconds,
                "rows_per_s": self.rows_per_s,
                "latency_p50_s": self.latency.quantile(0.5),
                "latency_p99_s": self.latency.quantile(0.99)}


class MicroBatcher:
    """Pads request batches to bucket shapes and scores them on a bank."""

    def __init__(self, bank: ModelBank, buckets: Sequence[int] = None,
                 layout: str = "dense", use_kernels: bool = False,
                 k_max: Optional[int] = None, max_batch: int = 64,
                 route: str = "sparse"):
        self.policy = BucketPolicy(
            buckets=tuple(buckets or default_buckets(max_batch)),
            layout=layout, k_max=k_max)
        self.bank = bank
        self.use_kernels = use_kernels
        self.route = route
        self._stats = {b: BucketStats(bucket=b) for b in self.buckets}

    @property
    def layout(self) -> str:
        return self.policy.layout

    @property
    def k_max(self) -> Optional[int]:
        return self.policy.k_max

    @property
    def buckets(self) -> tuple:
        return self.policy.buckets

    @property
    def max_bucket(self) -> int:
        return self.policy.max_bucket

    def bucket_for(self, r: int) -> int:
        """Smallest bucket >= r (r must not exceed the largest bucket)."""
        return self.policy.bucket_for(r)

    # -- request plumbing ----------------------------------------------------
    def predict(self, requests) -> np.ndarray:
        """Score any number of requests -> (B, K) numpy margins.

        dense layout: (B, n) array rows. padded_csc layout: a CSRMatrix.
        Oversized inputs are split into max-bucket chunks; the ragged tail
        is padded up to its bucket.
        """
        n_req = (requests.shape[0] if hasattr(requests, "shape")
                 else len(requests))
        out = []
        start = 0
        while start < n_req:
            stop = min(start + self.max_bucket, n_req)
            out.append(self._run_chunk(requests, start, stop))
            start = stop
        return np.concatenate(out, axis=0) if out else \
            np.zeros((0, self.bank.n_models), np.float32)

    def _run_chunk(self, requests, start: int, stop: int) -> np.ndarray:
        r = stop - start
        bucket = self.bucket_for(r)
        if self.layout == "dense":
            X = np.asarray(requests[start:stop], np.float32)
            if X.shape[1] != self.bank.n_features:
                raise ValueError(f"requests have {X.shape[1]} features, "
                                 f"bank has {self.bank.n_features}")
            X = self.policy.pad_dense(X, bucket)

            def run():
                return margins_dense(self.bank, X,
                                     use_kernels=self.use_kernels,
                                     route=self.route)
        else:
            packed = self.policy.pack_csc(requests, start, stop, bucket,
                                          self.bank.n_features,
                                          device=self.bank.device)

            def run():
                return margins_padded_csc(self.bank, packed,
                                          use_kernels=self.use_kernels)
        st = self._stats[bucket]
        t0 = time.perf_counter()
        z = run().cpu().numpy()        # waits until the device is done
        dt = time.perf_counter() - t0
        if st.calls > 0:
            st.busy_seconds += dt
            st.latency.observe(dt)
        else:
            st.warmup_seconds += dt
            st.warmup_rows = r
        st.calls += 1
        st.rows += r
        st.pad_rows += bucket - r
        return z[:r]

    # -- accounting ----------------------------------------------------------
    def stats(self) -> dict:
        per_bucket = [self._stats[b].as_dict() for b in self.buckets
                      if self._stats[b].calls]
        rows = sum(s["rows"] for s in per_bucket)
        busy = sum(s["busy_seconds"] for s in per_bucket)
        # real served requests only -- padding is engine overhead
        warm_rows = sum(s["rows"] - s["warmup_rows"] for s in per_bucket)
        # batcher-wide steady-state latency: merge the per-bucket
        # histograms (same fixed bounds, so counts add exactly)
        agg = Histogram()
        for b in self.buckets:
            if self._stats[b].latency.count:
                agg.merge(self._stats[b].latency)
        return {
            "layout": self.layout,
            "use_kernels": self.use_kernels,
            "route": self.route,
            "buckets": per_bucket,
            "total_rows": rows,
            "calls": sum(s["calls"] for s in per_bucket),
            "warmup_calls": len(per_bucket),   # one first call per bucket
            "steady_rows_per_s": (warm_rows / busy) if busy > 0 else None,
            "latency_p50_s": agg.quantile(0.5),
            "latency_p99_s": agg.quantile(0.99),
        }
