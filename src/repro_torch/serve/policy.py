"""Bucket policy: the shape quantization of serving, and the latency model.

Port of `repro.serve.policy`. Both serving fronts -- the synchronous
`serve.batcher.MicroBatcher` and the continuous-batching
`serve.loop.ServeLoop` -- pad request batches to a small fixed set of
bucket sizes. XLA needs that to compile one program per shape; PyTorch
compiles nothing, but the fixed shapes still bound the set of launch
geometries, keep every request of a bucket on one scorer route, and make
a bucket's latency estimate meaningful. This module owns that shared
geometry so both fronts pad identically:

  * `BucketPolicy` -- the bucket set, `bucket_for` (smallest bucket that
    fits), and the padding/packing of a ragged chunk up to its bucket
    shape (dense zero rows, or padded-CSC with empty rows).
  * `LatencyModel` -- per-bucket EWMA of steady-state compute latency,
    which the loop's deadline math reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.design_matrix import PaddedCSCDesign
from repro_torch.data.libsvm import padded_csc_arrays


def default_buckets(max_batch: int) -> tuple:
    """Powers of two up to max_batch, always including max_batch itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Bucket geometry + chunk packing, shared by batcher and loop.

    `layout` picks the request representation ("dense" or "padded_csc").
    The JAX policy needs one fixed padded-CSC column width `k_max` for
    every chunk, so that XLA sees one shape per bucket; the port compiles
    nothing, so by default (`k_max=None`) each chunk is packed at its own
    width, its largest column nnz: a 256-row chunk of a 20,958-wide
    request stream holds about half an entry a column, and the stream's
    width would pad every column several times over. An explicit `k_max`
    fixes the width as the JAX policy does; a chunk whose column nnz
    overflows it raises: truncation would silently change margins.
    """

    buckets: tuple
    layout: str = "dense"
    k_max: Optional[int] = None

    def __post_init__(self):
        if self.layout not in ("dense", "padded_csc"):
            raise ValueError(f"unknown request layout {self.layout!r}")
        bs = tuple(sorted(set(int(b) for b in self.buckets)))
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be >= 1: {self.buckets}")
        object.__setattr__(self, "buckets", bs)
        object.__setattr__(
            self, "k_max",
            None if self.k_max is None else int(self.k_max))

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, r: int) -> int:
        """Smallest bucket >= r (r must not exceed the largest bucket)."""
        for b in self.buckets:
            if b >= r:
                return b
        raise ValueError(f"chunk of {r} exceeds max bucket "
                         f"{self.max_bucket}")

    # -- chunk packing -------------------------------------------------------
    def pad_dense(self, X: np.ndarray, bucket: int) -> np.ndarray:
        """(r, n) float rows -> (bucket, n), zero rows appended (their
        margins are computed and discarded by the caller)."""
        X = np.asarray(X, np.float32)
        r = X.shape[0]
        if bucket < r:
            raise ValueError(f"chunk of {r} rows does not fit bucket "
                             f"{bucket}")
        if bucket == r:
            return X
        return np.concatenate(
            [X, np.zeros((bucket - r, X.shape[1]), np.float32)])

    def pack_csc(self, csr, start: int, stop: int, bucket: int,
                 n_features: int, device="cpu") -> PaddedCSCDesign:
        """Rows [start, stop) of a CSRMatrix -> (bucket, n) padded-CSC on
        `device`. Padding rows have no nonzeros; the column width is the
        policy's `k_max`, or the chunk's largest column nnz without one."""
        for a in ("data", "indices", "indptr", "shape"):
            if not hasattr(csr, a):
                raise TypeError(
                    f"padded_csc layout serves CSR request streams; got "
                    f"{type(csr).__name__} (dense rows go to "
                    f"layout='dense')")
        n = csr.shape[1]
        if n != n_features:
            raise ValueError(f"requests have {n} features, bank has "
                             f"{n_features}")
        lo, hi = csr.indptr[start], csr.indptr[stop]
        indptr = np.asarray(csr.indptr[start:stop + 1], np.int64) - lo
        indptr = np.concatenate(
            [indptr, np.full((bucket - (stop - start),), indptr[-1],
                             np.int64)])
        col_rows, col_vals, s, _ = padded_csc_arrays(
            csr.data[lo:hi], csr.indices[lo:hi], indptr, (bucket, n),
            k_max=self.k_max)
        return PaddedCSCDesign.from_arrays(col_rows, col_vals, s, device)


class LatencyModel:
    """Per-bucket EWMA estimate of steady-state compute latency.

    The serving loop's deadline-aware flush needs `estimate(bucket)` to
    compute the latest instant a pending chunk can still be flushed and
    meet its oldest request's deadline. Warm-up seeds each bucket with a
    measured call; steady-state calls update the EWMA so the estimate
    tracks load. Unseen buckets return `default_s` (conservative, so an
    unwarmed server flushes early rather than late).
    """

    def __init__(self, default_s: float = 5e-3, alpha: float = 0.3):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.default_s = float(default_s)
        self.alpha = float(alpha)
        self._est: Dict[int, float] = {}

    def observe(self, bucket: int, seconds: float) -> None:
        old = self._est.get(bucket)
        if old is None:
            self._est[bucket] = float(seconds)
        else:
            self._est[bucket] = (1.0 - self.alpha) * old \
                + self.alpha * float(seconds)

    def estimate(self, bucket: int) -> float:
        return self._est.get(bucket, self.default_s)

    def seeded(self, bucket: int) -> bool:
        return bucket in self._est

    def as_dict(self) -> dict:
        return {str(b): e for b, e in sorted(self._est.items())}
