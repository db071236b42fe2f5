"""LIBSVM text format reader/writer (the paper's six datasets ship in it).

Numpy-only copy of `repro.data.libsvm` for the PyTorch port, which imports
nothing of the JAX package; `padded_csc_arrays` lives here rather than in
`core.design_matrix` so the data layer stays free of torch as well.

Format, one sample per line:   <label> <idx>:<val> <idx>:<val> ...
Indices are 1-based. Three output layouts (DESIGN.md sections 3.1 / 7):

    layout="dense"       (s, n) float32 array — the original TPU slab path
    layout="csr"         CSRMatrix triple, no densification
    layout="padded_csc"  (col_rows, col_vals, shape) feature-major padded
                         arrays for the sparse DesignMatrix backend —
                         zero densification end to end

Parsing is numpy-vectorized: the per-line Python work is only collecting
"idx:val" tokens; index/value conversion of the whole nnz stream happens
in two `np.array(...).astype(...)` calls, which is ~an order of magnitude
faster than float()-per-token for the paper's datasets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    data: np.ndarray      # (nnz,) float32
    indices: np.ndarray   # (nnz,) int32 column ids
    indptr: np.ndarray    # (s+1,) int64
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def to_dense(self) -> np.ndarray:
        """Vectorized scatter — one fancy-indexed assignment, no row loop."""
        s, n = self.shape
        out = np.zeros((s, n), dtype=np.float32)
        row_ids = np.repeat(np.arange(s), np.diff(self.indptr))
        out[row_ids, self.indices] = self.data
        return out

    def max_col_nnz(self) -> int:
        """k_max of the padded-CSC layout this matrix would convert to."""
        if self.nnz == 0:
            return 1
        return int(np.bincount(self.indices,
                               minlength=self.shape[1]).max())

    def rows(self, start: int, stop: int) -> "CSRMatrix":
        """Rows [start, stop) as their own CSRMatrix (views, no copy)."""
        lo, hi = self.indptr[start], self.indptr[stop]
        return CSRMatrix(self.data[lo:hi], self.indices[lo:hi],
                         self.indptr[start:stop + 1] - lo,
                         (stop - start, self.shape[1]))

    @classmethod
    def from_dense(cls, X) -> "CSRMatrix":
        """Row-major sparse view of a dense array (serving/test helper)."""
        X = np.asarray(X, np.float32)
        rows, cols = np.nonzero(X)
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(rows, minlength=X.shape[0]))]
        ).astype(np.int64)
        return cls(data=X[rows, cols], indices=cols.astype(np.int32),
                   indptr=indptr, shape=X.shape)


@dataclasses.dataclass
class PaddedCSC:
    """Numpy-side padded feature-major layout (see core.design_matrix)."""
    col_rows: np.ndarray  # (n, k_max) int32; sentinel == s at padding
    col_vals: np.ndarray  # (n, k_max) float32; 0 at padding
    shape: Tuple[int, int]

    @property
    def k_max(self) -> int:
        return int(self.col_rows.shape[1])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.col_rows < self.shape[0]))

    def to_csr(self) -> CSRMatrix:
        """Row-major CSR of the same matrix, never densified. Entries that
        share a (row, column) slot are summed into one, as every scorer of
        the padded layout sums them."""
        s, n = self.shape
        live = self.col_rows < s
        cols = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                               self.col_rows.shape)[live]
        rows = self.col_rows[live].astype(np.int64)
        vals = self.col_vals[live].astype(np.float32)
        key = rows * n + cols
        uniq, inv = np.unique(key, return_inverse=True)
        data = np.zeros(uniq.shape, np.float32)
        np.add.at(data, inv, vals)
        urows = uniq // n
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(urows, minlength=s))]
        ).astype(np.int64)
        return CSRMatrix(data, (uniq % n).astype(np.int32), indptr, (s, n))


def csr_to_padded_csc(csr: CSRMatrix,
                      k_max: Optional[int] = None) -> PaddedCSC:
    """CSR -> padded-CSC without densifying. k_max defaults to the max
    column nnz; a smaller explicit k_max raises if any column overflows
    (truncation would silently change the objective — DESIGN.md 7.2)."""
    col_rows, col_vals, s, n = padded_csc_arrays(
        csr.data, csr.indices, csr.indptr, csr.shape, k_max=k_max)
    return PaddedCSC(col_rows=col_rows, col_vals=col_vals, shape=(s, n))


def padded_csc_arrays(data, indices, indptr, shape, k_max=None,
                      dtype=np.float32):
    """CSR triple -> (col_rows, col_vals, s, n) numpy padded-CSC arrays.

    Fully vectorized: stable-sorts the nnz stream by column, computes each
    entry's rank within its column from the column-start offsets, and
    scatters into the padded layout. O(nnz log nnz), no (s, n) temporary.
    """
    s, n = shape
    data = np.asarray(data, dtype=dtype)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = data.shape[0]
    row_ids = np.repeat(np.arange(s, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    cols = indices[order]
    rows = row_ids[order]
    vals = data[order]
    counts = np.bincount(cols, minlength=n).astype(np.int64)
    k = int(max(1, counts.max() if counts.size else 1))
    if k_max is not None:
        if k > int(k_max):
            raise ValueError(f"k_max={k_max} < max column nnz {k}")
        k = int(k_max)
    col_start = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(nnz, dtype=np.int64) - col_start[cols]
    col_rows = np.full((n, k), s, np.int32)
    col_vals = np.zeros((n, k), dtype)
    col_rows[cols, pos] = rows
    col_vals[cols, pos] = vals
    return col_rows, col_vals, int(s), int(n)


def _parse_libsvm_text(path: str):
    # Two flat 1-D token lists (not an (nnz, 2) unicode matrix — numpy
    # fixed-width string arrays cost max-token-width * 4 B per cell,
    # which is GBs of transient memory at paper-dataset nnz counts);
    # numeric conversion of each list is one vectorized np.asarray.
    labels, idx_tok, val_tok, ptr = [], [], [], [0]
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            labels.append(parts[0])
            for tok in parts[1:]:
                k, _, v = tok.partition(":")
                idx_tok.append(k)
                val_tok.append(v)
            ptr.append(len(idx_tok))
    y = np.asarray(labels, dtype=np.float32)
    idx = np.asarray(idx_tok, dtype=np.int64) - 1    # 1-based on disk
    vals = np.asarray(val_tok, dtype=np.float32)
    return y, idx, vals, np.asarray(ptr, dtype=np.int64)


def normalize_labels(y: np.ndarray):
    """Raw file labels -> (y_norm, classes).

    ANY <= 2-label set normalizes to the solvers' +-1 contract with
    classes == [-1, +1]: {0, 1} and {-1, +1} map as historically (sign),
    and other two-label vocabularies ({1, 2}-style files are common in
    the wild) map smaller -> -1, larger -> +1 — never as raw codes,
    which would silently zero out the y == 0 class inside a +-1 loss.
    Three or more labels are a multiclass vocabulary: classes is the
    sorted unique label values and y_norm the float32 integer codes into
    it (what `serve.ovr.fit_ovr` and `launch.predict` consume).
    """
    uniq = np.unique(y)
    if uniq.size <= 2:
        if set(uniq.tolist()) <= {0.0, 1.0} or \
                set(uniq.tolist()) <= {-1.0, 1.0}:
            y = np.where(y > 0, 1.0, -1.0)
        else:
            y = np.where(y == uniq.max(), 1.0, -1.0)
        return y.astype(np.float32), np.asarray([-1.0, 1.0], np.float32)
    codes = np.searchsorted(uniq, y)
    return codes.astype(np.float32), uniq.astype(np.float32)


def load_libsvm(path: str, n_features: Optional[int] = None,
                layout: str = "dense", k_max: Optional[int] = None,
                return_classes: bool = False):
    """-> (X, y) where X's type follows `layout` (y (s,) float32 +-1), or
    (X, y, classes) with return_classes=True.

    layout: "dense" ((s, n) float32 array), "csr" (CSRMatrix), or
    "padded_csc" (PaddedCSC -- never materializes the dense matrix).
    Labels: {0, 1}, {-1, +1} and other two-label files map to +-1
    (`normalize_labels`). With return_classes=True, y is the class CODES
    into the sorted vocabulary `classes` (binary files too), which is how
    the predict CLI scores OVR heads; a multiclass file without it raises.
    """
    if layout not in ("dense", "csr", "padded_csc"):
        raise ValueError(f"unknown layout {layout!r}")

    y, idx, vals, ptr = _parse_libsvm_text(path)
    n = n_features or (int(idx.max()) + 1 if idx.size else 0)
    y, classes = normalize_labels(y)
    if classes.shape[0] > 2 and not return_classes:
        raise ValueError(
            f"{path!r} has {classes.shape[0]} label values "
            f"{classes.tolist()[:8]}...; pass return_classes=True to get "
            f"(X, codes, classes)")
    csr = CSRMatrix(vals, idx.astype(np.int32), ptr, (y.shape[0], n))
    if layout == "dense":
        X = csr.to_dense()
    elif layout == "padded_csc":
        X = csr_to_padded_csc(csr, k_max=k_max)
    else:
        X = csr
    if not return_classes:
        return X, y
    if classes.shape[0] == 2:
        # y is always CODES into classes here: classes[codes] gives back
        # the +-1 labels of a binary file
        y = (y > 0).astype(np.float32)
    return X, y, classes


def save_libsvm(path: str, X: np.ndarray, y: np.ndarray) -> None:
    with open(path, "w") as fh:
        for xi, yi in zip(X, y):
            nz = np.nonzero(xi)[0]
            feats = " ".join(f"{j + 1}:{xi[j]:.6g}" for j in nz)
            fh.write(f"{yi:g} {feats}\n")


def save_libsvm_csr(path: str, X: CSRMatrix, y: np.ndarray) -> None:
    """`save_libsvm` from CSR rows, for request sets too large to densify.
    Values are written with 9 significant digits, so a float32 reads back
    exactly."""
    with open(path, "w") as fh:
        for i in range(X.shape[0]):
            lo, hi = X.indptr[i], X.indptr[i + 1]
            feats = " ".join(f"{j + 1}:{v:.9g}" for j, v in
                             zip(X.indices[lo:hi].tolist(),
                                 X.data[lo:hi].tolist()))
            fh.write(f"{y[i]:g} {feats}\n")
