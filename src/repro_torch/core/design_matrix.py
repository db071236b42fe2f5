"""Design-matrix backends in torch: dense array vs. padded feature-major sparse.

Port of `repro.core.design_matrix`. Two interchangeable backends behind one
duck-typed interface:

  * `DenseDesign`     -- a plain (s, n) tensor.
  * `PaddedCSCDesign` -- feature-major ELL/CSC hybrid: for each column j the
    row ids and values of its nonzeros, padded to a static width k_max:

        col_rows : (n, k_max) int32, row id or sentinel `s` at padding
        col_vals : (n, k_max) float, 0 at padding

Sentinels: torch has neither `take(..., mode="fill")` nor a `mode="drop"`
scatter. Gathers through a possibly-sentinel index use `_take_fill`
(clamp, then select the fill value), and scatters use an `s + 1` buffer
whose last slot collects the sentinel entries and is cut off, or clamp the
index and zero the update (`scatter_support`). Both add exact zeros only,
so padding contributes nothing to any reduction.

Mixed precision, as in the reference: the values may be stored in bf16
(`dtype=torch.bfloat16` at construction) while every product below
accumulates in float32 (`acc_dtype`; the casts are no-ops for float32
storage). The solver state (w, z, u, v) stays float32; only the design
values shrink.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


class DenseSlab(NamedTuple):
    """Dense (s, P) column slab for one bundle; padded columns zeroed."""
    XB: Tensor
    valid: Tensor


class SparseSlab(NamedTuple):
    """Padded-CSC slab: per bundle feature, its nonzero rows/values."""
    rows: Tensor       # (P, k_max) int32; sentinel == n_samples at padding
    vals: Tensor       # (P, k_max) float; 0 at padding
    valid: Tensor      # (P,) bool


class SlabSupport(NamedTuple):
    """The row support of one bundle slab.

    support: (r_max,) int32 -- sorted unique row ids touched by the bundle,
    sentinel-padded (== n_samples); r_max = P * k_max. pos: (P, k_max)
    int32 -- every slab entry's index into `support` (padding entries point
    at the first sentinel slot and carry value 0).
    """
    support: Tensor
    pos: Tensor


Slab = Union[DenseSlab, SparseSlab]


def _take_fill(v: Tensor, idx: Tensor, fill: float) -> Tensor:
    """v[idx] with out-of-range (sentinel) indices giving `fill`."""
    n = v.shape[0]
    out = v[idx.clamp(max=n - 1)]
    return torch.where(idx < n, out, torch.full_like(out, fill))


def padded_row_support(rows: Tensor, sentinel: int) -> SlabSupport:
    """Static-shape unique row set of a padded (P, k_max) row-id array.

    Sort the flattened ids, blank duplicates to the sentinel, re-sort so the
    unique ids stay sorted with all sentinels trailing, then recover every
    entry's slot with one left-side searchsorted -- the reference's exact
    recipe, so `support` and `pos` are equal to it element for element.
    """
    flat = rows.reshape(-1)
    srt = torch.sort(flat).values
    dup = torch.cat([torch.zeros((1,), dtype=torch.bool, device=rows.device),
                     srt[1:] == srt[:-1]])
    support = torch.sort(torch.where(dup, sentinel, srt)).values
    pos = torch.searchsorted(support, rows.contiguous(), out_int32=True)
    return SlabSupport(support=support.to(torch.int32), pos=pos)


class DesignMatrix:
    """Interface both backends implement (duck-typed).

    matvec(w)            -> (s,)  margins X @ w
    rmatvec(u)           -> (n,)  X^T @ u
    column_norms_sq()    -> (n,)  diag(X^T X)
    gather_slab(idx)     -> Slab  for a (P,) bundle with sentinel == n
    slab_grad_hess(...)  -> (g, h) raw bundle reductions (no l2 / floor)
    slab_matvec(...)     -> (s,)  X_B @ d_B (dense margins delta)
    slab_coordinate_deltas(...) -> (P, s) d_j X[:, j], one row a coordinate
    """

    layout: str = "abstract"


@dataclasses.dataclass(frozen=True)
class DenseDesign(DesignMatrix):
    """Dense backend: X is a plain (s, n) tensor."""

    X: Tensor
    layout = "dense"

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.X.shape)

    @property
    def n_samples(self) -> int:
        return self.X.shape[0]

    @property
    def n_features(self) -> int:
        return self.X.shape[1]

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def acc_dtype(self):
        """Accumulation dtype: float32 for bf16 storage, else the
        storage's."""
        return torch.promote_types(self.X.dtype, torch.float32)

    @property
    def device(self):
        return self.X.device

    def matvec(self, w: Tensor) -> Tensor:
        return self.X.to(self.acc_dtype) @ w

    def rmatvec(self, u: Tensor) -> Tensor:
        return self.X.T.to(self.acc_dtype) @ u

    def column_norms_sq(self) -> Tensor:
        return torch.sum(torch.square(self.X.to(self.acc_dtype)), dim=0)

    def gather_slab(self, idx: Tensor) -> DenseSlab:
        """idx: (P,) int32 with sentinel n -> contiguous (s, P) slab."""
        n = self.X.shape[1]
        valid = idx < n
        XB = torch.index_select(self.X, 1, idx.clamp(max=n - 1))
        XB = XB * valid[None, :].to(self.X.dtype)
        return DenseSlab(XB=XB, valid=valid)

    def slab_grad_hess(self, slab: DenseSlab, u: Tensor, v: Tensor):
        """g_j = sum_i u_i X_ij ; h_j = sum_i v_i X_ij^2 (raw, no l2/floor)."""
        XB = slab.XB.to(self.acc_dtype)
        g = XB.T @ u
        h = torch.square(XB).T @ v
        return g, h

    def slab_matvec(self, slab: DenseSlab, d: Tensor) -> Tensor:
        """delta_z = X_B @ d_B, the (s,) margin delta of a bundle step."""
        return slab.XB.to(self.acc_dtype) @ d

    def slab_coordinate_deltas(self, slab: DenseSlab, d: Tensor) -> Tensor:
        """(P, s) per-coordinate margin deltas d_j * X[:, j]: the blind
        one-coordinate steps SCDN's racing line searches evaluate."""
        return (slab.XB.T.to(self.acc_dtype) * d[:, None]).contiguous()

    def feature_major(self) -> Tensor:
        """(n, s) contiguous copy of X, in which column j is the
        contiguous row j: the layout the dense bundle kernel (K3) reads a
        bundle's columns from, in the storage dtype. Built at the first
        call (one transpose) and cached on the design."""
        XT = getattr(self, "_xt_cache", None)
        if XT is None:
            XT = self.X.T.contiguous()
            object.__setattr__(self, "_xt_cache", XT)
        return XT

    def to_dense(self) -> Tensor:
        return self.X


@dataclasses.dataclass(frozen=True)
class PaddedCSCDesign(DesignMatrix):
    """Feature-major padded sparse backend (ELL over columns)."""

    col_rows: Tensor   # (n, k_max) int32
    col_vals: Tensor   # (n, k_max) float
    _n_samples: int
    layout = "padded_csc"

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._n_samples, self.col_rows.shape[0])

    @property
    def n_samples(self) -> int:
        return self._n_samples

    @property
    def n_features(self) -> int:
        return self.col_rows.shape[0]

    @property
    def k_max(self) -> int:
        return self.col_rows.shape[1]

    @property
    def dtype(self):
        return self.col_vals.dtype

    @property
    def acc_dtype(self):
        """Accumulation dtype: float32 for bf16 storage, else the
        storage's."""
        return torch.promote_types(self.col_vals.dtype, torch.float32)

    @property
    def device(self):
        return self.col_vals.device

    def _scatter_rows(self, rows: Tensor, upd: Tensor) -> Tensor:
        """(s,) sums of `upd` at `rows`; sentinel rows land in slot s and
        are cut off (duplicate rows accumulate)."""
        s = self._n_samples
        z = torch.zeros((s + 1,), dtype=upd.dtype, device=upd.device)
        z.index_add_(0, rows.reshape(-1), upd.reshape(-1))
        return z[:s]

    def matvec(self, w: Tensor) -> Tensor:
        """z = X @ w as one scatter-add of every weighted nonzero."""
        return self._scatter_rows(
            self.col_rows, self.col_vals.to(self.acc_dtype) * w[:, None])

    def rmatvec(self, u: Tensor) -> Tensor:
        """X^T u: gather u at each column's rows, masked segment sum."""
        ug = _take_fill(u, self.col_rows, 0.0)
        return torch.sum(ug * self.col_vals.to(self.acc_dtype), dim=1)

    def column_norms_sq(self) -> Tensor:
        return torch.sum(torch.square(self.col_vals.to(self.acc_dtype)),
                         dim=1)

    def gather_slab(self, idx: Tensor) -> SparseSlab:
        """O(P * k_max) bundle gather -- never touches the other columns."""
        n = self.col_rows.shape[0]
        valid = idx < n
        safe = idx.clamp(max=n - 1)
        rows = torch.where(valid[:, None], self.col_rows[safe],
                           self._n_samples)
        vals = self.col_vals[safe] * valid[:, None].to(self.col_vals.dtype)
        return SparseSlab(rows=rows, vals=vals, valid=valid)

    def slab_grad_hess(self, slab: SparseSlab, u: Tensor, v: Tensor):
        """Masked segment reductions over the padded column layout."""
        vals = slab.vals.to(self.acc_dtype)
        ug = _take_fill(u, slab.rows, 0.0)
        vg = _take_fill(v, slab.rows, 0.0)
        g = torch.sum(ug * vals, dim=1)
        h = torch.sum(vg * torch.square(vals), dim=1)
        return g, h

    def slab_matvec(self, slab: SparseSlab, d: Tensor) -> Tensor:
        """delta_z via scatter-add at the slab rows (duplicate rows
        accumulate)."""
        return self._scatter_rows(slab.rows,
                                  slab.vals.to(self.acc_dtype) * d[:, None])

    def slab_coordinate_deltas(self, slab: SparseSlab, d: Tensor) -> Tensor:
        """(P, s) per-coordinate margin deltas: coordinate j's rows
        scattered into row j of a (P, s + 1) buffer, whose last column
        collects the sentinel entries and is cut off (a view with row
        stride s + 1)."""
        s = self._n_samples
        P = slab.rows.shape[0]
        out = torch.zeros((P, s + 1), dtype=self.acc_dtype,
                          device=d.device)
        flat = slab.rows + (s + 1) * torch.arange(
            P, dtype=slab.rows.dtype, device=slab.rows.device)[:, None]
        out.view(-1).index_add_(
            0, flat.reshape(-1),
            (slab.vals.to(self.acc_dtype) * d[:, None]).reshape(-1))
        return out[:, :s]

    # -- support-scoped slab protocol ----------------------------------------
    def slab_row_support(self, slab: SparseSlab) -> SlabSupport:
        return padded_row_support(slab.rows, self._n_samples)

    def slab_grad_hess_support(self, slab: SparseSlab, pos: Tensor,
                               u_R: Tensor, v_R: Tensor):
        """`slab_grad_hess` with u/v given only at the support rows (pos is
        always in bounds; padding values are 0)."""
        vals = slab.vals.to(self.acc_dtype)
        g = torch.sum(u_R[pos] * vals, dim=1)
        h = torch.sum(v_R[pos] * torch.square(vals), dim=1)
        return g, h

    def slab_matvec_support(self, slab: SparseSlab, pos: Tensor,
                            d: Tensor) -> Tensor:
        """(r_max,) delta_R with delta_R[r] = (X_B d_B)[support[r]];
        sentinel support slots stay exactly 0."""
        r_max = pos.shape[0] * pos.shape[1]
        out = torch.zeros((r_max,), dtype=d.dtype, device=d.device)
        out.index_add_(0, pos.reshape(-1),
                       (slab.vals.to(self.acc_dtype) * d[:, None]).reshape(-1))
        return out

    def scatter_support(self, z: Tensor, support: Tensor,
                        upd: Tensor) -> Tensor:
        """z[support] += upd IN PLACE, sentinel slots dropped (their index is
        clamped and their update zeroed, so they add an exact 0)."""
        s = self._n_samples
        valid = support < s
        z.index_add_(0, support.clamp(max=s - 1),
                     torch.where(valid, upd, torch.zeros_like(upd)))
        return z

    def to_dense(self) -> Tensor:
        """Materialize (s, n) -- test/debug only."""
        s, n = self.shape
        out = torch.zeros((s + 1, n), dtype=self.col_vals.dtype,
                          device=self.col_vals.device)
        cols = torch.arange(n, device=self.col_rows.device)[:, None].expand(
            self.col_rows.shape)
        out.index_put_((self.col_rows.long(), cols), self.col_vals,
                       accumulate=True)
        return out[:s]

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_arrays(cls, col_rows, col_vals, n_samples: int, device="cpu",
                    dtype=torch.float32) -> "PaddedCSCDesign":
        """Values cast to float32, then stored in `dtype` (bf16 rounds to
        nearest even, as the reference's cast does)."""
        vals = torch.as_tensor(np.asarray(col_vals, np.float32),
                               device=device)
        return cls(col_rows=torch.as_tensor(np.asarray(col_rows, np.int32),
                                            device=device),
                   col_vals=vals.to(dtype), _n_samples=int(n_samples))

    @classmethod
    def from_dense(cls, X, k_max=None, device="cpu",
                   dtype=torch.float32) -> "PaddedCSCDesign":
        """Convert a dense matrix (same column layout as the reference)."""
        X = np.asarray(X, dtype=np.float32)
        s, n = X.shape
        nz_rows, nz_cols = np.nonzero(X.T)  # nz_rows is the column id
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(nz_rows, minlength=n))])
        counts = np.diff(indptr).astype(np.int64)
        k = int(max(1, counts.max() if counts.size else 1))
        if k_max is not None:
            if k > int(k_max):
                raise ValueError(f"k_max={k_max} < max column nnz {k}")
            k = int(k_max)
        col_rows = np.full((n, k), s, np.int32)
        col_vals = np.zeros((n, k), np.float32)
        pos = np.arange(nz_rows.shape[0]) - indptr[nz_rows]
        col_rows[nz_rows, pos] = nz_cols
        col_vals[nz_rows, pos] = X.T[nz_rows, nz_cols]
        return cls.from_arrays(col_rows, col_vals, s, device, dtype)


def as_design(X, dtype=torch.float32, layout: str = "auto", k_max=None,
              device="cpu") -> DesignMatrix:
    """Coerce a dense array or a PaddedCSC-like object into a DesignMatrix
    on `device`, its values stored in `dtype` (float32 or bfloat16). "auto"
    keeps arrays dense and padded-CSC input sparse; forcing padded-CSC input
    dense is refused. A DesignMatrix passes through as it is."""
    if isinstance(X, DesignMatrix):
        return X
    if all(hasattr(X, a) for a in ("col_rows", "col_vals", "shape")):
        if layout == "dense":
            raise ValueError("PaddedCSC input with layout='dense' would "
                             "densify; pass layout='padded_csc'/'auto'.")
        if k_max is not None and int(k_max) != int(X.col_rows.shape[1]):
            raise ValueError(
                f"k_max={k_max} conflicts with the prebuilt PaddedCSC "
                f"width {X.col_rows.shape[1]}; re-pad at conversion time.")
        return PaddedCSCDesign.from_arrays(X.col_rows, X.col_vals,
                                           int(X.shape[0]), device, dtype)
    if layout == "padded_csc":
        return PaddedCSCDesign.from_dense(np.asarray(X), k_max=k_max,
                                          device=device, dtype=dtype)
    return DenseDesign(X=torch.as_tensor(np.asarray(X, np.float32),
                                         device=device).to(dtype))
