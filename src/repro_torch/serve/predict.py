"""Batched-margin prediction engine over sparse models, in torch.

Port of `repro.serve.predict`. Serving state is a `ModelBank`: the K
models of an artifact family (an OVR head, a path family, or one binary
model) stacked into TWO sparse layouts, built once at load time on one
device:

  per-model padded (the kernel layout):
    idx (K, A_max) int32   active feature ids, sentinel == n_features
    val (K, A_max) float   matching weights, 0 at padding

  union-compressed (the plain scorers' layout):
    union_idx (U,)   int32 sorted union of every model's active ids
    union_val (K, U) float each model's weights restricted to the union

A_max = max_k nnz(w_k) and U = |union|, so bank memory is K * A_max +
K * U, not K * n. Scoring touches ONLY active coordinates of the request
batch, in either request layout:

  * dense (B, n) slab       -> ONE shared gather X[:, union_idx] then a
    (B, U) x (U, K) matmul (`_dense_union`), or, with use_kernels, the
    per-model gather kernel K4a (`ops.serve_margins_dense`);
  * padded-CSC request batch -> gather the union's request columns once,
    scatter-add per model over request rows (`_csc_union`), or the
    per-model scatter kernel K4b (`ops.serve_margins_csc`).

The plain scorers are what the JAX package leaves to XLA outside any
Pallas kernel: `index_select` + `torch.matmul`, and `index_add_`. Tests
pin all four to the dense matmul ground truth. `decide` turns margins into
predictions: argmax over classes for an OVR bank, sign for binary/path.

Dense-layout ROUTING: the union-gather scorer loses to a plain densified
matmul at low weight sparsity / small batch. `margins_dense(...,
route=...)` offers "sparse" (union-gather), "dense" (densified (K, n)
matmul, built lazily and cached on the bank) and "auto", which picks per
call from a crossover table (sparsity x batch): the `route_crossover` of
the committed H100 run of `benchmarks/port/bench_serve.py`
(benchmarks/port/results/BENCH_serve_h100.json, read once; smoke runs are
skipped), `DEFAULT_ROUTE_CROSSOVER` (the same table) where the file is
missing or unreadable; `set_route_crossover` pins another one. The JAX
package reads its CPU table from BENCH_serve.json the same way.

Capacity-padded banks: `a_cap`/`u_cap` pad both layouts to fixed widths
beyond the current models' needs, so the serving loop's hot-swap can copy
a new model into the SAME tensors in place. idx padding uses the sentinel
`n_features`; union padding uses index 0 with weight 0 (a valid gather
that contributes exactly 0).

The JAX package also exports `scorer_cache_sizes`, which counts XLA's
compile caches of the jitted scorers. PyTorch runs eagerly and compiles
no scorer, so there is nothing to count and the port has no counterpart:
what a hot-swap must not do here is allocate or load a kernel library,
and `serve.loop` checks that instead.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.design_matrix import PaddedCSCDesign
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.artifact import ModelFamily

Tensor = torch.Tensor
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ModelBank:
    """Stacked sparse layouts of K models sharing n_features, on one device.

    `dtype` at build time sets the STORAGE dtype of val/union_val (float32
    default; bfloat16 halves bank memory and scorer traffic). Every scorer
    upcasts to float32 before its contraction, so margins are float32.
    """

    idx: Tensor                    # (K, A_max) int32, sentinel == n_features
    val: Tensor                    # (K, A_max) float, 0 at padding
    union_idx: Tensor              # (U,) int32 union of active ids
    union_val: Tensor              # (K, U) float weights on the union
    bias: Tensor                   # (K,) float32
    n_features: int
    kind: str = "binary"
    loss_name: str = "logistic"
    classes: Optional[np.ndarray] = None   # (K,) vocab for kind="ovr"

    @property
    def n_models(self) -> int:
        return int(self.idx.shape[0])

    @property
    def a_max(self) -> int:
        return int(self.idx.shape[1])

    @property
    def device(self) -> torch.device:
        return self.idx.device

    @property
    def nnz(self) -> np.ndarray:
        return torch.sum(self.idx < self.n_features, dim=1).cpu().numpy()

    def sparsity(self) -> float:
        """Mean fraction of zero weights across the bank's models
        (computed once and cached -- route="auto" reads it per call)."""
        cached = getattr(self, "_sparsity_cache", None)
        if cached is None:
            cached = 1.0 - float(self.nnz.mean()) / max(self.n_features, 1)
            object.__setattr__(self, "_sparsity_cache", cached)
        return cached

    def dense_matrix(self) -> Tensor:
        """Densified (K, n) float32 weight stack for the dense-matmul
        route, built lazily from the per-model layout and cached."""
        W = getattr(self, "_dense_w_cache", None)
        if W is None:
            W = torch.zeros((self.n_models, self.n_features + 1), dtype=f32,
                            device=self.device)
            # sentinel columns land in the extra last column, cut off
            W.scatter_(1, self.idx.long(), self.val.to(f32))
            W = W[:, :self.n_features].contiguous()
            object.__setattr__(self, "_dense_w_cache", W)
        return W

    def tensors(self) -> tuple:
        """(idx, val, union_idx, union_val, bias): the bank's storage."""
        return (self.idx, self.val, self.union_idx, self.union_val,
                self.bias)

    @classmethod
    def _build(cls, sparse_rows, bias, n: int, kind: str, loss_name: str,
               classes, dtype=f32, a_cap: Optional[int] = None,
               u_cap: Optional[int] = None, device="cuda") -> "ModelBank":
        """sparse_rows: [(indices, values)] per model -> both layouts.

        a_cap / u_cap pad the per-model and union layouts to FIXED widths
        (>= what the models need), so a later model swap at the same caps
        fits the same tensors.
        """
        dev = resolve_device(device)
        K = len(sparse_rows)
        a_max = max(1, max(ii.shape[0] for ii, _ in sparse_rows))
        if a_cap is not None:
            if a_max > int(a_cap):
                raise ValueError(
                    f"bank needs a_max={a_max} active weights per model "
                    f"but the capacity is a_cap={a_cap}")
            a_max = int(a_cap)
        idx = np.full((K, a_max), n, np.int32)
        val = np.zeros((K, a_max), np.float32)
        for k, (ii, vv) in enumerate(sparse_rows):
            idx[k, :ii.shape[0]] = ii
            val[k, :ii.shape[0]] = vv
        union = np.unique(np.concatenate(
            [ii for ii, _ in sparse_rows] or [np.zeros(0, np.int64)]))
        if union.size == 0:
            union = np.zeros((1,), np.int64)    # all-zero bank (c_max point)
        if u_cap is not None and union.shape[0] > int(u_cap):
            raise ValueError(
                f"bank union has {union.shape[0]} active features but "
                f"the capacity is u_cap={u_cap}")
        uval = np.zeros((K, union.shape[0]), np.float32)
        for k, (ii, vv) in enumerate(sparse_rows):
            uval[k, np.searchsorted(union, ii)] = vv
        if u_cap is not None and union.shape[0] < int(u_cap):
            # pad with index 0 / weight 0: a valid gather contributing 0
            pad = int(u_cap) - union.shape[0]
            union = np.concatenate([union, np.zeros((pad,), np.int64)])
            uval = np.concatenate([uval, np.zeros((K, pad), np.float32)],
                                  axis=1)
        b = np.zeros((K,), np.float32) if bias is None \
            else np.asarray(bias, np.float32).reshape(K)
        return cls(idx=torch.as_tensor(idx, device=dev),
                   val=torch.as_tensor(val, device=dev).to(dtype),
                   union_idx=torch.as_tensor(union.astype(np.int32),
                                             device=dev),
                   union_val=torch.as_tensor(uval, device=dev).to(dtype),
                   bias=torch.as_tensor(b, device=dev),
                   n_features=n, kind=kind, loss_name=loss_name,
                   classes=classes)

    @classmethod
    def from_family(cls, family: ModelFamily, dtype=f32,
                    a_cap: Optional[int] = None,
                    u_cap: Optional[int] = None,
                    device="cuda") -> "ModelBank":
        rows = [(m.w_indices, m.w_values.astype(np.float32))
                for m in family.models]
        bias = np.asarray([m.bias for m in family.models], np.float32)
        return cls._build(rows, bias, family.n_features, family.kind,
                          family.loss_name, family.classes, dtype=dtype,
                          a_cap=a_cap, u_cap=u_cap, device=device)

    @classmethod
    def from_dense(cls, W, bias=None, kind: str = "binary",
                   loss_name: str = "logistic",
                   classes: Optional[np.ndarray] = None,
                   dtype=f32, a_cap: Optional[int] = None,
                   u_cap: Optional[int] = None,
                   device="cuda") -> "ModelBank":
        """Stack (K, n) dense solutions."""
        W = np.asarray(W, np.float32)
        if W.ndim == 1:
            W = W[None, :]
        rows = [(np.flatnonzero(W[k]), W[k, np.flatnonzero(W[k])])
                for k in range(W.shape[0])]
        return cls._build(rows, bias, W.shape[1], kind, loss_name, classes,
                          dtype=dtype, a_cap=a_cap, u_cap=u_cap,
                          device=device)


def _dense_union(X: Tensor, union_idx: Tensor, union_val: Tensor,
                 bias: Tensor) -> Tensor:
    """One shared active-union gather, then a small (B, U) x (U, K)
    contraction -- the gather is paid once for all K models."""
    Xu = torch.index_select(X, 1, union_idx)
    return Xu @ union_val.to(f32).T + bias[None, :]


def _matmul(X: Tensor, W: Tensor, bias: Tensor) -> Tensor:
    """The densified scorer: z = X @ W.T."""
    return X @ W.T + bias[None, :]


def _csc_union(col_rows: Tensor, col_vals: Tensor, union_idx: Tensor,
               union_val: Tensor, bias: Tensor, n_requests: int) -> Tensor:
    """Shared gather of the union's request-matrix columns; per-model
    scaled scatter-add over request rows. Request padding (row id >=
    n_requests) lands in a last slot per model that is cut off."""
    B = int(n_requests)
    K = union_val.shape[0]
    rows = torch.index_select(col_rows, 0, union_idx).long()    # (U, k)
    rows = torch.where((rows >= 0) & (rows < B), rows, B)
    vals = torch.index_select(col_vals, 0, union_idx).to(f32)  # (U, k)
    contrib = vals[None, :, :] * union_val.to(f32)[:, :, None]  # (K, U, k)
    flat = rows[None, :, :] + (B + 1) * torch.arange(
        K, device=rows.device)[:, None, None]
    z = torch.zeros((K * (B + 1),), dtype=f32, device=col_vals.device)
    z.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return z.view(K, B + 1)[:, :B].T + bias[None, :]


# -- dense-layout route selection ---------------------------------------------

# Fallback when the committed BENCH_serve_h100.json is missing or
# unreadable: its measured full-run crossover (benchmarks/port/
# bench_serve.py on one NVIDIA H100 80GB HBM3 at 700 W; K=16, n=32768,
# the union gather against the densified torch.matmul, host wall a call
# of calls queued back to back). min_batch_sparse=None means dense
# always.
DEFAULT_ROUTE_CROSSOVER = (
    {"sparsity": 0.9, "min_batch_sparse": None},
    {"sparsity": 0.99, "min_batch_sparse": 1024},
    {"sparsity": 0.999, "min_batch_sparse": 512},
)

_route_lock = threading.Lock()
_route_crossover: Optional[tuple] = None


def bench_serve_path() -> Path:
    """The committed H100 serving benchmark whose `route_crossover`
    `--route auto` reads."""
    return Path(__file__).resolve().parents[3] / "benchmarks" / "port" / \
        "results" / "BENCH_serve_h100.json"


def _load_crossover(path: Path) -> Optional[tuple]:
    """The `route_crossover` of a full (not smoke) run's file, or None
    when the file is missing, unreadable, a smoke run's or malformed."""
    try:
        payload = json.loads(path.read_text())
        if payload.get("smoke") is not False:
            return None
        return tuple(
            {"sparsity": float(e["sparsity"]),
             "min_batch_sparse": (None if e.get("min_batch_sparse") is None
                                  else int(e["min_batch_sparse"]))}
            for e in payload["route_crossover"]) or None
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return None


def route_crossover() -> tuple:
    """The dense-vs-union-gather crossover table in force: the one
    `set_route_crossover` pinned, else the committed H100 table, loaded
    once from `bench_serve_path()` with DEFAULT_ROUTE_CROSSOVER as the
    fallback."""
    global _route_crossover
    with _route_lock:
        if _route_crossover is None:
            _route_crossover = _load_crossover(bench_serve_path()) or \
                DEFAULT_ROUTE_CROSSOVER
        return _route_crossover


def set_route_crossover(entries) -> None:
    """Pin the crossover table (None: the committed table again, reloaded
    at the next use) -- tests and benchmarks pin it to make routing
    deterministic."""
    global _route_crossover
    with _route_lock:
        _route_crossover = None if entries is None else tuple(entries)


def pick_route(sparsity: float, batch: int) -> str:
    """'sparse' (union-gather) or 'dense' (densified matmul) for a bank of
    the given weight sparsity scoring a batch of the given size, per the
    crossover table. Sparser-than-listed banks inherit the sparsest entry;
    batches below the crossover go dense."""
    best = None
    for e in sorted(route_crossover(), key=lambda e: e["sparsity"]):
        if sparsity >= e["sparsity"]:
            best = e
    if best is None or best["min_batch_sparse"] is None:
        return "dense"
    return "sparse" if batch >= best["min_batch_sparse"] else "dense"


def _as_requests(X, device) -> Tensor:
    if isinstance(X, torch.Tensor):
        return X.to(device=device, dtype=f32)
    return torch.as_tensor(np.asarray(X, np.float32), device=device)


def margins_dense(bank: ModelBank, X, use_kernels: bool = False,
                  route: str = "sparse") -> Tensor:
    """(B, K) float32 margins for a dense (B, n) request slab (numpy or a
    tensor; moved to the bank's device as float32).

    `route` selects the plain scorer: "sparse" (union-gather), "dense"
    (densified matmul), or "auto" (crossover table -- see pick_route).
    Ignored with use_kernels=True (the kernel path is per-model gather).
    """
    X = _as_requests(X, bank.device)
    if X.ndim != 2 or X.shape[1] != bank.n_features:
        raise ValueError(f"requests must be (B, {bank.n_features}), got "
                         f"{tuple(X.shape)}")
    if use_kernels:
        return ops.serve_margins_dense(X, bank.idx, bank.val) + \
            bank.bias[None, :]
    if route == "auto":
        route = pick_route(bank.sparsity(), int(X.shape[0]))
    if route == "dense":
        return _matmul(X, bank.dense_matrix(), bank.bias)
    if route != "sparse":
        raise ValueError(f"unknown dense-layout route {route!r} "
                         "(expected 'sparse', 'dense' or 'auto')")
    return _dense_union(X, bank.union_idx, bank.union_val, bank.bias)


def margins_padded_csc(bank: ModelBank, requests,
                       use_kernels: bool = False) -> Tensor:
    """(B, K) float32 margins for a padded-CSC request batch.

    `requests`: a PaddedCSCDesign or a numpy-side data.libsvm.PaddedCSC --
    the feature-major layout of the REQUEST matrix (B rows, n features);
    moved to the bank's device.
    """
    if isinstance(requests, PaddedCSCDesign):
        rows = requests.col_rows.to(bank.device)
        vals = requests.col_vals.to(bank.device)
        B, n = requests.shape
    elif all(hasattr(requests, a) for a in ("col_rows", "col_vals",
                                            "shape")):
        rows = torch.as_tensor(np.asarray(requests.col_rows, np.int32),
                               device=bank.device)
        vals = torch.as_tensor(np.asarray(requests.col_vals, np.float32),
                               device=bank.device)
        B, n = requests.shape
    else:
        raise TypeError(f"not a padded-CSC request batch: "
                        f"{type(requests).__name__}")
    if n != bank.n_features:
        raise ValueError(f"requests have {n} features, bank has "
                         f"{bank.n_features}")
    if use_kernels:
        return ops.serve_margins_csc(rows, vals, bank.idx, bank.val,
                                     n_requests=int(B)) + bank.bias[None, :]
    return _csc_union(rows, vals, bank.union_idx, bank.union_val, bank.bias,
                      n_requests=int(B))


def predict(bank: ModelBank, requests, use_kernels: bool = False) -> Tensor:
    """Margins for either request layout (dispatch on the request type)."""
    if hasattr(requests, "col_rows"):
        return margins_padded_csc(bank, requests, use_kernels=use_kernels)
    return margins_dense(bank, requests, use_kernels=use_kernels)


def decide(bank: ModelBank, margins) -> np.ndarray:
    """Margins -> predictions (numpy).

    ovr bank: (B,) class labels by argmax margin; binary bank: (B,) +-1 by
    sign (0 counts +1); path bank: (B, K) +-1 per grid point.
    """
    if isinstance(margins, torch.Tensor):
        margins = margins.detach().cpu().numpy()
    m = np.asarray(margins)
    if bank.kind == "ovr":
        if bank.classes is None:
            raise ValueError("ovr bank without a class vocabulary")
        return np.asarray(bank.classes)[np.argmax(m, axis=1)]
    pred = np.sign(m)
    pred[pred == 0] = 1.0
    if bank.kind == "binary":
        return pred[:, 0]
    return pred
