"""Synthetic dataset generators matched to the paper's benchmarks.

The paper's six datasets (Table 2) cannot ship offline, so each gets a
generator reproducing its *solver-relevant* profile: shape ratio s:n,
training-data sparsity, row normalization (document sets are unit-norm),
feature scaling ([-1,1] for gisette) and inter-feature correlation (the
quantity that kills SCDN — section 2.2). Sizes are scaled to CPU budgets
by default; `scale=1.0` reproduces the published dimensions.

Numpy-only copy of `repro.data.synthetic` for the PyTorch port: the same
seed gives bit-identical arrays in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.data.libsvm import PaddedCSC


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    s: int                 # published #train samples
    n: int                 # published #features
    sparsity: float        # published train sparsity (fraction of zeros)
    row_normalize: bool    # document sets are normalized to unit vectors
    scale_pm1: bool        # gisette: features linearly scaled to [-1, 1]
    c_svm: float           # best c* from Table 2
    c_logistic: float
    corr: float = 0.3      # latent-factor feature correlation strength


# Published shapes (paper Table 2); generators shrink via `scale`.
PAPER_DATASETS = {
    "a9a": DatasetSpec("a9a", 26_049, 123, 0.8872, True, False, 0.5, 2.0),
    "real-sim": DatasetSpec("real-sim", 57_848, 20_958, 0.9976, True, False,
                            1.0, 4.0),
    "news20": DatasetSpec("news20", 15_997, 1_355_191, 0.9997, True, False,
                          64.0, 64.0),
    "gisette": DatasetSpec("gisette", 6_000, 5_000, 0.009, False, True,
                           0.25, 0.25, corr=0.8),  # dense & highly correlated
    "rcv1": DatasetSpec("rcv1", 541_920, 47_236, 0.9985, True, False,
                        1.0, 4.0),
    "kdda": DatasetSpec("kdda", 8_407_752, 20_216_830, 0.9999, True, False,
                        1.0, 4.0),
}

# Default CPU-budget shapes (dense f32 X must stay well under RAM).
_CPU_SHAPES = {
    "a9a": (8_192, 123),
    "real-sim": (6_000, 2_048),
    "news20": (2_000, 16_384),
    "gisette": (2_000, 1_024),
    "rcv1": (12_000, 4_096),
    "kdda": (4_000, 16_384),
}


def make_classification(
    s: int,
    n: int,
    sparsity: float = 0.9,
    corr: float = 0.3,
    w_nnz_frac: float = 0.1,
    noise: float = 0.1,
    row_normalize: bool = True,
    scale_pm1: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse correlated binary classification data.

    X = mask .* (latent-factor mixture + idiosyncratic noise), labels from a
    planted sparse linear model through a logistic link. corr in [0, 1)
    drives the off-diagonal mass of X^T X (higher => SCDN diverges sooner).
    Returns (X (s,n) f32, y (s,) f32 in {-1,+1}, w_true (n,) f32).
    """
    rng = np.random.default_rng(seed)
    k = max(4, n // 64)  # latent dimension
    F = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    S = rng.standard_normal((s, k)).astype(np.float32)
    X = corr * (S @ F) + (1.0 - corr) * rng.standard_normal(
        (s, n)).astype(np.float32)
    if sparsity > 0:
        mask = rng.random((s, n)) >= sparsity
        X *= mask
    if scale_pm1:
        amax = np.abs(X).max(axis=0, keepdims=True)
        X = X / np.maximum(amax, 1e-12)
    if row_normalize:
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        X = X / np.maximum(norms, 1e-12)

    w_true = np.zeros((n,), np.float32)
    nnz = max(1, int(w_nnz_frac * n))
    sup = rng.choice(n, size=nnz, replace=False)
    w_true[sup] = rng.standard_normal(nnz).astype(np.float32) * 2.0
    logits = X @ w_true + noise * rng.standard_normal(s).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-logits))
    y = np.where(rng.random(s) < p, 1.0, -1.0).astype(np.float32)
    return X.astype(np.float32), y, w_true


def paper_like(name: str, scale: Optional[float] = None, seed: int = 0,
               with_test: bool = False):
    """Generate a dataset with the profile of a paper benchmark.

    scale=None uses the CPU-budget shape; scale=1.0 the published shape.
    Returns (X, y, spec) or (Xtr, ytr, Xte, yte, spec) with with_test=True
    (paper section 5.3 splits one fifth for test).
    """
    spec = PAPER_DATASETS[name]
    if scale is None:
        s, n = _CPU_SHAPES[name]
    else:
        s, n = max(64, int(spec.s * scale)), max(16, int(spec.n * scale))
    X, y, _ = make_classification(
        s, n, sparsity=spec.sparsity, corr=spec.corr,
        row_normalize=spec.row_normalize, scale_pm1=spec.scale_pm1,
        seed=seed)
    if not with_test:
        return X, y, spec
    cut = int(0.8 * s)
    return X[:cut], y[:cut], X[cut:], y[cut:], spec


def make_sparse_classification(
    s: int,
    n: int,
    nnz_per_col: int = 16,
    w_nnz_frac: float = 0.02,
    noise: float = 0.1,
    seed: int = 0,
):
    """Directly-sparse classification data — never materializes (s, n).

    Generates the padded-CSC layout column by column (vectorized): each
    column gets 1..nnz_per_col nonzeros at rows sampled with replacement
    (duplicate (i, j) slots sum, which both backends treat identically),
    values ~ N(0, 1/sqrt(nnz)). Labels come from a planted sparse linear
    model through a logistic link, with margins computed by an O(nnz)
    scatter — so a 20k x 50k problem costs ~n*k_max*8 bytes, not the
    4 GB of its dense form (DESIGN.md section 7). Returns
    (PaddedCSC, y (s,) +-1 f32, w_true (n,) f32).
    """
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, nnz_per_col + 1, size=n)
    k_max = int(nnz_per_col)
    col_rows = np.full((n, k_max), s, np.int32)
    col_vals = np.zeros((n, k_max), np.float32)
    mask = np.arange(k_max)[None, :] < counts[:, None]
    nnz = int(mask.sum())
    col_rows[mask] = rng.integers(0, s, size=nnz)
    scale = 1.0 / np.sqrt(counts.astype(np.float32))
    col_vals[mask] = rng.standard_normal(nnz).astype(np.float32) * \
        np.repeat(scale, counts)

    w_true = np.zeros((n,), np.float32)
    k_w = max(1, int(w_nnz_frac * n))
    sup = rng.choice(n, size=k_w, replace=False)
    w_true[sup] = rng.standard_normal(k_w).astype(np.float32) * 2.0
    z = np.zeros((s,), np.float32)
    np.add.at(z, col_rows[mask], col_vals[mask] * np.repeat(w_true, counts))
    z += noise * rng.standard_normal(s).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-z))
    y = np.where(rng.random(s) < p, 1.0, -1.0).astype(np.float32)
    return PaddedCSC(col_rows=col_rows, col_vals=col_vals, shape=(s, n)), \
        y, w_true


def train_accuracy(X: np.ndarray, y: np.ndarray, w) -> float:
    pred = np.sign(X @ np.asarray(w))
    pred[pred == 0] = 1.0
    return float(np.mean(pred == y))
