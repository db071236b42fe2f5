"""Per-feature KKT attribution (port of `repro.diag.kkt`).

Consumes the (K, n) violation series the engine harvests when the solver
runs with `record_kkt_vec=True` (`SolveHistory.kkt_vec`): row k is the
per-feature minimum-norm-subgradient violation |d_j F| after outer
iteration k -- the vector whose max is the stop criterion, so recording
it costs one (n,) copy to the host an iteration and no device work.

Everything here is host numpy over that series and returns plain
JSON-ready dicts, the same as the reference's, because the consumers are
the markdown report and `--out` payloads of either package.
"""
from __future__ import annotations

import numpy as np

# fixed log-spaced violation buckets, mirroring the obs histogram
# convention: counts has len(bounds)+1 entries, the last bucket is
# "> bounds[-1]" (and the first is "<= bounds[0]").
VIOL_BOUNDS = tuple(float(10.0 ** e) for e in range(-8, 3))  # 1e-8..1e2


def _series(kkt_vec) -> np.ndarray:
    v = np.asarray(kkt_vec, np.float64)
    if v.ndim == 1:
        v = v[None, :]
    if v.ndim != 2:
        raise ValueError(f"kkt_vec must be (K, n) or (n,), got {v.shape}")
    return v


def top_offenders(kkt_vec, k: int = 10, tol: float = 0.0) -> list:
    """Top-k features by FINAL-iteration violation.

    Each row: feature id, final violation, max violation over the run,
    and the number of iterations the feature spent above `tol` — the
    features that kept the solver from stopping, not just the ones that
    were briefly loud at iteration 0.
    """
    v = _series(kkt_vec)
    last = v[-1]
    k = min(int(k), last.shape[0])
    order = np.argsort(-last, kind="stable")[:k]
    return [{"feature": int(j),
             "viol_final": float(last[j]),
             "viol_max": float(np.max(v[:, j])),
             "iters_violating": int(np.sum(v[:, j] > tol))}
            for j in order]


def violation_histogram(kkt_vec, bounds=VIOL_BOUNDS) -> dict:
    """Distribution of the FINAL iteration's per-feature violations.

    Same shape contract as obs histograms: len(counts) == len(bounds)+1.
    Exact zeros (satisfied features — the common case at convergence)
    are counted separately so the log buckets describe the violating
    tail, not a spike at the bottom bucket.
    """
    last = _series(kkt_vec)[-1]
    nonzero = last[last > 0.0]
    edges = np.asarray(bounds, np.float64)
    counts = np.zeros(edges.shape[0] + 1, np.int64)
    if nonzero.size:
        counts += np.bincount(np.searchsorted(edges, nonzero, side="left"),
                              minlength=edges.shape[0] + 1)
    return {"count": int(last.shape[0]),
            "zeros": int(last.shape[0] - nonzero.size),
            "max": float(np.max(last)) if last.size else 0.0,
            "mean_nonzero": float(np.mean(nonzero)) if nonzero.size else 0.0,
            "bounds": [float(b) for b in edges],
            "counts": counts.tolist()}


def active_churn(kkt_vec, tol: float) -> dict:
    """Per-iteration churn of the violating set {j : viol_j > tol}.

    `entered[k]` / `left[k]` count features crossing tol between
    iterations k-1 and k (both 0 at k=0). Persistent churn late in a run
    is the signature of a bundle size the data cannot support: parallel
    updates keep re-violating features the previous iteration fixed.
    """
    v = _series(kkt_vec)
    viol = v > float(tol)
    n_violating = viol.sum(axis=1)
    flips = viol[1:] ^ viol[:-1]
    entered = np.concatenate([[0], (flips & viol[1:]).sum(axis=1)])
    left = np.concatenate([[0], (flips & ~viol[1:]).sum(axis=1)])
    return {"tol": float(tol),
            "n_violating": n_violating.astype(int).tolist(),
            "entered": entered.astype(int).tolist(),
            "left": left.astype(int).tolist(),
            "total_churn": int(entered.sum() + left.sum())}


def attribution(kkt_vec, tol: float, top_k: int = 10) -> dict:
    """The full attribution block the health report renders: offender
    table + final-iteration distribution + churn series."""
    v = _series(kkt_vec)
    return {"n_iters": int(v.shape[0]),
            "n_features": int(v.shape[1]),
            "offenders": top_offenders(v, k=top_k, tol=tol),
            "histogram": violation_histogram(v),
            "churn": active_churn(v, tol)}
