"""Backtrack forensics (port of `repro.diag.forensics`).

Folds the per-bundle line-search aux series (`SolveHistory.bundle_q` /
`bundle_alpha`: on the fused support step, the step counts and alphas K1
writes) into interpretable shapes:

* `backtrack_heatmap` -- the (iteration x depth) picture of where the
  Armijo search worked hard: the depth distribution, per-iteration
  mean/max depth, and the share of bundles backtracking deep.
* `divergence_postmortem` -- the record the engine attaches to
  `SolveResult.postmortem` when the divergence guard or the non-finite
  detector trips: objective growth since onset, the alpha trajectory,
  and the deepest bundles.

Sentinels: q == -1 / alpha == nan mark bundle slots past the dynamic
trip count under shrinking; both are masked out, never averaged in.
Host numpy only; the outputs equal the reference's on the same series.
"""
from __future__ import annotations

import numpy as np

# a bundle that needed >= DEEP_Q halvings took a step <= beta^3 of the
# Newton step — the empirical "data fought back" threshold the report
# and the post-mortem both quote.
DEEP_Q = 3


def _mask(bundle_q) -> tuple:
    q = np.asarray(bundle_q, np.float64)
    if q.ndim == 1:
        q = q[None, :]
    return q, q >= 0  # sentinel -1 == bundle never ran


def backtrack_heatmap(bundle_q, deep_q: int = DEEP_Q) -> dict:
    """Depth heatmap of a (K, b) per-bundle backtrack-count series.

    `depth_counts[d]` counts bundle-steps across the whole run that
    backtracked exactly d times; the per-iteration series say *when*
    the deep ones happened.
    """
    q, ran = _mask(bundle_q)
    ran_q = q[ran].astype(np.int64)
    max_q = int(ran_q.max()) if ran_q.size else 0
    depth_counts = np.bincount(ran_q, minlength=max_q + 1) \
        if ran_q.size else np.zeros(1, np.int64)
    with np.errstate(invalid="ignore"):
        qm = np.where(ran, q, np.nan)
        per_iter_mean = np.nanmean(qm, axis=1)
        per_iter_max = np.nanmax(qm, axis=1)
        n_ran = ran.sum(axis=1)
        deep_frac = np.where(
            n_ran > 0, (qm >= deep_q).sum(axis=1) / np.maximum(n_ran, 1), 0.0)
    return {"n_iters": int(q.shape[0]),
            "n_bundle_slots": int(q.shape[1]),
            "bundles_ran": int(ran_q.size),
            "deep_q": int(deep_q),
            "depth_counts": depth_counts.tolist(),
            "per_iter_mean": np.nan_to_num(per_iter_mean).tolist(),
            "per_iter_max": np.nan_to_num(per_iter_max).tolist(),
            "per_iter_deep_frac": np.asarray(deep_frac).tolist()}


def alpha_trajectory(bundle_alpha) -> dict:
    """Per-iteration min/mean accepted step over the bundles that ran —
    the alpha-collapse curve a diverging high-P solve draws on its way
    to the guard."""
    a = np.asarray(bundle_alpha, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    with np.errstate(invalid="ignore"):
        per_iter_min = np.nanmin(a, axis=1)
        per_iter_mean = np.nanmean(a, axis=1)
    return {"per_iter_min": np.nan_to_num(per_iter_min, nan=1.0).tolist(),
            "per_iter_mean": np.nan_to_num(per_iter_mean, nan=1.0).tolist()}


def worst_bundles(bundle_q, k: int = 5) -> list:
    """The k deepest (iteration, bundle, q) cells of the run."""
    q, ran = _mask(bundle_q)
    flat = np.where(ran, q, -1.0).ravel()
    k = min(int(k), int((flat >= 0).sum()))
    if k == 0:
        return []
    order = np.argsort(-flat, kind="stable")[:k]
    b = q.shape[1]
    return [{"iter": int(i // b), "bundle": int(i % b),
             "q": int(flat[i])} for i in order if flat[i] >= 0]


def divergence_postmortem(objective, kkt, ls_steps,
                          bundle_q=None, bundle_alpha=None) -> dict:
    """Post-mortem dict for a divergence-guard trip (engine/loop.py).

    Built from whatever history rows exist at the trip; richer when the
    per-bundle aux rode along (record_aux). Always JSON-serializable.
    Keys `objective_growth` and `deepest_mean_q` are load-bearing — the
    engine forwards them onto the trace as an instant event.
    """
    obj = np.asarray(objective, np.float64)
    kkt = np.asarray(kkt, np.float64)
    ls = np.asarray(ls_steps, np.float64)
    trip = int(obj.shape[0]) - 1
    # nanargmin/nanargmax raise on all-NaN input, which a non-finite
    # trip on the very first iteration produces — fall back to row 0
    obj_ok = obj.size and bool(np.any(np.isfinite(obj)))
    ls_ok = ls.size and bool(np.any(np.isfinite(ls)))
    onset = int(np.nanargmin(obj)) if obj_ok else 0
    pm = {
        "trip_iter": trip,
        "onset_iter": onset,
        "objective_at_onset": float(obj[onset]) if obj.size else float("nan"),
        "objective_at_trip": float(obj[-1]) if obj.size else float("nan"),
        "objective_growth": float(obj[-1] - obj[onset]) if obj.size
        else float("nan"),
        "kkt_at_trip": float(kkt[-1]) if kkt.size else float("nan"),
        "deepest_mean_q": float(np.nanmax(ls)) if ls_ok else float("nan"),
        "deepest_mean_q_iter": int(np.nanargmax(ls)) if ls_ok else 0,
    }
    if bundle_q is not None:
        pm["heatmap"] = backtrack_heatmap(bundle_q)
        pm["worst_bundles"] = worst_bundles(bundle_q)
    if bundle_alpha is not None:
        traj = alpha_trajectory(bundle_alpha)
        pm["alpha"] = traj
        mins = np.asarray(traj["per_iter_min"], np.float64)
        pm["alpha_floor"] = float(mins.min()) if mins.size else 1.0
        pm["alpha_floor_iter"] = int(mins.argmin()) if mins.size else 0
    return pm
