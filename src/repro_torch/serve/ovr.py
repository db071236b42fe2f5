"""One-vs-rest multiclass training on the batch solver (port of
`repro.serve.ovr`).

A K-class l1 problem decomposes into K independent binary subproblems
"class k vs the rest" (Bradley et al., Parallel Coordinate Descent for
L1-Regularized Loss Minimization) -- the workload of
`path.batch.solve_batch`: K problems sharing ONE DesignMatrix (resident
once on the device), differing only in their (K, s) label matrix,
advanced in lockstep with per-problem freeze-on-convergence (on the
padded-CSC support scope with the kernels, one K1 launch a problem a
bundle).

`fit_ovr` holds one design on the device whatever K is, and its output is
the multi-model artifact family the serving layer consumes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np

from repro_torch.core.pcdn import PCDNConfig
from repro_torch.core.problem import L1Problem, make_problem
from repro_torch.path.batch import BatchSolveResult, solve_batch
from repro_torch.serve import artifact as art


def encode_labels(y) -> tuple[np.ndarray, np.ndarray]:
    """Raw labels (ints, floats, strings) -> (codes (s,) int32, classes).

    classes is the sorted unique vocabulary; codes index into it. The
    same encoding `data.libsvm.load_libsvm(..., return_classes=True)`
    produces -- use that directly for libsvm files.
    """
    y = np.asarray(y)
    classes, codes = np.unique(y, return_inverse=True)
    return codes.astype(np.int32), classes


def ovr_label_matrix(codes, n_classes: Optional[int] = None,
                     dtype=np.float32) -> np.ndarray:
    """(K, s) +-1 label matrix: row k is +1 where codes == k, else -1."""
    codes = np.asarray(codes, np.int64)
    if codes.size == 0:
        raise ValueError("no labels")
    k = int(n_classes) if n_classes is not None else int(codes.max()) + 1
    if codes.min() < 0 or codes.max() >= k:
        raise ValueError(f"codes outside [0, {k})")
    return np.where(codes[None, :] == np.arange(k)[:, None],
                    1.0, -1.0).astype(dtype)


class OVRResult(NamedTuple):
    classes: np.ndarray         # (K,) label vocabulary, model order
    weights: np.ndarray         # (K, n) per-class solutions (host)
    cs: np.ndarray              # (K,) regularization value per class
    batch: BatchSolveResult     # raw per-problem solver diagnostics
    train_accuracy: float       # argmax-margin accuracy on the fit data


def fit_ovr(X, y, c: Union[float, Sequence[float]], cfg: PCDNConfig,
            loss: str = "logistic", classes: Optional[np.ndarray] = None,
            layout: str = "auto", seeds: Optional[Sequence[int]] = None,
            problem: Optional[L1Problem] = None,
            device="cuda") -> OVRResult:
    """Fit a one-vs-rest head: K binary l1 problems in one lockstep solve
    on `device` (the card by default).

    y: integer class codes (with `classes` as vocabulary, e.g. from
    `load_libsvm(..., return_classes=True)`) or raw labels (vocabulary
    derived by `encode_labels`). c: shared scalar or one value per class.
    problem: optional prebuilt L1Problem over X (its labels are ignored;
    the design matrix is reused as-is, on its own device).
    """
    if classes is None:
        codes, classes = encode_labels(y)
    else:
        codes = np.asarray(y, np.int64)
        classes = np.asarray(classes)
        order = np.argsort(classes, kind="stable")
        if not np.array_equal(order, np.arange(order.shape[0])):
            # canonicalize to the sorted vocabulary every other layer
            # assumes (libsvm codes, ModelFamily, launch.predict): remap
            # the caller's codes into sorted-class positions
            classes = classes[order]
            codes = np.argsort(order)[codes]
    K = int(classes.shape[0])
    if K < 2:
        raise ValueError(f"need >= 2 classes, got {K}")
    ys = ovr_label_matrix(codes, K)
    # np.ndim, not np.isscalar: numpy floats (spec fields, res.cs[k]) are
    # 0-d to ndim but NOT np.isscalar-true
    cs = np.full((K,), float(c), np.float64) if np.ndim(c) == 0 \
        else np.asarray(c, np.float64)
    if cs.shape != (K,):
        raise ValueError(f"need one c per class ({K}), got {cs.shape}")

    if problem is None:
        problem = make_problem(X, ys[0], c=float(cs[0]), loss=loss,
                               layout=layout, device=device)
    bres = solve_batch(problem, cfg, cs, ys=ys, seeds=seeds)
    weights = bres.w.cpu().numpy()
    # train accuracy straight off the final margins the carry already holds
    pred = np.argmax(bres.z.cpu().numpy(), axis=0)
    acc = float(np.mean(pred == codes))
    return OVRResult(classes=classes, weights=weights, cs=cs, batch=bres,
                     train_accuracy=acc)


def ovr_margins(weights: np.ndarray, X) -> np.ndarray:
    """(B, K) reference margins X @ W.T (numpy; serving uses serve.predict)."""
    return np.asarray(X) @ np.asarray(weights).T


def ovr_family(res: OVRResult, loss_name: str,
               provenance: Optional[dict] = None) -> "art.ModelFamily":
    """Package an OVR fit as a servable kind="ovr" model family."""
    models = []
    for k in range(res.classes.shape[0]):
        label = res.classes[k]
        label = label.item() if hasattr(label, "item") else label
        models.append(art.artifact_from_solution(
            res.weights[k], loss_name, float(res.cs[k]), label=label,
            meta={"objective": float(res.batch.objective[k]),
                  "kkt": float(res.batch.kkt[k]),
                  "n_outer": int(res.batch.n_outer[k]),
                  "converged": bool(res.batch.converged[k])}))
    return art.ModelFamily(kind="ovr", models=tuple(models),
                           provenance=provenance or {})
