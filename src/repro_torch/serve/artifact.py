"""Versioned on-disk model format, shared with the JAX package.

Numpy copy of `repro.serve.artifact`: the same `repro.serve/model@1` JSON
(`SCHEMA`), so an artifact saved by either package loads in the other.
That file is how weights cross between the two packages.

An l1 solution is sparse by construction, so a model ships as its active
set -- (indices, values) of the nonzero weights -- plus everything needed
to score a request and to audit where the model came from: loss name,
regularization c, optional bias, the label each model separates (OVR) or
its grid position (path family), and solver provenance.

One JSON file holds either a single binary model or a *family* of models
sharing (n_features, loss): a one-vs-rest head (kind="ovr", one model per
class) or a regularization-path sweep (kind="path", one model per grid
point).

The format extends the `--out` report of `launch.solve`: a report written
with the artifact fields is at once a loadable model, a warm-start input
(it keeps the `w_indices`/`w_values`/`n_features` record
`launch.common.load_warm_start` reads) and a history log. `load_model`
refuses files without the schema tag, so stale reports fail with a clear
message.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.fault.atomic import atomic_write_json

SCHEMA = "repro.serve/model@1"


@dataclasses.dataclass(frozen=True)
class ModelArtifact:
    """One sparse linear classifier: score(x) = w . x + bias.

    Weights are stored as the active set only; `w_indices` is sorted
    strictly ascending, `w_values` is aligned with it. `label` is the
    class this model separates in an OVR head (None for binary / path
    members); `meta` carries per-model fit diagnostics (objective, kkt,
    n_outer, converged) -- free-form, never needed for scoring.
    """

    n_features: int
    w_indices: np.ndarray          # (nnz,) int64, sorted ascending
    w_values: np.ndarray           # (nnz,) float64
    loss_name: str
    c: float
    bias: float = 0.0
    label: Optional[float] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        idx = np.asarray(self.w_indices, np.int64).reshape(-1)
        val = np.asarray(self.w_values, np.float64).reshape(-1)
        if idx.shape != val.shape:
            raise ValueError(f"w_indices {idx.shape} vs w_values "
                             f"{val.shape} length mismatch")
        if idx.size:
            if int(idx.min()) < 0 or int(idx.max()) >= self.n_features:
                raise ValueError(
                    f"w_indices outside [0, {self.n_features})")
            if np.any(np.diff(idx) <= 0):
                raise ValueError("w_indices must be sorted strictly "
                                 "ascending (duplicate or unsorted index)")
        object.__setattr__(self, "w_indices", idx)
        object.__setattr__(self, "w_values", val)

    @property
    def nnz(self) -> int:
        return int(self.w_indices.shape[0])

    def sparsity(self) -> float:
        return 1.0 - self.nnz / float(max(self.n_features, 1))

    def dense_weights(self, dtype=np.float32) -> np.ndarray:
        w = np.zeros((self.n_features,), dtype)
        w[self.w_indices] = self.w_values.astype(dtype)
        return w

    def _to_json(self) -> dict:
        d = {"c": float(self.c), "bias": float(self.bias),
             "w_indices": self.w_indices.tolist(),
             "w_values": self.w_values.tolist()}
        if self.label is not None:
            d["label"] = self.label
        if self.meta:
            d["meta"] = self.meta
        return d


def artifact_from_solution(w, loss_name: str, c: float, bias: float = 0.0,
                           label=None, meta: Optional[dict] = None,
                           ) -> ModelArtifact:
    """Build an artifact from a dense solution vector (numpy, or a tensor
    on any device)."""
    if hasattr(w, "detach"):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float64).reshape(-1)
    idx = np.flatnonzero(w)
    return ModelArtifact(n_features=int(w.shape[0]), w_indices=idx,
                         w_values=w[idx], loss_name=loss_name, c=float(c),
                         bias=float(bias), label=label, meta=meta or {})


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """Models sharing (n_features, loss): binary (1), ovr (K), path (K).

    For kind="ovr" every member carries its `label` and `classes` lists
    them in model order (argmax over member margins indexes into it);
    for kind="path" members are ordered by their grid c (ascending, the
    sweep order). kind="binary" has exactly one member.
    """

    kind: str                      # "binary" | "ovr" | "path"
    models: Tuple[ModelArtifact, ...]
    provenance: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ("binary", "ovr", "path"):
            raise ValueError(f"unknown family kind {self.kind!r}")
        if not self.models:
            raise ValueError("empty model family")
        if self.kind == "binary" and len(self.models) != 1:
            raise ValueError("kind='binary' must hold exactly one model")
        m0 = self.models[0]
        for m in self.models:
            if (m.n_features, m.loss_name) != (m0.n_features, m0.loss_name):
                raise ValueError(
                    "family members must share (n_features, loss); got "
                    f"({m.n_features}, {m.loss_name!r}) vs "
                    f"({m0.n_features}, {m0.loss_name!r})")
        if self.kind == "ovr":
            labels = [m.label for m in self.models]
            if any(lb is None for lb in labels):
                raise ValueError("every ovr member needs its class label")
            try:
                ordered = all(a < b for a, b in zip(labels, labels[1:]))
            except TypeError:
                raise ValueError(
                    f"ovr class labels must be mutually orderable, got "
                    f"{labels!r}")
            if not ordered:
                # serving maps file-side class codes to model order by
                # SORTED vocabulary position (launch.predict), so model
                # order must be the sorted label order, no duplicates
                raise ValueError(
                    f"ovr members must be in strictly ascending label "
                    f"order, got {labels!r}")
        object.__setattr__(self, "models", tuple(self.models))

    def __len__(self) -> int:
        return len(self.models)

    def __iter__(self):
        return iter(self.models)

    @property
    def model(self) -> ModelArtifact:
        """The single member of a binary family (errors otherwise)."""
        if len(self.models) != 1:
            raise ValueError(f"family has {len(self.models)} models; "
                             f"pick one explicitly")
        return self.models[0]

    @property
    def n_features(self) -> int:
        return self.models[0].n_features

    @property
    def loss_name(self) -> str:
        return self.models[0].loss_name

    @property
    def classes(self) -> Optional[np.ndarray]:
        """Label vocabulary in model order (ovr families only)."""
        if self.kind != "ovr":
            return None
        return np.asarray([m.label for m in self.models])

    @property
    def cs(self) -> np.ndarray:
        return np.asarray([m.c for m in self.models], np.float64)

    def dense_weights(self, dtype=np.float32) -> np.ndarray:
        """(K, n) densified stack -- debug / reference scoring only."""
        return np.stack([m.dense_weights(dtype) for m in self.models])


def solver_provenance(solver: str = "pcdn", dataset: Optional[str] = None,
                      **cfg_fields) -> dict:
    """Standard provenance block: who fitted this and with what knobs."""
    prov = {"solver": solver, "created_unix": time.time(),
            "repro": "arxiv:1306.4080 PCDN"}
    if dataset is not None:
        prov["dataset"] = str(dataset)
    prov.update({k: v for k, v in cfg_fields.items() if v is not None})
    return prov


def save_model(path: str, family, extra: Optional[dict] = None) -> dict:
    """Write a ModelFamily (or a lone ModelArtifact) as one JSON file.

    `extra` merges additional top-level keys into the payload -- this is
    how `launch.solve --out` keeps its history / timing fields next to the
    artifact ones. Reserved artifact keys cannot be overridden. Returns
    the payload written. The write is atomic (`fault.atomic`): a reader
    never observes a torn artifact, and a crash mid-save leaves any
    previous one intact.
    """
    if isinstance(family, ModelArtifact):
        family = ModelFamily(kind="binary", models=(family,))
    payload = {}
    if extra:
        payload.update(extra)
    reserved = {"schema", "kind", "loss", "n_features", "models"}
    clash = reserved & set(extra or ())
    if clash:
        raise ValueError(f"extra keys {sorted(clash)} collide with the "
                         f"artifact schema")
    payload.update({
        "schema": SCHEMA,
        "kind": family.kind,
        "loss": family.loss_name,
        "n_features": family.n_features,
        "provenance": {**family.provenance, **payload.get("provenance", {})},
        "models": [m._to_json() for m in family.models],
    })
    if family.kind == "ovr":
        payload["classes"] = [m.label for m in family.models]
    atomic_write_json(path, payload, indent=1, default=float)
    return payload


def load_model(path: str) -> ModelFamily:
    """Load a model family; validates the schema tag and weight records."""
    with open(path) as fh:
        obj = json.load(fh)
    return family_from_payload(obj, source=path)


def family_from_payload(obj: dict, source: str = "<payload>") -> ModelFamily:
    schema = obj.get("schema")
    if schema != SCHEMA:
        hint = ""
        if schema is None and "w_indices" in obj:
            hint = (" (looks like a pre-artifact --out report: it still "
                    "works as --warm-start input, but re-run the solve "
                    "to get a servable model)")
        raise ValueError(f"{source}: not a {SCHEMA} artifact "
                         f"(schema={schema!r}){hint}")
    n = int(obj["n_features"])
    loss = obj["loss"]
    models = []
    for m in obj["models"]:
        models.append(ModelArtifact(
            n_features=n,
            w_indices=np.asarray(m["w_indices"], np.int64),
            w_values=np.asarray(m["w_values"], np.float64),
            loss_name=loss, c=float(m["c"]),
            bias=float(m.get("bias", 0.0)),
            label=m.get("label"), meta=m.get("meta", {})))
    return ModelFamily(kind=obj["kind"], models=tuple(models),
                       provenance=obj.get("provenance", {}))


def pick_best_c(family: ModelFamily, metric: str = "val_accuracy",
                ) -> Tuple[int, ModelArtifact]:
    """Best grid point of a kind="path" family -> (index, artifact).

    Maximize `metric` from each member's fit meta, break ties by fewer
    nonzeros, then by the EARLIER grid point (smaller c -- the stronger
    regularizer). metric="nnz" inverts to "sparsest member" (min nnz,
    ties -> earlier). Raises if no member records the metric -- a family
    without validation scores has nothing to select on.
    """
    if family.kind != "path":
        raise ValueError(f"pick_best_c selects over a path family, got "
                         f"kind={family.kind!r}")
    if metric == "nnz":
        scored = [(-(m.nnz), -i) for i, m in enumerate(family.models)]
    else:
        scored = []
        for i, m in enumerate(family.models):
            v = m.meta.get(metric)
            if v is None:
                continue
            scored.append((float(v), -m.nnz, -i))
        if not scored:
            raise ValueError(
                f"no member of the family records meta[{metric!r}] -- "
                f"fit the path with a validation split (launch.path "
                f"--val-frac) to enable best-c selection")
    best = max(scored)
    i = -best[-1]
    return i, family.models[i]


def path_family(weights: np.ndarray, cs: Sequence[float], loss_name: str,
                metas: Optional[Sequence[dict]] = None,
                provenance: Optional[dict] = None) -> ModelFamily:
    """Family from a path sweep's (K, n) weight stack + its c-grid."""
    weights = np.asarray(weights)
    if weights.shape[0] != len(cs):
        raise ValueError(f"{weights.shape[0]} weight rows vs {len(cs)} cs")
    models = tuple(
        artifact_from_solution(weights[i], loss_name, float(cs[i]),
                               meta=(metas[i] if metas else None))
        for i in range(len(cs)))
    return ModelFamily(kind="path", models=models,
                       provenance=provenance or {})
