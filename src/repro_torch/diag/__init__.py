"""Solver-health diagnostics of the port (mirrors `repro.diag`).

Interprets what the engine and telemetry record -- the per-bundle (q,
alpha) aux plane, the opt-in per-feature KKT violation series, metrics
records and traces:

* `diag.kkt`       -- per-feature KKT attribution: top-k offender tables,
                      violation distributions, active-set churn.
* `diag.forensics` -- backtrack forensics: per-bundle depth heatmaps and
                      the divergence post-mortem the engine attaches to
                      `SolveResult.postmortem` when a guard trips.
* `diag.safep`     -- certified safe parallelism: the power-iteration
                      spectral radius of the normalized Gram matrix and
                      the omega-based ESO bound, off the design matrix.
* `diag.report`    -- one markdown health report
                      (`python -m repro_torch.diag.report`; `--diag-out`
                      on the solve/path CLIs).

Payloads and markdown equal the reference's on the same inputs. diag
consumes the engine; the engine's one reference back is its local import
of `forensics.divergence_postmortem` on a guard trip.
"""
from repro_torch.diag import forensics, kkt, safep  # noqa: F401
from repro_torch.diag.forensics import (backtrack_heatmap,
                                        divergence_postmortem)
from repro_torch.diag.kkt import attribution
from repro_torch.diag.safep import certify

__all__ = [
    "kkt", "forensics", "safep", "report",
    "attribution", "backtrack_heatmap", "divergence_postmortem",
    "certify", "build_payload", "render_markdown",
]


def __getattr__(name):
    # `report` loads lazily so `python -m repro_torch.diag.report` does
    # not trip runpy's found-in-sys.modules warning through its own
    # parent package's import.
    if name in ("report", "build_payload", "render_markdown"):
        import importlib
        # importlib, not `from repro_torch.diag import report`: the
        # from-form re-enters this __getattr__ and recurses
        _report = importlib.import_module("repro_torch.diag.report")
        if name == "report":
            return _report
        return getattr(_report, name)
    raise AttributeError(
        f"module 'repro_torch.diag' has no attribute {name!r}")
