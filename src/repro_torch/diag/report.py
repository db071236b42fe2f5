"""Markdown solver-health report (port of `repro.diag.report`).

    python -m repro_torch.diag.report --report report.json \
        [--metrics run.jsonl] [--trace trace.json] \
        [--dataset NAME|FILE --layout auto] [-o health.md] [--device cuda]

Assembles every diagnostics surface into one markdown document, with the
reference's sections and text:

* run summary + convergence trajectory (from a `launch.solve --out` /
  `launch.path --out` report JSON of either package),
* top-k per-feature KKT offenders, violation distribution and
  active-set churn (when the run recorded `history.kkt_vec` -- i.e. ran
  with `--diag-out`),
* backtrack-depth forensics from `history.bundle_q / bundle_alpha` and
  the divergence post-mortem if a guard tripped,
* the certified-P table (`diag.safep`) next to the observed P -- pass
  `--dataset` to recompute it from data (the design is built on
  `--device`), or it rides along inside a `--diag-out` report under the
  `"diag"` key,
* metrics / trace summaries when the JSONL / trace files are given.

The solve/path CLIs call `build_payload` + `render_markdown` directly
for `--diag-out`; this module's CLI re-renders the same report from
saved artifacts after the fact.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.diag import forensics, kkt, safep

BAR_WIDTH = 40  # widest ascii histogram bar


# ---------------------------------------------------------------------------
# payload assembly

def build_payload(report: dict | None = None,
                  metrics_records: list | None = None,
                  trace: dict | None = None,
                  safep_record: dict | None = None,
                  tol_kkt: float | None = None,
                  top_k: int = 10) -> dict:
    """One JSON-ready dict with every section the renderer knows.

    `report` is a solve/path `--out` payload (artifact schema + history);
    absent inputs simply drop their sections — the report degrades
    gracefully down to whatever artifacts exist.
    """
    payload: dict = {"sections": []}
    if report is not None:
        prov = report.get("provenance") or {}
        hist = _pick_history(report)
        tol = tol_kkt if tol_kkt is not None else prov.get("tol_kkt", 1e-3)
        payload["summary"] = {
            "dataset": prov.get("dataset"),
            "solver": prov.get("solver"),
            "backend": prov.get("backend"),
            "P": prov.get("P"),
            "loss": report.get("loss") or prov.get("loss"),
            "n_features": report.get("n_features"),
            "objective": report.get("objective"),
            "converged": report.get("converged"),
            "nnz": report.get("nnz"),
            "seconds": report.get("seconds"),
            "tol_kkt": tol,
        }
        payload["sections"].append("summary")
        if hist:
            payload["convergence"] = _convergence(hist, tol)
            payload["sections"].append("convergence")
            if hist.get("kkt_vec"):
                payload["attribution"] = kkt.attribution(
                    hist["kkt_vec"], tol=float(tol), top_k=top_k)
                payload["sections"].append("attribution")
            if hist.get("bundle_q"):
                payload["backtracks"] = forensics.backtrack_heatmap(
                    hist["bundle_q"])
                if hist.get("bundle_alpha"):
                    payload["backtracks"]["alpha"] = \
                        forensics.alpha_trajectory(hist["bundle_alpha"])
                payload["sections"].append("backtracks")
        pm = report.get("postmortem")
        if pm:
            payload["postmortem"] = pm
            payload["sections"].append("postmortem")
        if safep_record is None and isinstance(report.get("diag"), dict):
            safep_record = report["diag"].get("safep")
    if safep_record is not None:
        if payload.get("summary", {}).get("P") is not None \
                and "observed_P" not in safep_record:
            safep_record = dict(safep_record,
                                observed_P=int(payload["summary"]["P"]))
        payload["safep"] = safep_record
        payload["sections"].append("safep")
    if metrics_records:
        payload["metrics"] = _metrics_summary(metrics_records[-1])
        payload["sections"].append("metrics")
    if trace is not None:
        payload["trace"] = _trace_summary(trace)
        payload["sections"].append("trace")
    return payload


def _pick_history(report: dict) -> dict | None:
    """A solve report carries `history` directly; a path report carries
    per-point histories — take the last grid point's (the tightest c,
    where parallelism stress peaks)."""
    hist = report.get("history")
    if isinstance(hist, dict):
        return hist
    pts = report.get("points") or report.get("results")
    if isinstance(pts, list) and pts and isinstance(pts[-1], dict):
        h = pts[-1].get("history")
        if isinstance(h, dict):
            return h
    return None


def _convergence(hist: dict, tol) -> dict:
    obj = np.asarray(hist.get("objective", []), np.float64)
    kkt_s = np.asarray(hist.get("kkt", []), np.float64)
    ls = np.asarray(hist.get("ls_steps", []), np.float64)
    out = {"n_outer": int(obj.shape[0])}
    if obj.size:
        out.update(objective_first=float(obj[0]),
                   objective_final=float(obj[-1]))
    if kkt_s.size:
        out.update(kkt_final=float(kkt_s[-1]), tol_kkt=float(tol),
                   kkt_met=bool(kkt_s[-1] <= float(tol)))
    if ls.size:
        out.update(mean_q_final=float(ls[-1]),
                   mean_q_max=float(np.nanmax(ls)))
    if hist.get("n_active"):
        na = hist["n_active"]
        out.update(n_active_first=int(na[0]), n_active_final=int(na[-1]))
    return out


def _metrics_summary(record: dict) -> dict:
    m = record.get("metrics", {})
    hists = m.get("histograms", {})
    keep = {}
    for name in ("solver.iter_seconds", "solver.bundle_q",
                 "solver.bundle_alpha", "solver.mean_q"):
        h = hists.get(name)
        if h:
            keep[name] = {k: h.get(k)
                          for k in ("count", "mean", "p50", "p99", "max")}
    return {"ts": record.get("ts"), "cli": record.get("cli"),
            "counters": m.get("counters", {}),
            "gauges": m.get("gauges", {}),
            "histograms": keep}


def _trace_summary(trace: dict) -> dict:
    events = trace.get("traceEvents", [])
    by_name: dict = {}
    for ev in events:
        if not isinstance(ev, dict):
            continue
        name = ev.get("name", "?")
        rec = by_name.setdefault(name, {"events": 0, "total_ms": 0.0})
        rec["events"] += 1
        if ev.get("ph") == "X":
            rec["total_ms"] += float(ev.get("dur", 0)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["total_ms"])[:8]
    return {"n_events": len(events),
            "top_spans": [{"name": k, **v} for k, v in top]}


# ---------------------------------------------------------------------------
# markdown rendering

def _bar(count: int, peak: int) -> str:
    if peak <= 0:
        return ""
    return "#" * max(1, int(round(BAR_WIDTH * count / peak))) \
        if count else ""


def _fmt(x) -> str:
    if x is None:
        return "—"
    if isinstance(x, bool):
        return "yes" if x else "no"
    if isinstance(x, float):
        return f"{x:.4g}"
    return str(x)


def render_markdown(payload: dict) -> str:
    out = ["# Solver health report", ""]
    s = payload.get("summary")
    if s:
        out += ["## Run summary", "",
                "| field | value |", "|---|---|"]
        for k in ("dataset", "solver", "backend", "P", "loss",
                  "n_features", "objective", "converged", "nnz",
                  "seconds", "tol_kkt"):
            out.append(f"| {k} | {_fmt(s.get(k))} |")
        out.append("")
    c = payload.get("convergence")
    if c:
        out += ["## Convergence", ""]
        out.append(f"- {c['n_outer']} outer iterations; objective "
                   f"{_fmt(c.get('objective_first'))} → "
                   f"{_fmt(c.get('objective_final'))}")
        if "kkt_final" in c:
            verdict = "met" if c.get("kkt_met") else "NOT met"
            out.append(f"- final KKT violation {_fmt(c['kkt_final'])} vs "
                       f"tol {_fmt(c.get('tol_kkt'))} ({verdict})")
        if "mean_q_max" in c:
            out.append(f"- line search: final mean q "
                       f"{_fmt(c.get('mean_q_final'))}, deepest mean q "
                       f"{_fmt(c['mean_q_max'])}")
        if "n_active_first" in c:
            out.append(f"- active set {c['n_active_first']} → "
                       f"{c['n_active_final']} features")
        out.append("")
    a = payload.get("attribution")
    if a:
        out += ["## Top KKT offenders", "",
                "| feature | viol (final) | viol (max) | iters > tol |",
                "|---|---|---|---|"]
        for row in a["offenders"]:
            out.append(f"| {row['feature']} | {row['viol_final']:.3e} | "
                       f"{row['viol_max']:.3e} | "
                       f"{row['iters_violating']} |")
        h = a["histogram"]
        out += ["", "### Final violation distribution", "",
                f"{h['zeros']} / {h['count']} features exactly satisfied; "
                f"max violation {h['max']:.3e}.", "", "```"]
        peak = max(h["counts"]) if h["counts"] else 0
        edges = ["<=%.0e" % b for b in h["bounds"]] + \
                ["> %.0e" % h["bounds"][-1]]
        for label, cnt in zip(edges, h["counts"]):
            if cnt:
                out.append(f"{label:>10}  {cnt:>8}  {_bar(cnt, peak)}")
        out += ["```", ""]
        ch = a["churn"]
        nv = ch["n_violating"]
        out += ["### Active-set churn", "",
                f"- violating features (>{ch['tol']:g}): {nv[0]} → "
                f"{nv[-1]} over {len(nv)} iterations",
                f"- total churn (tol crossings): {ch['total_churn']} "
                f"(entered {sum(ch['entered'])}, left {sum(ch['left'])})",
                ""]
    b = payload.get("backtracks")
    if b:
        out += ["## Backtrack forensics", "",
                f"{b['bundles_ran']} bundle steps over {b['n_iters']} "
                f"iterations.", "", "```"]
        peak = max(b["depth_counts"]) if b["depth_counts"] else 0
        for d, cnt in enumerate(b["depth_counts"]):
            if cnt:
                out.append(f"q={d:<3} {cnt:>8}  {_bar(cnt, peak)}")
        out += ["```", ""]
        deep = np.asarray(b["per_iter_deep_frac"], np.float64)
        if deep.size:
            out.append(f"- deep bundles (q >= {b['deep_q']}): "
                       f"{100 * float(deep.mean()):.2f}% of bundles on "
                       f"average, worst iteration "
                       f"{100 * float(deep.max()):.2f}%")
        alpha = b.get("alpha")
        if alpha and alpha["per_iter_min"]:
            mins = np.asarray(alpha["per_iter_min"], np.float64)
            out.append(f"- accepted alpha floor {float(mins.min()):.3g} "
                       f"(iteration {int(mins.argmin())})")
        out.append("")
    pm = payload.get("postmortem")
    if pm:
        out += ["## Divergence post-mortem", "",
                f"- guard tripped at iteration {pm.get('trip_iter')}; "
                f"objective grew {_fmt(pm.get('objective_growth'))} since "
                f"its minimum at iteration {pm.get('onset_iter')}",
                f"- deepest mean backtrack depth "
                f"{_fmt(pm.get('deepest_mean_q'))} at iteration "
                f"{pm.get('deepest_mean_q_iter')}"]
        if pm.get("alpha_floor") is not None:
            out.append(f"- accepted alpha collapsed to "
                       f"{_fmt(pm['alpha_floor'])} at iteration "
                       f"{pm.get('alpha_floor_iter')}")
        for wb in pm.get("worst_bundles", [])[:5]:
            out.append(f"  - iteration {wb['iter']}, bundle "
                       f"{wb['bundle']}: q = {wb['q']}")
        out.append("")
    sp = payload.get("safep")
    if sp:
        out += ["## Certified parallelism", "",
                "| quantity | value |", "|---|---|",
                f"| n_features | {sp['n_features']} |",
                f"| rho (normalized Gram) | {sp['rho_normalized']:.4g} |",
                f"| P_spectral = n / rho | {sp['P_spectral']} |",
                f"| omega (max row support) | {sp['omega']} |",
                f"| P_eso (beta <= {sp['beta_max']:g}) | {sp['P_eso']} |",
                f"| **P_cert** | **{sp['P_cert']}** |"]
        if "observed_P" in sp:
            obs_p = sp["observed_P"]
            out.append(f"| observed P (divergence-free) | {obs_p} |")
            out.append("")
            if obs_p > sp["P_cert"]:
                out.append(
                    f"Observed P {obs_p} exceeds the certified bound "
                    f"{sp['P_cert']}: convergence rests on the Armijo "
                    f"backtrack, not on theory — expect deep q at this "
                    f"or larger P.")
            else:
                out.append(
                    f"Observed P {obs_p} is within the certified bound "
                    f"{sp['P_cert']}: the step sizes are theory-safe "
                    f"before the line search even runs.")
        if not sp.get("power_converged", True):
            out.append("")
            out.append(f"(power iteration stopped at {sp['power_iters']} "
                       f"iterations without meeting tolerance — rho is a "
                       f"lower bound)")
        out.append("")
    m = payload.get("metrics")
    if m:
        out += ["## Metrics summary", ""]
        ctr = m.get("counters", {})
        if ctr:
            shown = ", ".join(f"{k}={_fmt(v)}" for k, v in
                              sorted(ctr.items())[:8])
            out.append(f"- counters: {shown}")
        for name, h in m.get("histograms", {}).items():
            out.append(f"- {name}: count={h.get('count')} "
                       f"mean={_fmt(h.get('mean'))} "
                       f"p50={_fmt(h.get('p50'))} p99={_fmt(h.get('p99'))}")
        out.append("")
    t = payload.get("trace")
    if t:
        out += ["## Trace summary", "",
                f"{t['n_events']} trace events; busiest spans:", ""]
        for row in t["top_spans"]:
            out.append(f"- {row['name']}: {row['events']} events, "
                       f"{row['total_ms']:.1f} ms total")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


# ---------------------------------------------------------------------------
# CLI

def _load_design(dataset: str, layout: str, seed: int, device: str):
    """Rebuild just the design matrix for `--dataset` (profile name or
    libsvm file), on `device`, so the CLI can recompute the certified-P
    table."""
    from repro_torch.core.design_matrix import as_design
    from repro_torch.data import load_libsvm, paper_like
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if os.path.exists(dataset):
        file_layout = "padded_csc" if layout == "padded_csc" else "dense"
        X, _ = load_libsvm(dataset, layout=file_layout)
    else:
        X, _, _ = paper_like(dataset, seed=seed)
    return as_design(X, layout=layout, device=dev)


def _read_jsonl(path: str) -> list:
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.diag.report",
        description="Render a markdown solver-health report from saved "
                    "artifacts")
    ap.add_argument("--report", default=None, metavar="JSON",
                    help="a launch.solve/path --out report (history, "
                         "provenance, optional diag block)")
    ap.add_argument("--metrics", default=None, metavar="JSONL",
                    help="metrics run-record log (--metrics-out); the "
                         "last record is summarized")
    ap.add_argument("--trace", default=None, metavar="JSON",
                    help="Chrome-trace file (--trace-out)")
    ap.add_argument("--dataset", default=None,
                    help="recompute the certified-P table from this "
                         "dataset (profile name or libsvm file)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "dense", "padded_csc"])
    ap.add_argument("--beta-max", type=float, default=2.0,
                    help="ESO overapproximation budget (default 2.0)")
    ap.add_argument("--top-k", type=int, default=10,
                    help="offender-table size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --dataset's design is built and the power "
                         "iteration's products run; cuda raises when no "
                         "card is present")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=None,
                    help="KKT tolerance for attribution (default: the "
                         "report's provenance tol_kkt)")
    ap.add_argument("-o", "--out", default=None, metavar="MD",
                    help="write the report here (default: stdout)")
    args = ap.parse_args(argv)
    if not (args.report or args.metrics or args.trace or args.dataset):
        ap.error("nothing to report on: pass --report, --metrics, "
                 "--trace and/or --dataset")

    report = None
    if args.report:
        with open(args.report) as fh:
            report = json.load(fh)
    metrics_records = _read_jsonl(args.metrics) if args.metrics else None
    trace = None
    if args.trace:
        with open(args.trace) as fh:
            trace = json.load(fh)
    safep_record = None
    if args.dataset:
        design = _load_design(args.dataset, args.layout, args.seed,
                              args.device)
        safep_record = safep.certify(design, beta_max=args.beta_max,
                                     seed=args.seed)

    payload = build_payload(report=report, metrics_records=metrics_records,
                            trace=trace, safep_record=safep_record,
                            tol_kkt=args.tol, top_k=args.top_k)
    md = render_markdown(payload)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(md)
        print(f"[diag] health report written to {args.out}")
    else:
        sys.stdout.write(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
