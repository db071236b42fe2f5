"""Telemetry-artifact schema validator CLI (copy of `repro.obs.validate`):

    python -m repro_torch.obs.validate trace.json run.jsonl [...]

Validates both telemetry planes by file extension:

* ``*.jsonl`` -- metrics run-record logs (``--metrics-out``): every line
  must be one self-contained ``{ts, meta..., metrics: {counters,
  gauges, histograms}}`` record per the `repro_torch.obs.registry` contract --
  numeric counter/gauge values, histogram dicts with consistent
  bounds/counts (len(counts) == len(bounds)+1, sum(counts) == count).
* anything else -- Chrome-trace JSON per the contract of
  `repro_torch.obs.trace`: required ph/ts/dur fields, known phases, and
  properly nested (never partially overlapping) "X" spans on every
  (pid, tid) track.

Exit code 0 iff every file validates.
"""
from __future__ import annotations

import json
import sys

from repro_torch.obs.trace import validate_trace_file

# every histogram dict the registry snapshot writes carries exactly
# these keys (registry.Histogram.as_dict)
_HIST_KEYS = {"count", "sum", "min", "max", "mean", "p50", "p99",
              "bounds", "counts"}


def _check_numeric_map(name: str, obj) -> None:
    if not isinstance(obj, dict):
        raise ValueError(f"'{name}' must be an object")
    for k, v in obj.items():
        if not isinstance(k, str):
            raise ValueError(f"'{name}' key {k!r} is not a string")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"{name}[{k!r}] must be numeric, got {v!r}")


def _check_histogram(name: str, h) -> None:
    if not isinstance(h, dict):
        raise ValueError(f"histogram {name!r} must be an object")
    missing = _HIST_KEYS - set(h)
    if missing:
        raise ValueError(f"histogram {name!r} missing keys "
                         f"{sorted(missing)}")
    count, bounds, counts = h["count"], h["bounds"], h["counts"]
    if not isinstance(count, int) or count < 0:
        raise ValueError(f"histogram {name!r}: 'count' must be a "
                         f"non-negative int, got {count!r}")
    if not isinstance(bounds, list) or not isinstance(counts, list):
        raise ValueError(f"histogram {name!r}: 'bounds'/'counts' must "
                         f"be lists")
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"histogram {name!r}: len(counts)={len(counts)} != "
            f"len(bounds)+1={len(bounds) + 1}")
    if any(not isinstance(b, (int, float)) or isinstance(b, bool)
           for b in bounds):
        raise ValueError(f"histogram {name!r}: non-numeric bound")
    if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
        raise ValueError(f"histogram {name!r}: bounds must be strictly "
                         f"increasing")
    if any(not isinstance(c, int) or c < 0 for c in counts):
        raise ValueError(f"histogram {name!r}: counts must be "
                         f"non-negative ints")
    if sum(counts) != count:
        raise ValueError(f"histogram {name!r}: sum(counts)="
                         f"{sum(counts)} != count={count}")
    if count > 0 and (h["min"] is None or h["max"] is None):
        raise ValueError(f"histogram {name!r}: min/max must be set when "
                         f"count > 0")


def validate_metrics_record(record) -> None:
    """One run record per the `registry.write_metrics` contract."""
    if not isinstance(record, dict):
        raise ValueError("record must be a JSON object")
    ts = record.get("ts")
    if not isinstance(ts, str) or not ts:
        raise ValueError("record missing string 'ts'")
    metrics = record.get("metrics")
    if not isinstance(metrics, dict):
        raise ValueError("record missing object 'metrics'")
    unknown = set(metrics) - {"counters", "gauges", "histograms"}
    if unknown:
        raise ValueError(f"'metrics' has unknown sections "
                         f"{sorted(unknown)}")
    _check_numeric_map("metrics.counters", metrics.get("counters", {}))
    _check_numeric_map("metrics.gauges", metrics.get("gauges", {}))
    hists = metrics.get("histograms", {})
    if not isinstance(hists, dict):
        raise ValueError("'metrics.histograms' must be an object")
    for name, h in hists.items():
        _check_histogram(name, h)


def validate_metrics_file(path: str) -> int:
    """Validate a --metrics-out JSONL log; returns the record count."""
    n = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"line {lineno}: not JSON -- {exc}") \
                    from None
            try:
                validate_metrics_record(record)
            except ValueError as exc:
                raise ValueError(f"line {lineno}: {exc}") from None
            n += 1
    if n == 0:
        raise ValueError("no records (empty log)")
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate TRACE.json|RUN.jsonl "
              "[...]", file=sys.stderr)
        return 2
    status = 0
    for path in argv:
        kind = "metrics" if path.endswith(".jsonl") else "trace"
        try:
            if kind == "metrics":
                n = validate_metrics_file(path)
                unit = "records"
            else:
                n = validate_trace_file(path)
                unit = "events"
        except (OSError, ValueError) as exc:
            print(f"[obs.validate] {path}: INVALID -- {exc}", file=sys.stderr)
            status = 1
        else:
            print(f"[obs.validate] {path}: OK ({n} {unit})")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
