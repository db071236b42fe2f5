"""Launch-plan autotuner of the port's CUDA kernels (port of
`repro.kernels.autotune`).

Each kernel's launch plan in `kernels/ops.py` is a fixed rule set by hand
for the shapes the solver and the server give it (`ops.bundle_plan`,
`ops.direction_plan`, ...). This module lets a measurement replace the
rule, once per problem shape:

  * every tuned kernel declares DEFAULTS, all knobs None: "the rule
    decides", so a cold cache (or REPRO_AUTOTUNE=off) launches exactly
    what the rules launch; and a SEARCH SPACE of candidate values of the
    launch arguments its `.cu` source already takes at run time (cluster
    sizes, column splits, tile widths, block counts). No axis names a
    plain version: on a CUDA tensor the dispatchers launch the kernel,
    whatever the cache holds;
  * `tune(kernel, runner, ...)` measures the candidates (exhaustive for
    small spaces, a greedy coordinate hillclimb for larger ones;
    `benchmarks/port/hillclimb.py` logs the climb) and persists the
    winner in a JSON cache keyed by (kernel, shape bucket, dtype, backend,
    the kernel source's build digest), so a rebuilt source ignores
    winners tuned for the old one;
  * `resolve(kernel, ...)` merges the defaults, the cached winner and
    explicit overrides. `ops` resolves each plan once per shape through
    it and memoises the plan; a cached config that the kernel cannot take
    at the exact shape (the pow2 bucket covers shapes where it is
    illegal) gives the rule's plan and counts `autotune.infeasible`.
    Tuning never happens implicitly: a cache miss returns the defaults.

Shapes are bucketed to the next power of two per axis. Times on the card
are CUDA-event medians of calls each after a 128 MB write that evicts L2
(the L2-cold time the tuner decides on), with the L2-warm median beside
it. The runner's operands' device picks the clock: CUDA events for a
CUDA device, the host clock otherwise, and `tune` refuses to persist a
winner timed off the card (a CPU time never picks a launch plan). A
candidate replaces the rule only when it is faster by more than a noise
margin (MIN_MARGIN, or the default's own spread where that is wider), so
a cache does not take a plan on timing noise; the margin rides in the
cache entry.

Robustness contract (tests/test_torch_autotune.py): a corrupt cache file,
a stale entry (unknown kernel, keys outside the search space, values
that are not candidates, wrong value types) or an unwritable cache
directory never crash a solve: every failure path falls back to the
defaults.

In-process memo: a resolved config is kept by (kernel, bucket, dtype,
backend), so a shape resolved once reads no file and makes no syscall
again. `invalidate_cache()` clears it (and the plans `ops` memoised);
`record()` invalidates after writing. Call it after changing the env
variables in a running process.

Env knobs:

  REPRO_AUTOTUNE        "auto"/"on" (default) read the cache; "off"
                        ignore it entirely (defaults everywhere).
  REPRO_AUTOTUNE_CACHE  cache file path (default
                        ~/.cache/repro_torch/autotune.json; the JAX
                        package's file is ~/.cache/repro/autotune.json,
                        so neither rewrites the other's).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs

CACHE_VERSION = 1

# ---------------------------------------------------------------------------
# per-kernel defaults, search spaces and bucket axes
#
# A knob is a launch argument of the kernel's source; None means "the
# plan's rule decides". The candidates stay within each source's limits
# (kernels/csrc/*.cu, the launchers' checks); `ops`' plan functions raise
# ValueError for a value the kernel cannot take at a given exact shape.

DEFAULTS: Dict[str, Dict[str, object]] = {
    # K1: CTAs of the cluster, warps a column is split over
    "pcdn_bundle": {"cluster": None, "nseg": None},
    # K2 and its partials entry: warps a column
    "pcdn_sparse_direction": {"warps": None},
    # K3 and its partials entry: columns a cluster, the streamed row tile,
    # and whether the column segments are resident (only False overrides)
    "pcdn_direction": {"cc": None, "tile": None, "resident": None},
    # K4a: the column tile's width
    "serve_margins_dense": {"width": None},
    # K4b: CTAs of a model's cluster
    "serve_margins_csc": {"cluster": None},
    # K5's rows entry: blocks a row
    "pcdn_linesearch": {"blocks": None},
    # K5's batch entry: CTAs of the cluster (coordinates a CTA follow)
    "scdn_batch": {"cluster": None},
    # K5's dense batch entry: CTAs a cluster, clusters
    "scdn_dense_batch": {"cluster": None, "clusters": None},
}

SEARCH_SPACES: Dict[str, Dict[str, Tuple[object, ...]]] = {
    "pcdn_bundle": {
        "cluster": (None, 1, 2, 3, 4, 5, 6, 7, 8),
        "nseg": (None, 1, 2, 4, 8, 16),
    },
    "pcdn_sparse_direction": {
        "warps": (None, 1, 2, 4),
    },
    "pcdn_direction": {
        "cc": (None, 8, 16, 24, 32, 40, 48, 56, 64),
        "tile": (None, 512, 1024, 2048, 4096),
        "resident": (None, False),
    },
    "serve_margins_dense": {
        "width": (None, 64, 128, 192, 256, 320, 384, 512, 640, 768, 1024,
                  1536),
    },
    "serve_margins_csc": {
        "cluster": (None, 1, 2, 3, 4, 5, 6, 7, 8),
    },
    "pcdn_linesearch": {
        "blocks": (None, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64),
    },
    "scdn_batch": {
        "cluster": (None, 1, 2, 3, 4, 5, 6, 7, 8),
    },
    "scdn_dense_batch": {
        "cluster": (None, 1, 2, 3, 4, 5, 6, 7, 8),
        "clusters": (None, 8, 16, 32, 64, 128),
    },
}

# the shape axes of each key's bucket, in the order `ops` passes them
BUCKET_AXES: Dict[str, Tuple[str, ...]] = {
    "pcdn_bundle": ("p", "k", "s", "q"),
    "pcdn_sparse_direction": ("p", "k", "s"),
    "pcdn_direction": ("s", "p"),
    "serve_margins_dense": ("b", "n", "k", "a"),
    "serve_margins_csc": ("n", "kmax", "k", "a", "b"),
    "pcdn_linesearch": ("s", "p", "q"),
    "scdn_batch": ("p", "k", "q", "s"),
    "scdn_dense_batch": ("p", "s", "q"),
}

# spaces of at most this many candidates are searched exhaustively
EXHAUSTIVE_MAX = 40

# the least share by which a candidate must beat the plan it would replace:
# identical launches read 1-3% apart from one run to the next on the H100
# (PERF.md, PR 23), so a smaller gain is not told from noise
MIN_MARGIN = 0.03


# ---------------------------------------------------------------------------
# shape bucketing and cache keys


def next_pow2(x: int) -> int:
    x = max(1, int(x))
    return 1 << (x - 1).bit_length()


def shape_bucket(**dims) -> Tuple[Tuple[str, int], ...]:
    """Deterministic (name, pow2-rounded-size) tuple: the shape part of a
    cache key. One tuning run covers every shape in the bucket."""
    return tuple(sorted((k, next_pow2(v)) for k, v in dims.items()))


_BACKENDS: dict = {}


def backend_tag(device=None) -> str:
    """'cuda-sm90' on an H100 (the device's compute capability), 'cpu' on
    the CPU. `device` defaults to the current CUDA device when a card is
    present."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    tag = _BACKENDS.get(device)
    if tag is None:
        if device.type == "cuda":
            major, minor = torch.cuda.get_device_capability(device)
            tag = f"cuda-sm{major}{minor}"
        else:
            tag = device.type
        _BACKENDS[device] = tag
    return tag


@functools.lru_cache(maxsize=None)
def source_digest(kernel: str) -> str:
    """The build digest of the kernel's source (`build._digest`): it
    changes with the source, the shared headers (`csrc/*.cuh`) or the
    nvcc flags."""
    from repro_torch.kernels import build
    return build._digest(kernel)


def cache_key(kernel: str, bucket, dtype, backend: Optional[str] = None
              ) -> str:
    backend = backend or backend_tag()
    shp = ",".join(f"{k}{v}" for k, v in bucket)
    return (f"{kernel}|{shp}|{_dtype_name(dtype)}|{backend}|"
            f"{source_digest(kernel)}")


def _dtype_name(dtype) -> str:
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        import numpy as np
        return np.dtype(dtype).name
    except Exception:
        return name


# ---------------------------------------------------------------------------
# persistent cache


def enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "auto").strip().lower() not in (
        "0", "off", "false", "no")


def cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


# the file's view: (path, mtime_ns, entries), reloaded when the path
# changes or the file is rewritten; read only when the memo misses
_cache_state: Optional[Tuple[str, int, dict]] = None
# resolved configs by (kernel, bucket, dtype name, backend)
_RESOLVED: Dict[tuple, dict] = {}
# called by invalidate_cache(): `ops` clears its memoised plans
_ON_INVALIDATE: List[Callable[[], None]] = []


def on_invalidate(fn: Callable[[], None]) -> None:
    """Register `fn` to run at every `invalidate_cache()`."""
    _ON_INVALIDATE.append(fn)


def _load_cache() -> dict:
    global _cache_state
    path = cache_path()
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        _cache_state = (path, -1, {})
        return {}
    if _cache_state is not None and _cache_state[0] == path \
            and _cache_state[1] == mtime:
        return _cache_state[2]
    try:
        with open(path) as fh:
            obj = json.load(fh)
        if not isinstance(obj, dict) or obj.get("version") != CACHE_VERSION:
            raise ValueError("version mismatch")
        entries = obj.get("entries", {})
        if not isinstance(entries, dict):
            raise ValueError("entries not a dict")
    except Exception:
        # corrupt / unreadable / wrong version: behave as empty, never raise
        entries = {}
    _cache_state = (path, mtime, entries)
    return entries


def invalidate_cache() -> None:
    """Drop the in-memory cache view, the resolved configs and the plans
    `ops` memoised (tests; after env changes; after `record`)."""
    global _cache_state
    _cache_state = None
    _RESOLVED.clear()
    for fn in _ON_INVALIDATE:
        fn()


def _is_candidate(v, candidates) -> bool:
    """v is one of the candidates, of the same type (True is not 1, 0 is
    not False)."""
    return any(v is c or (type(v) is type(c) and v == c) for c in candidates)


def _validate(kernel: str, config: dict) -> Optional[dict]:
    """A cached config is usable iff every key belongs to the kernel's
    search space and every value is one of the declared candidates (the
    'stale entry' contract: a config written by an older search space
    falls back to the defaults, it does not crash)."""
    space = SEARCH_SPACES.get(kernel)
    if space is None or not isinstance(config, dict):
        return None
    out = {}
    for k, v in config.items():
        if k not in space:
            return None
        if not _is_candidate(v, space[k]):
            return None
        out[k] = v
    return out


def lookup(kernel: str, bucket, dtype, backend: Optional[str] = None
           ) -> Optional[dict]:
    """Validated cached winner for this cell, or None.

    Metrics (registry enabled): autotune.lookup_hits counts lookups that
    return a usable cached winner; autotune.lookup_misses everything else
    (disabled tuner, empty cache, absent or stale entry): the miss path is
    exactly "defaults were used". `resolve` looks up once per memoised
    cell."""
    cfg = _lookup(kernel, bucket, dtype, backend)
    obs.inc("autotune.lookup_hits" if cfg is not None
            else "autotune.lookup_misses")
    return cfg


def _lookup(kernel: str, bucket, dtype, backend: Optional[str] = None
            ) -> Optional[dict]:
    if not enabled():
        return None
    entries = _load_cache()
    if not entries:
        return None
    rec = entries.get(cache_key(kernel, bucket, dtype, backend))
    if not isinstance(rec, dict):
        return None
    return _validate(kernel, rec.get("config"))


def record(kernel: str, bucket, dtype, config: dict,
           us: Optional[float] = None, default_us: Optional[float] = None,
           backend: Optional[str] = None, **extra) -> bool:
    """Persist a tuned winner (entries of other kernels, backends or
    digests are kept). `extra` rides along in the entry (the warm times).
    Returns False (without raising) when the cache file cannot be
    written."""
    key = cache_key(kernel, bucket, dtype, backend)
    path = cache_path()
    try:
        entries = dict(_load_cache())
        entries[key] = {"config": dict(config), "us": us,
                        "default_us": default_us, **extra,
                        "when": time.strftime("%Y-%m-%dT%H:%M:%S")}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"version": CACHE_VERSION, "entries": entries}, fh,
                      indent=1)
        os.replace(tmp, path)
    except Exception:
        return False
    invalidate_cache()
    return True


def resolve(kernel: str, bucket, dtype, overrides: Optional[dict] = None,
            backend: Optional[str] = None) -> dict:
    """The dispatch decision of every tuned plan in `ops`.

    defaults <- cached winner <- explicit overrides (a non-None value
    always wins). The merge of defaults and the cached winner is memoised
    by (kernel, bucket, dtype, backend)."""
    backend = backend or backend_tag()
    key = (kernel, bucket, _dtype_name(dtype), backend)
    base = _RESOLVED.get(key)
    if base is None:
        base = dict(DEFAULTS[kernel])
        cached = lookup(kernel, bucket, dtype, backend)
        if cached:
            base.update(cached)
        _RESOLVED[key] = base
    cfg = dict(base)
    if overrides:
        for k, v in overrides.items():
            if v is not None:
                cfg[k] = v
    return cfg


# ---------------------------------------------------------------------------
# tuning


@dataclasses.dataclass(frozen=True)
class TuneResult:
    kernel: str
    config: dict                 # the winner
    us: float                    # winner's measured microseconds/call
    default_us: float            # the DEFAULT config's microseconds/call
    table: Tuple[dict, ...]      # every measured candidate {config, us,
    #                              warm_us}
    trajectory: Tuple[dict, ...]  # hillclimb steps {config, us} (exhaustive:
    #                               the winner only)
    skipped: int = 0             # candidates that raised (infeasible)
    margin: float = 0.0          # share a candidate had to win by

    @property
    def speedup(self) -> float:
        return self.default_us / max(self.us, 1e-9)


def _warm_of(table, config: dict) -> Optional[float]:
    """The L2-warm median the table holds for `config`."""
    for r in table:
        if r["config"] == config:
            return r.get("warm_us")
    return None


class Timing(float):
    """Microseconds a call: the L2-cold median on the card (the host
    clock's median on the CPU), with the L2-warm median as `warm_us`
    (None on the CPU) and the repeats' interquartile range over the median
    as `spread`."""

    warm_us: Optional[float] = None
    spread: Optional[float] = None


# 128 MB written before each cold call evicts the H100's 50 MB L2
_FLUSH_BYTES = 128 * 1024 * 1024
_FLUSH: dict = {}


def _flush_fn(torch):
    dev = torch.cuda.current_device()
    buf = _FLUSH.get(dev)
    if buf is None:
        buf = _FLUSH[dev] = torch.empty((_FLUSH_BYTES // 4,),
                                        device=f"cuda:{dev}")
    return buf.zero_


def _device_us(torch, fn, n: int, flush=None) -> List[float]:
    """Device microseconds of n calls, from CUDA events around each call.
    A spin kernel holds the card while the host queues the calls (about
    twice their host time, at most ~1 s), so the events see device time
    only, not the host's launch gaps."""
    t0 = time.perf_counter()
    for _ in range(2):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / 2
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(int(min(2 * per_call * n * 2e9, 2e9)))  # cycles
    for i in range(n):
        if flush is not None:
            flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) * 1e3 for a, b in zip(starts, ends)]


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _timing(xs: List[float]) -> Timing:
    """The median of xs, its interquartile range over it as `.spread`."""
    xs = sorted(xs)
    t = Timing(_median(xs))
    t.spread = (xs[(3 * len(xs)) // 4] - xs[len(xs) // 4]) / max(t, 1e-9)
    return t


def _on_card(device) -> bool:
    """The operands lie on a CUDA device (None: the CPU)."""
    import torch
    return device is not None and torch.device(device).type == "cuda"


def time_call(fn: Callable[[], object], repeats: int = 5,
              warmup: int = 1, device=None) -> Timing:
    """Median microseconds per call on the clock of `device`, where the
    call's operands lie: for a CUDA device CUDA events (the L2-cold
    median, the L2-warm median as `.warm_us`), else (None too) the host
    clock."""
    import torch
    for _ in range(warmup):
        fn()
    if not _on_card(device):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        return _timing(ts)
    with torch.cuda.device(torch.device(device)):
        torch.cuda.synchronize()
        cold = _timing(_device_us(torch, fn, repeats, _flush_fn(torch)))
        cold.warm_us = _median(_device_us(torch, fn, repeats))
    return cold


def candidate_configs(kernel: str) -> List[dict]:
    """The full cartesian search space (DEFAULT config always included)."""
    space = SEARCH_SPACES[kernel]
    keys = sorted(space)
    configs = [dict(zip(keys, vals))
               for vals in itertools.product(*(space[k] for k in keys))]
    default = DEFAULTS[kernel]
    if default not in configs:
        configs.insert(0, dict(default))
    return configs


def pick_strategy(kernel: str) -> str:
    """Exhaustive for a space of at most EXHAUSTIVE_MAX candidates, else
    the hillclimb."""
    return "exhaustive" if len(candidate_configs(kernel)) <= \
        EXHAUSTIVE_MAX else "hillclimb"


def _measure(runner: Callable[[dict], Callable], config: dict,
             repeats: int, device=None) -> Optional[float]:
    """Build + time one candidate; an infeasible candidate (runner or the
    launch raises) is skipped, not fatal."""
    try:
        fn = runner(config)
        return time_call(fn, repeats=repeats, device=device)
    except Exception:
        return None


def tune(kernel: str, runner: Callable[[dict], Callable], bucket, dtype,
         strategy: str = "exhaustive", repeats: int = 5,
         persist: bool = True, backend: Optional[str] = None,
         plan: Optional[Callable[[dict], object]] = None,
         device=None) -> TuneResult:
    """Measure candidates and persist the winner for this cache cell.

    runner(config) -> zero-arg callable executing one kernel call with
    that config (it raises when the kernel cannot take the config at its
    shape: the candidate is skipped). strategy: "exhaustive" times the
    whole cartesian space; "hillclimb" starts from the defaults and
    greedily improves one axis at a time. The DEFAULT config is always
    measured, so the recorded winner is never slower than the default by
    construction.

    The port's additions:
      device: where the runner's operands lie (None: the CPU); it picks
        the clock, and a winner timed off the card is never persisted.
      a margin: a candidate is taken only when it beats the default (the
        exhaustive search's best) or the current config (each step of the
        climb) by more than MIN_MARGIN or the default's own spread,
        whichever is wider (TuneResult.margin). With MIN_MARGIN 0 and no
        spread this is the reference's strict minimum.
      plan(config) -> the launch plan the config gives at the runner's
        shape: configs with an equal plan are one launch, measured once,
        the first measured standing for all (the default first), so a
        None knob and the value its rule picks cannot part by timing
        noise."""
    if persist:
        backend = backend or backend_tag(device)
        if backend == "cpu" or not _on_card(device):
            raise ValueError(f"autotune[{kernel}]: a winner timed on the "
                             f"CPU is not persisted (the CPU route runs the "
                             f"plain version, whatever the plan)")
    t_tune = time.perf_counter_ns()
    default = dict(DEFAULTS[kernel])
    table: List[dict] = []
    measured: Dict[str, float] = {}
    failed: set = set()

    def key_of(cfg: dict) -> str:
        return json.dumps(cfg, sort_keys=True)

    def launch_of(cfg: dict):
        if plan is None:
            return key_of(cfg)
        try:
            return repr(plan(cfg))
        except ValueError:
            return key_of(cfg)          # infeasible: the runner raises too

    def measure(cfg: dict) -> Optional[float]:
        k = launch_of(cfg)
        if k in measured:
            return measured[k]
        us = _measure(runner, cfg, repeats, device)
        if us is None:
            failed.add(k)
        else:
            measured[k] = us
            table.append({"config": dict(cfg), "us": float(us),
                          "warm_us": getattr(us, "warm_us", None)})
        return us

    default_us = measure(default)
    if default_us is None:
        raise RuntimeError(
            f"autotune[{kernel}]: the default config {default} failed to "
            f"run -- nothing to tune against")

    margin = max(MIN_MARGIN, getattr(default_us, "spread", None) or 0.0)
    keep = 1.0 - margin

    trajectory = [{"config": dict(default), "us": float(default_us)}]
    if strategy == "exhaustive":
        for cfg in candidate_configs(kernel):
            measure(cfg)
        best = min(table, key=lambda r: r["us"])
        if not best["us"] < default_us * keep:
            best = table[0]                 # the default, measured first
        trajectory.append({"config": dict(best["config"]),
                           "us": best["us"]})
    elif strategy == "hillclimb":
        space = SEARCH_SPACES[kernel]
        current, current_us = dict(default), default_us
        improved = True
        while improved:
            improved = False
            for axis in sorted(space):
                for v in space[axis]:
                    if current.get(axis) == v:
                        continue
                    cand = dict(current)
                    cand[axis] = v
                    us = measure(cand)
                    if us is not None and us < current_us * keep:
                        current, current_us = cand, us
                        trajectory.append({"config": dict(cand),
                                           "us": float(us)})
                        improved = True
        best = {"config": current, "us": current_us}
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    result = TuneResult(kernel=kernel, config=dict(best["config"]),
                        us=float(best["us"]), default_us=float(default_us),
                        table=tuple(table), trajectory=tuple(trajectory),
                        skipped=len(failed), margin=float(margin))
    if persist:
        record(kernel, bucket, dtype, result.config, us=result.us,
               default_us=result.default_us, backend=backend,
               warm_us=_warm_of(table, result.config),
               default_warm_us=_warm_of(table, default),
               margin=result.margin)
    t_done = time.perf_counter_ns()
    obs.inc("autotune.tunes")
    obs.observe("autotune.tune_seconds", (t_done - t_tune) / 1e9)
    obs.complete("autotune.tune", "kernels", t_tune, t_done,
                 args={"kernel": kernel, "strategy": strategy,
                       "candidates": len(table), "margin": result.margin,
                       "speedup": result.speedup})
    return result
