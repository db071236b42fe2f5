"""Dispatchers for the port's kernels: the three solver kernels (K1-K3)
with the sharded backend's entries of K2 and K3 (the shard-local g/h
partials, and K2's scatter X_B d for a given d),
the two serving-margin kernels (K4a, K4b), the batched line search (K5:
its (P, s) rows entry, and its two batch entries, a whole SCDN batch on
the padded-CSC layout and on the dense layout) and flash attention (K6),
the LM's blockwise prefill attention.

Each wrapper looks at where its tensors live:

  * on the CPU it returns the plain PyTorch version from `kernels/ref.py`;
  * on a CUDA device it checks device, dtype, shape and contiguity,
    allocates every output and scratch buffer, launches the hand-written
    kernel (kernels/csrc, built at first use by `kernels.build`) on
    PyTorch's current stream, raises if the launch reports an error, and
    adds one to its launch count. It never falls back to the plain version.

`launch_counts()` / `reset_launch_counts()` read and clear the counts, so a
run can show that its main path went through the kernels;
`flash_variant_counts()` splits K6's count by the variant that ran.

Launch plans (`kernels.autotune`): every plan function below (K1-K5; K6's
variant stays a fixed rule) takes an optional `config` of the tuner's
knobs; None knobs leave the rule's value, and a value the kernel cannot
take at the exact shape raises ValueError. Each dispatcher (and each
launch object) takes `config=` too: an explicit config is planned
strictly (the tuner's candidates), None resolves the plan through the
tuner once a shape (`tuned_plan`, memoised until
`autotune.invalidate_cache()`): the cached winner where it is feasible at
the exact shape, else the rule, counted as `autotune.infeasible`. A cold
cache or REPRO_AUTOTUNE=off gives the rules' launches exactly. A plan
changes how the kernel launches, never whether it does: no config reaches
a plain version on a CUDA tensor.

Telemetry (`repro_torch.obs`): while the metrics registry or the trace
writer is on, every dispatch, to the kernel or to the plain version, adds
one to the registry's `kernels.<name>.launches` and records a span
`kernels.<name>` on the `kernels` track with args {"impl": "cuda" |
"plain"}. The span is host time, which on a CUDA tensor is the enqueue
time of the launch, not the kernel's device time (`chip_smoke.py` times
the kernels with CUDA events). With both planes off a dispatch pays one
attribute check (`obs.gate.on`) and the decorator's call.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import obs
from repro_torch.kernels import autotune, build, ref
from repro_torch.obs import gate as _obs_gate

Tensor = torch.Tensor

KERNELS = ("pcdn_direction", "pcdn_sparse_direction", "pcdn_bundle",
           "serve_margins_dense", "serve_margins_csc", "pcdn_linesearch",
           "scdn_batch", "scdn_dense_batch", "flash_attention",
           "pcdn_direction_partials",
           "pcdn_sparse_direction_partials", "pcdn_sparse_scatter")
_LAUNCHES = {name: 0 for name in KERNELS}

# loss kind codes, as kernels/csrc/common.cuh numbers them
_KINDS = {"logistic": 0, "squared_hinge": 1, "squared": 2}
_VALUE_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    for name in _FLASH_VARIANT_LAUNCHES:
        _FLASH_VARIANT_LAUNCHES[name] = 0


def _observed(name: str, arg: int = 0):
    """The dispatcher's launch counter and span while a telemetry plane is
    on; `arg` is the position of a tensor argument whose device names the
    route."""
    counter = f"kernels.{name}.launches"
    span_name = f"kernels.{name}"

    def deco(fn):
        @functools.wraps(fn)
        def dispatch(*args, **kwargs):
            if not _obs_gate.on:
                return fn(*args, **kwargs)
            impl = "plain" if args[arg].device.type == "cpu" else "cuda"
            obs.inc(counter)
            with obs.span(span_name, "kernels", args={"impl": impl}):
                return fn(*args, **kwargs)
        return dispatch
    return deco


def _on_cpu(*tensors: Tensor) -> bool:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"kernel inputs on several devices: "
                         f"{ {t.device for t in tensors} }")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name: str, t: Tensor, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def _raw_stream(index: int) -> int:
    """PyTorch's current stream on card `index`, as an int, through the
    binding Triton's launcher uses: a few us less host time a launch than
    torch.cuda.current_stream, which builds a Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _stream(t: Tensor) -> int:
    return _raw_stream(t.get_device())


def _raise_if(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")


_CHECKED: set = set()


def _loaded(name: str, want: dict) -> "build.KernelLibrary":
    """build.load(name), its launch constants checked against `want` (the
    values this module plans with) the first time."""
    lib = build.load(name)
    if name not in _CHECKED:
        got = {k: lib.consts[k] for k in want}
        if got != want:
            raise RuntimeError(f"{name}: the built kernel's constants {got} "
                               f"differ from kernels/ops.py's {want}")
        _CHECKED.add(name)
    return lib


_F32 = (torch.float32,)
_I32 = (torch.int32,)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- launch plans through the tuner -------------------------------------------
# plans resolved through the tuner, by (kernel, plan args, bucket dims,
# dtype, device); cleared with the tuner's memo
_PLANS: dict = {}
autotune.on_invalidate(_PLANS.clear)


def _knobs(kernel: str, config) -> dict:
    """The non-None knobs of `config`, each a knob of `kernel`'s search
    space, else a ValueError."""
    if not config:
        return {}
    space = autotune.DEFAULTS[kernel]
    bad = set(config) - set(space)
    if bad:
        raise ValueError(f"{kernel}: unknown plan knobs {sorted(bad)}, the "
                         f"plan takes {sorted(space)}")
    return {k: v for k, v in config.items() if v is not None}


def _int_knob(kernel: str, knobs: dict, name: str, rule: int, lo: int,
              hi: int) -> int:
    """knobs[name] (an int in [lo, hi]) or the rule's value."""
    v = knobs.get(name)
    if v is None:
        return rule
    if type(v) is not int or not lo <= v <= hi:
        raise ValueError(f"{kernel}: {name}={v!r}, the kernel takes an "
                         f"integer {lo} to {hi}")
    return v


def tuned_plan(kernel: str, fn, args: tuple, dims: tuple, dtype, device,
               config: dict | None = None):
    """fn(*args) (a plan function of this module) planned through the
    tuner: with `config`, strictly that config; else the tuner's resolved
    config for the (dims, dtype, device) bucket, memoised by the call's
    key. A resolved config the kernel cannot take at these exact args
    gives the rule's plan and counts `autotune.infeasible`."""
    if config is not None:
        return fn(*args, config=config)
    key = (kernel, args, dims, dtype, device)
    plan = _PLANS.get(key)
    if plan is None:
        bucket = autotune.shape_bucket(
            **dict(zip(autotune.BUCKET_AXES[kernel], dims)))
        cfg = autotune.resolve(kernel, bucket, dtype,
                               backend=autotune.backend_tag(device))
        if any(v is not None for v in cfg.values()):
            try:
                plan = fn(*args, config=cfg)
            except ValueError:
                obs.inc("autotune.infeasible")
        if plan is None:
            plan = fn(*args)
        _PLANS[key] = plan
    return plan


# -- K3 ------------------------------------------------------------------------
# launch constants of kernels/csrc/pcdn_direction.cu (checked against the
# built library's when it is first loaded)
DIRECTION_THREADS = 512
DIRECTION_CLUSTER = 8
DIRECTION_MAX_CLUSTER_COLS = 64
DIRECTION_TILE_ROWS = 4096
SMEM_BUDGET = 232_448        # bytes of shared memory a block may use


def direction_smem_bytes(tile: int, cc: int, resident: bool,
                         itemsize: int) -> int:
    """K3's shared memory for a row tile: u and v, the cluster's columns'
    partial g, h, d and ids, the live columns' list and (offset, d) pairs,
    16 words of flags and an mbarrier, each rounded up to 4 floats, then,
    when `resident`, the cluster's column segments (`smem_bytes` in
    pcdn_direction.cu)."""
    tp = -(-tile // 4) * 4
    floats = 2 * tp + 7 * DIRECTION_MAX_CLUSTER_COLS + 16
    return 4 * floats + (cc * tp * itemsize if resident else 0)


@dataclasses.dataclass(frozen=True)
class DirectionPlan:
    """K3's launch for a bundle of P columns over s rows: `ctas` CTAs in
    clusters of DIRECTION_CLUSTER, cluster c owning bundle columns
    [c cc, (c + 1) cc) and its CTA of rank r rows [r sl, (r + 1) sl), in
    tiles of `tile` rows; the column segments copied into shared memory
    when `resident`, 16-byte loads when `vec`."""
    s: int
    P: int
    itemsize: int
    cc: int
    ctas: int
    sl: int
    tile: int
    resident: bool
    vec: bool

    @property
    def clusters(self) -> int:
        return self.ctas // DIRECTION_CLUSTER

    @property
    def smem_bytes(self) -> int:
        return direction_smem_bytes(self.tile, self.cc, self.resident,
                                    self.itemsize)


def direction_plan(s: int, P: int, itemsize: int, max_clusters: int,
                   config: dict | None = None) -> DirectionPlan:
    """K3's launch plan for a card that holds `max_clusters` of its
    clusters at once: one wave of clusters where the columns allow
    (ceil(P / max_clusters) columns a cluster, at most
    DIRECTION_MAX_CLUSTER_COLS; more clusters past that), the rows in
    DIRECTION_CLUSTER slices of a multiple of 8 rows; the slices' column
    segments resident in shared memory when they fit and s is a multiple
    of 16 bytes of values (then the loads are 16 bytes too), else read
    twice in tiles of DIRECTION_TILE_ROWS.

    `config` (the tuner's `pcdn_direction` knobs): `cc` columns a cluster
    (1 to DIRECTION_MAX_CLUSTER_COLS; the clusters follow), `resident`
    False to stream a plan the rule makes resident (True is the rule's
    alone), `tile` the streamed tile's rows (a multiple of 8, at most the
    slice; refused for a resident plan, whose tile is the slice)."""
    if s < 1 or P < 1:
        raise ValueError(f"pcdn_direction: empty slab s={s} P={P}")
    if itemsize not in (2, 4):
        raise ValueError(f"pcdn_direction: {itemsize}-byte values, the "
                         f"kernel takes float32 or bfloat16")
    if max_clusters < 1:
        raise ValueError(f"pcdn_direction: the card holds {max_clusters} "
                         f"clusters of the kernel at once")
    knobs = _knobs("pcdn_direction", config)
    cc = _int_knob("pcdn_direction", knobs, "cc",
                   min(DIRECTION_MAX_CLUSTER_COLS,
                       -(-P // min(max_clusters, P))),
                   1, DIRECTION_MAX_CLUSTER_COLS)
    ctas = DIRECTION_CLUSTER * -(-P // cc)
    sl = -(-s // (8 * DIRECTION_CLUSTER)) * 8
    vec = s % (16 // itemsize) == 0
    resident = vec and \
        direction_smem_bytes(sl, cc, True, itemsize) <= SMEM_BUDGET
    if "resident" in knobs:
        if knobs["resident"] is not False:
            raise ValueError(f"pcdn_direction: resident="
                             f"{knobs['resident']!r}; only False overrides "
                             f"the rule")
        resident = False
    tile = sl if resident else min(sl, DIRECTION_TILE_ROWS)
    if "tile" in knobs:
        t = knobs["tile"]
        if resident:
            raise ValueError(f"pcdn_direction: tile={t!r} for a resident "
                             f"plan (s={s}: the tile is the {sl}-row slice)")
        if type(t) is not int or t < 8 or t % 8:
            raise ValueError(f"pcdn_direction: tile={t!r}, the kernel takes "
                             f"a multiple of 8 rows")
        tile = min(sl, t)
    plan = DirectionPlan(s=s, P=P, itemsize=itemsize, cc=cc, ctas=ctas,
                         sl=sl, tile=tile, resident=resident, vec=vec)
    if plan.smem_bytes > SMEM_BUDGET:
        raise ValueError(f"pcdn_direction: {plan.smem_bytes} bytes of shared "
                         f"memory a CTA at cc={cc}, tile={tile}, more than "
                         f"the {SMEM_BUDGET} a block may use")
    return plan


_COUNTERS: dict = {}
_MAX_CLUSTERS: dict = {}


def direction_max_clusters(device: torch.device) -> int:
    """Clusters of the K3 kernel that `device` holds at once (asked of the
    CUDA runtime once a device)."""
    key = _device_index(device)
    n = _MAX_CLUSTERS.get(key)
    if n is None:
        with torch.cuda.device(key):
            n = build.load("pcdn_direction").pcdn_direction_max_clusters()
        if n < 1:
            raise RuntimeError(f"pcdn_direction: cudaOccupancyMaxActive"
                               f"Clusters failed or found no room ({n})")
        n = _MAX_CLUSTERS[key] = int(n)
    return n


def _direction_counter(device: torch.device) -> Tensor:
    """K3's arrival counters on `device`: one int32 for each rank of a
    cluster, zeroed once here; each launch's last arrivals set them back
    to 0."""
    key = _device_index(device)
    t = _COUNTERS.get(key)
    if t is None:
        t = _COUNTERS[key] = torch.zeros((DIRECTION_CLUSTER,),
                                         dtype=torch.int32, device=device)
    return t


@_observed("pcdn_direction")
def pcdn_direction(XT: Tensor, idx: Tensor, z: Tensor, y: Tensor,
                   w_B: Tensor, c, kind: str = "logistic", l2: float = 0.0,
                   *, config: dict | None = None):
    """K3: bundle direction over the dense layout, the slab gather, the
    loss factors and the margin delta inside. XT (n, s) float32|bf16, the
    dense design's feature-major copy (`DenseDesign.feature_major`), idx
    (P,) int32 with sentinel n in the ragged last bundle, z/y (s,) float32
    margins and labels, w_B (P,) float32, c a float -> (d, g, h), each
    (P,), and delta = X_B d (s,), all float32. One launch, no other device
    op; deterministic (every sum in a fixed order). Launches on one device
    share its arrival counters (`_direction_counter`), so they run one
    after another on one stream. `config`: the launch plan's knobs
    (`direction_plan`), else the tuner's."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(XT, idx, z, y, w_B):
        return ref.pcdn_direction_ref(XT, idx, z, y, w_B, c, kind=kind,
                                      l2=l2)
    n, s = XT.shape
    P = idx.shape[0]
    _check("XT", XT, tuple(_VALUE_TYPES), (n, s))
    _check("idx", idx, _I32, (P,))
    _check("z", z, _F32, (s,))
    _check("y", y, _F32, (s,))
    _check("w_B", w_B, _F32, (P,))
    if n < 1:
        raise ValueError("pcdn_direction: a design with no features")
    lib = _direction_lib()
    plan = _direction_plan(XT, P, config)
    # one allocation: d, g, h, delta, then the clusters' partials of delta
    buf = torch.empty((3 * P + s * (1 + plan.clusters),),
                      dtype=torch.float32, device=XT.device)
    d, g, h = buf[:3 * P].view(3, P)
    delta = buf[3 * P:3 * P + s]
    part = buf[3 * P + s:]
    fn = getattr(lib, f"pcdn_direction_{_VALUE_TYPES[XT.dtype]}")
    err = fn(_ptr(XT), _ptr(idx), _ptr(z), _ptr(y), _ptr(w_B), float(c),
             _KINDS[kind], float(l2), n, s, P, plan.cc, plan.ctas, plan.sl,
             plan.tile, int(plan.resident), int(plan.vec), _ptr(d), _ptr(g),
             _ptr(h), _ptr(delta), _ptr(part),
             _ptr(_direction_counter(XT.device)), _stream(XT))
    _raise_if(err, "pcdn_direction")
    _LAUNCHES["pcdn_direction"] += 1
    return d, g, h, delta


def _direction_plan(XT: Tensor, P: int, config) -> DirectionPlan:
    s = XT.shape[1]
    return tuned_plan("pcdn_direction", direction_plan,
                      (s, P, XT.element_size(),
                       direction_max_clusters(XT.device)), (s, P), XT.dtype,
                      XT.device, config)


def _direction_lib():
    return _loaded("pcdn_direction", {
        "pcdn_direction_threads": DIRECTION_THREADS,
        "pcdn_direction_cluster": DIRECTION_CLUSTER,
        "pcdn_direction_max_cluster_cols": DIRECTION_MAX_CLUSTER_COLS,
        "pcdn_direction_tile_rows": DIRECTION_TILE_ROWS})


@_observed("pcdn_direction_partials")
def pcdn_direction_partials(XT: Tensor, idx: Tensor, z: Tensor, y: Tensor,
                            c, kind: str = "logistic"):
    """K3's partials entry, the sharded backend's shard-local step on the
    dense layout: XT (n, s) the shard's feature-major block, idx (P,)
    int32 (sentinel n), z/y (s,) float32 -> (g, h), each (P,) float32:
    g = X_B^T u raw and h = max((X_B^2)^T v, 1e-12), u and v = c phi'(z),
    c phi''(z) formed at the rows. No d and no X_B d: the direction needs
    the g and h summed over the data shards. One launch of K3's plan
    (the tuner's, as K3's), stopping after the cluster's g/h sum;
    deterministic."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(XT, idx, z, y):
        return ref.pcdn_direction_partials_ref(XT, idx, z, y, c, kind=kind)
    n, s = XT.shape
    P = idx.shape[0]
    _check("XT", XT, tuple(_VALUE_TYPES), (n, s))
    _check("idx", idx, _I32, (P,))
    _check("z", z, _F32, (s,))
    _check("y", y, _F32, (s,))
    if n < 1:
        raise ValueError("pcdn_direction_partials: a design with no "
                         "features")
    lib = _direction_lib()
    plan = _direction_plan(XT, P, None)
    buf = torch.empty((2 * P,), dtype=torch.float32, device=XT.device)
    g, h = buf.view(2, P)
    fn = getattr(lib, f"pcdn_direction_partials_{_VALUE_TYPES[XT.dtype]}")
    err = fn(_ptr(XT), _ptr(idx), _ptr(z), _ptr(y), float(c), _KINDS[kind],
             n, s, P, plan.cc, plan.ctas, plan.sl, plan.tile,
             int(plan.resident), int(plan.vec), _ptr(g), _ptr(h),
             _stream(XT))
    _raise_if(err, "pcdn_direction_partials")
    _LAUNCHES["pcdn_direction_partials"] += 1
    return g, h


def sparse_direction_warps(K: int, config: dict | None = None) -> int:
    """Warps a feature's column is split over in the K2 launch: 1 up to 64
    entries, 2 up to 128, else 4 (a block holds 4 warps). `config` (the
    tuner's `pcdn_sparse_direction` knobs): `warps` 1, 2 or 4."""
    knobs = _knobs("pcdn_sparse_direction", config)
    warps = knobs.get("warps", 1 if K <= 64 else (2 if K <= 128 else 4))
    if not any(warps is w for w in (1, 2, 4)):
        raise ValueError(f"pcdn_sparse_direction: warps={warps!r}, the "
                         f"kernel takes 1, 2 or 4")
    return warps


def _sparse_warps(vals: Tensor, m: int, config) -> int:
    P, K = vals.shape
    return tuned_plan("pcdn_sparse_direction", sparse_direction_warps, (K,),
                      (P, K, m), vals.dtype, vals.device, config)


@_observed("pcdn_sparse_direction")
def pcdn_sparse_direction(rows: Tensor, vals: Tensor, z: Tensor, y: Tensor,
                          w_B: Tensor, c, kind: str = "logistic",
                          l2: float = 0.0, *, config: dict | None = None):
    """K2: bundle direction over a padded-CSC slab, the loss factors and the
    margin scatter inside. rows (P, K) int32 with sentinel len(z), vals
    (P, K) float32|bf16, z/y (m,) float32 margins and labels (the full
    scope: m = s; the support scope: positions into z_R, y_R), w_B (P,)
    float32, c a float -> (d, g, h), each (P,), and delta = X_B d (m,), all
    float32. Two launches (the direction, then the rows' sums) and a
    memset; each row's delta sums its entries in ascending entry id, so
    two calls on the same inputs are bit-equal. `config`: the plan's knobs
    (`sparse_direction_warps`), else the tuner's."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(rows, vals, z, y, w_B):
        return ref.pcdn_sparse_direction_ref(rows, vals, z, y, w_B, c,
                                             kind=kind, l2=l2)
    P, K = rows.shape
    m = z.shape[0]
    _check("rows", rows, _I32, (P, K))
    _check("vals", vals, tuple(_VALUE_TYPES), (P, K))
    _check("z", z, _F32, (m,))
    _check("y", y, _F32, (m,))
    _check("w_B", w_B, _F32, (P,))
    if P < 1 or K < 1 or m < 1:
        raise ValueError(f"pcdn_sparse_direction: empty input P={P} K={K} "
                         f"len(z)={m}")
    lib = build.load("pcdn_sparse_direction")
    # d, g, h, delta, then the rows' list heads (zeroed with delta)
    buf = torch.empty((3 * P + 2 * m,), dtype=torch.float32,
                      device=rows.device)
    d, g, h = buf[:3 * P].view(3, P)
    delta = buf[3 * P:3 * P + m]
    links = _entry_links(P, K, rows.device)
    fn = getattr(lib, f"pcdn_sparse_direction_{_VALUE_TYPES[vals.dtype]}")
    err = fn(_ptr(rows), _ptr(vals), _ptr(z), _ptr(y), _ptr(w_B), float(c),
             _KINDS[kind], float(l2), P, K, m, _sparse_warps(vals, m, config),
             _ptr(d), _ptr(g), _ptr(h), _ptr(delta), _ptr(links),
             _stream(rows))
    _raise_if(err, "pcdn_sparse_direction")
    _LAUNCHES["pcdn_sparse_direction"] += 1
    return d, g, h, delta


def _entry_links(P: int, K: int, device) -> Tensor:
    """K2's per-entry scratch: each entry's list link and term, (2 P K,)
    words, written before they are read (no fill)."""
    if P * K >= _INT32_MAX:
        raise ValueError(f"pcdn_sparse_direction: P * K = {P * K} entries, "
                         f"the kernel numbers them in int32")
    return torch.empty((2 * P * K,), dtype=torch.int32, device=device)


def _check_slab(rows: Tensor, vals: Tensor) -> tuple:
    P, K = rows.shape
    _check("rows", rows, _I32, (P, K))
    _check("vals", vals, tuple(_VALUE_TYPES), (P, K))
    if P < 1 or K < 1:
        raise ValueError(f"empty slab P={P} K={K}")
    return P, K


@_observed("pcdn_sparse_direction_partials")
def pcdn_sparse_direction_partials(rows: Tensor, vals: Tensor, z: Tensor,
                                   y: Tensor, c, kind: str = "logistic"):
    """K2's partials entry, the sharded backend's shard-local step on the
    padded-CSC layout: rows (P, K) int32 with sentinel len(z) (the shard's
    local rows, or positions into z_R/y_R on the support scope), vals
    (P, K) float32|bf16, z/y (m,) float32 -> (g, h), each (P,) float32: g
    raw, h floored at 1e-12, u and v formed at the rows. No d, no delta.
    One launch of K2's plan (the tuner's, as K2's); deterministic."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(rows, vals, z, y):
        return ref.pcdn_sparse_direction_partials_ref(rows, vals, z, y, c,
                                                      kind=kind)
    P, K = _check_slab(rows, vals)
    m = z.shape[0]
    _check("z", z, _F32, (m,))
    _check("y", y, _F32, (m,))
    if m < 1:
        raise ValueError("pcdn_sparse_direction_partials: empty z")
    lib = build.load("pcdn_sparse_direction")
    buf = torch.empty((2 * P,), dtype=torch.float32, device=rows.device)
    g, h = buf.view(2, P)
    fn = getattr(lib, "pcdn_sparse_direction_partials_"
                      f"{_VALUE_TYPES[vals.dtype]}")
    err = fn(_ptr(rows), _ptr(vals), _ptr(z), _ptr(y), float(c),
             _KINDS[kind], P, K, m, _sparse_warps(vals, m, None), _ptr(g),
             _ptr(h), _stream(rows))
    _raise_if(err, "pcdn_sparse_direction_partials")
    _LAUNCHES["pcdn_sparse_direction_partials"] += 1
    return g, h


@_observed("pcdn_sparse_scatter")
def pcdn_sparse_scatter(rows: Tensor, vals: Tensor, d: Tensor,
                        n_rows: int) -> Tensor:
    """K2's scatter half: delta = X_B d, (n_rows,) float32, over a padded-CSC
    slab rows (P, K) int32 (rows outside [0, n_rows) add nothing), vals
    (P, K) float32|bf16 and a given d (P,) float32 -- the sharded
    backend's phase 2, after the global g and h made d. Two launches and a
    memset; each row sums its entries in ascending entry id (the plain
    version's index_add_ order), so two calls are bit-equal."""
    if _on_cpu(rows, vals, d):
        return ref.pcdn_sparse_scatter_ref(rows, vals, d, n_rows)
    P, K = _check_slab(rows, vals)
    _check("d", d, _F32, (P,))
    m = int(n_rows)
    if m < 1:
        raise ValueError("pcdn_sparse_scatter: n_rows must be >= 1")
    lib = build.load("pcdn_sparse_direction")
    buf = torch.empty((2 * m,), dtype=torch.float32, device=rows.device)
    links = _entry_links(P, K, rows.device)
    fn = getattr(lib, f"pcdn_sparse_scatter_{_VALUE_TYPES[vals.dtype]}")
    err = fn(_ptr(rows), _ptr(vals), _ptr(d), P, K, m, _ptr(buf),
             _ptr(links), _stream(rows))
    _raise_if(err, "pcdn_sparse_scatter")
    _LAUNCHES["pcdn_sparse_scatter"] += 1
    return buf[:m]


# -- K1 ------------------------------------------------------------------------
# launch constants of kernels/csrc/pcdn_bundle.cu (checked against the
# built library's when it is loaded)
BUNDLE_THREADS = 512
BUNDLE_MAX_CLUSTER = 8
BUNDLE_MAX_Q = 64
BUNDLE_CHUNK = 2            # candidates a chunk of the in-kernel search
BUNDLE_ENTRIES_PER_CTA = 1024
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class BundlePlan:
    """K1's launch for a bundle of P columns of width K over s samples and
    n features, Q candidates: one cluster of `cluster` CTAs, a column split
    over `nseg` warps, and the workspace."""
    P: int
    K: int
    s: int
    n: int
    Q: int
    cluster: int
    nseg: int

    @property
    def workspace_ints(self) -> int:
        """int32 words: the (s,) owner map and (s,) list heads, then the
        R = P K slots' row, list link, term, delta, z and y, then w_B and d
        (P each)."""
        return 2 * self.s + 6 * self.P * self.K + 2 * self.P

    @property
    def workspace_bytes(self) -> int:
        return 4 * self.workspace_ints


def bundle_plan(P: int, K: int, s: int, n: int, Q: int,
                config: dict | None = None) -> BundlePlan:
    """K1's launch plan, or a ValueError naming the limit the kernel has:
    a cluster of ceil(P K / 1024) CTAs, at most 8 (the portable cluster
    size); each feature's column over the largest power of two of warps
    that the cluster's warps a feature and ceil(K / 32) allow, at most 16.
    `config` (the tuner's `pcdn_bundle` knobs): `cluster` 1 to 8, `nseg`
    a power of two up to 16 (the kernel takes any such split: features
    beyond the cluster's groups go in rounds, empty segments add 0)."""
    if min(P, K, s, n) < 1:
        raise ValueError(f"pcdn_bundle: empty design or bundle P={P} "
                         f"k_max={K} s={s} n={n} (each must be >= 1)")
    if not 1 <= Q <= BUNDLE_MAX_Q:
        raise ValueError(f"pcdn_bundle: Q={Q} candidates, the kernel takes "
                         f"1 to {BUNDLE_MAX_Q}")
    if P * K > _INT32_MAX or s >= _INT32_MAX or n >= _INT32_MAX:
        raise ValueError(f"pcdn_bundle: P * k_max = {P * K}, s = {s}, "
                         f"n = {n}: each must be below 2**31 (int32 entry "
                         f"ids and rows)")
    knobs = _knobs("pcdn_bundle", config)
    warps = BUNDLE_THREADS // 32
    cluster = _int_knob("pcdn_bundle", knobs, "cluster",
                        max(1, min(BUNDLE_MAX_CLUSTER,
                                   -(-P * K // BUNDLE_ENTRIES_PER_CTA))),
                        1, BUNDLE_MAX_CLUSTER)
    cap = min(warps, max(1, cluster * warps // P), -(-K // 32))
    nseg = 1
    while nseg * 2 <= cap:
        nseg *= 2
    nseg = _int_knob("pcdn_bundle", knobs, "nseg", nseg, 1, warps)
    if nseg & (nseg - 1):
        raise ValueError(f"pcdn_bundle: nseg={nseg}, the kernel takes a "
                         f"power of two (a split of its {warps} warps)")
    return BundlePlan(P=P, K=K, s=s, n=n, Q=Q, cluster=cluster, nseg=nseg)


class _BundleArgs(ctypes.Structure):
    """kernels/csrc/pcdn_bundle.cu's BundleArgs, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "col_rows", "col_vals", "z", "y", "w", "alphas", "n_steps", "alpha",
        "ws")] + [(name, ctypes.c_float) for name in (
            "c", "l2", "sigma", "gamma")] + [(name, ctypes.c_int) for name in (
                "kind", "n", "K", "s", "P", "Q", "cluster", "nseg")]


class BundleLaunch:
    """K1 bound to one outer iteration of the support scope: the design's
    columns (n, K), the labels y (s,), the candidates alphas (Q,), the loss
    and its scalars, and the (n_bundles,) outputs `n_steps` (int32) and
    `alpha` (float32) that bundle t writes at t. On the card it also holds
    the launch plan, the arguments (packed once) and the workspace, filled
    once here; `pcdn_bundle(launch, w, z, idx, t)` runs a bundle. The plan
    is `config`'s (`bundle_plan`), else the tuner's, resolved once a shape
    (a launch is built every outer iteration: later ones read the memo)."""

    def __init__(self, col_rows: Tensor, col_vals: Tensor, y: Tensor,
                 alphas: Tensor, c, P: int, n_bundles: int, *,
                 kind: str = "logistic", l2: float = 0.0,
                 sigma: float = 0.01, gamma: float = 0.0,
                 config: dict | None = None):
        if kind not in _KINDS:
            raise KeyError(f"unknown loss {kind!r}")
        n, K = col_rows.shape
        s = y.shape[0]
        Q = alphas.shape[0]
        self.plan = tuned_plan("pcdn_bundle", bundle_plan,
                               (int(P), K, s, n, Q), (int(P), K, s, Q),
                               col_vals.dtype, col_rows.device, config)
        self.col_rows, self.col_vals, self.y, self.alphas = (
            col_rows, col_vals, y, alphas)
        self.c, self.kind, self.l2 = float(c), kind, float(l2)
        self.sigma, self.gamma = float(sigma), float(gamma)
        self.device = col_rows.device
        self.on_cpu = _on_cpu(col_rows, col_vals, y, alphas)
        self.n_steps = torch.zeros((n_bundles,), dtype=torch.int32,
                                   device=self.device)
        self.alpha = torch.zeros((n_bundles,), dtype=torch.float32,
                                 device=self.device)
        if self.on_cpu:
            return
        _check("col_rows", col_rows, _I32, (n, K))
        _check("col_vals", col_vals, tuple(_VALUE_TYPES), (n, K))
        _check("y", y, _F32, (s,))
        _check("alphas", alphas, _F32, (self.plan.Q,))
        lib = _loaded("pcdn_bundle", {
            "pcdn_bundle_max_q": BUNDLE_MAX_Q,
            "pcdn_bundle_chunk": BUNDLE_CHUNK,
            "pcdn_bundle_max_cluster": BUNDLE_MAX_CLUSTER,
            "pcdn_bundle_threads": BUNDLE_THREADS,
            "pcdn_bundle_args_size": ctypes.sizeof(_BundleArgs)})
        self._fn = getattr(lib, f"pcdn_bundle_{_VALUE_TYPES[col_vals.dtype]}")
        self.workspace = torch.empty((self.plan.workspace_ints,),
                                     dtype=torch.int32, device=self.device)
        # the owner map starts at INT32_MAX (no bid), the list heads at 0
        # (empty), the slots' rows at -1; each launch leaves them so
        R = K * self.plan.P
        self.workspace[:s].fill_(_INT32_MAX)
        self.workspace[s:2 * s].zero_()
        self.workspace[2 * s:2 * s + R].fill_(-1)
        p = self.plan
        self._args = _BundleArgs(
            _ptr(col_rows), _ptr(col_vals), None, _ptr(y), None,
            _ptr(alphas), _ptr(self.n_steps), _ptr(self.alpha),
            _ptr(self.workspace), self.c, self.l2, self.sigma, self.gamma,
            _KINDS[kind], n, K, s, p.P, p.Q, p.cluster, p.nseg)
        self._ref = ctypes.byref(self._args)
        self._bound = None
        self._index = _device_index(self.device)

    def _bind(self, w: Tensor, z: Tensor, key: tuple) -> None:
        """Point the packed arguments at w and z, checked here once for each
        `key` (`_tensor_key` of w and of z)."""
        p = self.plan
        _check("w", w, _F32, (p.n,))
        _check("z", z, _F32, (p.s,))
        if w.device != self.device or z.device != self.device:
            raise ValueError(f"pcdn_bundle: w on {w.device}, z on "
                             f"{z.device}, the launch on {self.device}")
        self._args.w = w.data_ptr()
        self._args.z = z.data_ptr()
        self._bound = key


def _tensor_key(t: Tensor) -> tuple:
    """What `BundleLaunch._bind` checks of a tensor, cheap to read each call:
    a view at the same address with another length, stride or dtype gets
    checked again. (Addresses are unique across devices: CUDA's unified
    virtual addressing.)"""
    return t.data_ptr(), t.shape, t.stride(), t.dtype


@_observed("pcdn_bundle", arg=1)
def pcdn_bundle(launch: BundleLaunch, w: Tensor, z: Tensor, idx: Tensor,
                t: int) -> None:
    """K1: the whole support-restricted bundle step for the (P,) bundle idx
    (int32, sentinel n): w and z updated IN PLACE, launch.n_steps[t] and
    launch.alpha[t] written (n_steps = 1 and alpha = 0 when no candidate
    passes). One kernel launch on the card, no other device operation and
    no host sync."""
    if launch.on_cpu:
        _on_cpu(w, z, idx, launch.y)
        q, a = ref.pcdn_bundle_step_ref(
            launch.col_rows, launch.col_vals, idx, z, launch.y, w,
            launch.alphas, launch.c, kind=launch.kind, l2=launch.l2,
            sigma=launch.sigma, gamma=launch.gamma)
        launch.n_steps[t] = q
        launch.alpha[t] = a
        return
    key = (*_tensor_key(w), *_tensor_key(z))
    if key != launch._bound:
        launch._bind(w, z, key)
    if idx.dtype != torch.int32 or idx.shape != (launch.plan.P,) or \
            idx.device != launch.device or not idx.is_contiguous():
        raise ValueError(f"pcdn_bundle: idx must be a contiguous "
                         f"({launch.plan.P},) int32 tensor on "
                         f"{launch.device}; got {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")
    if not 0 <= t < launch.n_steps.shape[0]:
        raise IndexError(f"pcdn_bundle: bundle {t} of "
                         f"{launch.n_steps.shape[0]}")
    err = launch._fn(launch._ref, idx.data_ptr(), t,
                     _raw_stream(launch._index))
    _raise_if(err, "pcdn_bundle")
    _LAUNCHES["pcdn_bundle"] += 1


DENSE_MAX_WIDTH = 1536


def dense_tile_width(B: int, n: int, K: int, sms: int,
                     config: dict | None = None) -> int:
    """Column tile of the K4a launch, a multiple of 32: about four blocks
    per SM over the (32-row, width-column) tiles of X, at most 1536
    columns (the staged tile, 32 x (width + 1) floats, within the 227 KB
    a block may hold), and the (tiles, K, B) partials at most 16M floats
    where the width allows. `config` (the tuner's `serve_margins_dense`
    knobs): `width`, a multiple of 32 up to DENSE_MAX_WIDTH."""
    knobs = _knobs("serve_margins_dense", config)
    if "width" in knobs:
        width = knobs["width"]
        if type(width) is not int or width < 32 or width % 32 or \
                width > DENSE_MAX_WIDTH:
            raise ValueError(f"serve_margins_dense: width={width!r}, the "
                             f"kernel takes a multiple of 32 up to "
                             f"{DENSE_MAX_WIDTH}")
        return width
    row_tiles = -(-B // 32)
    want = max(1, -(-4 * sms // row_tiles))
    width = 32 * -(-n // (32 * want))
    while width < DENSE_MAX_WIDTH and -(-n // width) * K * B > (1 << 24):
        width *= 2
    return int(min(max(width, 32), DENSE_MAX_WIDTH))


@_observed("serve_margins_dense")
def serve_margins_dense(X: Tensor, idx: Tensor, val: Tensor, *,
                        config: dict | None = None) -> Tensor:
    """K4a: serving margins over a dense request slab. X (B, n) float32|
    bf16, idx (K, A) int32 with sentinel n at padding, val (K, A) float32|
    bf16 -> (B, K) float32 (bias not added).

    Contract on the card: each model's live ids ascend, sentinels after
    them (the artifact's w_indices are strictly ascending and ModelBank
    keeps that order). The kernel cuts X into column tiles and finds each
    model's ids in a tile by a search that assumes that order; ids out of
    order drop terms.
    Each column tile's partial margins are summed in tile order by a
    second launch: deterministic, no atomics. `config`: the plan's knobs
    (`dense_tile_width`), else the tuner's."""
    if _on_cpu(X, idx, val):
        return ref.serve_margins_dense_ref(X, idx, val)
    B, n = X.shape
    K, A = idx.shape
    _check("X", X, tuple(_VALUE_TYPES), (B, n))
    _check("idx", idx, _I32, (K, A))
    _check("val", val, tuple(_VALUE_TYPES), (K, A))
    if B < 1 or n < 1 or K < 1 or A < 1:
        raise ValueError(f"serve_margins_dense: empty input B={B} n={n} "
                         f"K={K} A={A}")
    lib = build.load("serve_margins_dense")
    width = tuned_plan("serve_margins_dense", dense_tile_width,
                       (B, n, K, _sm_count(X.device)), (B, n, K, A), X.dtype,
                       X.device, config)
    n_tiles = -(-n // width)
    # one allocation: the (B, K) output, then the (tiles, K, B) partials
    buf = torch.empty(((n_tiles + 1) * K * B,), dtype=torch.float32,
                      device=X.device)
    out, part = buf[:B * K].view(B, K), buf[B * K:]
    fn = getattr(lib, f"serve_margins_dense_{_VALUE_TYPES[X.dtype]}_"
                      f"{_VALUE_TYPES[val.dtype]}")
    err = fn(_ptr(X), _ptr(idx), _ptr(val), B, n, K, A, width, _ptr(part),
             _ptr(out), _stream(X))
    _raise_if(err, "serve_margins_dense")
    _LAUNCHES["serve_margins_dense"] += 1
    return out


# -- K4b -----------------------------------------------------------------------
# launch constants of kernels/csrc/serve_margins_csc.cu
CSC_THREADS = 1024
CSC_MAX_CLUSTER = 8
CSC_ROUND = 8               # (feature, slot) pairs a thread has in flight
CSC_MAX_RANGE_ROWS = 48 * 1024


@dataclasses.dataclass(frozen=True)
class CscPlan:
    """K4b's launch: for each of the K models one cluster of `cluster`
    CTAs, each a slice of the model's A features, repeated for `ranges`
    ranges of `range_rows` request rows; each CTA keeps a (range_rows,)
    margin column in shared memory."""
    B: int
    K: int
    A: int
    k_max: int
    cluster: int
    ranges: int
    range_rows: int

    @property
    def ctas(self) -> int:
        return self.cluster * self.K * self.ranges

    @property
    def smem_bytes(self) -> int:
        return 4 * self.range_rows


def csc_plan(B: int, K: int, A: int, k_max: int,
             config: dict | None = None) -> CscPlan:
    """K4b's launch plan, or a ValueError naming the limit: a cluster of
    ceil(A k_max / (CSC_THREADS CSC_ROUND)) CTAs a model (one round of
    pairs a thread where 8 CTAs suffice), at most CSC_MAX_CLUSTER; the
    request rows in as few ranges of at most CSC_MAX_RANGE_ROWS as cover
    them, balanced. `config` (the tuner's `serve_margins_csc` knobs):
    `cluster` 1 to CSC_MAX_CLUSTER (a CTA's slice may be empty)."""
    if min(B, K, A, k_max) < 1:
        raise ValueError(f"serve_margins_csc: empty input B={B} K={K} "
                         f"A={A} k_max={k_max}")
    if A * k_max > _INT32_MAX:
        raise ValueError(f"serve_margins_csc: A * k_max = {A * k_max} "
                         f"pairs, must be below 2**31")
    if K > 65535:
        raise ValueError(f"serve_margins_csc: {K} models, the grid takes "
                         f"65535")
    cluster = _int_knob("serve_margins_csc", _knobs("serve_margins_csc",
                                                     config), "cluster",
                        max(1, min(CSC_MAX_CLUSTER,
                                   -(-A * k_max // (CSC_THREADS *
                                                    CSC_ROUND)))),
                        1, CSC_MAX_CLUSTER)
    ranges = -(-B // CSC_MAX_RANGE_ROWS)
    if ranges > 65535:
        raise ValueError(f"serve_margins_csc: {ranges} row ranges, the "
                         f"grid takes 65535")
    return CscPlan(B=B, K=K, A=A, k_max=k_max, cluster=cluster,
                   ranges=ranges, range_rows=-(-B // ranges))


@_observed("serve_margins_csc")
def serve_margins_csc(col_rows: Tensor, col_vals: Tensor, idx: Tensor,
                      val: Tensor, n_requests: int, *,
                      config: dict | None = None) -> Tensor:
    """K4b: serving margins over a padded-CSC request batch. col_rows
    (n, k_max) int32 with sentinel n_requests at padding, col_vals
    (n, k_max) float32|bf16, idx/val (K, A) as for K4a -> (n_requests, K)
    float32 (bias not added). One launch: a cluster a model sums its
    CTAs' margin columns in rank order, each column summed with
    shared-memory atomics. `config`: the plan's knobs (`csc_plan`), else
    the tuner's."""
    if _on_cpu(col_rows, col_vals, idx, val):
        return ref.serve_margins_csc_ref(col_rows, col_vals, idx, val,
                                         n_requests)
    n, k_max = col_rows.shape
    K, A = idx.shape
    B = int(n_requests)
    _check("col_rows", col_rows, _I32, (n, k_max))
    _check("col_vals", col_vals, tuple(_VALUE_TYPES), (n, k_max))
    _check("idx", idx, _I32, (K, A))
    _check("val", val, tuple(_VALUE_TYPES), (K, A))
    if n < 1 or n * k_max > _INT32_MAX:
        raise ValueError(f"serve_margins_csc: n={n}, k_max={k_max}: n * "
                         f"k_max must be 1 to 2**31 - 1")
    plan = tuned_plan("serve_margins_csc", csc_plan, (B, K, A, k_max),
                      (n, k_max, K, A, B), col_vals.dtype, col_rows.device,
                      config)
    lib = _loaded("serve_margins_csc", {
        "serve_margins_csc_threads": CSC_THREADS,
        "serve_margins_csc_max_cluster": CSC_MAX_CLUSTER,
        "serve_margins_csc_round": CSC_ROUND,
        "serve_margins_csc_max_range_rows": CSC_MAX_RANGE_ROWS})
    out = torch.empty((B, K), dtype=torch.float32, device=col_rows.device)
    fn = getattr(lib, f"serve_margins_csc_{_VALUE_TYPES[col_vals.dtype]}_"
                      f"{_VALUE_TYPES[val.dtype]}")
    err = fn(_ptr(col_rows), _ptr(col_vals), _ptr(idx), _ptr(val), n, k_max,
             K, A, B, plan.cluster, plan.ranges, plan.range_rows, _ptr(out),
             _stream(col_rows))
    _raise_if(err, "serve_margins_csc")
    _LAUNCHES["serve_margins_csc"] += 1
    return out


# -- K5 ------------------------------------------------------------------------
# threads a block of kernels/csrc/pcdn_linesearch.cu (checked against the
# built library's when it is first loaded)
LINESEARCH_THREADS = 256


@_observed("pcdn_linesearch")
def pcdn_linesearch(z: Tensor, delta: Tensor, y: Tensor, alphas: Tensor,
                    kind: str = "logistic", *,
                    config: dict | None = None) -> Tensor:
    """K5: batched candidate loss deltas. z, y (s,) float32, delta (s,) or
    (P, s) float32 (rows may be a strided view: unit stride along s), alphas
    (Q,) float32 -> (Q,) or (P, Q) float32 with out[p, q] = sum_i phi(z_i +
    alphas[q] * delta[p, i], y_i) - phi(z_i, y_i); the caller scales by c
    and adds the l1 part. One launch for all P rows (a grid row each).
    Deterministic: block partials are summed in block order. `config`:
    the plan's knobs (`linesearch_blocks`), else the tuner's."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(z, delta, y, alphas):
        return ref.pcdn_linesearch_ref(z, delta, y, alphas, kind=kind)
    s = z.shape[0]
    Q = alphas.shape[0]
    _check("z", z, _F32, (s,))
    _check("y", y, _F32, (s,))
    _check("alphas", alphas, _F32, (Q,))
    rows = delta if delta.ndim == 2 else delta[None]
    P = rows.shape[0]
    if delta.dtype not in _F32:
        raise TypeError(f"delta: dtype {delta.dtype}, expected float32")
    if delta.ndim not in (1, 2) or rows.shape[1] != s:
        raise ValueError(f"delta: shape {tuple(delta.shape)}, expected "
                         f"({s},) or (P, {s})")
    ld = rows.stride(0) if P > 1 else s
    if rows.stride(1) != 1 or ld < s:
        raise ValueError(f"delta: strides {rows.stride()} (each row must "
                         f"be contiguous, rows {s} or more apart)")
    lib = _loaded("pcdn_linesearch",
                  {"pcdn_linesearch_threads": LINESEARCH_THREADS})
    max_q = lib.consts["pcdn_linesearch_max_q"]
    max_rows = lib.consts["pcdn_linesearch_max_rows"]
    if s < 1 or not 1 <= Q <= max_q or not 1 <= P <= max_rows:
        raise ValueError(f"pcdn_linesearch: unsupported sizes s={s} Q={Q} "
                         f"P={P} (Q <= {max_q}, P <= {max_rows})")
    n_blocks = tuned_plan("pcdn_linesearch", linesearch_blocks,
                          (s, P, _sm_count(z.device)), (s, P, Q), z.dtype,
                          z.device, config)
    buf = torch.empty((P * n_blocks * Q + P * Q,), dtype=torch.float32,
                      device=z.device)
    partials, out = buf[:P * n_blocks * Q], buf[P * n_blocks * Q:]
    err = lib.pcdn_linesearch_f32(_ptr(z), _ptr(rows), ld, _ptr(y),
                                  _ptr(alphas), _KINDS[kind], s, P, Q,
                                  n_blocks, _ptr(partials), _ptr(out),
                                  _stream(z))
    _raise_if(err, "pcdn_linesearch")
    _LAUNCHES["pcdn_linesearch"] += 1
    return out.view(P, Q) if delta.ndim == 2 else out


def linesearch_blocks(s: int, P: int, sms: int,
                      config: dict | None = None) -> int:
    """K5's blocks a row: one a LINESEARCH_THREADS samples, at most 4
    blocks an SM over all P rows together (and at least one a row).
    `config` (the tuner's `pcdn_linesearch` knobs): `blocks` 1 to one a
    LINESEARCH_THREADS samples."""
    rule = int(max(1, min(-(-s // LINESEARCH_THREADS), 4 * sms // P)))
    return _int_knob("pcdn_linesearch", _knobs("pcdn_linesearch", config),
                     "blocks", rule, 1,
                     max(1, -(-s // LINESEARCH_THREADS)))


# -- K5, batch entry -----------------------------------------------------------
# launch constants of kernels/csrc/scdn_batch.cu (checked against the built
# library's when it is loaded)
SCDN_THREADS = 256
SCDN_MAX_Q = 40
SCDN_CHUNK = 8              # candidates a pass of the in-kernel search
SCDN_MAX_CLUSTER = 8
SCDN_BITMAP_WORDS = 2048    # a CTA's row map: 65,536 bits
# dynamic shared memory a launch may take: a block's 232,448 bytes less
# room for the kernel's static arrays
SCDN_SMEM_BUDGET = SMEM_BUDGET - 1024


def scdn_batch_smem_bytes(K: int, slots: int, cpc: int, P: int) -> int:
    """The batch kernel's dynamic shared memory in bytes, words of 4: a row
    table of `slots` rows and distinct-row indices for each of the CTA's
    cpc coordinates, the table's lowest-entry and count columns, the row
    map, six (K,) entry and row arrays, three (K,) row arrays for each
    coordinate, the batch's P indices and four words a coordinate
    (`smem_words` in scdn_batch.cu)."""
    return 4 * (2 * slots * cpc + 2 * slots + SCDN_BITMAP_WORDS + 6 * K +
                3 * K * cpc + P + 4 * cpc)


@dataclasses.dataclass(frozen=True)
class ScdnBatchPlan:
    """K5's batch launch for P coordinates of padded-CSC width K, Q
    candidates, s samples: one cluster of `cluster` CTAs, coordinate p on
    CTA p % cluster (the CTA's p // cluster-th, `cpc` a CTA at most), a
    column's rows merged in a table of `slots` (a power of two, at least
    twice K: at most half full)."""
    P: int
    K: int
    Q: int
    s: int
    cluster: int
    cpc: int
    slots: int

    @property
    def smem_bytes(self) -> int:
        return scdn_batch_smem_bytes(self.K, self.slots, self.cpc, self.P)


def scdn_batch_plan(P: int, k_max: int, Q: int, s: int,
                    config: dict | None = None) -> ScdnBatchPlan:
    """K5's batch launch plan, or a ValueError naming the limit: a CTA a
    coordinate up to SCDN_MAX_CLUSTER (the portable cluster size), then
    ceil(P / 8) coordinates a CTA; every array of the batch in shared
    memory, so k_max and P are bounded by SCDN_SMEM_BUDGET. `config` (the
    tuner's `scdn_batch` knobs): `cluster` 1 to min(P, SCDN_MAX_CLUSTER),
    ceil(P / cluster) coordinates a CTA."""
    if min(P, k_max, s) < 1:
        raise ValueError(f"scdn_batch: empty batch or design P={P} "
                         f"k_max={k_max} s={s} (each must be >= 1)")
    if not 1 <= Q <= SCDN_MAX_Q:
        raise ValueError(f"scdn_batch: Q={Q} candidates, the kernel takes "
                         f"1 to {SCDN_MAX_Q}")
    if s >= _INT32_MAX:
        raise ValueError(f"scdn_batch: s = {s} samples, must be below 2**31 "
                         f"(int32 rows)")
    cluster = _int_knob("scdn_batch", _knobs("scdn_batch", config),
                        "cluster", min(P, SCDN_MAX_CLUSTER), 1,
                        min(P, SCDN_MAX_CLUSTER))
    cpc = -(-P // cluster)
    slots = 2 << (k_max - 1).bit_length()
    one = scdn_batch_smem_bytes(k_max, slots, 1, min(P, SCDN_MAX_CLUSTER))
    if one > SCDN_SMEM_BUDGET:
        raise ValueError(f"scdn_batch: k_max = {k_max} needs {one} bytes of "
                         f"shared memory a CTA, more than the "
                         f"{SCDN_SMEM_BUDGET} a launch may take")
    plan = ScdnBatchPlan(P=P, K=k_max, Q=Q, s=s, cluster=cluster, cpc=cpc,
                         slots=slots)
    if plan.smem_bytes > SCDN_SMEM_BUDGET:
        raise ValueError(f"scdn_batch: P = {P} coordinates ({cpc} a CTA of "
                         f"one {cluster}-CTA cluster) at k_max = {k_max} "
                         f"need {plan.smem_bytes} bytes of shared memory a "
                         f"CTA, more than the {SCDN_SMEM_BUDGET} one cluster "
                         f"launch may take")
    return plan


class _ScdnArgs(ctypes.Structure):
    """kernels/csrc/scdn_batch.cu's ScdnArgs, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "col_rows", "col_vals", "w", "z", "y", "alphas")] + \
        [(name, ctypes.c_float) for name in ("c", "l2", "sigma", "gamma")] + \
        [(name, ctypes.c_int) for name in (
            "kind", "n", "K", "s", "P", "Q", "cluster", "cpc", "slots")]


class _ScdnLaunch:
    """What K5's two batch entries share: the packed arguments' w and z,
    bound once for each tensor, and the dispatch (`_scdn_dispatch`).
    Subclasses set `name` (the kernel's), `n`, `plan` (with P, Q, s),
    `design_args` and, on the card, `_args`, `_ref`, `_fn`, `_index`."""

    name = ""

    def _bind(self, w: Tensor, z: Tensor, key: tuple) -> None:
        """Point the packed arguments at w and z, checked here once for each
        `key` (`_tensor_key` of w and of z)."""
        _check("w", w, _F32, (self.n,))
        _check("z", z, _F32, (self.plan.s,))
        if w.device != self.device or z.device != self.device:
            raise ValueError(f"{self.name}: w on {w.device}, z on "
                             f"{z.device}, the launch on {self.device}")
        self._args.w = w.data_ptr()
        self._args.z = z.data_ptr()
        self._bound = key


def _scdn_dispatch(launch: _ScdnLaunch, plain, w: Tensor, z: Tensor,
                   idx: Tensor, alpha: Tensor | None,
                   loss_deltas: Tensor | None) -> Tensor:
    """One batch through `launch`: on the CPU its plain version `plain`
    (called as `plain(*launch.design_args, idx, w, z, y, alphas, c,
    ...)`), into the caller's buffers; on the card the kernel, after the
    checks, counted once."""
    name, p = launch.name, launch.plan
    if launch.on_cpu:
        _on_cpu(w, z, idx, launch.y)
        a, lo = plain(*launch.design_args, idx, w, z, launch.y,
                      launch.alphas, launch.c, kind=launch.kind,
                      sigma=launch.sigma, gamma=launch.gamma, l2=launch.l2)
        if loss_deltas is not None:
            loss_deltas.copy_(lo)
        return a if alpha is None else alpha.copy_(a)
    key = (*_tensor_key(w), *_tensor_key(z))
    if key != launch._bound:
        launch._bind(w, z, key)
    if idx.dtype != torch.int32 or idx.shape != (p.P,) or \
            idx.device != launch.device or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous ({p.P},) int32 "
                         f"tensor on {launch.device}; got "
                         f"{tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if alpha is None:
        alpha = torch.empty((p.P,), dtype=torch.float32, device=launch.device)
    elif alpha.dtype != torch.float32 or alpha.shape != (p.P,) or \
            alpha.device != launch.device or not alpha.is_contiguous():
        raise ValueError(f"{name}: alpha must be a contiguous ({p.P},) "
                         f"float32 tensor on {launch.device}")
    lo_ptr = None
    if loss_deltas is not None:
        if loss_deltas.device != launch.device:
            raise ValueError(f"{name}: loss_deltas on {loss_deltas.device}, "
                             f"the launch on {launch.device}")
        _check("loss_deltas", loss_deltas, _F32, (p.P, p.Q))
        lo_ptr = loss_deltas.data_ptr()
    err = launch._fn(launch._ref, idx.data_ptr(), alpha.data_ptr(), lo_ptr,
                     _raw_stream(launch._index))
    _raise_if(err, name)
    _LAUNCHES[name] += 1
    return alpha


class ScdnBatchLaunch(_ScdnLaunch):
    """K5's batch entry bound to an SCDN round: the padded-CSC design's
    columns (n, K) float32, the labels y (s,), the candidates alphas (Q,),
    the loss and its scalars, and P coordinates a batch. On the card it
    also holds the launch plan and the arguments, packed once here;
    `scdn_batch(launch, w, z, idx, alpha)` runs a batch. The plan is
    `config`'s (`scdn_batch_plan`), else the tuner's."""

    name = "scdn_batch"

    def __init__(self, col_rows: Tensor, col_vals: Tensor, y: Tensor,
                 alphas: Tensor, c, P: int, *, kind: str = "logistic",
                 l2: float = 0.0, sigma: float = 0.01, gamma: float = 0.0,
                 config: dict | None = None):
        if kind not in _KINDS:
            raise KeyError(f"unknown loss {kind!r}")
        if col_vals.dtype != torch.float32:
            raise TypeError(f"scdn_batch: design values {col_vals.dtype}; "
                            f"the batch kernel takes float32 (SCDN refuses "
                            f"bf16 storage, as the reference does)")
        n, K = col_rows.shape
        s = y.shape[0]
        Q = alphas.shape[0]
        self.plan = tuned_plan("scdn_batch", scdn_batch_plan,
                               (int(P), K, Q, s), (int(P), K, Q, s),
                               col_vals.dtype, col_rows.device, config)
        self.n = n
        self.col_rows, self.col_vals, self.y, self.alphas = (
            col_rows, col_vals, y, alphas)
        self.c, self.kind, self.l2 = float(c), kind, float(l2)
        self.sigma, self.gamma = float(sigma), float(gamma)
        self.device = col_rows.device
        self.on_cpu = _on_cpu(col_rows, col_vals, y, alphas)
        if self.on_cpu:
            return
        p = self.plan
        _check("col_rows", col_rows, _I32, (n, K))
        _check("col_vals", col_vals, _F32, (n, K))
        _check("y", y, _F32, (s,))
        _check("alphas", alphas, _F32, (p.Q,))
        lib = _loaded("scdn_batch", {
            "scdn_batch_threads": SCDN_THREADS,
            "scdn_batch_max_q": SCDN_MAX_Q,
            "scdn_batch_chunk": SCDN_CHUNK,
            "scdn_batch_max_cluster": SCDN_MAX_CLUSTER,
            "scdn_batch_smem_budget": SCDN_SMEM_BUDGET,
            "scdn_batch_args_size": ctypes.sizeof(_ScdnArgs)})
        got = lib.scdn_batch_smem_bytes(K, p.slots, p.cpc, p.P)
        if got != p.smem_bytes:
            raise RuntimeError(f"scdn_batch: the kernel's shared memory "
                               f"{got} B differs from the plan's "
                               f"{p.smem_bytes} B")
        self._fn = lib.scdn_batch_f32
        self._args = _ScdnArgs(
            _ptr(col_rows), _ptr(col_vals), None, None, _ptr(y),
            _ptr(alphas), self.c, self.l2, self.sigma, self.gamma,
            _KINDS[kind], n, K, s, p.P, p.Q, p.cluster, p.cpc, p.slots)
        self._ref = ctypes.byref(self._args)
        self._bound = None
        self._index = _device_index(self.device)

    @property
    def design_args(self) -> tuple:
        """The design's arguments of the plain version,
        `ref.scdn_batch_ref(*design_args, idx, w, z, y, alphas, c, ...)`."""
        return self.col_rows, self.col_vals


@_observed("scdn_batch", arg=1)
def scdn_batch(launch: ScdnBatchLaunch, w: Tensor, z: Tensor, idx: Tensor,
               alpha: Tensor | None = None,
               loss_deltas: Tensor | None = None) -> Tensor:
    """K5's batch entry: one SCDN batch of the (P,) coordinates idx (int32,
    duplicates allowed) on the padded-CSC layout, w and z updated IN PLACE
    (`ref.scdn_batch_ref`'s function). Writes the accepted steps into
    `alpha` (P,) float32 (allocated when None) and returns it; with
    `loss_deltas`, a (P, Q) float32 buffer, also every candidate's loss
    delta sum_r phi(z_r + a_q delta_pr) - phi(z_r) (the search then
    evaluates every candidate). On the card: one kernel launch, no other
    device operation and no host sync; deterministic."""
    return _scdn_dispatch(launch, ref.scdn_batch_ref, w, z, idx, alpha,
                          loss_deltas)


# -- K5, dense batch entry -----------------------------------------------------
# launch constants of kernels/csrc/scdn_dense_batch.cu (checked against the
# built library's when it is loaded)
SCDN_DENSE_THREADS = 512
SCDN_DENSE_MAX_Q = 40
SCDN_DENSE_CHUNK = 8        # candidates a pass of the in-kernel search
SCDN_DENSE_MAX_CLUSTER = 8
SCDN_DENSE_TILE_ROWS = 8192  # a streamed tile's rows
# dynamic shared memory a launch may take: a block's 232,448 bytes less
# room for the kernel's static arrays
SCDN_DENSE_SMEM_BUDGET = SMEM_BUDGET - 2048


def scdn_dense_smem_bytes(tile: int) -> int:
    """The dense batch kernel's dynamic shared memory in bytes: four staged
    arrays (x, z, y, phi(z)) of a tile of rows each, rounded up to 4 words
    and 4 words of head room (`smem_bytes` in scdn_dense_batch.cu)."""
    return 16 * (-(-tile // 4) * 4 + 4)


@dataclasses.dataclass(frozen=True)
class ScdnDensePlan:
    """K5's dense batch launch for P coordinates over s samples, Q
    candidates: `clusters` clusters of `cluster` CTAs, cluster c taking
    coordinates c, c + clusters, ... (`cpc` at most); CTA rank r of a
    cluster rows [r sl, (r + 1) sl), staged in shared memory once
    (`resident`, tile = sl) or in tiles of `tile` rows."""
    P: int
    s: int
    Q: int
    cluster: int
    clusters: int
    cpc: int
    sl: int
    tile: int
    resident: bool

    @property
    def ctas(self) -> int:
        return self.cluster * self.clusters

    @property
    def smem_bytes(self) -> int:
        return scdn_dense_smem_bytes(self.tile)


def scdn_dense_plan(P: int, s: int, Q: int, sms: int,
                    config: dict | None = None) -> ScdnDensePlan:
    """K5's dense batch launch plan on a card of `sms` SMs, or a ValueError
    naming the limit: a cluster of sms // P CTAs a coordinate (at least 1,
    at most SCDN_DENSE_MAX_CLUSTER), so that P clusters fill about one
    wave of the SMs; above `sms` // cluster coordinates a cluster takes
    several in turn. The rows split evenly over a cluster's CTAs in slices
    of a multiple of 4; a slice whose four staged arrays fit in
    SCDN_DENSE_SMEM_BUDGET is resident, else it streams in tiles of
    SCDN_DENSE_TILE_ROWS rows. `config` (the tuner's `scdn_dense_batch`
    knobs): `cluster` 1 to SCDN_DENSE_MAX_CLUSTER CTAs a coordinate and
    `clusters` 1 to P (coordinates a cluster follow; clusters need not be
    co-resident: the update is a launch of its own)."""
    if min(P, s) < 1:
        raise ValueError(f"scdn_dense_batch: empty batch or design P={P} "
                         f"s={s} (each must be >= 1)")
    if not 1 <= Q <= SCDN_DENSE_MAX_Q:
        raise ValueError(f"scdn_dense_batch: Q={Q} candidates, the kernel "
                         f"takes 1 to {SCDN_DENSE_MAX_Q}")
    if s >= _INT32_MAX or P >= _INT32_MAX:
        raise ValueError(f"scdn_dense_batch: s = {s} samples, P = {P}: each "
                         f"must be below 2**31 (int32 rows and slots)")
    if sms < 1:
        raise ValueError(f"scdn_dense_batch: a card of {sms} SMs")
    knobs = _knobs("scdn_dense_batch", config)
    cluster = _int_knob("scdn_dense_batch", knobs, "cluster",
                        max(1, min(SCDN_DENSE_MAX_CLUSTER, sms // P)), 1,
                        SCDN_DENSE_MAX_CLUSTER)
    clusters = _int_knob("scdn_dense_batch", knobs, "clusters",
                         min(P, max(1, sms // cluster)), 1, P)
    sl = 4 * -(-s // (4 * cluster))
    resident = scdn_dense_smem_bytes(sl) <= SCDN_DENSE_SMEM_BUDGET
    return ScdnDensePlan(P=P, s=s, Q=Q, cluster=cluster, clusters=clusters,
                         cpc=-(-P // clusters), sl=sl,
                         tile=sl if resident else min(sl,
                                                      SCDN_DENSE_TILE_ROWS),
                         resident=resident)


class _ScdnDenseArgs(ctypes.Structure):
    """kernels/csrc/scdn_dense_batch.cu's DenseArgs, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "XT", "w", "z", "y", "alphas", "step")] + \
        [(name, ctypes.c_float) for name in ("c", "l2", "sigma", "gamma")] + \
        [(name, ctypes.c_int) for name in (
            "kind", "n", "s", "P", "Q", "cluster", "clusters", "cpc", "sl",
            "tile", "resident")]


class ScdnDenseBatchLaunch(_ScdnLaunch):
    """K5's dense batch entry bound to an SCDN round: the dense design's
    feature-major copy XT (n, s) float32 (`DenseDesign.feature_major()`),
    the labels y (s,), the candidates alphas (Q,), the loss and its
    scalars, and P coordinates a batch. On the card it also holds the
    launch plan, the arguments (packed once here) and the (P,) steps the
    batch launch hands the update launch; `scdn_dense_batch(launch, w, z,
    idx, alpha)` runs a batch. On the CPU the plan is made for one SM:
    its refusals hold, its layout is not used. The plan is `config`'s
    (`scdn_dense_plan`), else the tuner's."""

    name = "scdn_dense_batch"

    def __init__(self, XT: Tensor, y: Tensor, alphas: Tensor, c, P: int, *,
                 kind: str = "logistic", l2: float = 0.0,
                 sigma: float = 0.01, gamma: float = 0.0,
                 config: dict | None = None):
        if kind not in _KINDS:
            raise KeyError(f"unknown loss {kind!r}")
        if XT.dtype != torch.float32:
            raise TypeError(f"scdn_dense_batch: design values {XT.dtype}; "
                            f"the batch kernel takes float32 (SCDN refuses "
                            f"bf16 storage, as the reference does)")
        n, s = XT.shape
        self.n = n
        self.XT, self.y, self.alphas = XT, y, alphas
        self.c, self.kind, self.l2 = float(c), kind, float(l2)
        self.sigma, self.gamma = float(sigma), float(gamma)
        self.device = XT.device
        self.on_cpu = _on_cpu(XT, y, alphas)
        sms = 1 if self.on_cpu else _sm_count(self.device)
        Q = alphas.shape[0]
        self.plan = tuned_plan("scdn_dense_batch", scdn_dense_plan,
                               (int(P), s, Q, sms), (int(P), s, Q),
                               XT.dtype, XT.device, config)
        if self.on_cpu:
            return
        p = self.plan
        _check("XT", XT, _F32, (n, s))
        _check("y", y, _F32, (s,))
        _check("alphas", alphas, _F32, (p.Q,))
        if n < 1:
            raise ValueError("scdn_dense_batch: a design with no features")
        lib = _loaded("scdn_dense_batch", {
            "scdn_dense_batch_threads": SCDN_DENSE_THREADS,
            "scdn_dense_batch_max_q": SCDN_DENSE_MAX_Q,
            "scdn_dense_batch_chunk": SCDN_DENSE_CHUNK,
            "scdn_dense_batch_max_cluster": SCDN_DENSE_MAX_CLUSTER,
            "scdn_dense_batch_tile_rows": SCDN_DENSE_TILE_ROWS,
            "scdn_dense_batch_smem_budget": SCDN_DENSE_SMEM_BUDGET,
            "scdn_dense_batch_args_size": ctypes.sizeof(_ScdnDenseArgs)})
        got = lib.scdn_dense_batch_smem_bytes(p.tile)
        if got != p.smem_bytes:
            raise RuntimeError(f"scdn_dense_batch: the kernel's shared memory "
                               f"{got} B differs from the plan's "
                               f"{p.smem_bytes} B")
        self._fn = lib.scdn_dense_batch_f32
        self.step = torch.empty((p.P,), dtype=torch.float32,
                                device=self.device)
        self._args = _ScdnDenseArgs(
            _ptr(XT), None, None, _ptr(y), _ptr(alphas), _ptr(self.step),
            self.c, self.l2, self.sigma, self.gamma, _KINDS[kind], n, s, p.P,
            p.Q, p.cluster, p.clusters, p.cpc, p.sl, p.tile,
            int(p.resident))
        self._ref = ctypes.byref(self._args)
        self._bound = None
        self._index = _device_index(self.device)

    @property
    def design_args(self) -> tuple:
        """The design's arguments of the plain version,
        `ref.scdn_dense_batch_ref(*design_args, idx, w, z, y, alphas, c,
        ...)`."""
        return (self.XT,)


@_observed("scdn_dense_batch", arg=1)
def scdn_dense_batch(launch: ScdnDenseBatchLaunch, w: Tensor, z: Tensor,
                     idx: Tensor, alpha: Tensor | None = None,
                     loss_deltas: Tensor | None = None) -> Tensor:
    """K5's dense batch entry: one SCDN batch of the (P,) coordinates idx
    (int32, duplicates allowed, sentinel n) on the dense layout, w and z
    updated IN PLACE (`ref.scdn_dense_batch_ref`'s function). Writes the
    accepted steps into `alpha` (P,) float32 (allocated when None) and
    returns it; with `loss_deltas`, a (P, Q) float32 buffer, also every
    candidate's loss delta sum_i phi(z_i + a_q d_p x_ij) - phi(z_i) (the
    search then evaluates every candidate; the accepted alpha is the same).
    On the card: the batch launch and the update launch, no other device
    operation and no host sync; deterministic."""
    return _scdn_dispatch(launch, ref.scdn_dense_batch_ref, w, z, idx,
                          alpha, loss_deltas)


_FLASH_HEAD_DIMS = (64, 128, 256)
# K6's variants (kernels/csrc/flash_attention.cu) and the head dims each
# takes; mma's D 64 is there to time it against wgmma at the LM's shape
FLASH_VARIANTS = {"wgmma": (64, 128), "mma": (64, 256),
                  "f32": (64, 128, 256)}
_FLASH_VARIANT_LAUNCHES = {name: 0 for name in FLASH_VARIANTS}


def flash_variant(dtype: torch.dtype, D: int) -> str:
    """The K6 variant the dispatcher launches, fixed by dtype and head dim
    alone: bf16 at D 64 and 128 the wgmma/TMA kernel, bf16 at D 256 the
    mma.sync kernel (the wgmma ring and a 64 x 256 f32 accumulator per
    warpgroup do not fit), float32 the CUDA-core kernel."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if D in FLASH_VARIANTS["wgmma"] else "mma"


def flash_variant_counts() -> dict:
    """K6 launches by variant since the last `reset_launch_counts()`;
    they sum to `launch_counts()["flash_attention"]`."""
    return dict(_FLASH_VARIANT_LAUNCHES)


def flash_encode_us() -> float:
    """Host microseconds the last wgmma launch spent encoding its three
    tensor maps."""
    return build.load("flash_attention").flash_attention_encode_ns() / 1e3


@_observed("flash_attention")
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                    sm_scale: float | None = None, *,
                    variant: str | None = None) -> Tensor:
    """K6: softmax(q k^T * sm_scale, masked) v, f32 accumulation, output in
    q's dtype; sm_scale defaults to D ** -0.5.

    Takes `repro.kernels.ops.flash_attention`'s layout, q (BH, Sq, D) with
    k/v (BH / G, Skv, D) (query head bh reads kv head bh // G), or the
    model's, q (B, Sq, H, D) with k/v (B, Skv, Kv, D), and returns q's
    shape. Causal masks `qi >= kj` with both positions from 0. Any Sq and
    Skv: the kernel masks the tails itself (the JAX wrapper falls back to
    the dense reference when they are not multiples of its tile). On the
    card D is 64, 128 or 256, q/k/v float32 or bfloat16 alike, each with a
    contiguous last dim; the other strides are passed to the kernel.
    `flash_variant` picks the kernel; `variant` names another one of
    FLASH_VARIANTS that takes the dtype and D (to time them side by
    side)."""
    if _on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.ndim not in (3, 4) or k.ndim != q.ndim or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    D = q.shape[-1]
    if D not in _FLASH_HEAD_DIMS or k.shape[-1] != D:
        raise ValueError(f"flash_attention: head dim {D} (q) / "
                         f"{k.shape[-1]} (k), the kernel takes "
                         f"{_FLASH_HEAD_DIMS}")
    if q.dtype not in _VALUE_TYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}, expected one of {tuple(_VALUE_TYPES)} "
                        f"for all three")
    if variant is None:
        variant = flash_variant(q.dtype, D)
    if variant not in FLASH_VARIANTS or \
            D not in FLASH_VARIANTS[variant] or \
            (variant == "f32") != (q.dtype == torch.float32):
        raise ValueError(f"flash_attention: variant {variant!r} does not "
                         f"take {q.dtype} at head dim {D}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    o = out
    if q.ndim == 3:
        # a view of the model's layout: query head bh = kv head * G + member
        B = k.shape[0]
        if q.shape[0] % B:
            raise ValueError(f"flash_attention: {q.shape[0]} query heads "
                             f"over {B} kv heads")
        q, o = (t.unflatten(0, (B, -1)).transpose(1, 2) for t in (q, o))
        k, v = k.unsqueeze(2), v.unsqueeze(2)
    B, Sq, H, _ = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or H % Kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} against "
                         f"k/v {tuple(k.shape)}")
    G = H // Kv
    strides = flash_strides(q, k, v, o)
    if Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention: empty sequence Sq={Sq} "
                         f"Skv={Skv}")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    lib = build.load("flash_attention")
    flat = (ctypes.c_longlong * 12)(*strides)
    fn = getattr(lib, "flash_attention_f32" if variant == "f32"
                 else f"flash_attention_{variant}_bf16")
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(o), B, H, G, Sq, Skv, D,
             int(bool(causal)), float(sm_scale), flat, _stream(q))
    _raise_if(err, f"flash_attention ({variant})")
    _LAUNCHES["flash_attention"] += 1
    _FLASH_VARIANT_LAUNCHES[variant] += 1
    return out


def flash_strides(q: Tensor, k: Tensor, v: Tensor, o: Tensor) -> list:
    """The 12 (batch, head, row) strides in elements of q, k, v and o in
    the model's (B, S, H, D) layout, as the kernel takes them; raises
    where a tensor lacks a contiguous last dim, 16-byte alignment or
    strides in whole 16-byte steps (the kernels move 16 bytes at a time,
    TMA's tensor maps need both)."""
    align = 16 // q.element_size()
    out = []
    for name, t in zip("qkvo", (q, k, v, o)):
        st = (t.stride(0), t.stride(2), t.stride(1))
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(x % align for x in st):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, 16-byte alignment and strides in "
                             f"multiples of {align} elements; got strides "
                             f"{tuple(t.stride())}")
        out += [int(x) for x in st]
    return out
