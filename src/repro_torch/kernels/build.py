"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source in `csrc/` is compiled on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

No `--use_fast_math`: the logistic terms use full-precision expf/log1pf,
as the plain PyTorch versions do. The libraries go into
`build/repro_torch_kernels/` at the repository root (override with
REPRO_TORCH_BUILD_DIR), named by a hash of the source, the shared headers
and the flags, so an edited source is rebuilt and an unchanged one is not.
The first `load` compiles every missing library, one nvcc process per
source, all started together. A machine without nvcc raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pcdn_direction", "pcdn_sparse_direction", "pcdn_bundle",
           "serve_margins_dense", "serve_margins_csc", "pcdn_linesearch",
           "scdn_batch", "scdn_dense_batch", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.POINTER(ctypes.c_longlong)
_LL = ctypes.c_longlong

# argtypes of every exported C function (pointers and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int)
SIGNATURES = {
    # XT, idx, z, y, w_B, c, kind, l2, n, s, P, then the plan (cc, ctas,
    # sl, tile, resident, vec), d, g, h, delta, the partials, the counters,
    # stream; the plan's shared-memory floats for a row tile
    "pcdn_direction": {
        **{f"pcdn_direction_{t}": [_P, _P, _P, _P, _P, _F, _I, _F, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P, _P]
           for t in ("f32", "bf16")},
        # the partials entry: XT, idx, z, y, c, kind, n, s, P, the plan,
        # g, h, stream
        **{f"pcdn_direction_partials_{t}": [_P, _P, _P, _P, _F, _I, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _I, _P,
                                            _P, _P]
           for t in ("f32", "bf16")},
        "pcdn_direction_smem_floats": [_I],
        "pcdn_direction_max_clusters": []},
    # rows, vals, z, y, w_B, c, kind, l2, P, K, n_rows, warps a feature, d,
    # g, h, delta (with the rows' list heads), the entries' links and
    # terms, stream; the partials (rows, vals, z, y, c, kind, P, K, n_rows,
    # warps, g, h, stream); the scatter (rows, vals, d, P, K, n_rows,
    # delta, links, stream)
    "pcdn_sparse_direction": {
        **{f"pcdn_sparse_direction_{t}": [_P, _P, _P, _P, _P, _F, _I, _F, _I,
                                          _I, _I, _I, _P, _P, _P, _P, _P, _P]
           for t in ("f32", "bf16")},
        **{f"pcdn_sparse_direction_partials_{t}": [_P, _P, _P, _P, _F, _I,
                                                   _I, _I, _I, _I, _P, _P,
                                                   _P]
           for t in ("f32", "bf16")},
        **{f"pcdn_sparse_scatter_{t}": [_P, _P, _P, _I, _I, _I, _P, _P, _P]
           for t in ("f32", "bf16")}},
    # a pointer to the launch's BundleArgs (ops._BundleArgs), idx, t, stream
    "pcdn_bundle": {
        f"pcdn_bundle_{t}": [_P, _P, _I, _P] for t in ("f32", "bf16")},
    # (X or col_vals type)_(val type): each float32 or bfloat16
    "serve_margins_dense": {
        f"serve_margins_dense_{a}_{b}": [_P, _P, _P, _I, _I, _I, _I, _I, _P,
                                         _P, _P]
        for a in ("f32", "bf16") for b in ("f32", "bf16")},
    # col_rows, col_vals, idx, val, n, k_max, K, A, B, then the plan
    # (cluster, ranges, range rows), out, stream
    "serve_margins_csc": {
        f"serve_margins_csc_{a}_{b}": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _I, _I, _I, _P, _P]
        for a in ("f32", "bf16") for b in ("f32", "bf16")},
    # z, delta, delta's row stride, y, alphas, kind, s, P, Q, n_blocks,
    # partials, out, stream
    "pcdn_linesearch": {
        "pcdn_linesearch_f32": [_P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _P,
                                _P, _P],
    },
    # a pointer to the launch's ScdnArgs (ops._ScdnArgs), idx, alpha, the
    # (P, Q) loss deltas or null, stream; the plan's shared-memory bytes
    "scdn_batch": {
        "scdn_batch_f32": [_P, _P, _P, _P, _P],
        "scdn_batch_smem_bytes": [_I, _I, _I, _I],
    },
    # a pointer to the launch's DenseArgs (ops._ScdnDenseArgs), idx, alpha,
    # the (P, Q) loss deltas or null, stream; the shared-memory bytes of a
    # tile
    "scdn_dense_batch": {
        "scdn_dense_batch_f32": [_P, _P, _P, _P, _P],
        "scdn_dense_batch_smem_bytes": [_I],
    },
    # q, k, v, o, lse (or null), B, H, G, Sq, Skv, D, causal, window,
    # scale, 12 strides, stream; the host ns the last wgmma launch spent
    # encoding its tensor maps
    "flash_attention": {
        **{f"flash_attention_{t}": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _L, _P]
           for t in ("wgmma_bf16", "mma_bf16", "f32")},
        "flash_attention_encode_ns": []},
    # q, k, v, o, dO, lse, the scratch, dq, dk, dv, B, H, G, Sq, Skv, D,
    # causal, window, splits, scale, 24 strides, stream; wgmma: bf16 at D
    # 64, 128 and 256 (ops.FLASH_BWD_VARIANTS)
    "flash_attention_bwd": {
        f"flash_attention_bwd_{t}": [_P] * 10 + [_I] * 9 + [_F, _L, _P]
        for t in ("wgmma_bf16", "simt_bf16", "simt_f32")},
}

# zero-argument C functions returning a launch constant of the library:
# `load` reads them once into KernelLibrary.consts
CONSTANTS = {"pcdn_direction": ("pcdn_direction_threads",
                                "pcdn_direction_cluster",
                                "pcdn_direction_max_cluster_cols",
                                "pcdn_direction_tile_rows"),
             "pcdn_bundle": ("pcdn_bundle_max_q", "pcdn_bundle_chunk",
                             "pcdn_bundle_max_cluster", "pcdn_bundle_threads",
                             "pcdn_bundle_args_size"),
             "serve_margins_csc": ("serve_margins_csc_threads",
                                   "serve_margins_csc_max_cluster",
                                   "serve_margins_csc_round",
                                   "serve_margins_csc_max_range_rows"),
             "pcdn_linesearch": ("pcdn_linesearch_max_q",
                                 "pcdn_linesearch_threads",
                                 "pcdn_linesearch_max_rows"),
             "scdn_batch": ("scdn_batch_threads", "scdn_batch_max_q",
                            "scdn_batch_chunk", "scdn_batch_max_cluster",
                            "scdn_batch_smem_budget",
                            "scdn_batch_args_size"),
             "scdn_dense_batch": ("scdn_dense_batch_threads",
                                  "scdn_dense_batch_max_q",
                                  "scdn_dense_batch_chunk",
                                  "scdn_dense_batch_max_cluster",
                                  "scdn_dense_batch_tile_rows",
                                  "scdn_dense_batch_smem_budget",
                                  "scdn_dense_batch_args_size")}


class KernelLibrary(ctypes.CDLL):
    """A built kernel library; `consts` maps each name of CONSTANTS to the
    value its C function returned."""

    consts: dict[str, int]


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when found already built
    ptxas_log: str      # `-Xptxas -v` report: registers, spills, smem


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch are built at first use and need the CUDA "
        "toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _paths(name: str) -> tuple[Path, Path]:
    stem = build_dir() / f"lib{name}-{_digest(name)}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


_LOCK = threading.Lock()
_BUILT: dict[str, BuiltLibrary] = {}
_LIBS: dict[str, KernelLibrary] = {}


def build_all(names=SOURCES) -> dict[str, BuiltLibrary]:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all running at once. Raises with nvcc's output on a
    failed build."""
    with _LOCK:
        return _build_locked(tuple(names))


def _build_locked(names) -> dict[str, BuiltLibrary]:
    todo = []
    for name in names:
        if name in _BUILT:
            continue
        so, log = _paths(name)
        if so.exists():
            _BUILT[name] = BuiltLibrary(
                name, so, 0.0, log.read_text() if log.exists() else "")
        else:
            todo.append(name)
    if not todo:
        return {n: _BUILT[n] for n in names}
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        so, _ = _paths(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, tmp, t0, proc in procs:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        so, log = _paths(name)
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                            f"{out}")
            continue
        log.write_text(out)
        os.replace(tmp, so)
        _BUILT[name] = BuiltLibrary(name, so, seconds, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {n: _BUILT[n] for n in names}


def loaded() -> tuple:
    """Names of the libraries loaded into this process so far, in load
    order. A server that has warmed up loads none during traffic."""
    return tuple(_LIBS)


def load(name: str) -> KernelLibrary:
    """The ctypes library of kernel source `name`, building all sources on
    the first call. Every exported launcher has its argtypes declared and
    returns a cudaError_t as a C int."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            built = _build_locked(SOURCES)[name]
            lib = KernelLibrary(str(built.path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            consts = {}
            for fn in CONSTANTS.get(name, ()):
                getattr(lib, fn).argtypes = []
                getattr(lib, fn).restype = ctypes.c_int
                consts[fn] = getattr(lib, fn)()
            lib.consts = consts
            _LIBS[name] = lib
        return lib
