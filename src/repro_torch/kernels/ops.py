"""Dispatchers for the port's kernels: the three solver kernels (K1-K3),
the two serving-margin kernels (K4a, K4b) and the batched line search (K5).

Each wrapper looks at where its tensors live:

  * on the CPU it returns the plain PyTorch version from `kernels/ref.py`;
  * on a CUDA device it checks device, dtype, shape and contiguity,
    allocates every output and scratch buffer, launches the hand-written
    kernel (kernels/csrc, built at first use by `kernels.build`) on
    PyTorch's current stream, raises if the launch reports an error, and
    adds one to its launch count. It never falls back to the plain version.

`launch_counts()` / `reset_launch_counts()` read and clear the counts, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

KERNELS = ("pcdn_direction", "pcdn_sparse_direction", "pcdn_bundle",
           "serve_margins_dense", "serve_margins_csc", "pcdn_linesearch")
_LAUNCHES = {name: 0 for name in KERNELS}

# loss kind codes, as kernels/csrc/common.cuh numbers them
_KINDS = {"logistic": 0, "squared_hinge": 1, "squared": 2}
_VALUE_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _on_cpu(*tensors: Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name: str, t: Tensor, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def _ptr(t: Tensor) -> int:
    return t.data_ptr()


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")


_F32 = (torch.float32,)
_I32 = (torch.int32,)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _n_split(s: int, P: int, device) -> int:
    """Row splits of the K3 launch: enough blocks to give every SM about
    four (32 columns x n_split), each over at least 64 rows."""
    sms = _sm_count(device)
    p_tiles = -(-P // 32)
    want = -(-4 * sms // p_tiles)
    return int(max(1, min(want, -(-s // 64), 65535)))


def pcdn_direction(XB: Tensor, u: Tensor, v: Tensor, w_B: Tensor,
                   l2: float = 0.0):
    """K3: bundle direction over a dense slab. XB (s, P) float32|bf16,
    u/v (s,), w_B (P,) float32 -> (d, g, h), each (P,) float32."""
    if _on_cpu(XB, u, v, w_B):
        return ref.pcdn_direction_ref(XB, u, v, w_B, l2=l2)
    s, P = XB.shape
    _check("XB", XB, tuple(_VALUE_TYPES), (s, P))
    _check("u", u, _F32, (s,))
    _check("v", v, _F32, (s,))
    _check("w_B", w_B, _F32, (P,))
    if s < 1 or P < 1:
        raise ValueError(f"pcdn_direction: empty slab {(s, P)}")
    lib = build.load("pcdn_direction")
    n_split = _n_split(s, P, XB.device)
    part = torch.empty((2, n_split, P), dtype=torch.float32,
                       device=XB.device)
    d, g, h = torch.empty((3, P), dtype=torch.float32, device=XB.device)
    fn = getattr(lib, f"pcdn_direction_{_VALUE_TYPES[XB.dtype]}")
    err = fn(_ptr(XB), _ptr(u), _ptr(v), _ptr(w_B), float(l2), s, P,
             n_split, _ptr(part[0]), _ptr(part[1]), _ptr(d), _ptr(g),
             _ptr(h), _stream(XB))
    _raise_if(err, "pcdn_direction")
    _LAUNCHES["pcdn_direction"] += 1
    return d, g, h


def pcdn_sparse_direction(rows: Tensor, vals: Tensor, u: Tensor, v: Tensor,
                          w_B: Tensor, l2: float = 0.0):
    """K2: bundle direction over a padded-CSC slab. rows (P, K) int32 with
    sentinel len(u), vals (P, K) float32|bf16, u/v (s,), w_B (P,) float32
    -> (d, g, h), each (P,) float32."""
    if _on_cpu(rows, vals, u, v, w_B):
        return ref.pcdn_sparse_direction_ref(rows, vals, u, v, w_B, l2=l2)
    P, K = rows.shape
    s = u.shape[0]
    _check("rows", rows, _I32, (P, K))
    _check("vals", vals, tuple(_VALUE_TYPES), (P, K))
    _check("u", u, _F32, (s,))
    _check("v", v, _F32, (s,))
    _check("w_B", w_B, _F32, (P,))
    if P < 1 or K < 1:
        raise ValueError(f"pcdn_sparse_direction: empty slab {(P, K)}")
    lib = build.load("pcdn_sparse_direction")
    d, g, h = torch.empty((3, P), dtype=torch.float32, device=rows.device)
    fn = getattr(lib, f"pcdn_sparse_direction_{_VALUE_TYPES[vals.dtype]}")
    err = fn(_ptr(rows), _ptr(vals), _ptr(u), _ptr(v), _ptr(w_B), float(l2),
             P, K, s, _ptr(d), _ptr(g), _ptr(h), _stream(rows))
    _raise_if(err, "pcdn_sparse_direction")
    _LAUNCHES["pcdn_sparse_direction"] += 1
    return d, g, h


def pcdn_bundle(vals: Tensor, pos: Tensor, z_R: Tensor, y_R: Tensor,
                w_B: Tensor, alphas: Tensor, c, kind: str = "logistic",
                l2: float = 0.0, sigma: float = 0.01, gamma: float = 0.0):
    """K1: the fused support-restricted bundle step.

    vals/pos (P, K) from `PaddedCSCDesign.gather_slab` + `slab_row_support`,
    z_R/y_R (R = P*K,) margins and labels at the support rows (sentinel
    slots z = 0, y = 1), w_B (P,), alphas (Q,), c a float (a run-time
    kernel argument). Returns (upd_w (P,), upd_z (R,), alpha (), n_steps
    () int32), upd_* already scaled by the accepted alpha; no host sync.
    """
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(vals, pos, z_R, y_R, w_B, alphas):
        return ref.pcdn_bundle_ref(vals, pos, z_R, y_R, w_B, alphas, c,
                                   kind=kind, l2=l2, sigma=sigma,
                                   gamma=gamma)
    P, K = vals.shape
    R = z_R.shape[0]
    Q = alphas.shape[0]
    _check("vals", vals, tuple(_VALUE_TYPES), (P, K))
    _check("pos", pos, _I32, (P, K))
    _check("z_R", z_R, _F32, (R,))
    _check("y_R", y_R, _F32, (R,))
    _check("w_B", w_B, _F32, (P,))
    _check("alphas", alphas, _F32, (Q,))
    lib = build.load("pcdn_bundle")
    max_q = lib.consts["pcdn_bundle_max_q"]
    if P < 1 or K < 1 or R < 1 or not 1 <= Q <= max_q:
        raise ValueError(f"pcdn_bundle: unsupported sizes P={P} K={K} R={R} "
                         f"Q={Q} (Q <= {max_q})")
    n_tiles = -(-R // lib.consts["pcdn_bundle_tile"])
    # one allocation: outputs upd_w, upd_z, alpha, n_steps (its 4 bytes
    # viewed as int32), then the scratch d, g, h, delta_R, partials
    n_out = P + R + 2
    buf = torch.empty((n_out + 3 * P + R + n_tiles * Q,),
                      dtype=torch.float32, device=vals.device)
    upd_w, upd_z, alpha = buf[:P], buf[P:P + R], buf[P + R]
    n_steps = buf[P + R + 1:n_out].view(torch.int32)[0]
    d, g, h = buf[n_out:n_out + 3 * P].view(3, P)
    delta_R = buf[n_out + 3 * P:n_out + 3 * P + R]
    partials = buf[n_out + 3 * P + R:]
    fn = getattr(lib, f"pcdn_bundle_{_VALUE_TYPES[vals.dtype]}")
    err = fn(_ptr(vals), _ptr(pos), _ptr(z_R), _ptr(y_R), _ptr(w_B),
             _ptr(alphas), float(c), _KINDS[kind], float(l2), float(sigma),
             float(gamma), P, K, R, Q, _ptr(d), _ptr(g), _ptr(h),
             _ptr(delta_R), _ptr(partials), _ptr(upd_w), _ptr(upd_z),
             _ptr(alpha), _ptr(n_steps), _stream(vals))
    _raise_if(err, "pcdn_bundle")
    _LAUNCHES["pcdn_bundle"] += 1
    return upd_w, upd_z, alpha, n_steps


def serve_margins_dense(X: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """K4a: serving margins over a dense request slab. X (B, n) float32|
    bf16, idx (K, A) int32 with sentinel n at padding, val (K, A) float32|
    bf16 -> (B, K) float32 (bias not added)."""
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
    out = torch.empty((B, K), dtype=torch.float32, device=X.device)
    fn = getattr(lib, f"serve_margins_dense_{_VALUE_TYPES[X.dtype]}_"
                      f"{_VALUE_TYPES[val.dtype]}")
    err = fn(_ptr(X), _ptr(idx), _ptr(val), B, n, K, A, _ptr(out),
             _stream(X))
    _raise_if(err, "serve_margins_dense")
    _LAUNCHES["serve_margins_dense"] += 1
    return out


def _csc_slices(K: int, A: int, B: int, device) -> int:
    """Active-feature slices per model of the K4b launch: about four
    blocks per SM, each slice at least 8 features, and the (slices, K, B)
    partials at most 16M floats."""
    want = -(-4 * _sm_count(device) // K)
    return int(max(1, min(want, -(-A // 8), (1 << 24) // (K * B), 65535)))


def serve_margins_csc(col_rows: Tensor, col_vals: Tensor, idx: Tensor,
                      val: Tensor, n_requests: int,
                      n_slices: int = None) -> Tensor:
    """K4b: serving margins over a padded-CSC request batch. col_rows
    (n, k_max) int32 with sentinel n_requests at padding, col_vals
    (n, k_max) float32|bf16, idx/val (K, A) as for K4a -> (n_requests, K)
    float32 (bias not added), a transposed view of the kernel's (K, B)
    output. The model's active features are split into slices whose
    partial margins a second launch sums in slice order; `n_slices`
    overrides the count `_csc_slices` picks."""
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
    if B < 1 or n < 1 or k_max < 1 or K < 1 or A < 1:
        raise ValueError(f"serve_margins_csc: empty input B={B} n={n} "
                         f"k_max={k_max} K={K} A={A}")
    lib = build.load("serve_margins_csc")
    if n_slices is None:
        n_slices = _csc_slices(K, A, B, col_rows.device)
    # one allocation: the (K, B) output, then the (n_slices, K, B) partials
    buf = torch.empty(((n_slices + 1) * K * B,), dtype=torch.float32,
                      device=col_rows.device)
    out, part = buf[:K * B].view(K, B), buf[K * B:]
    fn = getattr(lib, f"serve_margins_csc_{_VALUE_TYPES[col_vals.dtype]}_"
                      f"{_VALUE_TYPES[val.dtype]}")
    err = fn(_ptr(col_rows), _ptr(col_vals), _ptr(idx), _ptr(val), n, k_max,
             K, A, B, n_slices, _ptr(part), _ptr(out), _stream(col_rows))
    _raise_if(err, "serve_margins_csc")
    _LAUNCHES["serve_margins_csc"] += 1
    return out.T


def pcdn_linesearch(z: Tensor, delta: Tensor, y: Tensor, alphas: Tensor,
                    kind: str = "logistic") -> Tensor:
    """K5: batched candidate loss deltas. z, delta, y (s,) float32, alphas
    (Q,) float32 -> (Q,) float32 with out[q] = sum_i phi(z_i + alphas[q] *
    delta_i, y_i) - phi(z_i, y_i); the caller scales by c and adds the l1
    part. Deterministic: block partials are summed in block order."""
    if kind not in _KINDS:
        raise KeyError(f"unknown loss {kind!r}")
    if _on_cpu(z, delta, y, alphas):
        return ref.pcdn_linesearch_ref(z, delta, y, alphas, kind=kind)
    s = z.shape[0]
    Q = alphas.shape[0]
    _check("z", z, _F32, (s,))
    _check("delta", delta, _F32, (s,))
    _check("y", y, _F32, (s,))
    _check("alphas", alphas, _F32, (Q,))
    lib = build.load("pcdn_linesearch")
    max_q = lib.consts["pcdn_linesearch_max_q"]
    if s < 1 or not 1 <= Q <= max_q:
        raise ValueError(f"pcdn_linesearch: unsupported sizes s={s} Q={Q} "
                         f"(Q <= {max_q})")
    threads = lib.consts["pcdn_linesearch_threads"]
    n_blocks = int(min(-(-s // threads), 4 * _sm_count(z.device)))
    buf = torch.empty((n_blocks * Q + Q,), dtype=torch.float32,
                      device=z.device)
    partials, out = buf[:n_blocks * Q], buf[n_blocks * Q:]
    err = lib.pcdn_linesearch_f32(_ptr(z), _ptr(delta), _ptr(y),
                                  _ptr(alphas), _KINDS[kind], s, Q, n_blocks,
                                  _ptr(partials), _ptr(out), _stream(z))
    _raise_if(err, "pcdn_linesearch")
    _LAUNCHES["pcdn_linesearch"] += 1
    return out
