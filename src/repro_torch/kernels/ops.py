"""Dispatchers for the port's kernels: the three solver kernels (K1-K3),
the two serving-margin kernels (K4a, K4b), the batched line search (K5)
and flash attention (K6), the LM's blockwise prefill attention.

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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

Tensor = torch.Tensor

KERNELS = ("pcdn_direction", "pcdn_sparse_direction", "pcdn_bundle",
           "serve_margins_dense", "serve_margins_csc", "pcdn_linesearch",
           "flash_attention")
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


def dense_tile_width(B: int, n: int, K: int, sms: int) -> int:
    """Column tile of the K4a launch, a multiple of 32: about four blocks
    per SM over the (32-row, width-column) tiles of X, at most 1536
    columns (the staged tile, 32 x (width + 1) floats, within the 227 KB
    a block may hold), and the (tiles, K, B) partials at most 16M floats
    where the width allows."""
    row_tiles = -(-B // 32)
    want = max(1, -(-4 * sms // row_tiles))
    width = 32 * -(-n // (32 * want))
    while width < 1536 and -(-n // width) * K * B > (1 << 24):
        width *= 2
    return int(min(max(width, 32), 1536))


def serve_margins_dense(X: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """K4a: serving margins over a dense request slab. X (B, n) float32|
    bf16, idx (K, A) int32 with sentinel n at padding, val (K, A) float32|
    bf16 -> (B, K) float32 (bias not added).

    Contract on the card: each model's live ids ascend, sentinels after
    them (the artifact's w_indices are strictly ascending and ModelBank
    keeps that order). The kernel cuts X into column tiles and finds each
    model's ids in a tile by a search that assumes that order; ids out of
    order drop terms.
    Each column tile's partial margins are summed in tile order by a
    second launch: deterministic, no atomics."""
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
    width = dense_tile_width(B, n, K, _sm_count(X.device))
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
