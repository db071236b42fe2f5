"""GQA/MQA attention with RoPE, causal / sliding-window / bidirectional
masks, cross-attention and a KV cache for decode: port of
`repro.models.attention`.

Head layout as in the reference: q (B, S, H, Dh) with H = Kv * G
(grouped-query), k/v (B, S, Kv, Dh); the dense scores keep the kv-head
axis, so GQA repeats nothing. Prefill attention (`attend_full`) takes the
dense route below BLOCKWISE_MIN_KV keys and the blockwise route from
there, as the reference does; the blockwise route is K6
(`kernels.ops.flash_attention`, the reference's `_flash_fwd_scan` twin,
with its sliding window), which reads kv head h // G in place and is
differentiable, window and all (its backward is K6b). A windowed layer's
decode cache is a ring of min(max_len, window) slots, as the reference's
hybrid cache is (`init_cache`, `fill_cache`, `decode_step`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import decls
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

Tensor = torch.Tensor
f32 = torch.float32
NEG_INF = -1e30

# dense (S, S) scores below this many keys, K6 from here on
BLOCKWISE_MIN_KV = 2048


class Attention(decls.Declared):
    """The projections of one attention layer, fused (one wqkv) or not,
    with optional QKV bias; padded heads start at zero (output-exact)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg.torch_dtype, device)
        self.cfg = cfg
        d = cfg.d_model
        H, Kv, Dh = cfg.eff_heads, cfg.eff_kv_heads, cfg.resolved_head_dim
        rH, rKv = cfg.n_heads, cfg.n_kv_heads
        if H % Kv:
            raise ValueError(f"{H} heads over {Kv} kv heads")
        wo = decls.dense(rH * Dh)
        if H != rH:
            wo = decls.padded(wo, 0, rH)
        if cfg.fused_qkv:
            self.declare("wqkv", (d, H + 2 * Kv, Dh), decls.dense(d))
            self.declare("wo", (H, Dh, d), wo)
            if cfg.qkv_bias:
                self.declare("bqkv", (H + 2 * Kv, Dh), decls.ZEROS)
            return
        wq, wkv = decls.dense(d), decls.dense(d)
        if H != rH:
            wq = decls.padded(wq, 1, rH)
        if Kv != rKv:
            wkv = decls.padded(wkv, 1, rKv)
        self.declare("wq", (d, H, Dh), wq)
        self.declare("wk", (d, Kv, Dh), wkv)
        self.declare("wv", (d, Kv, Dh), wkv)
        self.declare("wo", (H, Dh, d), wo)
        if cfg.qkv_bias:
            self.declare("bq", (H, Dh), decls.ZEROS)
            self.declare("bk", (Kv, Dh), decls.ZEROS)
            self.declare("bv", (Kv, Dh), decls.ZEROS)

    def _project(self, x: Tensor, w: Tensor, b) -> Tensor:
        """x (B, S, d) @ w (d, h, Dh) [+ b (h, Dh)] -> (B, S, h, Dh)."""
        d, h, dh = w.shape
        out = (x @ w.reshape(d, h * dh)).unflatten(-1, (h, dh))
        return out if b is None else out + b

    def project_qkv(self, x: Tensor):
        """-> q (B, S, H, Dh), k and v (B, S, Kv, Dh)."""
        if self.cfg.fused_qkv:
            out = self._project(x, self.wqkv, getattr(self, "bqkv", None))
            H, Kv = self.cfg.eff_heads, self.cfg.eff_kv_heads
            return out[..., :H, :], out[..., H:H + Kv, :], \
                out[..., H + Kv:, :]
        return (self._project(x, self.wq, getattr(self, "bq", None)),
                self._project(x, self.wk, getattr(self, "bk", None)),
                self._project(x, self.wv, getattr(self, "bv", None)))

    def project_q(self, x: Tensor) -> Tensor:
        """Cross-attention's queries, (B, S, H, Dh)."""
        if self.cfg.fused_qkv:
            return self.project_qkv(x)[0]
        return self._project(x, self.wq, getattr(self, "bq", None))

    def project_kv(self, x: Tensor):
        """Cross-attention's keys and values, (B, S, Kv, Dh) each."""
        if self.cfg.fused_qkv:
            return self.project_qkv(x)[1:]
        return (self._project(x, self.wk, getattr(self, "bk", None)),
                self._project(x, self.wv, getattr(self, "bv", None)))

    def project_out(self, o: Tensor) -> Tensor:
        """o (B, S, H, Dh) -> (B, S, d)."""
        H, Dh, d = self.wo.shape
        return o.reshape(*o.shape[:-2], H * Dh) @ self.wo.reshape(H * Dh, d)


def mask_bias(q_pos: Tensor, k_pos: Tensor, causal: bool,
              window: int) -> Tensor:
    """(..., Sq, Sk) additive float32 bias from positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=qp.device)
    if causal:
        ok = ok & (qp >= kp)
    if window > 0:
        ok = ok & (qp - kp < window)
    return torch.where(ok, 0.0, NEG_INF).to(f32)


def sdpa(q: Tensor, k: Tensor, v: Tensor, bias: Tensor) -> Tensor:
    """Dense attention: q (B, Sq, H, Dh), k/v (B, Sk, Kv, Dh), bias
    (Sq, Sk) or (B, Sq, Sk) -> (B, Sq, H, Dh).

    Scores in float32: bf16 operands are widened exactly before the
    product (PyTorch has no bf16 x bf16 -> f32 einsum), which is the
    reference's preferred_element_type=f32 up to summation order. The
    softmax is float32 and p is cast to v's dtype before p v, as in the
    reference."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32), k.to(f32)) * \
        Dh ** -0.5
    if bias.ndim == 2:           # (Sq, Sk) -> broadcast over batch
        bias = bias[None]
    s = s + bias[:, None, None]  # (B, Sq, Sk) -> (B, 1, 1, Sq, Sk)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, Sq, H, Dh)


def attend_full(cfg: ModelConfig, p: Attention, x: Tensor,
                positions: Tensor, causal: bool = True, window: int = 0,
                use_kernels: bool = True, kv_x: Tensor | None = None,
                kv_positions: Tensor | None = None):
    """Prefill attention of x (B, S, d) at positions (S,) counting from 0
    -> (out (B, S, d), k, v): the cache's keys (rotated) and values.
    Self-attention, or with `kv_x` (B, Skv, d) cross-attention onto it
    (keys at `kv_positions`, arange(Skv) by default; rope on
    self-attention only, as in the reference).

    Blockwise (K6, with `window`) from BLOCKWISE_MIN_KV keys, dense (Sq,
    Skv) scores below, as the reference dispatches. `use_kernels=False`
    sends the blockwise route to K6's plain version (`ref.attention_ref`)
    on any device."""
    if kv_x is None:
        q, k, v = p.project_qkv(x)
        if cfg.rope_theta > 0:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        kv_positions = positions
    else:
        q = p.project_q(x)
        k, v = p.project_kv(kv_x)
        if kv_positions is None:
            kv_positions = torch.arange(kv_x.shape[1], device=x.device)
    scale = cfg.resolved_head_dim ** -0.5
    if k.shape[1] >= BLOCKWISE_MIN_KV:
        attn = ops.flash_attention if use_kernels else ref.attention_ref
        o = attn(q, k, v, causal=causal, sm_scale=scale, window=window)
    else:
        o = sdpa(q, k, v, mask_bias(positions, kv_positions, causal,
                                    window))
    return p.project_out(o), k, v


class KVCache(NamedTuple):
    k: Tensor         # (B, S_max, Kv, Dh)
    v: Tensor         # (B, S_max, Kv, Dh)
    length: int       # filled prefix length (uniform batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               n_layers: int = 0, window: int = 0) -> KVCache:
    """Zero cache, stacked over layers when n_layers > 0: max_len slots,
    or with `window` > 0 a ring of min(max_len, window) slots (the
    reference's hybrid cache)."""
    Kv, Dh = cfg.eff_kv_heads, cfg.resolved_head_dim
    if window > 0:
        max_len = min(max_len, window)
    shape = (batch, max_len, Kv, Dh)
    if n_layers:
        shape = (n_layers,) + shape
    return KVCache(torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   0)


def fill_cache(k_cache: Tensor, k: Tensor) -> None:
    """Write a prefill's keys (or values) k (B, S, Kv, Dh) into a cache of
    (B, S_max, Kv, Dh) in place, as the reference's `_fit`: the first S
    slots when they fit; otherwise (a ring shorter than the prompt) the
    last S_max keys rolled by S % S_max, so that slot j holds the key of
    the position p with p % S_max == j."""
    S, S_max = k.shape[1], k_cache.shape[1]
    if S <= S_max:
        k_cache[:, :S] = k
    else:
        k_cache.copy_(torch.roll(k[:, -S_max:], S % S_max, dims=1))


def decode_step(cfg: ModelConfig, p: Attention, x: Tensor, cache: KVCache,
                window: int = 0) -> tuple[Tensor, KVCache]:
    """One-token decode: x (B, 1, d) at position cache.length. Writes the
    new key and value into cache.k/cache.v (B, S_max, Kv, Dh) in place
    (the reference returns new arrays): at slot cache.length, or with
    window > 0 at ring slot cache.length % S_max, where slot i holds
    position pos - ((slot - i) mod S_max). Attends over the filled slots,
    the last `window` positions of them when window > 0, with dense
    `sdpa` (the reference has no kernel here either). -> ((B, 1, d), the
    cache one position on)."""
    B = x.shape[0]
    S_max = cache.k.shape[1]
    pos = cache.length
    q, k_new, v_new = p.project_qkv(x)
    if cfg.rope_theta > 0:
        posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        q = rope(q, posv, cfg.rope_theta)
        k_new = rope(k_new, posv, cfg.rope_theta)
    slot = pos % S_max if window > 0 else min(pos, S_max - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    idx = torch.arange(S_max, device=x.device)
    q_pos = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    if window > 0:
        k_pos = pos - torch.remainder(slot - idx, S_max)
        valid = (k_pos >= 0) & (k_pos >= pos - window + 1) & (k_pos <= pos)
        bias = torch.where(valid, 0.0, NEG_INF).to(f32)[None, None, :]
        bias = bias.expand(B, 1, S_max)
    else:
        bias = mask_bias(q_pos, idx, causal=True, window=0)
    out = p.project_out(sdpa(q, cache.k, cache.v, bias))
    return out, KVCache(cache.k, cache.v, pos + 1)


def cross_decode(p: Attention, x: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """One decode step's cross-attention: x (B, 1, d) onto the keys and
    values k/v (B, F, Kv, Dh) projected from the encoder's output once at
    prefill, unmasked -> (B, 1, d)."""
    bias = torch.zeros((1, 1, k.shape[1]), dtype=f32, device=x.device)
    return p.project_out(sdpa(p.project_q(x), k, v, bias))
