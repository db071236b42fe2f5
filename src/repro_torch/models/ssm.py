"""Mamba-1 selective SSM block (falcon-mamba-7b): port of
`repro.models.ssm`.

Per layer: in_proj -> (x, z) branches; causal depthwise conv + silu on the
x branch; input-dependent (delta, B, C); the diagonal selective scan

    h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t ,   y_t = C_t . h_t + D x_t

in chunks of `_chunk_size(S)` positions with h carried from chunk to
chunk, as the reference runs it. Inside a chunk the scan is log-depth:
the reference's `jax.lax.associative_scan` becomes a Hillis-Steele scan
over the chunk's positions with the combine (A2 A1, A2 b1 + b2), log2(ck)
rounds of whole-chunk products (a loop over the positions would launch
an op a position). Decode keeps an O(1) state (h, the conv's tail).

Dtypes as in the reference: the projections and the conv in the model
dtype; delta, A, B, C, the scan and its state in float32; `A_log` and `D`
are float32 parameters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import decls
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
f32 = torch.float32


def _dims(cfg: ModelConfig):
    """-> (d_inner, dt_rank, d_state, d_conv)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


class SSM(decls.Declared):
    """`ssm_decls`' parameters under the reference's names and inits."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg.torch_dtype, device)
        d = cfg.d_model
        Di, R, N, Kc = _dims(cfg)
        self.declare("in_proj", (d, 2 * Di), decls.dense(d))
        self.declare("conv_w", (Kc, Di), decls.dense(Kc))
        self.declare("conv_b", (Di,), decls.ZEROS)
        self.declare("x_proj", (Di, R + 2 * N), decls.dense(Di))
        self.declare("dt_proj", (R, Di), decls.dense(R))
        self.declare("dt_bias", (Di,), decls.ZEROS)
        self.declare("A_log", (Di, N), decls.const(0.5), dtype=f32)
        self.declare("D", (Di,), decls.ONES, dtype=f32)
        self.declare("out_proj", (Di, d), decls.dense(Di))


class SSMState(NamedTuple):
    h: Tensor         # (B, Di, N) float32 recurrent state
    conv: Tensor      # (B, Kc-1, Di) conv tail
    length: int


def init_ssm_state(cfg: ModelConfig, batch: int, device,
                   n_layers: int = 0) -> SSMState:
    """Zero state, stacked over layers when n_layers > 0."""
    Di, _, N, Kc = _dims(cfg)
    shape_h = (batch, Di, N)
    shape_c = (batch, Kc - 1, Di)
    if n_layers:
        shape_h = (n_layers,) + shape_h
        shape_c = (n_layers,) + shape_c
    return SSMState(torch.zeros(shape_h, dtype=f32, device=device),
                    torch.zeros(shape_c, dtype=cfg.torch_dtype,
                                device=device), 0)


def _chunk_size(S: int, target: int = 256) -> int:
    """Largest divisor of S not exceeding target (bounds scan memory)."""
    best = 1
    for c in range(1, min(S, target) + 1):
        if S % c == 0:
            best = c
    return best


def _scan(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1:
    Hillis-Steele, each round combining every position with the one
    `off` before it. -> h at every position.

    A round copies the previous round's tensor whole and updates its
    positions from `off` on in place, reading the previous round's (not
    aliased, so autograd can differentiate it): a plain copy in place of
    a `torch.cat` of the two parts, which ran at about half the card's
    memory rate (PERF.md, section 5)."""
    n = a.shape[1]
    off = 1
    while off < n:
        prev, b = b, b.clone()
        b[:, off:].addcmul_(a[:, off:], prev[:, :-off])
        if 2 * off < n:
            prev, a = a, a.clone()
            a[:, off:].mul_(prev[:, :-off])
        off *= 2
    return b


def _ssm_core(cfg: ModelConfig, p: SSM, xb: Tensor,
              h0: Optional[Tensor]):
    """xb (B, S, Di) post-conv activations -> (y (B, S, Di), h_last
    (B, Di, N) float32). The (B, ck, Di, N) discretised state exists for
    one chunk at a time."""
    Di, R, N, _ = _dims(cfg)
    B, S, _ = xb.shape
    xf = xb.to(f32)
    dbc = (xb @ p.x_proj).to(f32)                            # (B, S, R+2N)
    dt_in, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    delta = F.softplus(dt_in @ p.dt_proj.to(f32) + p.dt_bias.to(f32))
    A = -torch.exp(p.A_log)                                  # (Di, N)
    ck = _chunk_size(S)
    h = h0 if h0 is not None else xb.new_zeros((B, Di, N), dtype=f32)
    ys = []
    for lo in range(0, S, ck):
        d_c, B_c, C_c, x_c = (t[:, lo:lo + ck] for t in (delta, Bm, Cm, xf))
        Abar = torch.exp(d_c[..., None] * A)                 # (B, ck, Di, N)
        Bx = (d_c * x_c)[..., None] * B_c[:, :, None, :]
        Bx[:, 0] += Abar[:, 0] * h
        hs = _scan(Abar, Bx)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C_c))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + xf * p.D
    return y.to(xb.dtype), h


def apply_ssm_block(cfg: ModelConfig, p: SSM, x: Tensor,
                    state: Optional[SSMState] = None):
    """The whole Mamba block over a sequence (prefill, training), from
    `state` (zeros by default). x (B, S, d) -> (out (B, S, d), the state
    after the sequence)."""
    Di, _, _, Kc = _dims(cfg)
    B, S, _ = x.shape
    xb, zb = torch.chunk(x @ p.in_proj, 2, dim=-1)
    prev = (state.conv if state is not None
            else x.new_zeros((B, Kc - 1, Di)))
    xpad = torch.cat([prev, xb], dim=1)                      # (B, S+Kc-1, Di)
    xc = sum(xpad[:, i:i + S] * p.conv_w[i] for i in range(Kc)) + p.conv_b
    xc = F.silu(xc)
    y, h_last = _ssm_core(cfg, p, xc, state.h if state is not None else None)
    out = (y * F.silu(zb)) @ p.out_proj
    length = (state.length if state is not None else 0) + S
    return out, SSMState(h_last, xpad[:, S:S + Kc - 1], length)


def ssm_decode_step(cfg: ModelConfig, p: SSM, x: Tensor, state: SSMState):
    """One token with the O(1) state. x (B, 1, d) -> (out (B, 1, d), the
    state one position on)."""
    _, R, N, _ = _dims(cfg)
    xb, zb = torch.chunk(x[:, 0] @ p.in_proj, 2, dim=-1)    # (B, Di)
    window = torch.cat([state.conv, xb[:, None]], dim=1)     # (B, Kc, Di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p.conv_w) + p.conv_b)
    xf = xc.to(f32)
    dbc = (xc @ p.x_proj).to(f32)
    dt_in, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    delta = F.softplus(dt_in @ p.dt_proj.to(f32) + p.dt_bias.to(f32))
    Abar = torch.exp(delta[..., None] * -torch.exp(p.A_log))  # (B, Di, N)
    h = Abar * state.h + (delta * xf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + xf * p.D
    out = (y.to(x.dtype) * F.silu(zb)) @ p.out_proj
    return out[:, None], SSMState(h, window[:, 1:], state.length + 1)
