"""RG-LRU recurrent block (recurrentgemma / Griffin): port of
`repro.models.rglru`.

Recurrent block: x -> two linear branches (lru_width); branch 1 gets a
causal depthwise conv, then the Real-Gated LRU

    r_t = sigmoid(W_a x_t + b_a)        (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)        (input gate)
    a_t = a^(c * r_t) ,  a = sigmoid(Lambda)   (per channel, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

branch 2 gets GeLU (tanh); the two multiply, then project back. Decode
keeps an O(1) state (h, the conv's tail), which is why the hybrid
family's cache is O(1) here and O(window) in its attention layers.

The reference's recurrence over a sequence is `jax.lax.associative_scan`
with the combine (a2 a1, a2 b1 + b2); here it is the same log-depth
scan as the ssm block's (`ssm._scan`: Hillis-Steele, each round a copy
and an in-place update, no `torch.cat`), over the whole sequence at once
(a (B, S, W) float32 carry). Dtypes as in the reference: the projections
and the conv in the model dtype; the gates, the scan and h in float32;
`b_a`, `b_i` and `Lambda` are float32 parameters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import decls
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import _scan

Tensor = torch.Tensor
f32 = torch.float32


def _width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


class RGLRU(decls.Declared):
    """`rglru_decls`' parameters under the reference's names and inits."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg.torch_dtype, device)
        d, W, Kc = cfg.d_model, _width(cfg), cfg.hybrid.conv_width
        self.declare("in_x", (d, W), decls.dense(d))
        self.declare("in_gate", (d, W), decls.dense(d))
        self.declare("conv_w", (Kc, W), decls.dense(Kc))
        self.declare("conv_b", (W,), decls.ZEROS)
        self.declare("w_a", (W, W), decls.dense(W))
        self.declare("b_a", (W,), decls.ZEROS, dtype=f32)
        self.declare("w_i", (W, W), decls.dense(W))
        self.declare("b_i", (W,), decls.ZEROS, dtype=f32)
        # a = sigmoid(Lambda) in ~(0.9, 0.999)
        self.declare("Lambda", (W,), decls.const(3.0), dtype=f32)
        self.declare("out", (W, d), decls.dense(W))


class LRUState(NamedTuple):
    h: Tensor         # (B, W) float32
    conv: Tensor      # (B, Kc-1, W)
    length: int


def init_lru_state(cfg: ModelConfig, batch: int, device,
                   n_layers: int = 0) -> LRUState:
    """Zero state, stacked over layers when n_layers > 0."""
    W, Kc = _width(cfg), cfg.hybrid.conv_width
    shape_h, shape_c = (batch, W), (batch, Kc - 1, W)
    if n_layers:
        shape_h, shape_c = (n_layers,) + shape_h, (n_layers,) + shape_c
    return LRUState(torch.zeros(shape_h, dtype=f32, device=device),
                    torch.zeros(shape_c, dtype=cfg.torch_dtype,
                                device=device), 0)


def _gates(cfg: ModelConfig, p: RGLRU, xc: Tensor):
    """a_t and the gated input of the LRU, float32. xc (..., W) post-conv."""
    xf = xc.to(f32)
    r = torch.sigmoid(xf @ p.w_a.to(f32) + p.b_a)
    i = torch.sigmoid(xf @ p.w_i.to(f32) + p.b_i)
    log_a = cfg.hybrid.lru_c * r * F.logsigmoid(p.Lambda)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * xf)
    return a, gated


def apply_rglru_block(cfg: ModelConfig, p: RGLRU, x: Tensor,
                      state: Optional[LRUState] = None):
    """The block over a sequence (prefill, training), from `state` (zeros
    by default). x (B, S, d) -> (out (B, S, d), the state after it)."""
    W, Kc = _width(cfg), cfg.hybrid.conv_width
    B, S, _ = x.shape
    xb = x @ p.in_x
    gate_branch = F.gelu(x @ p.in_gate, approximate="tanh")
    prev = (state.conv if state is not None
            else x.new_zeros((B, Kc - 1, W)))
    xpad = torch.cat([prev, xb], dim=1)                      # (B, S+Kc-1, W)
    xc = sum(xpad[:, i:i + S] * p.conv_w[i] for i in range(Kc)) + p.conv_b
    a, gated = _gates(cfg, p, xc)                            # (B, S, W) f32
    del xc
    if state is not None:
        gated[:, 0] += a[:, 0] * state.h
    hs = _scan(a, gated)
    del a, gated
    y = (hs.to(x.dtype) * gate_branch) @ p.out
    length = (state.length if state is not None else 0) + S
    return y, LRUState(hs[:, -1], xpad[:, S:], length)


def rglru_decode_step(cfg: ModelConfig, p: RGLRU, x: Tensor,
                      state: LRUState):
    """One token with the O(1) state. x (B, 1, d) -> (out (B, 1, d), the
    state one position on)."""
    xb = x[:, 0] @ p.in_x                                    # (B, W)
    gate_branch = F.gelu(x[:, 0] @ p.in_gate, approximate="tanh")
    window = torch.cat([state.conv, xb[:, None]], dim=1)     # (B, Kc, W)
    xc = torch.einsum("bkw,kw->bw", window, p.conv_w) + p.conv_b
    a, gated = _gates(cfg, p, xc)
    h = a * state.h + gated
    y = (h.to(x.dtype) * gate_branch) @ p.out
    return y[:, None], LRUState(h, window[:, 1:], state.length + 1)
