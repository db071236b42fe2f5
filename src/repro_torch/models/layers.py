"""Shared building blocks: norms, MLPs, RoPE, embeddings.

Port of `repro.models.layers` as modules: each declares its parameters
(`models.decls`) under the reference's names and layouts, so a reference
parameter tree loads as it is (`models.convert`). Compute runs in the
parameter dtype with float32 where the reference has it (norm statistics,
rope), and the training loss `softmax_xent`.

Split along "model" (`models.sharding`, while the train step computes
split): the MLP's gate and up columns and its down rows over "ff", one
exit sum, `b_down` added once after it; the embedding's rows over
"vocab": a lookup of the rank's rows (zero for the others' tokens) and
an exit sum, the logits on the rank's vocabulary slice (tied or
untied, the pads masked at the rank's offset), and `softmax_xent` in
its vocab-parallel form.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import decls
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
f32 = torch.float32


# --- norms -------------------------------------------------------------------

class RMSNorm(decls.Declared):
    """RMS norm with float32 statistics; `plus_one` is gemma's convention
    (the weight is a residual around 1)."""

    def __init__(self, d: int, eps: float, plus_one: bool, dtype, device):
        super().__init__(dtype, device)
        self.eps = eps
        self.plus_one = plus_one
        self.declare("scale", (d,), decls.ONES, axes=("embed",))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.to(f32)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        scale = self.scale.to(f32)
        if self.plus_one:
            scale = scale + 1.0
        return (y * scale).to(x.dtype)


class LayerNorm(decls.Declared):
    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__(dtype, device)
        self.eps = eps
        self.declare("scale", (d,), decls.ONES, axes=("embed",))
        self.declare("bias", (d,), decls.ZEROS, axes=("embed",))

    def forward(self, x: Tensor) -> Tensor:
        xf = x.to(f32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(f32) + self.bias.to(f32)).to(x.dtype)


def make_norm(cfg: ModelConfig, device, d: int = 0):
    d = d or cfg.d_model
    if cfg.family == "encdec":   # whisper uses layernorm
        return LayerNorm(d, cfg.norm_eps, cfg.torch_dtype, device)
    return RMSNorm(d, cfg.norm_eps,
                   cfg.name.startswith(("gemma", "recurrentgemma")),
                   cfg.torch_dtype, device)


# --- MLPs --------------------------------------------------------------------

class MLP(decls.Declared):
    """SwiGLU / GeGLU (tanh-approximate GELU), or the 2-matrix GELU MLP
    with optional biases."""

    def __init__(self, cfg: ModelConfig, device, d_ff: int = 0,
                 bias: bool = False):
        super().__init__(cfg.torch_dtype, device)
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.mlp_type = cfg.mlp_type
        if cfg.mlp_type in ("swiglu", "geglu"):
            self.declare("w_gate", (d, f), decls.dense(d),
                         axes=("embed", "ff"))
        self.declare("w_up", (d, f), decls.dense(d), axes=("embed", "ff"))
        self.declare("w_down", (f, d), decls.dense(f),
                     axes=("ff", "embed"))
        self.bias = bias and cfg.mlp_type not in ("swiglu", "geglu")
        if self.bias:
            self.declare("b_up", (f,), decls.ZEROS, axes=("ff",))
            self.declare("b_down", (d,), decls.ZEROS, axes=("embed",))

    def forward(self, x: Tensor) -> Tensor:
        sp = self.split_on("w_up", 1)
        if sp is not None:
            x = sp.enter(x)
        if self.mlp_type == "swiglu":
            out = (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        elif self.mlp_type == "geglu":
            out = (F.gelu(x @ self.w_gate, approximate="tanh") *
                   (x @ self.w_up)) @ self.w_down
        else:
            h = x @ self.w_up
            if self.bias:
                h = h + self.b_up
            out = F.gelu(h, approximate="tanh") @ self.w_down
        if sp is not None:
            out = sp.leave(out)
        if self.bias:
            out = out + self.b_down
        return out


# --- embeddings / unembedding -------------------------------------------------

class Embed(decls.Declared):
    """Token embedding over the 128-padded vocab; unembedding is tied
    (embedding^T) or its own (d, Vp) matrix, and masks the pad logits."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg.torch_dtype, device)
        self.cfg = cfg
        Vp, d = cfg.padded_vocab, cfg.d_model
        self.declare("embedding", (Vp, d), decls.EMBEDDING,
                     axes=("vocab", "embed"))
        if not cfg.tie_embeddings:
            self.declare("unembed", (d, Vp), decls.dense(d),
                         axes=("embed", "vocab"))

    def vocab_split(self):
        """The rank's split when the vocabulary's rows are split over it,
        else None."""
        return self.split_on("embedding", 0)

    def apply_embed(self, tokens: Tensor) -> Tensor:
        sp = self.vocab_split()
        if sp is None:
            x = self.embedding[tokens]
        else:
            # the rank's rows; the other ranks' tokens read 0 here
            n = self.embedding.shape[0]
            local = tokens - sp.block(n)
            mine = (local >= 0) & (local < n)
            x = sp.leave(self.embedding[local.clamp(0, n - 1)] *
                         mine[..., None].to(self.embedding.dtype))
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def apply_unembed(self, x: Tensor) -> Tensor:
        """Logits (..., padded vocab); under a vocabulary split the rank's
        slice of them."""
        cfg = self.cfg
        w = self.embedding.T if cfg.tie_embeddings else self.unembed
        sp = self.vocab_split()
        if sp is not None:
            x = sp.enter(x)
        logits = x @ w
        if cfg.padded_vocab != cfg.vocab_size:    # mask the pad logits
            n = logits.shape[-1]
            lo = 0 if sp is None else sp.block(n)
            pad = torch.arange(lo, lo + n, device=x.device) >= cfg.vocab_size
            logits = logits + torch.where(pad, -1e9, 0.0).to(logits.dtype)
        return logits


# --- rotary position embeddings -----------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x (..., S, H, Dh), positions broadcastable to (..., S). Half-split
    rotation (the first half of Dh pairs with the second, not
    interleaved), computed in float32 and cast back."""
    half = x.shape[-1] // 2
    # theta ** exponent in float32 (no host-to-device copy of theta,
    # which would synchronise the stream)
    exponent = -torch.arange(half, dtype=f32, device=x.device) / half
    freqs = torch.pow(theta, exponent)
    ang = positions[..., None].to(f32) * freqs             # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int) -> Tensor:
    """Whisper's fixed sinusoids, (n_pos, d) float32 on the CPU: the
    reference's table (`repro.models.layers.sinusoidal_positions`), built
    in numpy float64 and cast, sin in the first half, cos in the second."""
    half = d // 2
    freqs = np.exp(-np.arange(half) * (np.log(10000.0) / (half - 1)))
    ang = np.arange(n_pos)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32))


def sinusoid_at(pos: int, d: int, device) -> Tensor:
    """The sinusoid of one position, (d,) float32 on `device`, computed in
    float32 (on the CPU) as the reference's decode step computes it, not
    read from the float64 table: the two differ in the last bits."""
    half = d // 2
    step = torch.log(torch.tensor(10000.0)) / (half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=f32) * step)
    ang = torch.tensor(float(pos)) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(device)


# --- losses ------------------------------------------------------------------

def softmax_xent(logits: Tensor, labels: Tensor,
                 mask: Tensor | None = None,
                 total: Tensor | None = None, split=None) -> Tensor:
    """Mean next-token cross-entropy in float32. logits (..., V), labels
    (...) integer, mask (...) optional weights: sum(nll * m) / max(sum(m),
    1). Pad-vocab logits carry -1e9 from `Embed.apply_unembed`, so they
    add nothing.

    `split` (a `sharding.Split`): logits are the rank's slice of the
    vocabulary (rows split.index * V on), and the loss is the reference's
    vocab-parallel form with no all-gather of logits: the log-sum-exp
    from the rank-ordered max over "model" and the slices' sums of
    exp(l - max) summed over it, the gold logit the rank's where the
    label falls in its slice (0 elsewhere) summed over it. Every rank
    returns the same loss.

    `total`: the weight of the whole batch when these rows are one data
    shard of it (sum(m) summed over the shards, or their token count
    without a mask). The result is then this shard's sum(nll * m) /
    max(total, 1), and the shards' results add up to the whole batch's
    mean, as do their gradients (`train.steps`): a mean a shard would
    weigh the shards' tokens unequally where their sum(m) differ."""
    lf = logits.to(f32)
    if split is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    else:
        V = lf.shape[-1]
        m = split.mesh.pmax_ordered(lf.detach().amax(-1), split.axes)
        lse = m + torch.log(split.leave(
            torch.sum(torch.exp(lf - m[..., None]), dim=-1)))
        local = labels.long() - split.block(V)
        mine = (local >= 0) & (local < V)
        gold = torch.gather(lf, -1, local.clamp(0, V - 1)[..., None])[..., 0]
        gold = split.leave(torch.where(mine, gold, 0.0))
    nll = lse - gold
    if total is not None:
        num = torch.sum(nll if mask is None else nll * mask.to(f32))
        return num / torch.clamp(total, min=1.0)
    if mask is not None:
        m = mask.to(f32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
