"""Mixture-of-Experts layer with sort-based capacity dispatch: port of
`repro.models.moe` on one card.

    MoE(cfg, device)              -- `moe_decls`' parameters: router (d, E)
        float32, w_gate / w_up (E, d, F), w_down (E, F, d), and the shared
        experts (`shared`, a SwiGLU MLP of Fs = d_ff_shared or n_shared * F)
    apply_moe(cfg, p, x)          -- prefill and training: the capacity
        dispatch of the reference's `_moe_local`
    apply_moe_dense(cfg, p, x)    -- decode: every expert on every token

The reference runs the dispatch inside a shard_map, each model shard
holding a slice of the experts and the combine summed over the mesh. One
card holds every expert, so this is its body at E_l = E, e_lo = 0, with
no psum: route in float32 (softmax, top-k, the gates renormalised), sort
the (token, slot) pairs by expert (stable), give each its position in its
expert's queue, drop those at or past the capacity
cap = max(8, ceil8(int(cf * T * K / E))), gather the kept tokens into an
(E, cap, d) buffer, run the gated expert FFN as batched products and
combine with the gates.

The dispatch and the combine are gathers, not scatters: slot c of
expert e reads the token at sorted position starts[e] + c, each (token,
slot) pair reads its expert's output row back in (T, K) order, and a
token's K values are summed in slot order. No float atomics (`index_add_`), so two
calls on the same input are bit-equal on the card; the reference adds
the values into a zero (T, d) buffer in an order XLA picks.

The init follows `moe_decls`: the expert weights w_gate and w_up are
`dense` with the reference's default fan-in, their first dimension (E),
and w_down with fan-in F.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import decls
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
f32 = torch.float32


class MoE(decls.Declared):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg.torch_dtype, device)
        m = cfg.moe
        d, E, Fe = cfg.d_model, m.n_experts, m.d_ff_expert
        self.declare("router", (d, E), decls.dense(d), dtype=f32)
        self.declare("w_gate", (E, d, Fe), decls.dense(E))
        self.declare("w_up", (E, d, Fe), decls.dense(E))
        self.declare("w_down", (E, Fe, d), decls.dense(Fe))
        if m.n_shared:
            # the reference's shared experts are always SwiGLU
            self.shared = L.MLP(cfg.replace(mlp_type="swiglu"), device,
                                d_ff=m.d_ff_shared or m.n_shared * Fe)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert has for T tokens: int(cf * T * K / E) rounded up to
    a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(m.capacity_factor * T * m.top_k / m.n_experts)
    return max(8, -(-cap // 8) * 8)


def router_probs(router: Tensor, x: Tensor) -> Tensor:
    """x (..., d) -> the softmax over experts (..., E), in float32."""
    return torch.softmax(x.to(f32) @ router.to(f32), dim=-1)


def renormalise(gates: Tensor) -> Tensor:
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def route(cfg: ModelConfig, router: Tensor, xt: Tensor):
    """xt (T, d) -> (gates (T, K) float32 renormalised, ids (T, K))."""
    gates, ids = torch.topk(router_probs(router, xt), cfg.moe.top_k, dim=-1)
    return renormalise(gates), ids


class Dispatch(NamedTuple):
    """Where each (token, slot) pair of a capacity dispatch goes."""
    cap: int
    src: Tensor       # (E, cap): the token each expert slot reads, T if empty
    slot: Tensor      # (T * K,): the pair's row of the (E * cap) buffer
    keep: Tensor      # (T * K,) bool: False where the pair was dropped


def dispatch(cfg: ModelConfig, ids: Tensor) -> Dispatch:
    """ids (T, K) -> the capacity dispatch: pairs sorted by expert, stably
    (token order inside an expert), each at its position in its expert's
    queue; the pairs at or past `capacity` are dropped, as the reference
    drops them."""
    T, K = ids.shape
    E = cfg.moe.n_experts
    cap = capacity(cfg, T)
    dev = ids.device
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=dev, dtype=se.dtype)
    # queue bounds by search, not bincount: no host sync on the card
    starts = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - starts
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=dev) - starts[se]
    keep = pos < cap
    c = torch.arange(cap, device=dev)
    filled = c[None] < counts[:, None]                     # (E, cap)
    at = torch.clamp(starts[:, None] + c[None], max=T * K - 1)
    src = torch.where(filled, order[at] // K, T)
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return Dispatch(cap, src, slot, keep)


def apply_moe(cfg: ModelConfig, p: MoE, x: Tensor) -> Tensor:
    """x (B, S, d) -> (B, S, d): routed experts through the capacity
    dispatch, plus the shared experts."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    xt = x.reshape(B * S, D)
    gates, ids = route(cfg, p.router, xt)
    dp = dispatch(cfg, ids)
    # a zero row at index T for the empty slots
    buf = torch.cat([xt, xt.new_zeros((1, D))])[dp.src]     # (E, cap, d)
    # the gated expert FFN, expert by expert as batched products
    h = F.silu(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_e = torch.bmm(h, p.w_down).reshape(E * dp.cap, D)
    w = gates.reshape(-1).to(x.dtype) * dp.keep.to(x.dtype)
    vals = out_e[dp.slot] * w[:, None]
    out = vals.reshape(B * S, K, D).sum(dim=1).reshape(B, S, D)
    if cfg.moe.n_shared:
        out = out + p.shared(x)
    return out


def dense_weights(cfg: ModelConfig, router: Tensor, x: Tensor) -> Tensor:
    """x (..., d) -> (..., E) float32: each expert's gate where it is at
    least the k-th largest (ties included), 0 elsewhere, renormalised."""
    gates_all = router_probs(router, x)
    thresh = torch.topk(gates_all, cfg.moe.top_k, dim=-1).values[..., -1:]
    return renormalise(torch.where(gates_all >= thresh, gates_all, 0.0))


def _bmm_f32(a: Tensor, b: Tensor) -> Tensor:
    """a (E, n, k) @ b (E, k, m) -> float32, its float32 accumulators kept
    (the reference's preferred_element_type=float32): on the card cuBLAS
    writes them out (`out_dtype`); elsewhere the inputs are widened first,
    which is exact."""
    if a.dtype == f32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=f32)
    return torch.bmm(a.to(f32), b.to(f32))


def apply_moe_dense(cfg: ModelConfig, p: MoE, x: Tensor) -> Tensor:
    """x (B, S, d) -> (B, S, d), for the few tokens of a decode step:
    every expert runs on every token and the outputs are weighted by
    `dense_weights`. The expert products keep float32 accumulators, as
    the reference's do; the silu product rounds to the model dtype before
    w_down, as the reference's does."""
    B, S, D = x.shape
    E = cfg.moe.n_experts
    weights = dense_weights(cfg, p.router, x).reshape(B * S, -1)
    xt = x.reshape(B * S, D).expand(E, B * S, D)
    hg = _bmm_f32(xt, p.w_gate)                             # (E, T, F)
    hu = _bmm_f32(xt, p.w_up)
    h = (F.silu(hg) * hu).to(x.dtype)
    out_e = _bmm_f32(h, p.w_down)                           # (E, T, d)
    out = torch.einsum("etd,te->td", out_e, weights).to(x.dtype)
    out = out.reshape(B, S, D)
    if cfg.moe.n_shared:
        out = out + p.shared(x)
    return out
