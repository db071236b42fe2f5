"""Parameter counting: total and active (MoE) — used for MODEL_FLOPS.
A copy of `repro.utils.params`."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    d, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    n = d * H * Dh + 2 * d * Kv * Dh + H * Dh * d
    if cfg.qkv_bias:
        n += H * Dh + 2 * Kv * Dh
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    d = cfg.d_model
    if cfg.mlp_type in ("swiglu", "geglu"):
        return 3 * d * d_ff
    return 2 * d * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    s = cfg.ssm
    Di = s.expand * d
    R = s.dt_rank or -(-d // 16)
    N = s.d_state
    return (d * 2 * Di + s.d_conv * Di + Di + Di * (R + 2 * N)
            + R * Di + Di + Di * N + Di + Di * d)


def _rec_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    W = cfg.hybrid.lru_width or d
    Kc = cfg.hybrid.conv_width
    lru = 2 * d * W + Kc * W + W + 2 * W * W + 3 * W + W * d
    return lru + _mlp_params(cfg, cfg.d_ff)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active) parameter count, embeddings included."""
    embed = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed *= 2
    per_layer_norms = 2 * cfg.d_model

    if cfg.family in ("dense", "vlm"):
        layer = _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + \
            per_layer_norms
        total = cfg.n_layers * layer
    elif cfg.family == "moe":
        m = cfg.moe
        n_moe = cfg.n_layers - (1 if m.first_layer_dense else 0)
        router = cfg.d_model * m.n_experts
        experts_total = m.n_experts * _mlp_params(cfg, m.d_ff_expert)
        experts_active = m.top_k * _mlp_params(cfg, m.d_ff_expert)
        shared = (_mlp_params(cfg, m.d_ff_shared) if m.n_shared else 0)
        moe_layer = _attn_params(cfg) + router + shared + per_layer_norms
        total = n_moe * (moe_layer +
                         (experts_active if active_only else experts_total))
        if m.first_layer_dense:
            total += _attn_params(cfg) + _mlp_params(cfg, m.d_ff_dense) + \
                per_layer_norms
    elif cfg.family == "ssm":
        total = cfg.n_layers * (_ssm_params(cfg) + cfg.d_model)
    elif cfg.family == "hybrid":
        nt = cfg.n_layers // 3
        rem = cfg.n_layers - 3 * nt
        attn_layer = _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + \
            per_layer_norms
        rec_layer = _rec_params(cfg) + per_layer_norms
        total = nt * (2 * rec_layer + attn_layer) + rem * rec_layer
    elif cfg.family == "encdec":
        enc_layer = _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + \
            per_layer_norms
        dec_layer = 2 * _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + \
            3 * cfg.d_model
        total = cfg.encdec.n_encoder_layers * enc_layer + \
            cfg.n_layers * dec_layer
    else:
        raise ValueError(cfg.family)
    return int(total + embed + cfg.d_model)


def active_param_count(cfg: ModelConfig) -> int:
    return param_count(cfg, active_only=True)
