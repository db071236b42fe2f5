"""grok-1-314b [moe]: 8 experts top-2, wide gated FFN.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,                  # per expert
    vocab_size=131_072,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                  capacity_factor=1.25),
)

REDUCED = CONFIG.replace(
    name="grok-1-314b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                  capacity_factor=8.0),
    dtype="float32", remat=False,
)
