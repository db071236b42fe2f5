"""deepseek-moe-16b [moe]: fine-grained MoE — 2 shared + 64 routed top-6,
dense first layer. [arXiv:2401.06066; hf]"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                   # per routed expert
    vocab_size=102_400,
    mlp_type="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=64, top_k=6, n_shared=2,
        d_ff_expert=1408, d_ff_shared=2816,
        capacity_factor=1.25,
        first_layer_dense=True, d_ff_dense=10944,
    ),
)

REDUCED = CONFIG.replace(
    name="deepseek-moe-16b-reduced",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_ff_expert=32,
                  d_ff_shared=64, capacity_factor=8.0,
                  first_layer_dense=True, d_ff_dense=128),
    dtype="float32", remat=False,
)
