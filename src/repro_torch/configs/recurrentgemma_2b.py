"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, (rec,rec,attn)
pattern. [arXiv:2402.19427; hf]"""
from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,                 # 8 x (rec,rec,attn) + 2 tail rec layers
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_type="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    hybrid=HybridConfig(lru_width=2560, conv_width=4, window=2048),
)

REDUCED = CONFIG.replace(
    name="recurrentgemma-2b-reduced",
    n_layers=5,                  # 1 triple + 2 tail rec layers
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    hybrid=HybridConfig(lru_width=64, conv_width=4, window=16),
    dtype="float32",
    remat=False,
)
