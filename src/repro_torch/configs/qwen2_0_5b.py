"""qwen2-0.5b [dense]: GQA with QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    mlp_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    name="qwen2-0.5b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
