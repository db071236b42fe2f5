"""gemma-7b [dense]: GeGLU, head_dim 256, scaled embeddings, tied unembed.
[arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,                # != d_model // n_heads (192) by design
    d_ff=24576,
    vocab_size=256_000,
    mlp_type="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
)

REDUCED = CONFIG.replace(
    name="gemma-7b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
