"""pixtral-12b [vlm]: Pixtral-ViT frontend (stub) + Mistral-Nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    vlm=VLMConfig(n_patches=256),
)

REDUCED = CONFIG.replace(
    name="pixtral-12b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    vlm=VLMConfig(n_patches=8),
    dtype="float32",
    remat=False,
)
