"""qwen1.5-32b [dense]: MHA (kv == heads) with QKV bias.
[hf:Qwen/Qwen1.5-0.5B family scaling; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152_064,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

REDUCED = CONFIG.replace(
    name="qwen1.5-32b-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", remat=False,
)
