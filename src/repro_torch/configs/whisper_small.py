"""whisper-small [audio]: encoder-decoder; conv/audio frontend is a STUB —
input_specs() supplies precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,                 # decoder layers (12 encoder layers below)
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    mlp_type="gelu_mlp",
    qkv_bias=True,
    rope_theta=0.0,              # absolute (sinusoidal) positions
    encdec=EncDecConfig(n_encoder_layers=12, encoder_frames=1500,
                        max_target_positions=448),
)

REDUCED = CONFIG.replace(
    name="whisper-small-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    encdec=EncDecConfig(n_encoder_layers=2, encoder_frames=16,
                        max_target_positions=448),
    dtype="float32", remat=False,
)
