"""falcon-mamba-7b [ssm]: attention-free Mamba-1 architecture.
[arXiv:2410.05355; unverified]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                   # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                      # no MLP blocks; mamba block only
    vocab_size=65_024,
    rope_theta=0.0,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

REDUCED = CONFIG.replace(
    name="falcon-mamba-7b-reduced",
    n_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    dtype="float32", remat=False,
)
