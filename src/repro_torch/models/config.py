"""Model configuration dataclasses shared by all 10 assigned architectures.

A copy of `repro.models.config` with `torch_dtype` in place of
`jnp_dtype`; the registry (`repro_torch.configs`) is the same data."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # deepseek: shared experts always active
    d_ff_expert: int = 0         # per-expert hidden
    d_ff_shared: int = 0         # total shared hidden (n_shared * d_ff_expert)
    capacity_factor: float = 1.25
    first_layer_dense: bool = False
    d_ff_dense: int = 0          # d_ff of the dense first layer


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma: repeating (rec, rec, attn) pattern."""
    pattern_period: int = 3      # every third layer is local attention
    lru_width: int = 0           # 0 => d_model
    conv_width: int = 4
    window: int = 2048           # local-attention window
    lru_c: float = 8.0           # RG-LRU a = sigmoid(L)^(c*r)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper: encoder-decoder with stubbed conv/audio frontend."""
    n_encoder_layers: int = 12
    encoder_frames: int = 1500   # frontend stub output length
    max_target_positions: int = 448


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Pixtral: ViT frontend stub; patch embeddings prepended to tokens."""
    n_patches: int = 256         # stub patches per example
    patch_embed_dim: int = 0     # 0 => d_model (already projected)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    mlp_type: str = "swiglu"     # swiglu | geglu | gelu_mlp
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False    # gemma: scale embeddings by sqrt(d_model)
    attn_window: int = 0         # 0 => full attention
    # head padding (beyond-paper optimization, EXPERIMENTS.md section Perf):
    # when n_heads doesn't divide the model axis (e.g. qwen1.5's 40 on a
    # 16-wide axis) attention replicates across it (measured 16x flop +
    # HBM waste). Padding q/kv heads to a divisible count with ZERO-
    # initialized weights is output-exact at init and shards cleanly.
    pad_heads: int = 0           # 0 => no padding
    pad_kv_heads: int = 0
    # fused QKV projection (beyond-paper optimization): one einsum for
    # q/k/v means ONE backward all-reduce of dL/dx instead of three
    # (measured 30% of grok train_4k's collective bytes). Numerically
    # identical; params store a single wqkv.
    fused_qkv: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True           # checkpoint each scanned layer in train

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def eff_heads(self) -> int:
        return self.pad_heads or self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.pad_kv_heads or self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the logits dim always
        shards over the model axis (whisper's 51865 is odd — unpadded it
        replicates (B, S, V) f32 logits and all-reduces them; measured
        ~98 TB of collective traffic on train_4k). Pad logits are masked
        to -inf in apply_unembed."""
        return -(-self.vocab_size // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with O(1)-or-O(window) state? (long_500k)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def get_shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether a shape cell applies to an arch (DESIGN.md shape-cell notes)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense-KV decode has no "
                       "sub-quadratic mechanism (skip per assignment)")
    if cfg.family == "encdec" and cell.name == "long_500k":
        return False, "whisper decoder max positions 448 << 524288"
    return True, ""
