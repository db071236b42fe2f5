"""Concrete model inputs: port of the concrete half of
`repro.launch.specs` (`concrete=True`).

    train_batch_specs(cfg, batch, seq, seed, device) -> {"tokens", "labels"
        [, "patches", "loss_mask"] [, "frames"]}
    decode_batch_specs(cfg, batch, seed, device)     -> {"tokens" (B, 1)}
    prefix_specs(cfg, batch, seed, device)           -> {"patches"} (vlm),
        {"frames"} (encdec) or {}: what the serving CLI feeds prefill
    cell_input_specs(cfg, cell, seed, device)        -- by the cell's kind

Every value is drawn from one `torch.Generator` seeded with `seed`, on
`device` (cuda by default: it raises without a card). jax.random's bits
cannot be matched, so the batches match the reference's in shape, dtype,
range and layout only: tokens and labels int32 in [0, vocab); vlm's patch
embeddings (normal * 0.02, in the model dtype) take the first n_patches
positions, the text the rest (seq - n_patches, at least 1), and its
loss_mask is 0 on the patches and 1 on the text; encdec's frame
embeddings are (batch, encoder_frames, d_model).

The reference's other half, ShapeDtypeStruct stand-ins, serves only its
XLA dry-run and has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, ShapeCell


def _tokens(gen, shape, high, device):
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _embeddings(gen, shape, dtype, device):
    """Normal * 0.02, drawn in float32 and cast first, as the reference
    does."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.to(dtype) * 0.02


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                      device="cuda") -> dict:
    """The inputs of a train step: tokens and labels (and vlm's patches
    and loss_mask, encdec's frames)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    V = cfg.vocab_size
    if cfg.family != "vlm":
        out = {"tokens": _tokens(gen, (batch, seq), V, dev),
               "labels": _tokens(gen, (batch, seq), V, dev)}
    else:
        npatch = cfg.vlm.n_patches
        text = max(seq - npatch, 1)
        out = {"tokens": _tokens(gen, (batch, text), V, dev),
               "labels": _tokens(gen, (batch, npatch + text), V, dev),
               "patches": _embeddings(gen, (batch, npatch, cfg.d_model),
                                      cfg.torch_dtype, dev)}
        mask = torch.ones((batch, npatch + text), dtype=torch.float32,
                          device=dev)
        mask[:, :npatch] = 0.0
        out["loss_mask"] = mask
    if cfg.family == "encdec":
        out["frames"] = _embeddings(
            gen, (batch, cfg.encdec.encoder_frames, cfg.d_model),
            cfg.torch_dtype, dev)
    return out


def prefix_specs(cfg: ModelConfig, batch: int, seed: int = 0,
                 device="cuda") -> dict:
    """The serving CLI's stand-ins for the frontends: vlm's patch
    embeddings (batch, n_patches, d_model) or encdec's frame embeddings
    (batch, encoder_frames, d_model), normal * 0.02 in the model dtype;
    {} for the other families. The reference's `launch/serve.py` draws
    them from PRNGKey(seed + 1); here a generator seeded with seed + 1."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if cfg.family == "vlm":
        return {"patches": _embeddings(
            gen, (batch, cfg.vlm.n_patches, cfg.d_model), cfg.torch_dtype,
            dev)}
    if cfg.family == "encdec":
        return {"frames": _embeddings(
            gen, (batch, cfg.encdec.encoder_frames, cfg.d_model),
            cfg.torch_dtype, dev)}
    return {}


def decode_batch_specs(cfg: ModelConfig, batch: int, seed: int = 0,
                       device="cuda") -> dict:
    """The inputs of a serve step: one new token a sequence."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": _tokens(gen, (batch, 1), cfg.vocab_size, dev)}


def cell_input_specs(cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
                     device="cuda") -> dict:
    if cell.kind in ("train", "prefill"):
        return train_batch_specs(cfg, cell.global_batch, cell.seq_len, seed,
                                 device)
    return decode_batch_specs(cfg, cell.global_batch, seed, device)
