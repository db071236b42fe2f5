"""Serving path of the dense family: decode cache, prefill and one-token
decode. Port of `repro.models.decode`.

The cache is the reference's: {"kv": {"k": (L, B, S_max, Kv, Dh), "v":
...}, "length": filled prefix}, here with a Python int length and updated
in place: max_len slots, a sliding window masked by position.

The reference's prefill runs the stack twice (`model.logits`, then a
replay capturing k/v); this one runs it once, keeping each layer's
rotated keys and values, and unembeds only the last position, which is
all prefill returns. The flash-decoding guard (`qrep`) is a mesh concern
with no counterpart on one card.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.transformer import Model

Tensor = torch.Tensor


def init_cache(model: Model, batch: int, max_len: int) -> dict:
    kv = attn.init_cache(model.cfg, batch, max_len, model.device,
                         n_layers=model.cfg.n_layers)
    return {"kv": {"k": kv.k, "v": kv.v}, "length": kv.length}


@torch.no_grad()
def prefill(model: Model, tokens: Tensor, max_len: int):
    """tokens (B, S) -> (last-position logits (B, 1, V), decode cache)."""
    B, S = tokens.shape
    cache = init_cache(model, B, max_len)
    x = model.embed.apply_embed(tokens)
    positions = torch.arange(S, device=tokens.device)
    for i, layer in enumerate(model.layers):
        x, k, v = layer(x, positions, model.use_kernels)
        cache["kv"]["k"][i, :, :S] = k
        cache["kv"]["v"][i, :, :S] = v
    cache["length"] = S
    h = model.final_norm(x[:, -1:])
    return model.embed.apply_unembed(h), cache


@torch.no_grad()
def decode_step(model: Model, cache: dict, tokens: Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    x = model.embed.apply_embed(tokens)
    length = cache["length"]
    for i, layer in enumerate(model.layers):
        x, _ = layer.decode(x, attn.KVCache(cache["kv"]["k"][i],
                                            cache["kv"]["v"][i], length))
    logits = model.embed.apply_unembed(model.final_norm(x))
    cache["length"] = length + 1
    return logits, cache
