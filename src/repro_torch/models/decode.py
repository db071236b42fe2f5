"""Serving path: per-family decode caches, prefill and one-token decode.
Port of `repro.models.decode` for the dense, moe and ssm families.

The caches are the reference's, here with a Python int length and updated
in place:
  dense : {"kv": {"k": (L, B, S_max, Kv, Dh), "v": ...}}, max_len slots,
          a sliding window masked by position
  moe   : "kv" over the MoE layers, and "kv0" (1, B, S_max, Kv, Dh) for
          deepseek's dense first layer
  ssm   : {"h": (L, B, Di, N) float32, "conv": (L, B, Kc-1, Di)}: O(1) in
          the sequence length
each with "length", the filled prefix.

The reference's prefill runs the stack twice (`model.logits`, then a
replay capturing k/v or the recurrent state); this one runs it once,
keeping each layer's rotated keys and values (or its state), and
unembeds only the last position, which is all prefill returns. moe's
prefill runs the capacity dispatch over the whole prompt batch, its
decode step every expert on the step's tokens (`apply_moe_dense`), as in
the reference. The flash-decoding guard (`qrep`) is a mesh concern with
no counterpart on one card.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import Model, SSMLayer

Tensor = torch.Tensor


def _slots(model: Model):
    """(layer, its cache key, its index under that key) for each layer of
    `model.stack()`, in forward order: an SSMLayer's state goes under "h"
    (and "conv"), an attention layer's k/v under "kv", or under "kv0"
    when it runs ahead of the stacked `layers` (moe's dense layer0)."""
    stack = model.stack()
    n0 = len(stack) - len(model.layers)
    for j, layer in enumerate(stack):
        if isinstance(layer, SSMLayer):
            yield layer, "h", j - n0
        elif j < n0:
            yield layer, "kv0", j
        else:
            yield layer, "kv", j - n0


def init_cache(model: Model, batch: int, max_len: int) -> dict:
    cfg = model.cfg
    n = Counter(key for _, key, _ in _slots(model))
    cache = {"length": 0}
    if n["h"]:
        st = ssm_mod.init_ssm_state(cfg, batch, model.device,
                                    n_layers=n["h"])
        cache.update(h=st.h, conv=st.conv)
    for key in ("kv", "kv0"):
        if n[key]:
            kv = attn.init_cache(cfg, batch, max_len, model.device,
                                 n_layers=n[key])
            cache[key] = {"k": kv.k, "v": kv.v}
    return cache


@torch.no_grad()
def prefill(model: Model, tokens: Tensor, max_len: int):
    """tokens (B, S) -> (last-position logits (B, 1, V), decode cache)."""
    B, S = tokens.shape
    cache = init_cache(model, B, max_len)
    x = model.embed.apply_embed(tokens)
    positions = torch.arange(S, device=tokens.device)
    for layer, key, i in _slots(model):
        x, *kept = layer(x, positions, model.use_kernels)
        if key == "h":
            cache["h"][i] = kept[0].h
            cache["conv"][i] = kept[0].conv
        else:
            cache[key]["k"][i, :, :S] = kept[0]
            cache[key]["v"][i, :, :S] = kept[1]
    cache["length"] = S
    h = model.final_norm(x[:, -1:])
    return model.embed.apply_unembed(h), cache


@torch.no_grad()
def decode_step(model: Model, cache: dict, tokens: Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    x = model.embed.apply_embed(tokens)
    length = cache["length"]
    for layer, key, i in _slots(model):
        if key == "h":
            x, st = layer.decode(x, ssm_mod.SSMState(
                cache["h"][i], cache["conv"][i], length))
            cache["h"][i] = st.h
            cache["conv"][i] = st.conv
        else:
            x, _ = layer.decode(x, attn.KVCache(cache[key]["k"][i],
                                                cache[key]["v"][i], length))
    logits = model.embed.apply_unembed(model.final_norm(x))
    cache["length"] = length + 1
    return logits, cache
