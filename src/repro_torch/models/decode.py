"""Serving path: per-family decode caches, prefill and one-token decode.
Port of `repro.models.decode`, every family.

The caches are the reference's, here with a Python int length and updated
in place:
  dense, vlm : {"kv": {"k": (L, B, S_max, Kv, Dh), "v": ...}}, max_len
               slots (vlm's count the patches), a sliding window masked
               by position
  moe        : "kv" over the MoE layers, and "kv0" (1, B, S_max, Kv, Dh)
               for deepseek's dense first layer
  ssm        : {"h": (L, B, Di, N) float32, "conv": (L, B, Kc-1, Di)}:
               O(1) in the sequence length
  hybrid     : "lru1_h"/"lru1_conv" and "lru2_h"/"lru2_conv" (n_triples,
               B, W) float32 / (n_triples, B, Kc-1, W) for the triples'
               two rec layers, "kv" (n_triples, B, min(max_len, window),
               Kv, Dh) a ring for their attention layers, and
               "tail<j>_h"/"tail<j>_conv" (B, W) / (B, Kc-1, W) for each
               tail rec layer: O(1) + O(window)
  encdec     : "kv" for the decoder's self-attention, and "cross" (L, B,
               encoder_frames, Kv, Dh), the cross-attention's keys and
               values projected from the encoder's output once at prefill
each with "length", the filled prefix (vlm: patches + text).

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
from repro_torch.models import layers as L
from repro_torch.models import rglru
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import Model, SSMLayer

Tensor = torch.Tensor
KV_KEYS = ("kv", "kv0")


def _slots(model: Model):
    """(layer, its cache key, its index on the key's stacked axis or None)
    for each layer of `model.stack()`, in forward order. An attention
    layer's k/v go under "kv", or "kv0" when it runs ahead of the stacked
    `layers` (moe's dense layer0); a recurrent layer's state under the key
    prefix p, as p + "h" and p + "conv": "" for the ssm's layers,
    "lru1_"/"lru2_" for the hybrid's triples, "tail<j>_" (unstacked,
    index None) for its tail."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        for i, t in enumerate(model.triples):
            yield t.rec1, "lru1_", i
            yield t.rec2, "lru2_", i
            yield t.attn, "kv", i
        for j, tail in enumerate(model.tails()):
            yield tail, f"tail{j}_", None
        return
    if cfg.family == "encdec":
        for i, layer in enumerate(model.dec_layers):
            yield layer, "kv", i
        return
    stack = model.stack()
    n0 = len(stack) - len(model.layers)
    for j, layer in enumerate(stack):
        if isinstance(layer, SSMLayer):
            yield layer, "", j - n0
        elif j < n0:
            yield layer, "kv0", j
        else:
            yield layer, "kv", j - n0


def _at(t: Tensor, i):
    """Layer i's slice of a stacked cache tensor (the tensor when None)."""
    return t if i is None else t[i]


def init_cache(model: Model, batch: int, max_len: int) -> dict:
    cfg, dev = model.cfg, model.device
    slots = [(key, i) for _, key, i in _slots(model)]
    n = Counter(key for key, i in slots if i is not None)
    cache = {"length": 0}
    for key in [k for k in n if k in KV_KEYS]:
        window = cfg.hybrid.window if cfg.family == "hybrid" else 0
        kv = attn.init_cache(cfg, batch, max_len, dev, n_layers=n[key],
                             window=window)
        cache[key] = {"k": kv.k, "v": kv.v}
    for key, i in slots:
        if key in KV_KEYS or key + "h" in cache:
            continue
        n_layers = 0 if i is None else n[key]
        if cfg.family == "ssm":
            st = ssm_mod.init_ssm_state(cfg, batch, dev, n_layers=n_layers)
        else:
            st = rglru.init_lru_state(cfg, batch, dev, n_layers=n_layers)
        cache[key + "h"], cache[key + "conv"] = st.h, st.conv
    if cfg.family == "encdec":
        kv = attn.init_cache(cfg, batch, cfg.encdec.encoder_frames, dev,
                             n_layers=cfg.n_layers)
        cache["cross"] = {"k": kv.k, "v": kv.v}
    return cache


@torch.no_grad()
def prefill(model: Model, tokens: Tensor, max_len: int,
            patches: Tensor | None = None, frames: Tensor | None = None):
    """tokens (B, S) (with vlm's patch embeddings (B, n_patches, d) or
    encdec's frame embeddings (B, encoder_frames, d)) -> (last-position
    logits (B, 1, V), decode cache). `max_len` counts vlm's patches, as
    the reference's serving CLI does."""
    x, positions, enc_out = model.embed_inputs(tokens, patches, frames)
    cache = init_cache(model, tokens.shape[0], max_len)
    extra = () if enc_out is None else (enc_out,)
    for layer, key, i in _slots(model):
        x, *kept = layer(x, positions, model.use_kernels, *extra)
        if key in KV_KEYS:
            attn.fill_cache(cache[key]["k"][i], kept[0])
            attn.fill_cache(cache[key]["v"][i], kept[1])
            if enc_out is not None:
                cache["cross"]["k"][i] = kept[2]
                cache["cross"]["v"][i] = kept[3]
        else:
            _at(cache[key + "h"], i).copy_(kept[0].h)
            _at(cache[key + "conv"], i).copy_(kept[0].conv)
    cache["length"] = x.shape[1]
    h = model.final_norm(x[:, -1:])
    return model.embed.apply_unembed(h), cache


@torch.no_grad()
def decode_step(model: Model, cache: dict, tokens: Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    cfg = model.cfg
    x = model.embed.apply_embed(tokens)
    length = cache["length"]
    if cfg.family == "encdec":
        x = x + L.sinusoid_at(length, cfg.d_model, x.device).to(x.dtype)
    for layer, key, i in _slots(model):
        if key in KV_KEYS:
            kv = attn.KVCache(cache[key]["k"][i], cache[key]["v"][i], length)
            if cfg.family == "encdec":
                x, _ = layer.decode(x, kv, cache["cross"]["k"][i],
                                    cache["cross"]["v"][i])
            else:
                x, _ = layer.decode(x, kv)
            continue
        state = (ssm_mod.SSMState if cfg.family == "ssm" else
                 rglru.LRUState)(_at(cache[key + "h"], i),
                                 _at(cache[key + "conv"], i), length)
        x, st = layer.decode(x, state)
        _at(cache[key + "h"], i).copy_(st.h)
        _at(cache[key + "conv"], i).copy_(st.conv)
    logits = model.embed.apply_unembed(model.final_norm(x))
    cache["length"] = length + 1
    return logits, cache
