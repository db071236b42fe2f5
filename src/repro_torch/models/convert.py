"""Carry the JAX package's weights into the port's Model.

`repro.models.transformer.Model.init_params` returns a nested dict whose
per-layer leaves are stacked along a leading (L, ...) axis (the reference
scans over layers). Given that tree as numpy arrays, `params_from_jax`
returns the port's state dict: `layers.<i>.<path>` for layer i of each
stacked leaf, the other leaves under their dotted path, every tensor in
the config's dtype. With it both packages compute from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def params_from_jax(cfg: ModelConfig, tree: dict) -> dict:
    """Reference parameter tree (numpy leaves) -> the port's state dict."""
    out = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(path + (key,), child)
            return
        # a float32 copy: exact for bfloat16 leaves, which numpy holds
        # only as an extension type, and writable as torch wants it
        arr = torch.from_numpy(np.array(node, np.float32)).to(
            cfg.torch_dtype)
        if path[0] == "layers":
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{'.'.join(path)}: {arr.shape[0]} stacked "
                                 f"layers, config has {cfg.n_layers}")
            for i in range(cfg.n_layers):
                out[".".join(("layers", str(i)) + path[1:])] = arr[i]
        else:
            out[".".join(path)] = arr

    walk((), tree)
    return out


def load_jax_params(model, tree: dict) -> None:
    """Load a reference parameter tree into `model` (every parameter,
    strictly: a missing or extra name raises)."""
    model.load_state_dict(params_from_jax(model.cfg, tree), strict=True)
