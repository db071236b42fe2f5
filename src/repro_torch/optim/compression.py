"""Top-k error-feedback gradient compression: port of
`repro.optim.compression` on dicts of tensors.

Each leaf sends only the top-`frac` share of its entries by magnitude;
the rest accumulates in a float32 residual that is added back the next
step (error feedback), so compressed + new residual == grads + old
residual exactly. The reference applies it to data-parallel all-reduces
of the LM trainer; the port's LM runs on one card, where it is the same
function with no collective.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
f32 = torch.float32


def topk_mask(x: Tensor, frac: float) -> Tensor:
    """Boolean mask of the entries with |x| >= the k-th largest |x|, k =
    max(1, int(frac * n)): ties with the threshold are all kept, as
    `jax.lax.top_k`'s threshold keeps them."""
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(frac * flat.shape[0]))
    thresh = torch.topk(flat, k).values[-1]
    return torch.abs(x) >= thresh


def topk_compress_update(grads: dict, residual: dict,
                         frac: float = 0.01) -> Tuple[dict, dict]:
    """-> (compressed_grads, new_residual): each leaf's float32 total
    g + r split into what is sent (the top-k entries, in g's dtype) and
    what stays."""
    comp, res = {}, {}
    for k, g in grads.items():
        total = g.to(f32) + residual[k]
        sent = torch.where(topk_mask(total, frac), total, 0.0)
        comp[k], res[k] = sent.to(g.dtype), total - sent
    return comp, res


def init_residual(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=f32, device=p.device)
            for k, p in params.items()}
