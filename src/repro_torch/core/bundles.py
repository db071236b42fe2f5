"""Random Gauss-Seidel bundle partitioning (paper Eq. 8), in torch.

Each outer iteration draws a fresh random permutation of the feature set N
and slices it into b = ceil(n / P) disjoint bundles of size P. When P does
not divide n the final bundle is padded with the sentinel index n; all
bundle math masks it out.

Port of `repro.core.bundles`. Permutations come from an explicit
`torch.Generator` (drawn on the CPU, then moved to the solver's device), so
the same seed gives the same partitions on the CPU and on the card. They
differ from the reference's `jax.random` draws; parity tests hand the
reference's (b, P) arrays to the port instead.

torch has no `mode="drop"` scatter, so `scatter_add` clamps the sentinel to
a real index and zeroes its update: adding an exact 0 changes nothing.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def num_bundles(n: int, P: int) -> int:
    return -(-n // P)  # ceil


def _perm(gen: torch.Generator, n: int, device) -> Tensor:
    return torch.randperm(n, generator=gen).to(device)


def partition(gen: torch.Generator, n: int, P: int, device="cpu") -> Tensor:
    """-> (b, P) int32 bundle indices; entries == n are padding."""
    b = num_bundles(n, P)
    perm = _perm(gen, n, device)
    pad = torch.full((b * P - n,), n, dtype=perm.dtype, device=perm.device)
    return torch.cat([perm, pad]).reshape(b, P).to(torch.int32)


def partition_active(gen: torch.Generator, active: Tensor,
                     P: int) -> tuple[Tensor, int]:
    """Active-set partition for the shrinking solver.

    Same (b, P) layout as `partition`, but every ACTIVE feature lands in
    the leading ceil(n_active / P) bundles (random order within the active
    block); inactive and pad slots hold the sentinel n. Returns (idxs,
    b_active) with b_active a host int: the bundle loop's trip count,
    which costs one host sync per outer iteration.
    """
    n = active.shape[0]
    b = num_bundles(n, P)
    perm = _perm(gen, n, active.device)
    order = torch.argsort((~active[perm]).to(torch.int8), stable=True)
    perm = perm[order]
    flat = torch.where(active[perm], perm, n)
    pad = torch.full((b * P - n,), n, dtype=flat.dtype, device=flat.device)
    idxs = torch.cat([flat, pad]).reshape(b, P).to(torch.int32)
    n_active = int(active.sum())
    return idxs, (n_active + P - 1) // P


def gather_vec(v: Tensor, idx: Tensor) -> tuple[Tensor, Tensor]:
    """Gather (P,) entries of a feature-indexed vector with pad masking."""
    n = v.shape[0]
    valid = idx < n
    out = v[idx.clamp(max=n - 1)] * valid.to(v.dtype)
    return out, valid


def scatter_add(w: Tensor, idx: Tensor, upd: Tensor) -> Tensor:
    """w[idx] += upd IN PLACE, sentinel entries (idx == n) dropped."""
    n = w.shape[0]
    valid = idx < n
    w.index_add_(0, idx.clamp(max=n - 1),
                 torch.where(valid, upd, torch.zeros_like(upd)))
    return w
