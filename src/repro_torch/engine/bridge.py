"""Carry problem and solver state across from the JAX package, as numpy.

The reference draws bundle partitions with `jax.random`, which torch cannot
reproduce, so a step-by-step comparison of the two packages starts both
from one carry and feeds the port the reference's partitions:

    design = design_from_numpy(col_rows=..., col_vals=..., shape=(s, n))
    state  = state_from_numpy(w, z, active, device="cpu")
    idxs   = partition_from_numpy(ref_idxs, device="cpu")
    outer(state.w, state.z, state.gen, state.active, True, c, idxs=idxs)

Everything arrives as numpy arrays (`np.asarray` of a jax array), never as
jax objects: this module imports neither jax nor the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.design_matrix import (DenseDesign, DesignMatrix,
                                            PaddedCSCDesign)
from repro_torch.device import resolve_device
from repro_torch.engine.loop import EngineState


def design_from_numpy(col_rows=None, col_vals=None,
                      shape: Optional[Tuple[int, int]] = None, X=None,
                      device="cuda") -> DesignMatrix:
    """A padded-CSC design from (col_rows, col_vals, shape), or a dense one
    from X (float32 either way)."""
    dev = resolve_device(device)
    if X is not None:
        return DenseDesign(X=torch.as_tensor(np.asarray(X, np.float32),
                                             device=dev))
    if col_rows is None or col_vals is None or shape is None:
        raise ValueError("pass X, or col_rows, col_vals and shape")
    return PaddedCSCDesign.from_arrays(col_rows, col_vals, int(shape[0]),
                                       dev)


def state_from_numpy(w, z, active=None, device="cuda",
                     seed: int = 0) -> EngineState:
    """An EngineState from host w (n,), z (s,) and optional active (n,);
    the generator is seeded with `seed`."""
    dev = resolve_device(device)
    w_t = torch.tensor(np.asarray(w, np.float32), device=dev)  # copies
    z_t = torch.tensor(np.asarray(z, np.float32), device=dev)
    if active is None:
        act = torch.ones(w_t.shape, dtype=torch.bool, device=dev)
    else:
        act = torch.tensor(np.asarray(active, bool), device=dev)
    return EngineState(w=w_t, z=z_t, gen=torch.Generator().manual_seed(seed),
                       active=act)


def partition_from_numpy(idxs, device="cuda") -> torch.Tensor:
    """The reference's (b, P) partition array as an int32 tensor."""
    return torch.tensor(np.asarray(idxs, np.int32),
                        device=resolve_device(device))
