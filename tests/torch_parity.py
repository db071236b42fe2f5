"""Shared set-up of the solver parity tests (tests/test_torch_solver_*.py):
one problem in both packages, a shared starting carry, and the reference's
partition draw."""
import jax
import numpy as np
import torch

from repro.core import bundles as jB
from repro.core import pcdn as jpcdn
from repro.core import problem as jprob
from repro.data import make_classification
from repro_torch.core import pcdn as tpcdn
from repro_torch.core import problem as tprob

# w and z after a step or an iteration: float32 sums in another order
TOL = dict(rtol=1e-5, atol=1e-6)

# (layout, ls_scope): the three routes of the bundle step
ROUTES = [("dense", "full"), ("padded_csc", "full"),
          ("padded_csc", "support")]


def problems(layout, seed=0, s=400, n=96, c=2.0):
    sparsity = 0.5 if layout == "dense" else 0.93
    X, y, _ = make_classification(s, n, sparsity=sparsity, seed=seed)
    jp = jprob.make_problem(X, y, c=c, layout=layout)
    tp = tprob.make_problem(X, y, c=c, layout=layout, device="cpu")
    return jp, tp


def configs(P, scope, use_kernels, shrink=False):
    kw = dict(P=P, ls_scope=scope, use_kernels=use_kernels, shrink=shrink,
              seed=0)
    return jpcdn.PCDNConfig(**kw), tpcdn.PCDNConfig(**kw)


def start_carry(jp, seed=1):
    """A sparse w and its margins, as numpy: the shared carry."""
    rng = np.random.default_rng(seed)
    n = jp.n_features
    w = np.where(rng.random(n) < 0.3, 0.2 * rng.standard_normal(n), 0.0)
    w = w.astype(np.float32)
    z = np.asarray(jp.margins(jax.numpy.asarray(w)))
    return w, z


def reference_partition(key, active, P, shrink):
    """The partition the reference's outer iteration draws from `key`."""
    _, sub = jax.random.split(key)
    if shrink:
        idxs, b_active = jB.partition_active(sub, jax.numpy.asarray(active),
                                             P)
        return np.asarray(idxs), int(b_active)
    return np.asarray(jB.partition(sub, active.shape[0], P)), None


def tensor(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)
