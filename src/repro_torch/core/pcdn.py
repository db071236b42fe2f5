"""PCDN -- Parallel Coordinate Descent Newton (paper Algorithm 3), in torch.

Outer iteration k:
  1. randomly partition N into b = ceil(n/P) bundles          (Eq. 8)
  2. for each bundle B^t in turn (Gauss-Seidel):
     a. P one-dimensional Newton directions in parallel       (Eq. 4/5/10)
     b. one P-dimensional Armijo line search along d^t        (Eq. 6/11)
     c. w += alpha d ;  z += alpha * X_B d_B                  (Alg. 4 step 5)

CDN is this solver with P = 1 (`cdn_config`). Port of `repro.core.pcdn`:
the bundle loop is a Python loop (the reference's `lax.scan` /
`fori_loop`), and a bundle step updates w and z in place -- the outer
iteration copies its input carry once, so callers keep theirs.

With `use_kernels`, the bundle math runs in the hand-written CUDA kernels
(kernels/ops.py): `pcdn_bundle` for the padded-CSC support scope with the
batched search, `pcdn_sparse_direction` for the padded-CSC full scope (and
the support scope with backtracking), `pcdn_direction` for the dense
layout. Host syncs per bundle: none on the fused support step, one per
candidate chunk on the full-scope `armijo_chunked` early exit, one per
candidate on backtracking.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import bundles as B
from repro_torch.core.design_matrix import (PaddedCSCDesign, SparseSlab,
                                            _take_fill)
from repro_torch.core.direction import delta_decrement, newton_direction
from repro_torch.core.linesearch import (ArmijoParams, armijo_backtracking,
                                         armijo_chunked, armijo_support,
                                         candidate_alphas)
from repro_torch.core.problem import L1Problem

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PCDNConfig:
    P: int                       # bundle size == degree of parallelism
    armijo: ArmijoParams = ArmijoParams()
    max_outer: int = 200
    tol_kkt: float = 1e-3        # stop when KKT violation <= tol_kkt
    tol_rel_obj: float = 0.0     # optional: stop when F <= (1+tol) F*
    ls_kind: str = "batched"     # "batched" | "backtracking" (faithful)
    # "support" | "full" | "auto" (support iff padded_csc and
    # AUTO_SUPPORT_MARGIN * P * k_max <= s) -- see resolve_ls_scope
    ls_scope: str = "auto"
    ls_chunk: int = 8            # candidate chunk of the full-scope search
    seed: int = 0                # torch.Generator seed of the partitions
    use_kernels: bool = False    # route bundle math through CUDA kernels
    shrink: bool = False         # mask near-optimal zero features out
    shrink_tol: float = 0.01     # shrink j when w_j == 0, |g_j| < 1 - tol
    recheck_every: int = 1       # full-set KKT recheck period


def cdn_config(**kw) -> PCDNConfig:
    """CDN = PCDN with bundle size 1 (paper section 2.1)."""
    kw.setdefault("ls_kind", "backtracking")
    return PCDNConfig(P=1, **kw)


def with_bundle_size(cfg: PCDNConfig, P: int) -> PCDNConfig:
    """`cfg` at a different bundle size, everything else identical."""
    return dataclasses.replace(cfg, P=int(P))


def _line_search_fn(cfg: PCDNConfig) -> Callable:
    if cfg.ls_kind == "batched":
        return functools.partial(armijo_chunked, chunk=cfg.ls_chunk)
    if cfg.ls_kind == "backtracking":
        return armijo_backtracking
    raise ValueError(f"unknown ls_kind {cfg.ls_kind!r}")


AUTO_SUPPORT_MARGIN = 4  # auto picks support iff MARGIN * P * k_max <= s


def resolve_ls_scope(cfg: PCDNConfig, problem: L1Problem) -> str:
    """"support" needs the padded_csc layout; "auto" also needs
    AUTO_SUPPORT_MARGIN * P * k_max <= s."""
    if cfg.ls_scope == "full":
        return "full"
    sparse = isinstance(problem.design, PaddedCSCDesign)
    if cfg.ls_scope == "support":
        if not sparse:
            raise ValueError(
                "ls_scope='support' requires the padded_csc design "
                "backend; the dense layout has no compressed row support "
                "(use layout='padded_csc' or ls_scope='full'/'auto').")
        return "support"
    if cfg.ls_scope != "auto":
        raise ValueError(f"unknown ls_scope {cfg.ls_scope!r}")
    if sparse and (AUTO_SUPPORT_MARGIN * cfg.P * problem.design.k_max
                   <= problem.n_samples):
        return "support"
    return "full"


def make_bundle_step(problem: L1Problem, cfg: PCDNConfig):
    """One inner iteration t (steps 6-11 of Algorithm 3).

    Returns step((w, z), idx) -> ((w, z), (n_steps, alpha)), which updates
    w and z IN PLACE. idx is a (P,) index tensor with sentinel n. Both
    scopes of the reference: full (dense (s,) margin delta, search over
    all samples) and support (every per-sample pass restricted to the
    bundle's <= P * k_max row support; one fused kernel with use_kernels
    and the batched search).
    """
    loss = problem.loss
    gamma = cfg.armijo.gamma
    scope = resolve_ls_scope(cfg, problem)
    l2 = problem.elastic_net_l2
    c = problem.c
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops

    if scope == "support":
        design = problem.design
        fuse = cfg.use_kernels and cfg.ls_kind == "batched"
        alphas = candidate_alphas(cfg.armijo, torch.float32, design.device)

        def step(carry, idx):
            w, z = carry
            slab = design.gather_slab(idx)
            w_B, _ = B.gather_vec(w, idx)
            support, pos = design.slab_row_support(slab)
            z_R = _take_fill(z, support, 0.0)
            y_R = _take_fill(problem.y, support, 1.0)
            if fuse:
                upd_w, upd_z, alpha, n_steps = kops.pcdn_bundle(
                    slab.vals, pos, z_R, y_R, w_B, alphas, c,
                    kind=problem.loss_name, l2=l2,
                    sigma=cfg.armijo.sigma, gamma=gamma)
                B.scatter_add(w, idx, upd_w)
                design.scatter_support(z, support, upd_z)
                return (w, z), (n_steps, alpha)
            if cfg.use_kernels:
                # backtracking: no fused step, but the direction still
                # runs in the sparse kernel, with pos as support-local rows
                u_R = problem.grad_factor_at(z_R, y_R)
                v_R = problem.hess_factor_at(z_R, y_R)
                d, g, h = kops.pcdn_sparse_direction(pos, slab.vals, u_R,
                                                     v_R, w_B, l2=l2)
            else:
                g, h = problem.bundle_grad_hess_support(slab, pos, z_R,
                                                        y_R, w_B)
                d = newton_direction(g, h, w_B)
            Delta = delta_decrement(g, h, w_B, d, gamma)
            delta_R = design.slab_matvec_support(slab, pos, d)
            ls_fn = (armijo_support if cfg.ls_kind == "batched"
                     else armijo_backtracking)
            res = ls_fn(loss, c, z_R, delta_R, y_R, w_B, d, Delta,
                        cfg.armijo, l2=l2)
            B.scatter_add(w, idx, res.alpha * d)
            design.scatter_support(z, support, res.alpha * delta_R)
            return (w, z), (res.n_steps, res.alpha)

        return step

    ls = _line_search_fn(cfg)

    def step(carry, idx):
        w, z = carry
        slab = problem.design.gather_slab(idx)
        w_B, _ = B.gather_vec(w, idx)
        if cfg.use_kernels:
            u = problem.grad_factor(z)
            v = problem.hess_factor(z)
            if isinstance(slab, SparseSlab):
                d, g, h = kops.pcdn_sparse_direction(slab.rows, slab.vals, u,
                                                     v, w_B, l2=l2)
            else:
                d, g, h = kops.pcdn_direction(slab.XB, u, v, w_B, l2=l2)
        else:
            g, h = problem.bundle_grad_hess(z, slab, w_B)
            d = newton_direction(g, h, w_B)
        Delta = delta_decrement(g, h, w_B, d, gamma)
        delta_z = problem.design.slab_matvec(slab, d)
        res = ls(loss, c, z, delta_z, problem.y, w_B, d, Delta, cfg.armijo,
                 l2=l2)
        B.scatter_add(w, idx, res.alpha * d)
        z.add_(res.alpha * delta_z)
        return (w, z), (res.n_steps, res.alpha)

    return step


def make_path_outer(problem: L1Problem, cfg: PCDNConfig):
    """The local backend's outer iteration:

        outer(w, z, gen, active, recheck, c, idxs=None, b_active=None)
          -> (w, z, gen, f, kkt, nnz, mean_q, active, n_active)

    Same contract as the reference's `make_path_outer`, with a
    `torch.Generator` in place of the PRNG key. `c` is a float, so one
    built iteration serves any c. `idxs` (b, P) and, under shrinking,
    `b_active` replace the generator's draw -- how tests feed the
    reference's partitions. The returned w and z are new tensors: the
    input carry is copied once and then updated in place. f, kkt, nnz,
    mean_q and n_active stay on the device; `kkt` is the full-set
    violation. Shrinking masks j when w_j == 0 and |g_j| < 1 - shrink_tol;
    `recheck` un-shrinks any feature whose violation exceeds tol_kkt.
    """
    n = problem.n_features

    def outer(w: Tensor, z: Tensor, gen: torch.Generator, active: Tensor,
              recheck: bool, c, idxs: Optional[Tensor] = None,
              b_active: Optional[int] = None):
        prob = problem.with_c(c)
        step = make_bundle_step(prob, cfg)
        w = w.clone()
        z = z.clone()
        if idxs is None:
            if cfg.shrink:
                idxs, b_active = B.partition_active(gen, active, cfg.P)
            else:
                idxs = B.partition(gen, n, cfg.P, device=w.device)
        idxs = torch.as_tensor(idxs, dtype=torch.int32, device=w.device)
        if b_active is None:
            b_active = (-(-int(active.sum()) // cfg.P) if cfg.shrink
                        else idxs.shape[0])
        q_sum = torch.zeros((), dtype=torch.float32, device=w.device)
        for t in range(int(b_active)):
            (w, z), (q, _alpha) = step((w, z), idxs[t])
            q_sum += q
        mean_q = q_sum / max(int(b_active), 1)
        f = prob.objective_from_margins(z, w)
        g = prob.full_grad(z, w)
        viol = prob.kkt_violation_from_grad(w, g)
        kkt = torch.max(viol)
        if cfg.shrink:
            interior = (w == 0) & (torch.abs(g) < 1.0 - cfg.shrink_tol)
            active = active & ~interior
            if recheck:
                active = active | (viol > cfg.tol_kkt)
        nnz = torch.sum(w != 0)
        n_active = torch.sum(active.to(torch.int32))
        return w, z, gen, f, kkt, nnz, mean_q, active, n_active

    return outer


def solve(problem: L1Problem, cfg: PCDNConfig, w0=None,
          f_star: Optional[float] = None):
    """Run PCDN until the KKT (or relative-objective) stop or max_outer,
    through the engine's host loop on a `LocalBackend`."""
    from repro_torch.engine import loop as engine_loop
    from repro_torch.engine.local import LocalBackend

    backend = LocalBackend(problem, cfg)
    return engine_loop.solve(
        backend, problem.c, w0=w0, max_outer=cfg.max_outer,
        tol_kkt=cfg.tol_kkt, recheck_every=cfg.recheck_every,
        tol_rel_obj=cfg.tol_rel_obj, f_star=f_star)
