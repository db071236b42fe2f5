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
(kernels/ops.py): `pcdn_bundle` (K1) for the padded-CSC support scope with
the batched search, `pcdn_sparse_direction` (K2) for the padded-CSC full
scope and the support scope with backtracking, `pcdn_direction` (K3) for
the dense layout (on the design's feature-major copy, with the slab
gather, the loss factors and the margin delta inside).

Device work and host syncs per bundle. The fused support step is one K1
launch and nothing else: no host sync, no other device operation (its
workspace is filled once per outer iteration, and the outer iteration
reads the bundles' step counts once, from a (b,) tensor). The full scope
runs K2 or K3 (the loss factors and the margin delta inside), the Armijo
search over all samples with one host sync per candidate chunk evaluated
(`armijo_chunked`), and the w and z updates. Backtracking costs one host
sync per candidate.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.core import bundles as B
from repro_torch.core.design_matrix import PaddedCSCDesign, _take_fill
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


class BundleStep:
    """One inner iteration t (steps 6-11 of Algorithm 3), built once per
    outer iteration by `make_bundle_step`.

    `update(w, z, idx, t)` runs the step for the (P,) bundle idx (sentinel
    n), updating w and z IN PLACE, and records its Armijo step count and
    alpha at t of `n_steps` (int32) and `alpha` (float32), (n_bundles,)
    tensors on the device, so the outer iteration reads them once.
    `step((w, z), idx)` is `update` at t = 0 with the reference step's
    return, ((w, z), (n_steps, alpha)).
    """

    def __init__(self, update: Callable, n_steps: Tensor, alpha: Tensor):
        self.update = update
        self.n_steps = n_steps
        self.alpha = alpha

    def __call__(self, carry, idx):
        w, z = carry
        self.update(w, z, idx, 0)
        return (w, z), (self.n_steps[0], self.alpha[0])


def make_bundle_step(problem: L1Problem, cfg: PCDNConfig,
                     n_bundles: int = 1) -> BundleStep:
    """The bundle step of `problem` under `cfg`, for up to n_bundles
    bundles an outer iteration. Both scopes of the reference: full (dense
    (s,) margin delta, search over all samples) and support (every
    per-sample pass restricted to the bundle's <= P * k_max row support;
    with use_kernels and the batched search the whole step is one K1
    launch, whose workspace is allocated here).
    """
    loss = problem.loss
    gamma = cfg.armijo.gamma
    scope = resolve_ls_scope(cfg, problem)
    l2 = problem.elastic_net_l2
    c = problem.c
    design = problem.design
    dev = design.device
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops

    if scope == "support":
        alphas = candidate_alphas(cfg.armijo, torch.float32, dev)
        if cfg.use_kernels and cfg.ls_kind == "batched":
            launch = kops.BundleLaunch(
                design.col_rows, design.col_vals, problem.y, alphas, c,
                cfg.P, n_bundles, kind=problem.loss_name, l2=l2,
                sigma=cfg.armijo.sigma, gamma=gamma)

            def fused(w, z, idx, t):
                kops.pcdn_bundle(launch, w, z, idx, t)

            return BundleStep(fused, launch.n_steps, launch.alpha)

        n_steps, alpha = _step_outputs(n_bundles, dev)
        ls_fn = (armijo_support if cfg.ls_kind == "batched"
                 else armijo_backtracking)

        def support_step(w, z, idx, t):
            slab = design.gather_slab(idx)
            w_B, _ = B.gather_vec(w, idx)
            support, pos = design.slab_row_support(slab)
            z_R = _take_fill(z, support, 0.0)
            y_R = _take_fill(problem.y, support, 1.0)
            if cfg.use_kernels:
                # backtracking: no fused step, but the direction and
                # delta_R run in the sparse kernel, pos as the rows
                d, g, h, delta_R = kops.pcdn_sparse_direction(
                    pos, slab.vals, z_R, y_R, w_B, c,
                    kind=problem.loss_name, l2=l2)
            else:
                g, h = problem.bundle_grad_hess_support(slab, pos, z_R,
                                                        y_R, w_B)
                d = newton_direction(g, h, w_B)
                delta_R = design.slab_matvec_support(slab, pos, d)
            Delta = delta_decrement(g, h, w_B, d, gamma)
            res = ls_fn(loss, c, z_R, delta_R, y_R, w_B, d, Delta,
                        cfg.armijo, l2=l2)
            B.scatter_add(w, idx, res.alpha * d)
            design.scatter_support(z, support, res.alpha * delta_R)
            n_steps[t] = res.n_steps
            alpha[t] = res.alpha

        return BundleStep(support_step, n_steps, alpha)

    ls = _line_search_fn(cfg)
    n_steps, alpha = _step_outputs(n_bundles, dev)
    sparse = isinstance(design, PaddedCSCDesign)
    XT = design.feature_major() if cfg.use_kernels and not sparse else None

    def full_step(w, z, idx, t):
        w_B, _ = B.gather_vec(w, idx)
        if XT is not None:
            # the slab gather, the loss factors and X_B d inside K3
            d, g, h, delta_z = kops.pcdn_direction(
                XT, idx, z, problem.y, w_B, c, kind=problem.loss_name, l2=l2)
        elif cfg.use_kernels:
            slab = design.gather_slab(idx)
            d, g, h, delta_z = kops.pcdn_sparse_direction(
                slab.rows, slab.vals, z, problem.y, w_B, c,
                kind=problem.loss_name, l2=l2)
        else:
            slab = design.gather_slab(idx)
            g, h = problem.bundle_grad_hess(z, slab, w_B)
            d = newton_direction(g, h, w_B)
            delta_z = design.slab_matvec(slab, d)
        Delta = delta_decrement(g, h, w_B, d, gamma)
        res = ls(loss, c, z, delta_z, problem.y, w_B, d, Delta, cfg.armijo,
                 l2=l2)
        B.scatter_add(w, idx, res.alpha * d)
        z.add_(res.alpha * delta_z)
        n_steps[t] = res.n_steps
        alpha[t] = res.alpha

    return BundleStep(full_step, n_steps, alpha)


def _step_outputs(n_bundles: int, device) -> tuple[Tensor, Tensor]:
    return (torch.zeros((n_bundles,), dtype=torch.int32, device=device),
            torch.zeros((n_bundles,), dtype=torch.float32, device=device))


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
        b_active = int(b_active)
        step = make_bundle_step(prob, cfg, n_bundles=b_active)
        for t, idx in enumerate(idxs[:b_active].unbind(0)):
            step.update(w, z, idx, t)
        mean_q = torch.sum(step.n_steps, dtype=torch.float32) / \
            max(b_active, 1)
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
