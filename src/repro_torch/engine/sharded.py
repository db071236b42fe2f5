"""Sharded execution backend of the port: the reference's 2-D (data x model)
PCDN (`repro.engine.sharded`) on `torch.distributed`.

Layout, each rank holding its own block only (ranks row-major over the
mesh, `launch.mesh`):

    X : (s, n)  blocks over (data-like axes, "model")  samples x features
    y : (s,)    block over the data-like axes
    z : (s,)    block over the data-like axes           margins, the same
                                                         on every model shard
    w : (n,)    block over "model"                       the same on every
                                                         data shard
    active:(n,) block over "model"                       un-shrunk mask

Each bundle draws P_local = P / n_model features *per model shard* (a
stratified random partition: still a disjoint cover of the features each
outer iteration). Collective schedule a bundle (`Mesh.psum`; a reduction
over axes of size 1 issues nothing):

    1. sum over the data-like axes of [g_part ; h_part]   (2 P_local floats)
    2. sum over "model" of the partial margins X_B d_B   (s_local floats)
       with Delta riding along when fused
    3. ONE sum over all axes of the (Q,) per-candidate Armijo vector (loss
       part pre-divided by n_model, l1 part by n_data)

Both layouts ride the schedule: "dense" holds the (s_l, n_l) block (and,
with `use_kernels`, its feature-major copy for K3), "padded_csc" the
shard's own columns with row ids local to its sample range (k_max the
largest nnz of any (column, data shard) cell, as the reference packs it).

With `use_kernels` the shard-local bundle reductions run in the
hand-written kernels: the g/h partials in `pcdn_direction_partials` (K3,
dense) or `pcdn_sparse_direction_partials` (K2, padded-CSC, also on the
support scope with the support positions as rows), each h partial floored
at 1e-12 as the reference's Pallas kernels floor it; the padded-CSC margin
delta X_B d in `pcdn_sparse_scatter`, whose fixed order keeps a resumed
solve bit-exact. The dense margin delta stays a plain product.

The backend implements the engine contract of `engine.loop`:

    outer(w, z, gen, active, recheck, c, idxs=None, b_active=None)
      -> (w, z, gen, f, kkt, nnz, mean_q, active, n_active) [+ extras]

with w, z and active this rank's blocks. Partitions: the carry's
`torch.Generator` (the same on every rank) gives one seed a step; model
shard m draws its partition from a generator seeded with (seed, m), so
every data shard of a model column draws the same one. `idxs` (this
shard's (b, P_local) array, or a sequence of them indexed by model shard)
replaces the draw, as in `core.pcdn.make_path_outer`. Under shrinking the
trip count is the max over model shards of the local active bundle
counts. `record_aux` appends the (q, alpha) the phase-3 sum makes the same
on every rank; `record_kkt_vec` the violation vector gathered over the
model axis and cut to the real n.

Kept from the reference, not faults of the port: s is padded to a
multiple of the data-shard count with rows of y = 1, z = 0, whose loss
(c log 2 a row for the logistic loss) counts in f; each h partial is
floored before the phase-1 sum; the support scope needs a model axis of
size 1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bundles as B
from repro_torch.core.design_matrix import (DenseDesign, PaddedCSCDesign,
                                            _take_fill)
from repro_torch.core.direction import delta_decrement, newton_direction
from repro_torch.core.linesearch import (ArmijoParams, candidate_alphas,
                                         select_first_satisfying)
from repro_torch.core.losses import HESSIAN_FLOOR, get_loss
from repro_torch.core.pcdn import AUTO_SUPPORT_MARGIN
from repro_torch.engine.loop import EngineState

Tensor = torch.Tensor
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShardedPCDNConfig:
    """The reference's fields and defaults (`repro.engine.sharded`)."""

    P_local: int                   # bundle features per model shard
    c: float
    loss_name: str = "logistic"
    armijo: ArmijoParams = ArmijoParams()
    elastic_net_l2: float = 0.0
    data_axes: Sequence[str] = ("data",)   # ("pod", "data") multi-pod
    model_axis: str = "model"
    seed: int = 0
    # "batched": one sum carries all Q candidates; "backtracking": one
    # scalar sum a candidate (Algorithm 4)
    ls_kind: str = "batched"
    # [g;h] in one collective and [X_B d; Delta] in another; unfused: four
    fuse_collectives: bool = True
    use_kernels: bool = False
    # "support" | "full" | "auto": the support scope needs padded_csc, the
    # batched search and a model axis of size 1
    ls_scope: str = "auto"
    shrink: bool = False
    shrink_tol: float = 0.01
    recheck_every: int = 1
    tol_kkt: float = 1e-3          # un-shrink threshold (keep == stop tol)
    record_aux: bool = False
    record_kkt_vec: bool = False

    @property
    def all_axes(self):
        return tuple(self.data_axes) + (self.model_axis,)


_GOLDEN = 0x9E3779B97F4A7C15


def shard_generator(seed: int, m: int) -> torch.Generator:
    """Model shard m's partition generator for a step's seed."""
    return torch.Generator().manual_seed((int(seed) + m * _GOLDEN) % 2 ** 63)


def draw_step_seed(gen: torch.Generator) -> int:
    """One seed a step from the carry generator (the same on every rank)."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


def make_sharded_outer(cfg: ShardedPCDNConfig, mesh, design, y: Tensor,
                       n_features: Optional[int] = None):
    """The sharded outer iteration over this rank's block: `design` (a
    DenseDesign or PaddedCSCDesign of the (s_l, n_l) block, sentinel s_l)
    and `y` (s_l,). n_features: the real n, to cut the gathered KKT vector
    (default: the padded n)."""
    loss = get_loss(cfg.loss_name)
    kind = cfg.loss_name
    layout = design.layout
    gamma, sigma = cfg.armijo.gamma, cfg.armijo.sigma
    P_local = cfg.P_local
    data_axes = tuple(cfg.data_axes)
    model_axis = cfg.model_axis
    all_axes = cfg.all_axes
    n_model = mesh.size(model_axis)
    n_data = mesh.size(data_axes)
    m_idx = mesh.index(model_axis)
    n_local = design.n_features
    s_l = design.n_samples
    n_pad = n_local * n_model
    n_real = n_pad if n_features is None else int(n_features)
    dev = design.device
    l2 = cfg.elastic_net_l2
    if layout not in ("dense", "padded_csc"):
        raise ValueError(f"unknown layout {layout!r}")
    if cfg.ls_kind not in ("batched", "backtracking"):
        raise ValueError(f"unknown ls_kind {cfg.ls_kind!r}")
    support_ok = (layout == "padded_csc" and cfg.ls_kind == "batched"
                  and n_model == 1)
    if cfg.ls_scope == "support" and not support_ok:
        raise ValueError(
            "ls_scope='support' on the sharded backend requires "
            "layout='padded_csc', ls_kind='batched' and a model axis of "
            f"size 1 (got layout={layout!r}, ls_kind={cfg.ls_kind!r}, "
            f"model={n_model}); with model parallelism a bundle's "
            "row support spans shards and is unknown locally -- use "
            "ls_scope='auto' to fall back to full scope.")
    elif cfg.ls_scope not in ("support", "auto", "full"):
        raise ValueError(f"unknown ls_scope {cfg.ls_scope!r}")
    use_support = layout == "padded_csc" and support_ok and (
        cfg.ls_scope == "support" or
        (cfg.ls_scope == "auto" and
         AUTO_SUPPORT_MARGIN * P_local * design.k_max <= s_l))
    if cfg.use_kernels:
        from repro_torch.kernels import ops as kops
    XT = (design.feature_major() if cfg.use_kernels and layout == "dense"
          else None)
    alphas = candidate_alphas(cfg.armijo, f32, dev)
    inv_model = 1.0 / n_model
    inv_data = 1.0 / n_data

    def direction(g_part: Tensor, h_part: Tensor, w_B: Tensor):
        """Phase 1: [g;h] summed over the data shards, then Eq. 5."""
        if cfg.fuse_collectives:
            gh = mesh.psum(torch.cat([g_part, h_part]), data_axes)
            g, h = gh[:P_local], gh[P_local:]
        else:
            g = mesh.psum(g_part.contiguous(), data_axes)
            h = mesh.psum(h_part.contiguous(), data_axes)
        if l2:
            g = g + l2 * w_B
            h = h + l2
        h = torch.clamp_min(h, HESSIAN_FLOOR)
        return g, h, newton_direction(g, h, w_B)

    def armijo_vector(loss_part: Tensor, w_B: Tensor, d: Tensor,
                      alpha_q) -> Tensor:
        """Phase 3's summand: the loss part over this shard's samples and
        the l1 part over its features, pre-divided so that one sum over all
        axes gives their totals."""
        wq = w_B + alpha_q * d if alpha_q.ndim == 0 else \
            w_B[None, :] + alpha_q[:, None] * d[None, :]
        l1_part = torch.sum(torch.abs(wq), dim=-1) - torch.sum(torch.abs(w_B))
        return loss_part * inv_model + l1_part * inv_data

    def step_support(w: Tensor, z: Tensor, idx: Tensor, c: float):
        """The support-restricted step: phase 1 and phase 3 as in the full
        scope, the per-sample passes over the bundle's local row support;
        the model axis has size 1, so phase 2 carries Delta only."""
        slab = design.gather_slab(idx)
        w_B, _ = B.gather_vec(w, idx)
        support, pos = design.slab_row_support(slab)
        z_R = _take_fill(z, support, 0.0)
        y_R = _take_fill(y, support, 1.0)
        if cfg.use_kernels:
            g_part, h_part = kops.pcdn_sparse_direction_partials(
                pos, slab.vals, z_R, y_R, c, kind=kind)
        else:
            g_part, h_part = design.slab_grad_hess_support(
                slab, pos, c * loss.dz(z_R, y_R), c * loss.d2z(z_R, y_R))
        g, h, d = direction(g_part, h_part, w_B)
        Delta = mesh.psum(delta_decrement(g, h, w_B, d, gamma).reshape(1),
                          model_axis)[0]
        delta_R = (kops.pcdn_sparse_scatter(pos, slab.vals, d, z_R.shape[0])
                   if cfg.use_kernels
                   else design.slab_matvec_support(slab, pos, d))
        zq = z_R[None, :] + alphas[:, None] * delta_R[None, :]
        loss_part = c * torch.sum(loss.value(zq, y_R[None, :]) -
                                  loss.value(z_R, y_R)[None, :], dim=-1)
        f_deltas = mesh.psum(armijo_vector(loss_part, w_B, d, alphas),
                             all_axes)
        res = select_first_satisfying(f_deltas, alphas, Delta, sigma)
        B.scatter_add(w, idx, res.alpha * d)
        design.scatter_support(z, support, res.alpha * delta_R)
        return res.n_steps, res.alpha

    def step_full(w: Tensor, z: Tensor, idx: Tensor, c: float):
        w_B, _ = B.gather_vec(w, idx)
        slab = None
        if cfg.use_kernels and layout == "dense":
            g_part, h_part = kops.pcdn_direction_partials(XT, idx, z, y, c,
                                                          kind=kind)
        else:
            slab = design.gather_slab(idx)
            if cfg.use_kernels:
                g_part, h_part = kops.pcdn_sparse_direction_partials(
                    slab.rows, slab.vals, z, y, c, kind=kind)
            else:
                g_part, h_part = design.slab_grad_hess(
                    slab, c * loss.dz(z, y), c * loss.d2z(z, y))
        g, h, d = direction(g_part, h_part, w_B)
        Delta_part = delta_decrement(g, h, w_B, d, gamma)
        if XT is not None:
            # the dense phase-2 product over the feature-major block (a
            # sentinel's row is a real column's, times d = 0)
            dz_part = d @ XT.index_select(
                0, idx.clamp(max=n_local - 1)).to(f32)
        elif cfg.use_kernels:
            dz_part = kops.pcdn_sparse_scatter(slab.rows, slab.vals, d, s_l)
        else:
            dz_part = design.slab_matvec(slab, d)
        if cfg.fuse_collectives:
            packed = mesh.psum(torch.cat([dz_part, Delta_part.reshape(1)]),
                               model_axis)
            delta_z, Delta = packed[:-1], packed[-1]
        else:
            delta_z = mesh.psum(dz_part.contiguous(), model_axis)
            Delta = mesh.psum(Delta_part.reshape(1), model_axis)[0]
        if cfg.ls_kind == "batched":
            zq = z[None, :] + alphas[:, None] * delta_z[None, :]
            loss_part = c * torch.sum(loss.value(zq, y[None, :]) -
                                      loss.value(z, y)[None, :], dim=-1)
            f_deltas = mesh.psum(armijo_vector(loss_part, w_B, d, alphas),
                                 all_axes)
            res = select_first_satisfying(f_deltas, alphas, Delta, sigma)
            alpha, n_steps = res.alpha, res.n_steps
        else:
            # Algorithm 4: one scalar sum over all axes a candidate
            f_base = c * torch.sum(loss.value(z, y))
            q, a, ok = 0, 1.0, False
            while not ok and q < cfg.armijo.max_steps:
                a_t = torch.tensor(a, dtype=f32, device=dev)
                lo = c * torch.sum(loss.value(z + a_t * delta_z, y)) - f_base
                fd = mesh.psum(armijo_vector(lo, w_B, d, a_t).reshape(1),
                               all_axes)
                ok = bool(fd[0] <= sigma * a * Delta)
                q += 1
                if not ok:
                    a *= cfg.armijo.beta
            alpha = torch.tensor(a if ok else 0.0, dtype=f32, device=dev)
            n_steps = q
        B.scatter_add(w, idx, alpha * d)
        z.add_(alpha * delta_z)
        return n_steps, alpha

    step = step_support if use_support else step_full

    def outer(w: Tensor, z: Tensor, gen: torch.Generator, active: Tensor,
              recheck: bool, c, idxs=None, b_active: Optional[int] = None):
        c = float(c)
        w = w.clone()
        z = z.clone()
        if idxs is None:
            gen_m = shard_generator(draw_step_seed(gen), m_idx)
            if cfg.shrink:
                idxs, b_active = B.partition_active(gen_m, active, P_local)
            else:
                idxs = B.partition(gen_m, n_local, P_local, device=dev)
        elif isinstance(idxs, (list, tuple)):
            idxs = idxs[m_idx]
        if not isinstance(idxs, Tensor):
            idxs = torch.tensor(np.asarray(idxs, np.int32))
        idxs = idxs.to(dtype=torch.int32, device=dev)
        if cfg.shrink:
            if b_active is None:
                b_active = -(-int(active.sum()) // P_local)
            # every model shard runs the same number of collectives;
            # shards with fewer active bundles run sentinel-only ones
            trip = int(mesh.pmax(torch.tensor([int(b_active)],
                                              dtype=torch.int32, device=dev),
                                 model_axis)[0])
        else:
            trip = idxs.shape[0]
        q_out = torch.zeros((trip,), dtype=torch.int32, device=dev)
        a_out = torch.zeros((trip,), dtype=f32, device=dev)
        for t in range(trip):
            q, a = step(w, z, idxs[t], c)
            q_out[t] = q
            a_out[t] = a
        mean_q = torch.sum(q_out, dtype=f32) / max(trip, 1)
        # diagnostics: the objective and the full-set KKT violation
        f = mesh.psum((c * torch.sum(loss.value(z, y))).reshape(1),
                      data_axes)
        f = f + mesh.psum(torch.sum(torch.abs(w)).reshape(1), model_axis)
        if l2:
            f = f + 0.5 * l2 * mesh.psum(
                torch.sum(torch.square(w)).reshape(1), model_axis)
        g_full = mesh.psum(design.rmatvec(c * loss.dz(z, y)).contiguous(),
                           data_axes)
        if l2:
            g_full = g_full + l2 * w
        viol = torch.abs(torch.where(
            w > 0, g_full + 1.0,
            torch.where(w < 0, g_full - 1.0,
                        torch.clamp_min(torch.abs(g_full) - 1.0, 0.0))))
        kkt = mesh.pmax(torch.max(viol).reshape(1), all_axes)[0]
        if cfg.shrink:
            interior = (w == 0) & (torch.abs(g_full) < 1.0 - cfg.shrink_tol)
            active = active & ~interior
            if recheck:
                active = active | (viol > cfg.tol_kkt)
        nnz = mesh.psum(torch.sum(w != 0, dtype=torch.int32).reshape(1),
                        model_axis)[0]
        n_active = mesh.psum(torch.sum(active, dtype=torch.int32).reshape(1),
                             model_axis)[0]
        out = (w, z, gen, f[0], kkt, nnz, mean_q, active, n_active)
        if cfg.record_aux:
            b_max = idxs.shape[0]
            if trip < b_max:
                # sentinel slots: bundles past the trip count never ran
                q_out = torch.cat([q_out, q_out.new_full((b_max - trip,),
                                                         -1)])
                a_out = torch.cat([a_out, a_out.new_full(
                    (b_max - trip,), float("nan"))])
            out = out + ((q_out, a_out),)
        if cfg.record_kkt_vec:
            out = out + (gather_model(mesh, model_axis, viol,
                                      n_pad)[:n_real],)
        return out

    outer.use_support = use_support
    return outer


def gather_model(mesh, model_axis: str, block: Tensor, n_pad: int) -> Tensor:
    """The (n_pad,) vector whose model-shard blocks are `block`: each shard
    writes its block into zeros and the model axis sums them (exact: one
    nonzero term an element)."""
    n_l = block.shape[0]
    m = mesh.index(model_axis)
    full = torch.zeros((n_pad,), dtype=block.dtype, device=block.device)
    full[m * n_l:(m + 1) * n_l] = block
    return mesh.psum(full, model_axis)


def gather_data(mesh, data_axes, block: Tensor, s_pad: int) -> Tensor:
    """The (s_pad,) vector whose data-shard blocks are `block`."""
    s_l = block.shape[0]
    di = mesh.index(data_axes)
    full = torch.zeros((s_pad,), dtype=block.dtype, device=block.device)
    full[di * s_l:(di + 1) * s_l] = block
    return mesh.psum(full, data_axes)


def make_sharded_margins(cfg: ShardedPCDNConfig, mesh, design):
    """z = X w on the mesh: fn(w_l) -> z_l, the shard's margins summed over
    the model axis (the warm-start refresh between path points)."""
    def margins(w_l: Tensor) -> Tensor:
        return mesh.psum(design.matvec(w_l).contiguous(), cfg.model_axis)
    return margins


def _is_csr_like(X) -> bool:
    return all(hasattr(X, a) for a in ("data", "indices", "indptr", "shape"))


def _as_host(X):
    """Dense arrays and CSR-like triples as they are; a padded-CSC host
    object (`data.PaddedCSC`) as its CSR image."""
    if not _is_csr_like(X) and hasattr(X, "to_csr") and \
            hasattr(X, "col_rows"):
        return X.to_csr()
    return X


def _coo(X):
    """(rows, cols, vals) of the nonzeros, rows ascending (CSR order)."""
    if _is_csr_like(X):
        s = int(X.shape[0])
        return (np.repeat(np.arange(s, dtype=np.int64),
                          np.diff(np.asarray(X.indptr))),
                np.asarray(X.indices, dtype=np.int64),
                np.asarray(X.data, dtype=np.float32))
    X = np.asarray(X)
    rows, cols = np.nonzero(X)
    return rows, cols, X[rows, cols].astype(np.float32)


def host_c_max(X, y, loss_name: str) -> float:
    """The analytic path start 1 / ||X^T phi'(0, y)||_inf from the host data
    (one rmatvec; the reference's `_host_c_max`)."""
    loss = get_loss(loss_name)
    s, n = int(X.shape[0]), int(X.shape[1])
    u0 = loss.dz(torch.zeros((s,), dtype=f32),
                 torch.as_tensor(np.asarray(y, np.float32))).numpy()
    if _is_csr_like(X):
        rows, cols, vals = _coo(X)
        g0 = np.zeros((n,), np.float32)
        np.add.at(g0, cols, vals * u0[rows])
    else:
        g0 = np.asarray(X, np.float32).T @ u0
    denom = float(np.max(np.abs(g0)))
    if denom <= 0.0:
        raise ValueError("degenerate problem: X^T phi'(0, y) == 0 "
                         "(no feature correlates with the labels)")
    return 1.0 / denom


def _sizes(s: int, n: int, mesh, cfg: ShardedPCDNConfig):
    d_sz = mesh.size(cfg.data_axes)
    m_sz = mesh.size(cfg.model_axis)
    s_pad = s + (-s) % d_sz
    n_pad = n + (-n) % m_sz
    return d_sz, m_sz, s_pad, n_pad, s_pad // d_sz, n_pad // m_sz


def shard_problem(X, y, mesh, cfg: ShardedPCDNConfig):
    """This rank's dense block: (X_l (s_l, n_l), y_l (s_l,)) on its device,
    zero-padded rows with y = 1 and zero-padded columns; (w, z) zeros."""
    X = np.asarray(X)
    s, n = X.shape
    _, _, s_pad, n_pad, s_l, n_l = _sizes(s, n, mesh, cfg)
    di, mi = mesh.index(cfg.data_axes), mesh.index(cfg.model_axis)
    r0, c0 = di * s_l, mi * n_l
    block = np.zeros((s_l, n_l), np.float32)
    sub = X[r0:min(r0 + s_l, s), c0:min(c0 + n_l, n)]
    block[:sub.shape[0], :sub.shape[1]] = sub
    dev = mesh.device
    y_l = _y_block(y, s, s_pad, r0, s_l)
    return (torch.as_tensor(block, device=dev),
            torch.as_tensor(y_l, device=dev),
            torch.zeros((n_l,), dtype=f32, device=dev),
            torch.zeros((s_l,), dtype=f32, device=dev))


def _y_block(y, s: int, s_pad: int, r0: int, s_l: int) -> np.ndarray:
    y_full = np.ones((s_pad,), np.float32)   # padded rows: no gradient
    y_full[:s] = np.asarray(y, np.float32)
    return y_full[r0:r0 + s_l]


def shard_problem_sparse(X, y, mesh, cfg: ShardedPCDNConfig,
                         k_max: Optional[int] = None):
    """This rank's padded-CSC block: (col_rows (n_l, k), col_vals (n_l, k),
    y_l, w, z) on its device, row ids local to the shard's sample range and
    sentinel s_l; k = the largest nnz of any (column, data shard) cell over
    the whole design (the reference's packing), or `k_max`. X: dense or
    CSR-like; never densified."""
    X = _as_host(X)
    s, n = int(X.shape[0]), int(X.shape[1])
    d_sz, _, s_pad, n_pad, s_l, n_l = _sizes(s, n, mesh, cfg)
    rows, cols, vals = _coo(X)
    di_all = rows // s_l
    counts = np.bincount(cols * d_sz + di_all, minlength=n_pad * d_sz)
    k = int(max(1, counts.max() if counts.size else 1))
    if k_max is not None:
        if k > int(k_max):
            raise ValueError(f"k_max={k_max} < max (column, shard) nnz {k}")
        k = int(k_max)
    di, mi = mesh.index(cfg.data_axes), mesh.index(cfg.model_axis)
    mine = (di_all == di) & (cols // n_l == mi)
    lc = cols[mine] - mi * n_l
    order = np.argsort(lc, kind="stable")       # CSR order within a column
    lc, lr, lv = lc[order], (rows[mine] % s_l)[order], vals[mine][order]
    start = np.concatenate([[0], np.cumsum(np.bincount(lc, minlength=n_l))])
    pos = np.arange(lc.shape[0], dtype=np.int64) - start[lc]
    col_rows = np.full((n_l, k), s_l, np.int32)
    col_vals = np.zeros((n_l, k), np.float32)
    col_rows[lc, pos] = lr
    col_vals[lc, pos] = lv
    dev = mesh.device
    return (torch.as_tensor(col_rows, device=dev),
            torch.as_tensor(col_vals, device=dev),
            torch.as_tensor(_y_block(y, s, s_pad, di * s_l, s_l), device=dev),
            torch.zeros((n_l,), dtype=f32, device=dev),
            torch.zeros((s_l,), dtype=f32, device=dev))


class ShardedBackend:
    """Engine execution backend over a `launch.mesh.Mesh`.

    Each rank places its own block of (X, y) on its device at construction
    (never the whole design), builds the outer iteration and the margins
    program once, and then serves any number of solves and path points.
    Padding of n (to a multiple of the model-axis size) and of s (of the
    data-shard count) is internal: `n_features`, `n_samples`,
    `host_weights`, `host_margins` and `host_active` speak the real sizes,
    and `restore_state` takes unpadded host arrays (a `fault.checkpoint`
    snapshot written by either backend of either package).
    """

    def __init__(self, X, y, mesh, cfg: ShardedPCDNConfig,
                 layout: str = "auto", k_max: Optional[int] = None):
        X = _as_host(X)
        is_csr = _is_csr_like(X)
        if layout == "auto":
            layout = "padded_csc" if is_csr else "dense"
        if layout == "dense" and is_csr:
            raise ValueError("CSR input with layout='dense' would densify")
        if layout not in ("dense", "padded_csc"):
            raise ValueError(f"unknown layout {layout!r}")
        self.mesh = mesh
        self.cfg = cfg
        self.layout = layout
        self._n = int(X.shape[1])
        self._s = int(X.shape[0])
        self._c_max = host_c_max(X, y, cfg.loss_name)
        (_, _, self.s_pad, self.n_pad, self.s_local,
         self.n_local) = _sizes(self._s, self._n, mesh, cfg)
        if layout == "dense":
            X_l, self._y, _, _ = shard_problem(X, y, mesh, cfg)
            self.design = DenseDesign(X=X_l)
        else:
            rows_l, vals_l, self._y, _, _ = shard_problem_sparse(
                X, y, mesh, cfg, k_max=k_max)
            self.design = PaddedCSCDesign(rows_l, vals_l, self.s_local)
        self.outer = make_sharded_outer(cfg, mesh, self.design, self._y,
                                        n_features=self._n)
        self._margins_fn = make_sharded_margins(cfg, mesh, self.design)

    @property
    def n_features(self) -> int:
        return self._n

    @property
    def n_samples(self) -> int:
        return self._s

    @property
    def dtype(self):
        return f32

    @property
    def device(self):
        return self.mesh.device

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints, reports and telemetry files."""
        return self.mesh.rank == 0

    def _w_block(self, w) -> Tensor:
        wf = np.zeros((self.n_pad,), np.float32)
        w = np.asarray(w, np.float32).reshape(-1)
        if w.shape[0] != self._n:
            raise ValueError(f"checkpoint has {w.shape[0]} features, "
                             f"problem has {self._n}")
        wf[:self._n] = w
        m0 = self.mesh.index(self.cfg.model_axis) * self.n_local
        return torch.tensor(wf[m0:m0 + self.n_local], device=self.device)

    def init_state(self, w0=None) -> EngineState:
        if w0 is None:
            w = torch.zeros((self.n_local,), dtype=f32, device=self.device)
            z = torch.zeros((self.s_local,), dtype=f32, device=self.device)
        else:
            w = self._w_block(w0)
            z = self.margins(w)
        return EngineState(
            w=w, z=z, gen=torch.Generator().manual_seed(self.cfg.seed),
            active=torch.ones((self.n_local,), dtype=torch.bool,
                              device=self.device))

    def margins(self, w: Tensor) -> Tensor:
        return self._margins_fn(w)

    def c_max(self) -> float:
        return self._c_max

    def host_weights(self, w: Tensor) -> np.ndarray:
        """The full (n,) weights on every rank (a sum over the model axis)."""
        return gather_model(self.mesh, self.cfg.model_axis, w,
                            self.n_pad)[:self._n].cpu().numpy()

    def host_margins(self, z: Tensor) -> np.ndarray:
        """The full (n_samples,) margins, sample padding stripped: the
        mesh-agnostic checkpoint image of z."""
        return gather_data(self.mesh, self.cfg.data_axes, z,
                           self.s_pad)[:self._s].cpu().numpy()

    def host_active(self, active: Tensor) -> np.ndarray:
        return gather_model(self.mesh, self.cfg.model_axis,
                            active.to(torch.int32),
                            self.n_pad)[:self._n].cpu().numpy().astype(bool)

    def restore_state(self, w, z=None, active=None, key=None,
                      gen_state=None) -> EngineState:
        """EngineState from UNPADDED host arrays (a checkpoint written by
        either backend, under any mesh): each rank takes its blocks; padded
        sample rows get z = 0, as the margins of zero rows are, so a
        restored carry equals a recomputed one. `key` (the reference's PRNG
        key) is accepted and unused; `gen_state` restores the generator,
        else it is seeded from cfg.seed."""
        del key
        w_d = self._w_block(w)
        if active is None:
            act_d = torch.ones((self.n_local,), dtype=torch.bool,
                               device=self.device)
        else:
            af = np.zeros((self.n_pad,), bool)
            af[:self._n] = np.asarray(active).reshape(self._n).astype(bool)
            m0 = self.mesh.index(self.cfg.model_axis) * self.n_local
            act_d = torch.tensor(af[m0:m0 + self.n_local],
                                 device=self.device)
        if z is None:
            z_d = self.margins(w_d)
        else:
            zf = np.zeros((self.s_pad,), np.float32)
            zf[:self._s] = np.asarray(z, np.float32).reshape(self._s)
            r0 = self.mesh.index(self.cfg.data_axes) * self.s_local
            z_d = torch.tensor(zf[r0:r0 + self.s_local], device=self.device)
        gen = torch.Generator().manual_seed(self.cfg.seed)
        if gen_state is not None:
            gen.set_state(gen_state)
        return EngineState(w=w_d, z=z_d, gen=gen, active=act_d)
