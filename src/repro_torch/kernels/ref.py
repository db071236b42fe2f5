"""Plain PyTorch versions of the port's kernels (K1-K6).

Ports of `repro.kernels.ref`'s oracles. Each computes, in float32, exactly
what its CUDA kernel computes (kernels/csrc/*.cu):

  * `pcdn_direction_ref`        -- K3, dense bundle with the slab gather,
                                   the loss factors and the margin delta
                                   -> (d, g, h, delta)
  * `pcdn_sparse_direction_ref` -- K2, padded-CSC slab with the loss
                                   factors and the margin scatter
                                   -> (d, g, h, delta)
  * `pcdn_direction_partials_ref`, `pcdn_sparse_direction_partials_ref`
                                -- K3's and K2's partials entries: a
                                   shard's raw g and floored h -> (g, h)
  * `pcdn_sparse_scatter_ref`   -- K2's scatter entry: X_B d for a given
                                   d -> delta
  * `pcdn_bundle_step_ref`      -- K1, the whole support-restricted bundle
                                   step: w, z updated in place
                                   -> (n_steps, alpha); built on
  * `pcdn_bundle_ref`           -- the per-bundle math on a gathered
                                   support -> (upd_w, upd_z, alpha, n_steps)
  * `serve_margins_dense_ref`   -- K4a, serving margins over a dense
                                   request slab -> (B, K)
  * `serve_margins_csc_ref`     -- K4b, serving margins over a padded-CSC
                                   request batch -> (B, K)
  * `pcdn_linesearch_ref`       -- K5, the Q candidates' loss deltas (Q,),
                                   or (P, Q) for P rows of deltas
  * `scdn_batch_ref`            -- K5's batch entry, one whole SCDN batch
                                   on the padded-CSC layout: w, z updated
                                   in place -> (alpha, loss_deltas)
  * `attention_ref`             -- K6, dense softmax attention (the flash
                                   kernel's function)

`kernels.ops` takes them for tensors on the CPU; the tests hold them
against the reference, and `chip_smoke.py` holds the kernels against them
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import bundles as B
from repro_torch.core.design_matrix import PaddedCSCDesign, _take_fill
from repro_torch.core.direction import newton_direction
from repro_torch.core.losses import HESSIAN_FLOOR, get_loss

Tensor = torch.Tensor
f32 = torch.float32


def pcdn_direction_ref(XT: Tensor, idx: Tensor, z: Tensor, y: Tensor,
                       w_B: Tensor, c, kind: str = "logistic",
                       l2: float = 0.0):
    """(d, g, h, delta) for a dense bundle, as the reference's dense full
    step composes it: the slab gather (a take of the bundle's columns,
    sentinel idx >= n zeroed; here rows of the feature-major XT (n, s)),
    the loss factors u, v = c phi'(z), c phi''(z), g/h over the slab, Eq.
    5, and delta = X_B d of length s."""
    loss = get_loss(kind)
    n = XT.shape[0]
    valid = idx < n
    XB = XT[idx.clamp(max=n - 1).long()].to(f32) * \
        valid[:, None].to(f32)                                    # (P, s)
    z = z.to(f32)
    y = y.to(f32)
    c = float(c)
    u = c * loss.dz(z, y)
    v = c * loss.d2z(z, y)
    g = XB @ u + l2 * w_B
    h = torch.clamp_min(torch.square(XB) @ v + l2, HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B.to(f32))
    return d, g, h, d @ XB


def pcdn_sparse_direction_ref(rows: Tensor, vals: Tensor, z: Tensor,
                              y: Tensor, w_B: Tensor, c,
                              kind: str = "logistic", l2: float = 0.0):
    """(d, g, h, delta) for a padded-CSC slab: the loss factors u, v =
    c phi'(z), c phi''(z), then g/h over the slab (rows == len(z), the
    sentinel, add 0), Eq. 5, and delta = X_B d of length len(z) by an
    index_add at the slab's rows."""
    loss = get_loss(kind)
    z = z.to(f32)
    y = y.to(f32)
    c = float(c)
    u = c * loss.dz(z, y)
    v = c * loss.d2z(z, y)
    vals = vals.to(f32)
    s = z.shape[0]
    valid = (rows >= 0) & (rows < s)
    safe = rows.clamp(0, s - 1)
    zero = torch.zeros((), dtype=f32, device=z.device)
    ug = torch.where(valid, u[safe], zero)
    vg = torch.where(valid, v[safe], zero)
    g = torch.sum(ug * vals, dim=1) + l2 * w_B
    h = torch.clamp_min(torch.sum(vg * torch.square(vals), dim=1) + l2,
                        HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B.to(f32))
    delta = torch.zeros((s + 1,), dtype=f32, device=z.device)
    delta.index_add_(0, torch.where(valid, rows, s).reshape(-1).long(),
                     (vals * d[:, None]).reshape(-1))
    return d, g, h, delta[:s]


def pcdn_direction_partials_ref(XT: Tensor, idx: Tensor, z: Tensor,
                                y: Tensor, c, kind: str = "logistic"):
    """(g, h) of a dense bundle on one shard, as the reference's sharded
    backend takes them from its Pallas K3 with l2 = 0: the slab gather
    (sentinel idx >= n zeroed), u, v = c phi'(z), c phi''(z), g = X_B^T u
    and h = max((X_B^2)^T v, 1e-12)."""
    loss = get_loss(kind)
    n = XT.shape[0]
    valid = idx < n
    XB = XT[idx.clamp(max=n - 1).long()].to(f32) * \
        valid[:, None].to(f32)                                    # (P, s)
    z = z.to(f32)
    y = y.to(f32)
    c = float(c)
    u = c * loss.dz(z, y)
    v = c * loss.d2z(z, y)
    return XB @ u, torch.clamp_min(torch.square(XB) @ v, HESSIAN_FLOOR)


def pcdn_sparse_direction_partials_ref(rows: Tensor, vals: Tensor,
                                       z: Tensor, y: Tensor, c,
                                       kind: str = "logistic"):
    """(g, h) of a padded-CSC slab on one shard (rows == len(z), the
    sentinel, add 0), as the reference's sharded backend takes them from
    its Pallas K2 with l2 = 0: g raw, h floored at 1e-12."""
    loss = get_loss(kind)
    z = z.to(f32)
    y = y.to(f32)
    c = float(c)
    u = c * loss.dz(z, y)
    v = c * loss.d2z(z, y)
    vals = vals.to(f32)
    s = z.shape[0]
    valid = (rows >= 0) & (rows < s)
    safe = rows.clamp(0, s - 1).long()
    zero = torch.zeros((), dtype=f32, device=z.device)
    ug = torch.where(valid, u[safe], zero)
    vg = torch.where(valid, v[safe], zero)
    return (torch.sum(ug * vals, dim=1),
            torch.clamp_min(torch.sum(vg * torch.square(vals), dim=1),
                            HESSIAN_FLOOR))


def pcdn_sparse_scatter_ref(rows: Tensor, vals: Tensor, d: Tensor,
                            n_rows: int) -> Tensor:
    """delta = X_B d of length n_rows over a padded-CSC slab: an index_add
    of vals * d at the slab's rows (rows outside [0, n_rows) dropped), on
    the CPU in entry order."""
    m = int(n_rows)
    valid = (rows >= 0) & (rows < m)
    delta = torch.zeros((m + 1,), dtype=f32, device=d.device)
    delta.index_add_(0, torch.where(valid, rows, m).reshape(-1).long(),
                     (vals.to(f32) * d.to(f32)[:, None]).reshape(-1))
    return delta[:m]


def pcdn_bundle_ref(vals: Tensor, pos: Tensor, z_R: Tensor, y_R: Tensor,
                    w_B: Tensor, alphas: Tensor, c,
                    kind: str = "logistic", l2: float = 0.0,
                    sigma: float = 0.01, gamma: float = 0.0):
    """The fused support-restricted bundle step, unfused: support factors
    -> g/h -> Eq. 5 d -> Delta -> support margin delta -> batched Armijo.
    Returns (upd_w, upd_z, alpha, n_steps) with upd_* scaled by alpha;
    when no candidate passes alpha = 0 and n_steps = 1."""
    loss = get_loss(kind)
    z_R = z_R.to(f32)
    y_R = y_R.to(f32)
    vals = vals.to(f32)
    w_B = w_B.to(f32)
    c = float(c)
    u_R = c * loss.dz(z_R, y_R)
    v_R = c * loss.d2z(z_R, y_R)
    g = torch.sum(u_R[pos] * vals, dim=1) + l2 * w_B
    h = torch.clamp_min(torch.sum(v_R[pos] * torch.square(vals), dim=1) + l2,
                        HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B)
    Delta = (torch.sum(g * d) + gamma * torch.sum(h * torch.square(d)) +
             torch.sum(torch.abs(w_B + d)) - torch.sum(torch.abs(w_B)))
    delta_R = torch.zeros_like(z_R)
    delta_R.index_add_(0, pos.reshape(-1), (vals * d[:, None]).reshape(-1))
    alphas = alphas.to(f32)
    zq = z_R[None, :] + alphas[:, None] * delta_R[None, :]
    lo = c * torch.sum(loss.value(zq, y_R[None, :]) -
                       loss.value(z_R, y_R)[None, :], dim=1)
    wq = w_B[None, :] + alphas[:, None] * d[None, :]
    f_deltas = lo + torch.sum(torch.abs(wq), dim=1) - \
        torch.sum(torch.abs(w_B))
    if l2:
        f_deltas = f_deltas + 0.5 * l2 * (
            torch.sum(torch.square(wq), dim=1) - torch.sum(torch.square(w_B)))
    ok = f_deltas <= sigma * alphas * Delta
    first = torch.argmax(ok.to(torch.int32))
    alpha = torch.where(torch.any(ok), alphas[first],
                        torch.zeros((), dtype=f32, device=alphas.device))
    return alpha * d, alpha * delta_R, alpha, (first + 1).to(torch.int32)


def pcdn_bundle_step_ref(col_rows: Tensor, col_vals: Tensor, idx: Tensor,
                         z: Tensor, y: Tensor, w: Tensor, alphas: Tensor, c,
                         kind: str = "logistic", l2: float = 0.0,
                         sigma: float = 0.01, gamma: float = 0.0):
    """K1's whole function, as the plain support step composes it: gather
    the bundle's slab and w_B, build its sorted row support, gather z and
    y there, run `pcdn_bundle_ref`, then scatter the updates into w and z
    IN PLACE. col_rows/col_vals (n, K) with sentinel len(z) at padding, idx
    (P,) with sentinel n. Returns (n_steps, alpha) as 0-d tensors."""
    design = PaddedCSCDesign(col_rows, col_vals, z.shape[0])
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    support, pos = design.slab_row_support(slab)
    z_R = _take_fill(z, support, 0.0)
    y_R = _take_fill(y, support, 1.0)
    upd_w, upd_z, alpha, n_steps = pcdn_bundle_ref(
        slab.vals, pos, z_R, y_R, w_B, alphas, c, kind=kind, l2=l2,
        sigma=sigma, gamma=gamma)
    B.scatter_add(w, idx, upd_w)
    design.scatter_support(z, support, upd_z)
    return n_steps, alpha


def pcdn_linesearch_ref(z: Tensor, delta: Tensor, y: Tensor, alphas: Tensor,
                        kind: str = "logistic") -> Tensor:
    """Per-candidate loss deltas sum_i phi(z + a*delta) - phi(z): (Q,) for
    delta (s,), (P, Q) for delta (P, s) (a row each, as `jax.vmap` of the
    reference's oracle over delta's leading axis gives)."""
    loss = get_loss(kind)
    z = z.to(f32)
    y = y.to(f32)
    zq = z + alphas.to(f32)[:, None] * delta.to(f32)[..., None, :]
    return torch.sum(loss.value(zq, y) - loss.value(z, y), dim=-1)


def scdn_batch_ref(col_rows: Tensor, col_vals: Tensor, idx: Tensor,
                   w: Tensor, z: Tensor, y: Tensor, alphas: Tensor, c,
                   kind: str = "logistic", sigma: float = 0.01,
                   gamma: float = 0.0, l2: float = 0.0):
    """K5's batch entry: one SCDN batch of P racing one-coordinate steps on
    the padded-CSC layout, w and z updated IN PLACE -> (alpha (P,),
    loss_deltas (P, Q)).

    For each slot p, j = idx[p] (duplicates allowed, sentinel n adds
    nothing): g_p, h_p over the column's entries (the l2 fold, the
    Hessian floor), d_p by Eq. 5 and Delta_p = g d + gamma h d^2 +
    |w_j + d| - |w_j|. The column's duplicate rows are merged first:
    delta_pr = d_p * sum_{k: r_pk = r} x_pk (x summed in k order) over
    its distinct rows r, and

        loss_deltas[p, q] = sum_r phi(z_r + alpha_q delta_pr) - phi(z_r)
        L_pq = c loss_deltas[p, q] + |w_j + alpha_q d_p| - |w_j|

    alpha_p is the first alpha_q with L_pq <= sigma alpha_q Delta_p, else
    0. Only then, every slot having read the same w and z: w[j] +=
    alpha_p d_p and z[r_pk] += x_pk alpha_p d_p for every entry (every
    duplicate adds). `l2` folds into g and h only, as in the reference's
    batch, whose searches have no l2 term."""
    loss = get_loss(kind)
    s = z.shape[0]
    P = idx.shape[0]
    design = PaddedCSCDesign(col_rows, col_vals, s)
    slab = design.gather_slab(idx)
    vals = slab.vals.to(f32)
    w_B, _ = B.gather_vec(w, idx)
    c = float(c)
    valid = (slab.rows >= 0) & (slab.rows < s)
    safe = slab.rows.clamp(0, s - 1).long()
    zero = torch.zeros((), dtype=f32, device=z.device)
    u = torch.where(valid, c * loss.dz(z[safe], y[safe]), zero)
    v = torch.where(valid, c * loss.d2z(z[safe], y[safe]), zero)
    g = torch.sum(u * vals, dim=1)
    h = torch.sum(v * torch.square(vals), dim=1)
    if l2:
        g = g + l2 * w_B
        h = h + l2
    h = torch.clamp_min(h, HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B)
    Delta = g * d + gamma * (h * torch.square(d)) + \
        (torch.abs(w_B + d) - torch.abs(w_B))
    # each slot's distinct rows: (slot, row) keys, sorted; index_add_ sums
    # a key's entries in entry order
    slot = torch.arange(P, device=z.device)[:, None].expand_as(slab.rows)
    keys = (slot * s + safe)[valid]
    uniq, inv = torch.unique(keys, return_inverse=True)
    xs = torch.zeros(uniq.shape, dtype=f32, device=z.device)
    xs.index_add_(0, inv, vals[valid])
    p_of, r_of = uniq // s, uniq % s
    delta = d[p_of] * xs
    alphas = alphas.to(f32)
    z_r, y_r = z[r_of].to(f32), y[r_of].to(f32)
    terms = loss.value(z_r[:, None] + alphas[None, :] * delta[:, None],
                       y_r[:, None]) - loss.value(z_r, y_r)[:, None]
    lo = torch.zeros((P, alphas.shape[0]), dtype=f32, device=z.device)
    lo.index_add_(0, p_of, terms)
    wq = w_B[:, None] + alphas[None, :] * d[:, None]
    out = c * lo + (torch.abs(wq) - torch.abs(w_B)[:, None])
    ok = out <= sigma * alphas[None, :] * Delta[:, None]
    first = torch.argmax(ok.to(torch.int32), dim=1)
    alpha = torch.where(torch.any(ok, dim=1), alphas[first], zero)
    upd = alpha * d
    B.scatter_add(w, idx, upd)
    z.add_(design.slab_matvec(slab, upd))
    return alpha, lo


def serve_margins_dense_ref(X: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """(B, K) serving margins over a dense request slab: for each model k,
    gather only its active columns of X (sentinel idx >= n gathers 0) and
    contract with the active values."""
    n = X.shape[1]
    xg = X.to(f32)[:, idx.clamp(max=n - 1)]                  # (B, K, A)
    xg = torch.where(idx < n, xg, torch.zeros((), dtype=f32, device=X.device))
    return torch.einsum("bka,ka->bk", xg, val.to(f32))


def serve_margins_csc_ref(col_rows: Tensor, col_vals: Tensor, idx: Tensor,
                          val: Tensor, n_requests: int) -> Tensor:
    """(B, K) serving margins over a padded-CSC request batch: gather each
    model's active columns of the request matrix, scale, scatter-add over
    request rows. Model padding (idx >= n) and request padding (row id
    >= n_requests) land in a last slot that is cut off."""
    n = col_rows.shape[0]
    K = idx.shape[0]
    B = int(n_requests)
    live = (idx < n)[:, :, None]                               # (K, A, 1)
    safe = idx.clamp(max=n - 1).long()
    rows = col_rows[safe].long()                               # (K, A, k)
    rows = torch.where(live & (rows >= 0) & (rows < B), rows, B)
    contrib = col_vals.to(f32)[safe] * val.to(f32)[:, :, None]
    # model k scatters into its own (B + 1)-slot segment
    flat = rows + (B + 1) * torch.arange(K, device=rows.device)[:, None,
                                                                 None]
    z = torch.zeros((K * (B + 1),), dtype=f32, device=col_vals.device)
    z.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    return z.view(K, B + 1)[:, :B].T


def attention_ref(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                  sm_scale: float | None = None) -> Tensor:
    """Dense softmax attention in float32, output in q's dtype.

    The model's layout, q (B, Sq, H, D) with k/v (B, Skv, Kv, D), query
    head h reading kv head h // (H / Kv); or q (BH, Sq, D) with k/v
    (BH / G, Skv, D), query head bh reading kv head bh // G (G = 1 is
    `repro.kernels.ref.attention_ref`'s contract), taken as a view of the
    first with B = BH / G and Kv = 1. Causal masks `qi >= kj` with both
    positions from 0 (aligned top-left) by -1e30 before the softmax."""
    heads_first = q.ndim == 3
    if heads_first:
        q = q.unflatten(0, (k.shape[0], -1)).transpose(1, 2)
        k, v = k.unsqueeze(2), v.unsqueeze(2)
    B, Sq, H, D = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Sq, Kv, H // Kv, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(f32), k.to(f32)) * sm_scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        kj = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f32))
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    return o.transpose(1, 2).flatten(0, 1) if heads_first else o
