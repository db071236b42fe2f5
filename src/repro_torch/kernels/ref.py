"""Plain PyTorch versions of the port's kernels (K1-K5).

Ports of `repro.kernels.ref`'s oracles. Each computes, in float32, exactly
what its CUDA kernel computes (kernels/csrc/*.cu):

  * `pcdn_direction_ref`        -- K3, dense bundle slab -> (d, g, h)
  * `pcdn_sparse_direction_ref` -- K2, padded-CSC slab   -> (d, g, h)
  * `pcdn_bundle_ref`           -- K1, the fused support-restricted step
                                   -> (upd_w, upd_z, alpha, n_steps)
  * `serve_margins_dense_ref`   -- K4a, serving margins over a dense
                                   request slab -> (B, K)
  * `serve_margins_csc_ref`     -- K4b, serving margins over a padded-CSC
                                   request batch -> (B, K)
  * `pcdn_linesearch_ref`       -- K5, the Q candidates' loss deltas (Q,)

`kernels.ops` takes them for tensors on the CPU; the tests hold them
against the reference, and `chip_smoke.py` holds the kernels against them
on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.direction import newton_direction
from repro_torch.core.losses import HESSIAN_FLOOR, get_loss

Tensor = torch.Tensor
f32 = torch.float32


def pcdn_direction_ref(XB: Tensor, u: Tensor, v: Tensor, w_B: Tensor,
                       l2: float = 0.0):
    """(d, g, h) for a dense (s, P) bundle slab."""
    XB = XB.to(f32)
    g = XB.T @ u.to(f32)
    h = torch.square(XB).T @ v.to(f32)
    g = g + l2 * w_B
    h = torch.clamp_min(h + l2, HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B.to(f32))
    return d, g, h


def pcdn_sparse_direction_ref(rows: Tensor, vals: Tensor, u: Tensor,
                              v: Tensor, w_B: Tensor, l2: float = 0.0):
    """(d, g, h) for a padded-CSC slab; rows == len(u) (sentinel) add 0."""
    vals = vals.to(f32)
    s = u.shape[0]
    valid = (rows >= 0) & (rows < s)
    safe = rows.clamp(0, s - 1)
    zero = torch.zeros((), dtype=f32, device=u.device)
    ug = torch.where(valid, u.to(f32)[safe], zero)
    vg = torch.where(valid, v.to(f32)[safe], zero)
    g = torch.sum(ug * vals, dim=1) + l2 * w_B
    h = torch.clamp_min(torch.sum(vg * torch.square(vals), dim=1) + l2,
                        HESSIAN_FLOOR)
    d = newton_direction(g, h, w_B.to(f32))
    return d, g, h


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


def pcdn_linesearch_ref(z: Tensor, delta: Tensor, y: Tensor, alphas: Tensor,
                        kind: str = "logistic") -> Tensor:
    """(Q,) per-candidate loss deltas: sum_i phi(z + a*delta) - phi(z)."""
    loss = get_loss(kind)
    z = z.to(f32)
    y = y.to(f32)
    zq = z[None, :] + alphas.to(f32)[:, None] * delta.to(f32)[None, :]
    return torch.sum(loss.value(zq, y[None, :]) - loss.value(z, y)[None, :],
                     dim=-1)


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
