"""P-dimensional Armijo line search (paper Eq. 6/11, Algorithm 4), in torch.

Accept the largest alpha = beta^q, q = 0, 1, 2, ... with

    F_c(w + alpha d) - F_c(w) <= sigma * alpha * Delta            (Eq. 6)

evaluated through the per-sample margins z and delta = X_B d_B, so no pass
over X happens inside the search. Port of `repro.core.linesearch`, with the
same four variants:

  * `armijo_backtracking` -- the faithful sequential loop (Algorithm 4);
  * `armijo_batched`      -- all Q candidates in one pass, the loss part
    from the batched line-search kernel (K5, `kernels.ops.pcdn_linesearch`;
    its plain version on the CPU); with a (P, s) delta, P one-coordinate
    searches at once (SCDN's racing updates);
  * `armijo_chunked`      -- the full-scope default: chunks of 8 candidates
    with early exit. In eager PyTorch the exit test reads a device flag,
    so it costs one host sync per chunk evaluated;
  * `armijo_support`      -- the batched grid over a bundle's row support.

All return (alpha, n_steps, accepted) as tensors; n_steps is q + 1, and
when no candidate passes alpha = 0 (the batched forms then report
n_steps = 1, the chunked form Q).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.losses import Loss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ArmijoParams:
    """Paper section 5.1: sigma=0.01, gamma=0, beta=0.5 for all solvers."""

    beta: float = 0.5
    sigma: float = 0.01
    gamma: float = 0.0
    max_steps: int = 40  # beta^40 ~ 1e-12: below this alpha is numerically 0


class LineSearchResult(NamedTuple):
    alpha: Tensor      # scalar, accepted step size (0.0 if not accepted)
    n_steps: Tensor    # int32, number of candidates evaluated (q + 1)
    accepted: Tensor   # bool


def objective_delta(loss: Loss, c, z, delta, y, w_B, d_B, alpha,
                    l2: float = 0.0) -> Tensor:
    """F_c(w + alpha d) - F_c(w) through intermediates; alpha a scalar."""
    lo = c * torch.sum(loss.value(z + alpha * delta, y) - loss.value(z, y))
    l1 = torch.sum(torch.abs(w_B + alpha * d_B)) - torch.sum(torch.abs(w_B))
    out = lo + l1
    if l2:
        out = out + 0.5 * l2 * (torch.sum(torch.square(w_B + alpha * d_B)) -
                                torch.sum(torch.square(w_B)))
    return out


def objective_delta_batched(loss: Loss, c, z, delta, y, w_B, d_B, alphas,
                            l2: float = 0.0) -> Tensor:
    """Vectorized over a (Q,) vector of candidate alphas -> (Q,) deltas.
    Materializes the (Q, len(z)) grid."""
    zq = z[None, :] + alphas[:, None] * delta[None, :]
    lo = c * torch.sum(loss.value(zq, y[None, :]) -
                       loss.value(z, y)[None, :], dim=-1)
    wq = w_B[None, :] + alphas[:, None] * d_B[None, :]
    l1 = torch.sum(torch.abs(wq), dim=-1) - torch.sum(torch.abs(w_B))
    out = lo + l1
    if l2:
        out = out + 0.5 * l2 * (torch.sum(torch.square(wq), dim=-1) -
                                torch.sum(torch.square(w_B)))
    return out


def armijo_backtracking(loss: Loss, c, z, delta, y, w_B, d_B, Delta,
                        params: ArmijoParams,
                        l2: float = 0.0) -> LineSearchResult:
    """Faithful Algorithm 4: try alpha = 1, beta, beta^2, ... in turn
    (one host sync per candidate)."""
    alpha = 1.0
    q = 0
    ok = False
    while not ok and q < params.max_steps:
        f_delta = objective_delta(loss, c, z, delta, y, w_B, d_B,
                                  torch.tensor(alpha, dtype=z.dtype,
                                               device=z.device), l2)
        ok = bool(f_delta <= params.sigma * alpha * Delta)
        q += 1
        if not ok:
            alpha = alpha * params.beta
    dev = z.device
    return LineSearchResult(
        alpha=torch.tensor(alpha if ok else 0.0, dtype=z.dtype, device=dev),
        n_steps=torch.tensor(q, dtype=torch.int32, device=dev),
        accepted=torch.tensor(ok, device=dev))


def candidate_alphas(params: ArmijoParams, dtype=torch.float32,
                     device="cpu") -> Tensor:
    """beta^0 .. beta^{max_steps-1}."""
    q = torch.arange(params.max_steps, dtype=dtype, device=device)
    return torch.pow(torch.tensor(params.beta, dtype=dtype, device=device), q)


def select_first_satisfying(f_deltas: Tensor, alphas: Tensor, Delta: Tensor,
                            sigma: float) -> LineSearchResult:
    """Pick the first Armijo-accepted alpha (largest candidate); argmax of
    an all-false mask is 0, so n_steps is 1 when none passes."""
    ok = f_deltas <= sigma * alphas * Delta
    any_ok = torch.any(ok)
    first = torch.argmax(ok.to(torch.int32))
    alpha = torch.where(any_ok, alphas[first], torch.zeros_like(alphas[0]))
    return LineSearchResult(alpha=alpha,
                            n_steps=(first + 1).to(torch.int32),
                            accepted=any_ok)


def armijo_batched(loss: Loss, c, z, delta, y, w_B, d_B, Delta,
                   params: ArmijoParams, l2: float = 0.0,
                   loss_deltas=None) -> LineSearchResult:
    """One pass over all Q candidates: the loss part c * sum_i [phi(z_i +
    alpha delta_i) - phi(z_i)] from `loss_deltas` (default K5,
    `kernels.ops.pcdn_linesearch`), then the l1 (and l2) part over the
    coordinates.

    delta (s,) with w_B, d_B (P,) and a scalar Delta: one P-dimensional
    search. delta (P, s) with w_B, d_B, Delta (P,): P one-coordinate
    searches, row j along d_B[j] e_j; alpha and n_steps are then (P,),
    each the first candidate of its row with f <= sigma alpha Delta_j.
    """
    if loss_deltas is None:
        from repro_torch.kernels import ops
        loss_deltas = ops.pcdn_linesearch
    alphas = candidate_alphas(params, z.dtype, z.device)
    lo = c * loss_deltas(z, delta, y, alphas, kind=loss.name)
    if delta.ndim == 1:
        wq = w_B[None, :] + alphas[:, None] * d_B[None, :]
        out = lo + (torch.sum(torch.abs(wq), dim=-1) -
                    torch.sum(torch.abs(w_B)))
        if l2:
            out = out + 0.5 * l2 * (torch.sum(torch.square(wq), dim=-1) -
                                    torch.sum(torch.square(w_B)))
        return select_first_satisfying(out, alphas, Delta, params.sigma)
    wq = w_B[:, None] + alphas[None, :] * d_B[:, None]          # (P, Q)
    out = lo + (torch.abs(wq) - torch.abs(w_B)[:, None])
    if l2:
        out = out + 0.5 * l2 * (torch.square(wq) -
                                torch.square(w_B)[:, None])
    ok = out <= params.sigma * alphas[None, :] * Delta[:, None]
    any_ok = torch.any(ok, dim=1)
    first = torch.argmax(ok.to(torch.int32), dim=1)
    alpha = torch.where(any_ok, alphas[first], torch.zeros_like(alphas[0]))
    return LineSearchResult(alpha=alpha, n_steps=(first + 1).to(torch.int32),
                            accepted=any_ok)


def armijo_chunked(loss: Loss, c, z, delta, y, w_B, d_B, Delta,
                   params: ArmijoParams, l2: float = 0.0,
                   chunk: int = 8) -> LineSearchResult:
    """Chunked early-exit variant: the full-scope solver default.

    Candidates are evaluated `chunk` at a time, stopping at the first chunk
    that holds a satisfying alpha. Accepted alpha and n_steps match
    `armijo_batched`, except that n_steps is Q when nothing passes. The
    exit test is one host sync per chunk.
    """
    alphas = candidate_alphas(params, z.dtype, z.device)
    Q = alphas.shape[0]
    chunk = min(chunk, Q)
    n_chunks = -(-Q // chunk)
    # pad with the smallest candidate: a duplicate can never be the FIRST
    # satisfying alpha (its original either passed earlier or also fails)
    alphas_p = torch.cat([alphas, alphas[-1:].expand(n_chunks * chunk - Q)])
    dev = z.device
    for i in range(n_chunks):
        a = alphas_p[i * chunk:(i + 1) * chunk]
        f_deltas = objective_delta_batched(loss, c, z, delta, y, w_B, d_B,
                                           a, l2)
        ok = f_deltas <= params.sigma * a * Delta
        if bool(torch.any(ok)):
            first = torch.argmax(ok.to(torch.int32))
            return LineSearchResult(
                alpha=a[first],
                n_steps=(i * chunk + first + 1).to(torch.int32),
                accepted=torch.tensor(True, device=dev))
    return LineSearchResult(
        alpha=torch.zeros((), dtype=z.dtype, device=dev),
        n_steps=torch.tensor(Q, dtype=torch.int32, device=dev),
        accepted=torch.tensor(False, device=dev))


def armijo_support(loss: Loss, c, z_R, delta_R, y_R, w_B, d_B, Delta,
                   params: ArmijoParams, l2: float = 0.0) -> LineSearchResult:
    """Support-scoped batched search: z_R / delta_R / y_R gathered at the
    bundle's (r_max,) row support, sentinel slots z = delta = 0 (their
    candidate loss delta is exactly 0)."""
    alphas = candidate_alphas(params, z_R.dtype, z_R.device)
    f_deltas = objective_delta_batched(loss, c, z_R, delta_R, y_R, w_B, d_B,
                                       alphas, l2)
    return select_first_satisfying(f_deltas, alphas, Delta, params.sigma)
