"""P-dimensional Armijo line search (paper Eq. 6/11, Algorithm 4), in torch.

Accept the largest alpha = beta^q, q = 0, 1, 2, ... with

    F_c(w + alpha d) - F_c(w) <= sigma * alpha * Delta            (Eq. 6)

evaluated through the per-sample margins z and delta = X_B d_B, so no pass
over X happens inside the search. Port of `repro.core.linesearch`, with the
same four variants:

  * `armijo_backtracking` -- the faithful sequential loop (Algorithm 4);
  * `armijo_batched`      -- all Q candidates in one vectorized pass;
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
                   params: ArmijoParams, l2: float = 0.0) -> LineSearchResult:
    """One vectorized pass over all candidates."""
    alphas = candidate_alphas(params, z.dtype, z.device)
    f_deltas = objective_delta_batched(loss, c, z, delta, y, w_B, d_B,
                                       alphas, l2)
    return select_first_satisfying(f_deltas, alphas, Delta, params.sigma)


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
