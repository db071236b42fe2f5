"""AdamW with decoupled weight decay and global-norm clipping: port of
`repro.optim.adamw` on dicts of tensors.

Not `torch.optim.AdamW`: the reference keeps its moments in float32
whatever the parameters' dtype, clips by the global norm of the grads
inside the step and can keep float32 master weights (`keep_master`), and
its arithmetic is kept here in its order: the clip scale from the global
norm in float32, the bias corrections after the step's increment, the
new value `base - lr * (mhat / (sqrt(vhat) + eps) + wd * base)` in
float32 (`base` the master copy when kept), cast to the parameter's dtype.

Functional, as the reference is: `adamw_update` returns new tensors and
changes none of its inputs, so a step re-issued from the state before an
attempt (`fault.runner`) is applied once.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor
f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    keep_master: bool = False


class AdamWState(NamedTuple):
    step: Tensor          # 0-d int32
    mu: dict              # name -> float32 tensor
    nu: dict
    master: Optional[dict]  # float32 params, or None


def adamw_init(params: dict, cfg: AdamWConfig) -> AdamWState:
    device = next(iter(params.values())).device
    mu = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
          for k, p in params.items()}
    nu = {k: torch.zeros(p.shape, dtype=f32, device=p.device)
          for k, p in params.items()}
    master = ({k: p.detach().to(f32, copy=True) for k, p in params.items()}
              if cfg.keep_master else None)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), mu,
                      nu, master)


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in
    float32."""
    sq = [torch.sum(torch.square(x.to(f32))) for x in tree.values()]
    return torch.sqrt(torch.stack(sq).sum())


def adamw_update(params: dict, grads: dict, state: AdamWState,
                 cfg: AdamWConfig, lr=None):
    """-> (new_params, new_state, metrics {"grad_norm", "lr"} as float32
    tensors). `lr` (a float or a 0-d tensor) defaults to cfg.lr."""
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                         max=1.0) if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=step.device),
                         step.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=step.device),
                         step.to(f32))
    new_params, mu, nu, master = {}, {}, {}, {}
    for k, p in params.items():
        gf = grads[k].to(f32) * scale
        m = state.mu[k] * b1 + gf * (1 - b1)
        v = state.nu[k] * b2 + torch.square(gf) * (1 - b2)
        base = (state.master[k] if state.master is not None
                else p.detach().to(f32))
        new = base - lr * ((m / c1) / (torch.sqrt(v / c2) + cfg.eps)
                           + cfg.weight_decay * base)
        new_params[k] = new.to(p.dtype)
        mu[k], nu[k], master[k] = m, v, new
    return new_params, AdamWState(
        step, mu, nu, master if cfg.keep_master else None), {
        "grad_norm": gnorm,
        "lr": torch.as_tensor(lr, dtype=f32, device=step.device)}
