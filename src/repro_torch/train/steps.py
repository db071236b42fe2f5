"""Step factories of the port of `repro.train.steps`: the train step, and
the serving steps. The serving steps take no params argument (the
parameters live in the model); the train step is functional, as the
reference's is.

`make_train_step` returns the step alone: the reference also returns the
parameters' and the optimizer state's shardings for pjit, and the port's
LM runs on one card (its mesh, `launch.mesh`, serves the sharded PCDN
backend; LM data-parallel training is a later slice, ROADMAP). The cache
sharding specs are likewise a mesh concern with no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from repro_torch.models import decode as dec
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_schedule: Optional[Callable] = None):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"grad_norm", "lr", "loss"}).

    params: {name: tensor} under the model's parameter names (its
    `named_parameters()`); batch: {"tokens", "labels"[, "loss_mask"]} on
    the model's device. The loss and its gradient are taken at `params`
    through `torch.func.functional_call(model, params, (batch,))`, the
    learning rate from `lr_schedule(opt_state.step)` (the step before the
    increment, as in the reference) or opt_cfg.lr, then `adamw_update`.

    Functional: the step returns new tensors and changes none of its
    inputs (the parameters it differentiates are detached aliases), so
    `fault.runner.FaultTolerantRunner` can re-issue a straggling step from
    the state before the attempt without applying it twice."""

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss = functional_call(model, leaves, (batch,))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        lr = (lr_schedule(opt_state.step) if lr_schedule is not None
              else opt_cfg.lr)
        params, opt_state, metrics = adamw_update(
            params, dict(zip(leaves, grads)), opt_state, opt_cfg, lr)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: Model):
    """-> serve_step(cache, tokens) -> (logits, cache): one greedy decode
    step for the whole request batch."""
    def serve_step(cache, tokens):
        return dec.decode_step(model, cache, tokens)
    return serve_step


def make_prefill_step(model: Model):
    """-> prefill_step(batch) -> logits (B, S, V) over the whole prompt
    (with vlm's batch["patches"], encdec's batch["frames"])."""
    def prefill_step(batch):
        return model.logits(batch["tokens"], patches=batch.get("patches"),
                            frames=batch.get("frames"))
    return prefill_step
