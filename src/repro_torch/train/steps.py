"""Step factories of the port of `repro.train.steps`: the train step, and
the serving steps. The serving steps take no params argument (the
parameters live in the model); the train step is functional, as the
reference's is.

`make_train_step` returns the step alone, on one device or over a
("data", "model") mesh (`launch.mesh`): each rank holds the block of
every parameter and of its AdamW state that the reference's logical-axis
rules give it (`models.sharding`), and its data shard's rows of the
batch (`data.tokens.shard_rows`). Along "data" the step is FSDP
(`models.sharding.DataGather`): each layer gathers its blocks inside its
forward and its remat recompute, and each gradient is summed over
"data" only into the block the rank keeps; along "model" each rank
computes its share (heads and ff, the vocabulary, experts, ssm and
RG-LRU channels) on its own blocks, as the reference's GSPMD does under
its rules. The reference instead
returns the shardings for pjit; the cache sharding specs of serving have
no counterpart (the port serves on one card).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from repro_torch.models import decode as dec
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     global_norm)


def data_axes(mesh) -> tuple:
    """The mesh's data-like axes, the batch's: ("pod", "data") where
    present."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_loss_and_grads(model: Model, mesh=None, rows_split: bool = False):
    """-> loss_and_grads(params, batch) -> (loss, grads): the loss of the
    whole batch and the gradient of every parameter at `params` ({name:
    tensor} under the model's parameter names: its `named_parameters()`),
    through `torch.func.functional_call(model, params, (batch,))`.

    Over `mesh` (a `launch.mesh.Mesh`) params are this rank's blocks
    (`sharding.local_slice` under `sharding.spec_tree(model)`), and batch
    is this rank's rows when `rows_split` (the batch split over the data
    axes, `data.tokens.rows_split`), else the whole batch; each gradient
    comes out as the rank's block. Over data axes of more than one rank
    the step is FSDP (`sharding.DataGather`): the leaves outside the
    layers (the embedding, the final norms) are gathered over the data
    axes once, at the start; each layer gathers its own blocks inside
    its forward and again in its remat recompute (one all-gather a
    dtype), so a rank holds one layer's whole weights at a time; and the
    backward sums each gradient over the data axes only into the rank's
    block, in rank order with float32 adds (a layer's in its backward,
    the others' after it: `sharding.psum_scatter_tree`), or, where every
    rank had the whole batch, keeps the rank's block of it. The "model"
    blocks stay the rank's, and it computes its share along "model"
    (`Model.split_compute(sharding.Split(mesh))`: the collectives over
    "model" are autograd's, inside the forward, the remat recompute and
    the backward) of the loss on the rank's rows (their share of the
    whole batch's mean: their sum over the count summed over "data"). A
    parameter replicated over "model" gets its whole gradient on every
    rank: where only part of a rank's work reads it (kv projections
    "model" does not divide, the moe router), its output entered the
    split region and that output's gradient was summed over "model".
    With every axis of size 1 (or no mesh) nothing is gathered or split:
    the one-rank step, bit for bit; over "model" alone nothing is
    gathered."""
    axes = () if mesh is None else data_axes(mesh)
    split = mesh is not None and rows_split
    model_split = sh.Split.over(mesh)
    fsdp = (sh.DataGather(model, mesh, axes, split)
            if mesh is not None and mesh.size(axes) > 1 else None)

    def loss_and_grads(params: dict, batch: dict):
        if fsdp is None:
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            bound, wrt = leaves, list(leaves.values())
        else:
            top = sh.gather_tree({k: params[k] for k in fsdp.top},
                                 fsdp.specs, mesh)
            leaves = {k: t.detach().requires_grad_(True)
                      for k, t in top.items()}
            bound = {**{k: p.detach() for k, p in params.items()}, **leaves}
            wrt = [*leaves.values(), fsdp.begin(batch["tokens"].device)]
        kwargs = {}
        if split:
            mask = batch.get("loss_mask")
            count = (torch.sum(mask.to(torch.float32)) if mask is not None
                     else torch.tensor(float(batch["labels"].numel()),
                                       device=batch["labels"].device))
            kwargs["total"] = mesh.psum_ordered(count, axes)
        with torch.enable_grad(), model.split_compute(model_split), \
                model.gathering(fsdp):
            loss = functional_call(model, bound, (batch,), kwargs)
            got = torch.autograd.grad(loss, wrt)
        grads = dict(zip(leaves, got))
        # `finish` frees each whole gradient as it goes, and the leaves
        # gathered at the start are let go before it
        del got, leaves, bound, wrt
        if fsdp is not None:
            del top
            grads = fsdp.finish(grads, params)
        loss = loss.detach()
        if split:
            loss = mesh.psum_ordered(loss, axes)
        return loss, grads

    return loss_and_grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_schedule: Optional[Callable] = None, mesh=None,
                    rows_split: bool = False):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"grad_norm", "lr", "loss"}).

    The loss and its gradient at `params` (`make_loss_and_grads`, on
    batch {"tokens", "labels"[, "loss_mask"]} on the model's device), the
    learning rate from `lr_schedule(opt_state.step)` (the step before the
    increment, as in the reference) or opt_cfg.lr, then `adamw_update`.

    Over `mesh` params, batch and the state's mu, nu and master are this
    rank's blocks and rows, as `make_loss_and_grads` takes them and gives
    the gradients: the step updates its blocks, and the clip's norm
    counts each element once over the mesh. On a mesh whose axes are all
    of size 1 the step is the one-device step, bit for bit.

    Functional: the step returns new tensors and changes none of its
    inputs (the parameters it differentiates are detached aliases), so
    `fault.runner.FaultTolerantRunner` can re-issue a straggling step from
    the state before the attempt without applying it twice."""
    loss_and_grads = make_loss_and_grads(model, mesh, rows_split)
    norm = None
    if mesh is not None and mesh.world > 1:
        counted = {k for k, spec in sh.spec_tree(model, None, mesh).items()
                   if sh.counted_once(spec, mesh)}

        def norm(grads):
            return global_norm(grads, counted, lambda t:
                               mesh.psum_ordered(t, mesh.axis_names))

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        loss, grads = loss_and_grads(params, batch)
        lr = (lr_schedule(opt_state.step) if lr_schedule is not None
              else opt_cfg.lr)
        params, opt_state, metrics = adamw_update(
            params, grads, opt_state, opt_cfg, lr, norm=norm)
        metrics["loss"] = loss
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
