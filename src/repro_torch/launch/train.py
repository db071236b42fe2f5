"""LM training driver: ``python -m repro_torch.launch.train --arch <id> ...``

Port of `repro.launch.train`, every family (dense, moe, ssm, hybrid, vlm,
encdec): config -> model -> AdamW (weight decay 0.01) + linear warmup
(max(steps // 20, 2) steps) and cosine -> token pipeline -> fault-tolerant
step loop with checkpoints. The reduced config by default; --full is the
published config, on the mesh of --data and --model-parallel (the
reference's --full asks for its 256-chip production mesh instead). Every
flag of the reference, plus --device (cuda by default; cpu runs the
kernels' plain versions). The pipeline's batches carry vlm's patches and
loss_mask and encdec's frames; the patch and frame embeddings go to the
model in its dtype (float32 numpy in the pipeline;
`launch.specs.train_batch_specs` makes them so too), the loss mask in
float32.

A (data, model) mesh: `torchrun --nproc-per-node D*M -m
repro_torch.launch.train --data D --model-parallel M` (`launch.mesh`:
NCCL when each rank has a card, gloo when the ranks share one or run on
the CPU; the choice is printed). Each rank holds the block of every
parameter and of its AdamW state that the reference's logical-axis rules
give it (`models.sharding`) and its rows of each batch (split over
"data" when D divides --batch, else the whole batch), and runs
`train.steps.make_train_step` over the mesh: each rank gathers its
blocks whole over "data" and computes its share along "model" (its
heads, ff columns, vocabulary rows of the logits and the loss, experts
or expert_ff columns, ssm / lru channels; partial sums added over
"model" in rank order), as the reference's rules place it. Init draws
the whole tree on every rank from the one seeded generator and keeps
the rank's blocks, so the bits are a world of 1's. A (D, M) that is
not the world size raises `launch.mesh`'s message before any process
group starts; without WORLD_SIZE and at D = M = 1 no process group
starts at all.

Checkpoints hold the reference's tree, (params, AdamWState(step, mu, nu,
master)) with the layers stacked on a leading axis (`layers`, moe's
unstacked `layer0`, the hybrid's `triples` beside its `tail_rec<j>`,
encdec's `enc_layers` and `dec_layers`), under its leaf names, the
float32 leaves (the MoE router, the SSM's `A_log` and `D`, the RG-LRU's
`b_a`, `b_i` and `Lambda`) in float32: a checkpoint directory written by
`python -m repro.launch.train` resumes here and the other way
(`models.convert`). Over a mesh the ranks gather the full state, rank 0
writes it, and every rank restores it and keeps its blocks: a checkpoint
written at one (D, M) resumes at any other. A directory that already
holds a checkpoint resumes from it, as the reference's runner does.
`REPRO_FAULT_PLAN` (`fault.inject`) drives the loop's fault hook:
`crash_at_iter` / `delay_at_iter` count training steps (on every rank).

Prints (rank 0) the reference's log lines, then one `[train] result
{json}` line (each step's loss, the walls between losses and their
median after the first, tokens/s at that median, the peak device memory
and each rank's, each rank's largest restore on a card (what it added
to the device's allocation at its peak, and the bytes of the state it
restored there), the kernels' launch counts, the mesh and the
collectives a step issues, the runner's events) and returns the same
dict on every rank.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import TokenPipeline, rows_split
from repro_torch.device import resolve_device
from repro_torch.fault.checkpoint import CheckpointManager
from repro_torch.fault.inject import plan_from_env
from repro_torch.fault.runner import FaultTolerantRunner, RunnerConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import check_world, make_host_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.convert import (full_state, local_state,
                                        stack_layers, unstack_layers)
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.train.steps import data_axes, make_train_step

# the pipeline's float32 embeddings, which go to the model in its dtype
EMBEDDINGS = ("patches", "frames")


class TrainCheckpoints(CheckpointManager):
    """The runner's store for a (params, AdamWState) state of flat dicts,
    written and read in the reference's layout (`stack_layers`). Over a
    mesh of more than one rank the state holds this rank's blocks: `save`
    gathers the full state on every rank (a collective), rank 0 writes
    it and every rank waits for the write; `restore` reads the full
    state on every rank, on the host, and keeps this rank's blocks.

    On a card each restore is measured: `restored` holds the largest
    restore's (bytes it added to the device's allocation at its peak,
    bytes of the state it restored there), and `peak_before` the
    device's peak before the latest restore reset the peak counter."""

    def __init__(self, directory: str, cfg, keep: int = 2, mesh=None):
        super().__init__(directory, keep=keep)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.restored = None
        self.peak_before = 0

    def _map(self, fn, state):
        params, opt = state
        return fn(params), AdamWState(
            opt.step, fn(opt.mu), fn(opt.nu),
            None if opt.master is None else fn(opt.master))

    def _nested(self, state):
        return self._map(lambda tree: stack_layers(self.cfg, tree), state)

    def save(self, step, state, extra=None):
        if self.mesh is None:
            return super().save(step, self._nested(state), extra)
        full = self._map(lambda t: full_state(self.cfg, t, self.mesh),
                         state)
        path = self._step_dir(step)
        if self.mesh.rank == 0:
            path = super().save(step, self._nested(full), extra)
        del full
        self.mesh.barrier()
        return path

    def restore(self, like, step=None):
        """`_restore`, measured on a card (see the class docstring)."""
        dev = next(iter(like[0].values())).device
        if dev.type != "cuda":
            return self._restore(like, step)
        self.peak_before = max(self.peak_before,
                               torch.cuda.max_memory_allocated(dev))
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step, state = self._restore(like, step)
        added = torch.cuda.max_memory_allocated(dev) - before
        params, opt = state
        held = sum(t.nbytes for tree in (params, opt.mu, opt.nu, opt.master)
                   if tree is not None for t in tree.values()
                   if t.device == dev)
        if self.restored is None or added > self.restored[0]:
            self.restored = (added, held)
        return step, state

    def _restore(self, like, step=None):
        """The state in `like`'s key order: the global norm sums its
        leaves in dict order, so a resumed step is bit-equal only if the
        order is the live state's. The nested template the store reads
        dtypes and devices from is stacked from empty tensors of the live
        leaves' dtype and device, not from the leaves (a second copy of
        the state on the card while the restored one is built); over a
        mesh the template is on the host, and each rank moves its blocks
        to its device."""
        like_params, like_opt = like
        host = None if self.mesh is None else torch.device("cpu")

        def empty(tree):
            return None if tree is None else \
                {k: t.new_empty(0, device=host or t.device)
                 for k, t in tree.items()}

        template = (empty(like_params), AdamWState(
            like_opt.step, empty(like_opt.mu), empty(like_opt.nu),
            empty(like_opt.master)))
        step, (params, opt) = super().restore(self._nested(template), step)

        def flat(tree, order):
            if tree is None:
                return None
            got = unstack_layers(self.cfg, tree)
            if self.mesh is not None:
                dev = next(iter(order.values())).device
                got = {k: t.to(dev) for k, t in
                       local_state(self.cfg, got, self.mesh).items()}
            return {k: got[k] for k in order}

        return step, (flat(params, like_params), AdamWState(
            opt.step, flat(opt.mu, like_opt.mu), flat(opt.nu, like_opt.nu),
            flat(opt.master, like_opt.master)))


def placement_line(mesh, specs: dict, batch: int, split: bool) -> str:
    """The placement the run uses, in one line."""
    D = mesh.size(data_axes(mesh))
    rows = (f"batch {batch} split over \"data\" ({batch // D} a rank)"
            if split else f"batch {batch} on every rank (whole: "
            f"{'one data shard' if D == 1 else f'{D} does not divide it'})")
    compute = ("\"model\" splits the compute: every rank gathers its "
               "blocks over \"data\" and computes its share of the heads, "
               "ff, vocabulary, experts and channels, the partial sums "
               "added over \"model\""
               if mesh.size("model") > 1 else
               "every rank gathers the full weights and runs its rows' "
               "forward and backward whole")
    return (f"[train] mesh {mesh.describe()}; {rows}; parameters and "
            f"AdamW state by the logical-axis rules, {sh.describe(specs, mesh)}"
            f"; {compute}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the reduced one)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda raises when no card is present")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    check_world((args.data, args.model_parallel), ("data", "model"), world)

    cfg = get_config(args.arch, reduced=not args.full)
    mesh = None
    if "WORLD_SIZE" in os.environ:
        mesh = make_host_mesh(args.data, args.model_parallel,
                              device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    model = Model(cfg, dev)
    split = mesh is not None and rows_split(args.batch,
                                            mesh.size(data_axes(mesh)))

    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.01)
    sched = linear_warmup_cosine(args.lr, warmup_steps=max(args.steps // 20,
                                                           2),
                                 total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, sched, mesh=mesh,
                              rows_split=split)

    init_params(model, torch.Generator(device=dev).manual_seed(args.seed))
    params = {k: p.detach() for k, p in model.named_parameters()}
    shard, shards = 0, 1
    if mesh is not None:
        params = local_state(cfg, params, mesh)
        if split:
            shard = mesh.index(data_axes(mesh))
            shards = mesh.size(data_axes(mesh))
        if lead:
            print(placement_line(mesh, sh.spec_tree(model, None, mesh),
                                 args.batch, split), flush=True)
    opt = adamw_init(params, opt_cfg)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = TrainCheckpoints(args.ckpt_dir, cfg, keep=2, mesh=mesh)
    issued = []          # collectives a step issued

    def loop_step(state, idx):
        params, opt = state
        batch = {}
        for k, v in pipe.batch_at(idx, shard, shards).items():
            dtype = cfg.torch_dtype if k in EMBEDDINGS else None
            batch[k] = torch.as_tensor(v, device=dev, dtype=dtype)
        before = 0 if mesh is None else mesh.counts["issued"]
        params, opt, metrics = step_fn(params, opt, batch)
        if mesh is not None:
            issued.append(mesh.counts["issued"] - before)
        return (params, opt), metrics

    slowest = None
    if mesh is not None and mesh.world > 1:
        def slowest(seconds):
            t = torch.tensor([seconds], dtype=torch.float64, device=dev)
            return float(mesh.pmax(t, mesh.axis_names)[0])

    plan = plan_from_env()
    runner = FaultTolerantRunner(
        loop_step, (params, opt), ckpt,
        RunnerConfig(ckpt_every=args.ckpt_every),
        inject_fault=None if plan is None else plan.fire_step,
        slowest=slowest)
    del params, opt

    losses, loss_steps, walls = [], [], []
    t_last = [time.perf_counter()]

    def cb(step, metrics):
        loss = float(metrics["loss"])   # waits for the step
        now = time.perf_counter()
        walls.append(now - t_last[0])
        t_last[0] = now
        losses.append(loss)
        loss_steps.append(step)
        if lead and (step % 10 == 0 or step == runner.start_step):
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        ckpt.peak_before = 0
    t0 = time.time()
    t_last[0] = time.perf_counter()
    runner.run(args.steps, metrics_cb=cb)
    dt = time.time() - t0
    if lead:
        print(f"[train] {args.arch}: {args.steps} steps in {dt:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert np.isfinite(losses[-1]), "training diverged"
    # a wall is from one step's loss to the next one's: the first holds
    # the warm-up, a wall after a checkpoint its write; the median of the
    # others is the step's
    steady = float(np.median(walls[1:])) if len(walls) > 1 else None
    peak = (max(ckpt.peak_before, torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else None)
    peaks = [peak]
    restored = [None if ckpt.restored is None else list(ckpt.restored)]
    if mesh is not None and mesh.world > 1:
        # every rank restores in lockstep: all or none have a reading
        mine = [peak or 0, *(ckpt.restored or (0, 0))]
        got = mesh.all_gather(torch.tensor(mine, dtype=torch.int64,
                                           device=dev), mesh.axis_names)
        got = got.view(mesh.world, 3).tolist()
        peaks = [r[0] if peak is not None else None for r in got]
        restored = [r[1:] if ckpt.restored is not None else None
                    for r in got]
    result = {
        "arch": args.arch, "device": str(dev), "start_step":
        runner.start_step, "losses": losses, "loss_steps": loss_steps,
        "step_walls_s": walls, "step_wall_s": steady,
        "tokens_per_s": (args.batch * args.seq / steady
                         if steady else None),
        "peak_bytes": peak, "peak_bytes_by_rank": peaks,
        "restore_bytes_by_rank": restored,
        "mesh": None if mesh is None else {
            "data": args.data, "model": args.model_parallel,
            "world": mesh.world, "backend": mesh.backend, "rank": mesh.rank,
            "rows_split": split},
        "collectives_per_step": (int(np.median(issued)) if issued
                                 else 0),
        "launches": ops.launch_counts(),
        "launches_by_variant": {
            "flash_attention": ops.flash_variant_counts(),
            "flash_attention_bwd": ops.flash_bwd_variant_counts()},
        "events": [e["kind"] for e in runner.events]}
    if lead:
        print("[train] result " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
