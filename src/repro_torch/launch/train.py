"""LM training driver: ``python -m repro_torch.launch.train --arch <id> ...``

Port of `repro.launch.train`, every family (dense, moe, ssm, hybrid, vlm,
encdec): config -> model -> AdamW (weight decay 0.01) + linear warmup
(max(steps // 20, 2) steps) and cosine -> token pipeline -> fault-tolerant
step loop with checkpoints. The reduced config by default; --full is the
published config, on the card. Every flag of the reference, plus --device
(cuda by default; cpu runs the kernels' plain versions). The pipeline's
batches carry vlm's patches and loss_mask and encdec's frames; the patch
and frame embeddings go to the model in its dtype (float32 numpy in the
pipeline; `launch.specs.train_batch_specs` makes them so too), the loss
mask in float32.

One card: --data and --model-parallel above 1 raise, because the port has
no LM sharding yet (ROADMAP Queue 1 item 6, LM data-parallel training).

Checkpoints hold the reference's tree, (params, AdamWState(step, mu, nu,
master)) with the layers stacked on a leading axis (`layers`, moe's
unstacked `layer0`, the hybrid's `triples` beside its `tail_rec<j>`,
encdec's `enc_layers` and `dec_layers`), under its leaf names, the
float32 leaves (the MoE router, the SSM's `A_log` and `D`, the RG-LRU's
`b_a`, `b_i` and `Lambda`) in float32: a checkpoint directory written by
`python -m repro.launch.train` resumes here and the other way
(`models.convert`). A directory that already
holds a checkpoint resumes from it, as the reference's runner does.
`REPRO_FAULT_PLAN` (`fault.inject`) drives the loop's fault hook:
`crash_at_iter` / `delay_at_iter` count training steps.

Prints the reference's log lines, then one `[train] result {json}` line
(each step's loss, the walls between losses and their median after the
first, tokens/s at that median, the peak device memory, the kernels'
launch counts, the runner's events) and returns the same dict.
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
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.fault.checkpoint import CheckpointManager
from repro_torch.fault.inject import plan_from_env
from repro_torch.fault.runner import FaultTolerantRunner, RunnerConfig
from repro_torch.kernels import ops
from repro_torch.models.convert import stack_layers, unstack_layers
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.train.steps import make_train_step

NO_SHARDING = ("the port's LM trains on one card: LM data-parallel and "
               "model-parallel training is ROADMAP Queue 1 item 6 (not "
               "ported)")
# the pipeline's float32 embeddings, which go to the model in its dtype
EMBEDDINGS = ("patches", "frames")


class TrainCheckpoints(CheckpointManager):
    """The runner's store for a (params, AdamWState) state of flat dicts,
    written and read in the reference's layout (`stack_layers`)."""

    def __init__(self, directory: str, cfg, keep: int = 2):
        super().__init__(directory, keep=keep)
        self.cfg = cfg

    def _nested(self, state):
        params, opt = state
        cfg = self.cfg
        return (stack_layers(cfg, params), AdamWState(
            opt.step, stack_layers(cfg, opt.mu), stack_layers(cfg, opt.nu),
            None if opt.master is None else stack_layers(cfg, opt.master)))

    def save(self, step, state, extra=None):
        return super().save(step, self._nested(state), extra)

    def restore(self, like, step=None):
        """The state in `like`'s key order: the global norm sums its
        leaves in dict order, so a resumed step is bit-equal only if the
        order is the live state's. The nested template the store reads
        dtypes and devices from is stacked from empty tensors of the live
        leaves' dtype and device, not from the leaves (a second copy of
        the state on the card while the restored one is built)."""
        like_params, like_opt = like

        def empty(tree):
            return None if tree is None else \
                {k: t.new_empty(0) for k, t in tree.items()}

        template = (empty(like_params), AdamWState(
            like_opt.step, empty(like_opt.mu), empty(like_opt.nu),
            empty(like_opt.master)))
        step, (params, opt) = super().restore(self._nested(template), step)

        def flat(tree, order):
            if tree is None:
                return None
            got = unstack_layers(self.cfg, tree)
            return {k: got[k] for k in order}

        return step, (flat(params, like_params), AdamWState(
            opt.step, flat(opt.mu, like_opt.mu), flat(opt.nu, like_opt.nu),
            flat(opt.master, like_opt.master)))


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
    if args.data > 1 or args.model_parallel > 1:
        ap.error(f"--data {args.data} --model-parallel "
                 f"{args.model_parallel}: {NO_SHARDING}")

    cfg = get_config(args.arch, reduced=not args.full)
    dev = resolve_device(args.device)
    model = Model(cfg, dev)

    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.01)
    sched = linear_warmup_cosine(args.lr, warmup_steps=max(args.steps // 20,
                                                           2),
                                 total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, sched)

    init_params(model, torch.Generator(device=dev).manual_seed(args.seed))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params, opt_cfg)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = TrainCheckpoints(args.ckpt_dir, cfg, keep=2)

    def loop_step(state, idx):
        params, opt = state
        batch = {}
        for k, v in pipe.batch_at(idx).items():
            dtype = cfg.torch_dtype if k in EMBEDDINGS else None
            batch[k] = torch.as_tensor(v, device=dev, dtype=dtype)
        params, opt, metrics = step_fn(params, opt, batch)
        return (params, opt), metrics

    plan = plan_from_env()
    runner = FaultTolerantRunner(
        loop_step, (params, opt), ckpt,
        RunnerConfig(ckpt_every=args.ckpt_every),
        inject_fault=None if plan is None else plan.fire_step)
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
        if step % 10 == 0 or step == runner.start_step:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)

    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    t_last[0] = time.perf_counter()
    runner.run(args.steps, metrics_cb=cb)
    dt = time.time() - t0
    print(f"[train] {args.arch}: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert np.isfinite(losses[-1]), "training diverged"
    # a wall is from one step's loss to the next one's: the first holds
    # the warm-up, a wall after a checkpoint its write; the median of the
    # others is the step's
    steady = float(np.median(walls[1:])) if len(walls) > 1 else None
    result = {
        "arch": args.arch, "device": str(dev), "start_step":
        runner.start_step, "losses": losses, "loss_steps": loss_steps,
        "step_walls_s": walls, "step_wall_s": steady,
        "tokens_per_s": (args.batch * args.seq / steady
                         if steady else None),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "launches": ops.launch_counts(),
        "launches_by_variant": {
            "flash_attention": ops.flash_variant_counts(),
            "flash_attention_bwd": ops.flash_bwd_variant_counts()},
        "events": [e["kind"] for e in runner.events]}
    print("[train] result " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
