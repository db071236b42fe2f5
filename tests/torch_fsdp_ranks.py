"""The ranks of tests/test_torch_train_fsdp.py: one process a rank on gloo
(torch.multiprocessing), the group on a FileStore, one torch thread:

    python tests/torch_fsdp_ranks.py --world 2 --store /tmp/store

For every family's reduced config (qwen2-0.5b, deepseek-moe-16b,
falcon-mamba-7b, recurrentgemma-2b, pixtral-12b, whisper-small), in
float32 and bf16, with remat on and off, each rank runs STEPS train
steps over the world's mesh ((1, 1) at 1 rank, (2, 1) at 2, (2, 2) at 4)
from one seeded init, twice:

1. `train.steps.make_train_step`, FSDP over "data" (each layer gathered
   inside its forward and recompute, each gradient summed only into the
   rank's block), its collectives recorded: each all-gather's and each
   all-to-all's axes and the bytes `Mesh.counts` says it brought;
2. `gather_all_step`, the step before FSDP, assembled here from
   `sharding.gather_tree` (every block gathered whole over "data" at the
   start), `Mesh.psum_ordered` (every whole gradient summed over "data"
   in rank order, float32) and `sharding.local_slice` (the rank's block
   kept), its collectives recorded alike.

At (1, 1) the second route is the one-process step (no mesh). Each rank
reports whether the losses, clip norms, parameters and AdamW moments of
the two routes are equal bit for bit, and the bytes of its blocks (all,
and those split over "data") of each layer and of the leaves outside
the layers. qwen2-0.5b also runs a batch of 3 rows, which "data" does
not divide: every rank takes the whole batch and keeps its block of the
whole gradient. qwen2-0.5b in bf16 and recurrentgemma-2b (its embedding
untied) in float32 run again with `sharding.EXCHANGE_ROW_BYTES` at
CAPPED_ROW_BYTES, at most one row of a leaf: the gradient exchange goes
in many all-to-alls, each block in pieces of its leading dim. Rank 0
prints one `CASE {json}` line a case, every rank's report in it, then
FSDP_OK.
"""
import argparse
import json

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("qwen2-0.5b", "deepseek-moe-16b", "falcon-mamba-7b",
         "recurrentgemma-2b", "pixtral-12b", "whisper-small")
DTYPES = ("float32", "bfloat16")
MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2)}
BATCH, SEQ = 4, 16
WHOLE_BATCH = 3          # qwen2's second case: "data" does not divide it
STEPS = 2
CAPPED_ROW_BYTES = 4096  # the reduced configs' longest row, float32
EMBEDDINGS = ("patches", "frames")


def gather_all_step(model, opt_cfg, mesh, rows_split):
    """The train step that gathers every block whole over the data axes at
    its start, sums every whole gradient over them (`Mesh.psum_ordered`,
    float32, one flat sum a dtype) and keeps the rank's block."""
    from torch.func import functional_call

    from repro_torch.models import sharding as sh
    from repro_torch.optim.adamw import adamw_update, global_norm
    from repro_torch.train.steps import data_axes
    axes = data_axes(mesh)
    full_specs = sh.spec_tree(model, None, mesh)
    specs = {k: sh.restrict(s, axes) for k, s in full_specs.items()}
    counted = {k for k, s in full_specs.items() if sh.counted_once(s, mesh)}
    model_split = sh.Split.over(mesh)

    def norm(grads):
        return global_norm(grads, counted, lambda t: mesh.psum_ordered(
            t, mesh.axis_names))

    def step(params, opt, batch):
        full = sh.gather_tree(params, specs, mesh)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in full.items()}
        kwargs = {}
        if rows_split:
            mask = batch.get("loss_mask")
            count = (torch.sum(mask.to(torch.float32)) if mask is not None
                     else torch.tensor(float(batch["labels"].numel())))
            kwargs["total"] = mesh.psum_ordered(count, axes)
        with torch.enable_grad(), model.split_compute(model_split):
            loss = functional_call(model, leaves, (batch,), kwargs)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        loss = loss.detach()
        if rows_split:
            out = sh.packed(grads, list(grads), lambda flat:
                            mesh.psum_ordered(flat, axes, torch.float32))
            grads = {k: out[k] for k in grads}
            loss = mesh.psum_ordered(loss, axes)
        grads = {k: sh.local_slice(g, specs[k], mesh)
                 for k, g in grads.items()}
        params, opt, met = adamw_update(params, grads, opt, opt_cfg,
                                        opt_cfg.lr, norm=norm)
        met["loss"] = loss
        return params, opt, met
    return step


def _record(log: list):
    """Patch `Mesh.all_gather`, `psum_ordered` and `psum_scatter_ordered`
    to append (kind, axes, bytes brought, elements sent) of each one
    issued to `log` -> undo()."""
    from repro_torch.launch.mesh import Mesh
    saved = []

    def patch(name, kind):
        real = getattr(Mesh, name)

        def f(self, t, axes, *a, **kw):
            before = self.counts["bytes"]
            out = real(self, t, axes, *a, **kw)
            if self.counts["bytes"] > before:
                log.append((kind, list(self._axes(axes)),
                            self.counts["bytes"] - before, t.numel()))
            return out
        saved.append((name, real))
        setattr(Mesh, name, f)

    patch("all_gather", "gather")
    patch("psum_ordered", "sum")
    patch("psum_scatter_ordered", "scatter")

    def undo():
        for name, real in saved:
            setattr(Mesh, name, real)
    return undo


def _case(mesh, arch, dtype, remat, batch_rows, row_bytes=None):
    from repro_torch.models import sharding as sh
    saved = sh.EXCHANGE_ROW_BYTES
    sh.EXCHANGE_ROW_BYTES = row_bytes or saved
    try:
        return _routes(mesh, arch, dtype, remat, batch_rows)
    finally:
        sh.EXCHANGE_ROW_BYTES = saved


def _routes(mesh, arch, dtype, remat, batch_rows):
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, rows_split
    from repro_torch.models import sharding as sh
    from repro_torch.models.convert import local_state
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import data_axes, make_train_step
    cfg = get_config(arch, reduced=True).replace(dtype=dtype, remat=remat)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    full = {k: p.detach() for k, p in model.named_parameters()}
    axes = data_axes(mesh)
    D = mesh.size(axes)
    split = rows_split(batch_rows, D)
    shard = mesh.index(axes) if split else 0
    batch = {k: torch.as_tensor(v, dtype=cfg.torch_dtype
                                if k in EMBEDDINGS else None)
             for k, v in TokenPipeline(cfg, batch_rows, SEQ, seed=1)
             .batch_at(0, shard, D if split else 1).items()}
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.01)
    one = mesh.world == 1
    routes = {"fsdp": make_train_step(model, opt_cfg, mesh=mesh,
                                      rows_split=split),
              "before": (make_train_step(model, opt_cfg) if one else
                         gather_all_step(model, opt_cfg, mesh, split))}
    out = {}
    for name, step in routes.items():
        params = full if one and name == "before" else local_state(
            cfg, full, mesh)
        opt = adamw_init(params, opt_cfg)
        log, met = [], []
        mesh.reset_counts()
        undo = _record(log)
        try:
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch)
                met.append([m["loss"], m["grad_norm"]])
        finally:
            undo()
        out[name] = (params, opt, met, log, mesh.counts["issued"])
    (p1, o1, m1, log, issued), (p2, o2, m2, log2, issued2) = \
        out["fsdp"], out["before"]

    def unequal(a, b):
        return sorted(k for k in a if not torch.equal(a[k], b[k]))

    # the bytes of this rank's blocks: all, and those split over the data
    # axes, of each layer and of the leaves outside the layers
    gather = sh.DataGather(model, mesh, axes, split)
    units = {"top": gather.top}
    for prefix in gather.prefix.values():
        units[prefix] = [k for k in p1 if k.startswith(prefix)]
    blocks = {u: sum(p1[k].nbytes for k in names)
              for u, names in units.items()}
    gathered = {u: sum(p1[k].nbytes for k in names
                       if sh._split_dims(gather.specs[k], mesh))
                for u, names in units.items()}
    return {"equal": {"loss": all(torch.equal(a[0], b[0])
                                  for a, b in zip(m1, m2)),
                      "grad_norm": all(torch.equal(a[1], b[1])
                                       for a, b in zip(m1, m2)),
                      "step": torch.equal(o1.step, o2.step)},
            "unequal": {"params": unequal(p1, p2), "mu": unequal(o1.mu, o2.mu),
                        "nu": unequal(o1.nu, o2.nu)},
            "losses": [float(m[0]) for m in m1],
            "rows_split": split, "D": D, "layers": len(gather.prefix),
            "log": log, "log_before": log2, "issued": issued,
            "issued_before": issued2, "blocks": blocks,
            "gathered": gathered,
            "model_bytes": sum(t.nbytes for t in full.values()),
            "rank_bytes": sum(t.nbytes for t in p1.values())}


def _rank(rank: int, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=rank, world_size=args.world)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*MESHES[args.world], device="cpu")
    cases = [(arch, dtype, remat, BATCH, None) for arch in ARCHS
             for dtype in DTYPES for remat in (False, True)]
    cases += [("qwen2-0.5b", "float32", remat, WHOLE_BATCH, None)
              for remat in (False, True)]
    cases += [("qwen2-0.5b", "bfloat16", False, BATCH, CAPPED_ROW_BYTES),
              ("recurrentgemma-2b", "float32", True, BATCH,
               CAPPED_ROW_BYTES)]
    for arch, dtype, remat, rows, row_bytes in cases:
        got = _case(mesh, arch, dtype, remat, rows, row_bytes)
        every = [None] * mesh.world
        dist.all_gather_object(every, got)
        if rank == 0:
            print("CASE " + json.dumps({
                "arch": arch, "dtype": dtype, "remat": remat, "rows": rows,
                "row_bytes": row_bytes, "mesh": list(MESHES[args.world]),
                "ranks": every}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True,
                    choices=sorted(MESHES))
    ap.add_argument("--store", required=True)
    args = ap.parse_args()
    mp.spawn(_rank, args=(args,), nprocs=args.world, join=True)
    print("FSDP_OK", flush=True)


if __name__ == "__main__":
    main()
