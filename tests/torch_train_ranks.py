"""The port's ranks of tests/test_torch_train_sharded.py, one process a rank
on gloo (torch.multiprocessing), the group on a FileStore:

    python tests/torch_train_ranks.py --world 2 --npz case.npz \
        --store /tmp/store [--meshes 1x4]

The npz (written by the test) holds one family's case, float32, under
the port's parameter names: the reduced config's arch and moe capacity
factor (`arch`, `capacity`), the reference's parameters (`p/<name>`),
batches (`b<j>/<key>`) and, for each batch and each way its rows fall
over "data" (`whole`: one shard; `split`: two), the reference's loss
and gradients from `jax.value_and_grad` (`loss/<j>/<way>`,
`g/<j>/<way>/<name>`), and optionally `n_experts` (the moe case's
expert count in place of the reduced config's). Each rank, for each mesh
of its world ((2, 1) and (1, 2) at 2 ranks, (2, 2) at 4; or --meshes):

1. takes its blocks of the parameters (`convert.local_state`) and its
   rows of each batch
   (`data.tokens.shard_rows`), runs `train.steps.make_loss_and_grads`
   (which computes the rank's share along "model" and returns its
   "model" block of each gradient) and holds the loss and every
   gradient, gathered whole over "model", against the
   reference's (the `split` oracle where the rows split over "data",
   else `whole`) at rtol RTOL, atol RTOL x the leaf's largest entry
   (ATOL_ZERO x the model's for leaves that are 0 in exact arithmetic);
   Where the case's capacity drops tokens (moe) and the rows split, the
   loss must differ from the whole batch's on one process (rel > 1e-4):
   each shard's queues fill apart;
2. runs STEPS train steps on the first batch, freely, from a shared
   carry cut to the rank's blocks, and holds each loss and each step's
   clip norm (`grad_norm`, rtol STEP_RTOL), the gathered parameters, and
   the gathered AdamW moments and step count after, against the same
   steps on one process (no mesh) from the same carry, at the reduced
   config's own capacity (no token dropped either way). The carry is
   one step on one process from the init: from zero moments Adam's
   first update is about lr x sign(g), so an entry whose gradient sits
   near Adam's eps moves by up to lr on its float32 sum order, and where
   "model" splits the compute the sums run in another order in every
   layer (the gradients ~1e-6 of their largest entry apart); from zero
   moments falcon-mamba's clip norm at step 3 read 4.7e-5 apart at
   (1, 2), from the carry 2.1e-6. The parameters: rtol STEP_RTOL, atol
   PARAM_ATOL x lr x STEPS (Adam moves an element by up to lr a step
   whatever its gradient's size, so a small gradient's float32 sum order
   shows there; the key biases, whose gradient is float noise around 0,
   PARAM_ATOL_ZERO x lr x STEPS, below what qwen2's move). The moments:
   rtol STEP_RTOL, atol MOMENT_ATOL x the leaf's largest entry (the
   key biases': ATOL_ZERO x the model's);
3. runs them again: losses and norms bit-equal to 2, and the
   parameters and moments.

Prints PORT_OK from the parent when every rank passed.
"""
import argparse

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RTOL = 1e-5
# the key biases' gradient is 0 in exact arithmetic (a row's scores all
# shift by q . bk, which the softmax ignores): held to ATOL_ZERO x the
# largest gradient entry of the model, as tests/test_torch_train_families
# holds them
ZERO = ("bk",)
ATOL_ZERO = 1e-5
STEPS = 3
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-2
# the key biases' limit, a twentieth of the 3 lr that Adam moves an
# element in STEPS steps at most: qwen2's moved 2.94e-2 and 3.00e-2 on
# one process and the sharded steps ended up to 1.57e-4 from those;
# whisper's, whose gradients are near Adam's eps, moved up to 1.67e-3
# on their float noise and ended up to 8.33e-4 apart
PARAM_ATOL_ZERO = 5e-2
# the moments after STEPS free steps: the last steps' gradients, taken
# at parameters that moved apart as above (the worst read 8.1e-5 of the
# leaf's largest entry, recurrentgemma's at (1, 2) and (2, 2))
MOMENT_ATOL = 1e-3
DROP_RTOL = 1e-4
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def _cfg(npz, own_capacity=False):
    """The case's reduced config: with its moe capacity factor, or the
    config's own."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(str(npz["arch"]), reduced=True)
    if "n_experts" in npz.files:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, n_experts=int(npz["n_experts"])))
    cap = float(npz["capacity"])
    if cap > 0 and not own_capacity:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cap))
    return cfg


def _close(name, got, want, rtol, atol):
    got = got.detach().to(torch.float64).numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


def _batches(npz, device="cpu"):
    out = {}
    for key in npz.files:
        if key.startswith("b") and "/" in key:
            j, name = key.split("/", 1)
            out.setdefault(int(j[1:]), {})[name] = torch.from_numpy(
                np.array(npz[key]))
    return [out[j] for j in sorted(out)]


def _rank(rank: int, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=rank, world_size=args.world)
    from repro_torch.data.tokens import rows_split, shard_rows
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.convert import (full_state, local_state,
                                            state_specs)
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init
    from repro_torch.train.steps import make_loss_and_grads, make_train_step

    npz = np.load(args.npz)
    cfg = _cfg(npz)
    model = Model(cfg, "cpu")
    # the steps' model: the config's own capacity
    stepper = Model(_cfg(npz, own_capacity=True), "cpu")
    params = {k: torch.from_numpy(np.array(npz["p/" + k]))
              for k, _ in model.named_parameters()}
    batches = _batches(npz)
    opt_cfg = AdamWConfig(lr=1e-2, weight_decay=0.01)
    drops = float(npz["capacity"]) > 0

    def run(step, state, batch):
        """STEPS steps from `state` -> (losses, norms, params, opt)."""
        losses, norms = [], []
        p, o = state
        for _ in range(STEPS):
            p, o, met = step(p, o, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return losses, norms, p, o

    # the same steps on one process, from the carry: the reference for 2
    one_step = make_train_step(stepper, opt_cfg)
    carry = one_step(params, adamw_init(params, opt_cfg), batches[0])[:2]
    one_losses, one_norms, one_params, one_opt = run(one_step, carry,
                                                     batches[0])
    top_moment = {part: max(float(t.abs().max()) for t in
                            getattr(one_opt, part).values())
                  for part in ("mu", "nu")}
    meshes = ([tuple(int(a) for a in m.split("x"))
               for m in args.meshes.split(",")] if args.meshes
              else MESHES[args.world])
    for shape in meshes:
        mesh = make_host_mesh(*shape, device="cpu")
        D = mesh.size("data")
        local = local_state(cfg, params, mesh)
        by_model = {k: sh.restrict(spec, ("model",))
                    for k, spec in state_specs(cfg, mesh).items()}
        for j, batch in enumerate(batches):
            B = len(batch["tokens"])
            split = rows_split(B, D)
            way = "split" if split else "whole"
            rows = shard_rows(batch, mesh.index("data"), D)
            loss, grads = make_loss_and_grads(model, mesh, split)(local,
                                                                  rows)
            grads = sh.gather_tree(grads, by_model, mesh)
            tag = f"{shape} batch {j} ({way})"
            _close(f"{tag} loss", loss, npz[f"loss/{j}/{way}"], RTOL, 0.0)
            want = {k: npz[f"g/{j}/{way}/{k}"] for k in grads}
            top = max(float(np.abs(w).max()) for w in want.values())
            for k, g in grads.items():
                atol = (ATOL_ZERO * top if k.split(".")[-1] in ZERO
                        else RTOL * float(np.abs(want[k]).max()))
                _close(f"{tag} grad {k}", g, want[k], RTOL, atol)
            if drops and split:
                one, _ = make_loss_and_grads(model)(params, batch)
                assert abs(float(loss) - float(one)) > \
                    DROP_RTOL * abs(float(one)), (tag, loss, one)
        step = make_train_step(stepper, opt_cfg, mesh=mesh,
                               rows_split=rows_split(
                                   len(batches[0]["tokens"]), D))
        rows = shard_rows(batches[0], mesh.index("data"), D)
        p0, o0 = carry
        state = (local_state(cfg, p0, mesh), AdamWState(
            o0.step, local_state(cfg, o0.mu, mesh),
            local_state(cfg, o0.nu, mesh), None))
        losses, norms, p, o = run(step, state, rows)
        np.testing.assert_allclose(losses, one_losses, rtol=STEP_RTOL,
                                   err_msg=f"{shape} losses")
        np.testing.assert_allclose(norms, one_norms, rtol=STEP_RTOL,
                                   err_msg=f"{shape} grad norms")
        gathered = full_state(cfg, p, mesh)
        for k, t in one_params.items():
            atol = (PARAM_ATOL_ZERO if k.split(".")[-1] in ZERO
                    else PARAM_ATOL) * opt_cfg.lr * STEPS
            _close(f"{shape} params after {STEPS} steps: {k}", gathered[k],
                   t.numpy(), STEP_RTOL, atol)
        assert int(o.step) == int(one_opt.step), (shape, o.step)
        for part in ("mu", "nu"):
            got = full_state(cfg, getattr(o, part), mesh)
            for k, t in getattr(one_opt, part).items():
                atol = (ATOL_ZERO * top_moment[part]
                        if k.split(".")[-1] in ZERO
                        else MOMENT_ATOL * float(t.abs().max()))
                _close(f"{shape} {part} after {STEPS} steps: {k}", got[k],
                       t.numpy(), STEP_RTOL, atol)
        again, again_norms, p2, o2 = run(step, state, rows)
        assert again == losses and again_norms == norms, (shape, again,
                                                          losses)
        assert all(torch.equal(p[k], p2[k]) for k in p), shape
        assert all(torch.equal(o.mu[k], o2.mu[k]) and
                   torch.equal(o.nu[k], o2.nu[k]) for k in o.mu), shape
        if rank == 0:
            print(f"[ranks] {cfg.name} {mesh.describe()}: issued "
                  f"{mesh.counts['issued']} of {mesh.counts['asked']} "
                  f"collectives; losses {losses}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--npz", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--meshes", default="",
                    help="DxM[,DxM...] in place of the world's meshes")
    args = ap.parse_args()
    mp.spawn(_rank, args=(args,), nprocs=args.world, join=True)
    print("PORT_OK", flush=True)


if __name__ == "__main__":
    main()
