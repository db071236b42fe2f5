"""The ranks of tests/test_torch_train_split.py: two processes on gloo
(torch.multiprocessing), the group on a FileStore:

    python tests/torch_split_ranks.py --store /tmp/store --ckpt /tmp/ck

On a (1, 2) mesh each rank:

1. runs one `train.steps.make_loss_and_grads` of the reduced qwen2-0.5b,
   recurrentgemma-2b, deepseek-moe-16b and falcon-mamba-7b (float32,
   seeded weights, the token pipeline's 2 x 16 batch) and records what
   its step computes with: the logits' last dim, the q and kv heads of
   every attention, the MLPs' hidden width, the experts' blocks, the
   ssm and RG-LRU channels scanned, and every all-gather over "model"
   of a parameter block (by storage). It asserts the rank's share:
   padded_vocab / 2 logits, H / 2 heads (the kv heads H / 2 reads, or
   every kv head where "model" does not divide them), d_ff / 2, E / 2
   experts, Di / 2 or W / 2 channels, and no all-gather over "model" of
   a leaf the rules split over "model" but the RG-LRU's w_a and w_i;
   the loss equal on both ranks;
2. runs the reduced qwen2-0.5b with a fused `wqkv` and QKV biases (its
   fused dim split on storage, gathered and its rows taken) and holds
   its loss and every gradient, gathered over "model", against one
   process's at rtol FUSED_RTOL;
3. holds the vocab-parallel `layers.softmax_xent` (the rank's slice of
   seeded float32 logits, with a mask and with `total`) and its gradient
   against the whole-vocabulary one, rtol XENT_RTOL;
4. saves one train state through `launch.train.TrainCheckpoints` at (1,
   2) and at (2, 1) and rank 0 holds the
   written files against the same state saved by one process, byte for
   byte.

Prints SPLIT_OK and a JSON line of what rank 0 recorded from the parent.
"""
import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("qwen2-0.5b", "recurrentgemma-2b", "deepseek-moe-16b",
         "falcon-mamba-7b")
BATCH, SEQ = 2, 16
XENT_RTOL = 1e-6
FUSED_RTOL = 1e-5
# the RG-LRU's gate weights, stored split on their rows only, are gathered
# whole (`models.sharding`'s docstring)
GATHERED = ("rec.w_a", "rec.w_i")


def _record(seen: dict, local: dict, specs: dict):
    """Patch the port's compute to note its shapes in `seen` -> undo()."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import attention, layers, moe, rglru, ssm
    split_leaves = {p.data_ptr(): name for name, p in local.items()
                    if any(e == "model" or (isinstance(e, tuple)
                                            and "model" in e)
                           for e in specs[name] if e is not None)}
    saved = []

    def patch(owner, name, wrap):
        real = getattr(owner, name)
        saved.append((owner, name, real))
        setattr(owner, name, wrap(real))

    def heads(real):
        def f(q, k, v, *a, **kw):
            seen.setdefault("attention", []).append([q.shape[2], k.shape[2]])
            return real(q, k, v, *a, **kw)
        return f

    def xent(real):
        def f(logits, *a, **kw):
            seen["logits"] = logits.shape[-1]
            return real(logits, *a, **kw)
        return f

    def moe_(real):
        def f(cfg, p, x):
            seen.setdefault("experts", []).append(list(p.w_gate.shape))
            return real(cfg, p, x)
        return f

    def core(real):
        def f(cfg, p, xb, *a, **kw):
            seen.setdefault("channels", []).append(xb.shape[-1])
            return real(cfg, p, xb, *a, **kw)
        return f

    def gates(real):
        def f(cfg, p, xc, *a, **kw):
            seen.setdefault("channels", []).append(xc.shape[-1])
            return real(cfg, p, xc, *a, **kw)
        return f

    def gather(real):
        def f(self, t, axes, dim=0):
            if "model" in self._axes(axes) and t.data_ptr() in split_leaves:
                seen.setdefault("gathered", []).append(
                    split_leaves[t.data_ptr()])
            return real(self, t, axes, dim)
        return f

    def mlp(real):
        def f(self, x):
            seen.setdefault("mlp", []).append(self.w_up.shape[1])
            return real(self, x)
        return f

    patch(attention, "sdpa", heads)
    patch(ops, "flash_attention", heads)
    patch(ref, "attention_ref", heads)
    patch(layers, "softmax_xent", xent)
    patch(moe, "apply_moe", moe_)
    patch(ssm, "_ssm_core", core)
    patch(rglru, "_gates", gates)
    patch(Mesh, "all_gather", gather)
    patch(layers.MLP, "forward", mlp)

    def undo():
        for owner, name, real in reversed(saved):
            setattr(owner, name, real)
    return undo


def _split_step(arch: str, mesh) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.convert import local_state, state_specs
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.train.steps import make_loss_and_grads
    cfg = get_config(arch, reduced=True).replace(dtype="float32")
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    full = {k: p.detach() for k, p in model.named_parameters()}
    local = local_state(cfg, full, mesh)
    batch = {k: torch.as_tensor(v) for k, v in
             TokenPipeline(cfg, BATCH, SEQ, seed=1).batch_at(0).items()}
    seen = {}
    undo = _record(seen, local, state_specs(cfg, mesh))
    try:
        loss, _ = make_loss_and_grads(model, mesh)(local, batch)
    finally:
        undo()
    both = mesh.all_gather(loss.reshape(1), "model")
    assert torch.equal(both[0], both[1]), (arch, both)

    H, Kv = cfg.eff_heads, cfg.eff_kv_heads
    assert seen["logits"] == cfg.padded_vocab // 2, (arch, seen)
    for q, k in seen.get("attention", []):
        want_k = Kv // 2 if Kv % 2 == 0 else Kv
        assert (q, k) == (H // 2, want_k), (arch, seen["attention"])
    if cfg.family == "moe":
        E = cfg.moe.n_experts
        assert all(s[0] == E // 2 for s in seen["experts"]), seen
        fs = cfg.moe.d_ff_shared or cfg.moe.n_shared * cfg.moe.d_ff_expert
        assert set(seen["mlp"]) <= {cfg.moe.d_ff_dense // 2, fs // 2}, seen
    elif cfg.family == "ssm":
        Di = cfg.ssm.expand * cfg.d_model
        assert set(seen["channels"]) == {Di // 2}, seen
    else:
        assert set(seen["mlp"]) == {cfg.d_ff // 2}, (arch, seen)
    if cfg.family == "hybrid":
        W = cfg.hybrid.lru_width or cfg.d_model
        assert set(seen["channels"]) == {W // 2}, seen
    gathered = seen.get("gathered", [])
    assert all(n.endswith(GATHERED) for n in gathered), (arch, gathered)
    if cfg.family == "hybrid":
        assert gathered, arch         # the gates' weights, by name
    seen["loss"] = float(loss)
    return seen


def _fused(mesh) -> None:
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import sharding as sh
    from repro_torch.models.convert import local_state, state_specs
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.train.steps import make_loss_and_grads
    cfg = get_config("qwen2-0.5b", reduced=True).replace(
        dtype="float32", fused_qkv=True, qkv_bias=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    full = {k: (torch.randn(p.shape, generator=g) * 0.1
                if k.endswith("bqkv") else p.detach())
            for k, p in model.named_parameters()}
    batch = {k: torch.as_tensor(v) for k, v in
             TokenPipeline(cfg, BATCH, SEQ, seed=1).batch_at(0).items()}
    want, wgrads = make_loss_and_grads(model)(full, batch)
    got, grads = make_loss_and_grads(model, mesh)(
        local_state(cfg, full, mesh), batch)
    by_model = {k: sh.restrict(spec, ("model",))
                for k, spec in state_specs(cfg, mesh).items()}
    grads = sh.gather_tree(grads, by_model, mesh)
    np.testing.assert_allclose(got.item(), want.item(), rtol=FUSED_RTOL)
    top = max(float(t.abs().max()) for t in wgrads.values())
    for k, t in wgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), t.numpy(),
                                   rtol=FUSED_RTOL, atol=FUSED_RTOL * top,
                                   err_msg=k)


def _xent(mesh) -> None:
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import Split
    g = torch.Generator().manual_seed(0)
    B, S, V = 3, 5, 64
    logits = torch.randn(B, S, V, generator=g) * 4
    labels = torch.randint(0, V, (B, S), generator=g)
    mask = (torch.rand(B, S, generator=g) > 0.3).float()
    sp = Split(mesh)
    n = V // sp.size
    for kw in ({}, {"mask": mask}, {"mask": mask, "total": torch.tensor(9.)}):
        whole = logits.clone().requires_grad_(True)
        want = L.softmax_xent(whole, labels, **kw)
        (gw,) = torch.autograd.grad(want, whole)
        mine = logits[..., sp.block(n):sp.block(n) + n].clone()
        mine.requires_grad_(True)
        got = L.softmax_xent(mine, labels, split=sp, **kw)
        (gm,) = torch.autograd.grad(got, mine)
        np.testing.assert_allclose(got.item(), want.item(), rtol=XENT_RTOL,
                                   err_msg=str(list(kw)))
        np.testing.assert_allclose(
            gm.numpy(), gw[..., sp.block(n):sp.block(n) + n].numpy(),
            rtol=XENT_RTOL, atol=XENT_RTOL * float(gw.abs().max()),
            err_msg=str(list(kw)))


def _checkpoint(ckpt: str, rank: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import TrainCheckpoints
    from repro_torch.models.convert import local_state
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init
    cfg = get_config("recurrentgemma-2b", reduced=True)
    model = Model(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(2))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params, AdamWConfig(keep_master=True))
    g = torch.Generator().manual_seed(3)
    opt = AdamWState(opt.step + 5, *({k: torch.randn(t.shape, generator=g)
                                      for k, t in tree.items()}
                                     for tree in (opt.mu, opt.nu,
                                                  opt.master)))
    if rank == 0:
        TrainCheckpoints(os.path.join(ckpt, "one"), cfg).save(
            7, (params, opt))
    for shape in ((1, 2), (2, 1)):
        mesh = make_host_mesh(*shape, device="cpu")

        def cut(tree):
            return local_state(cfg, tree, mesh)

        d = os.path.join(ckpt, f"{shape[0]}x{shape[1]}")
        TrainCheckpoints(d, cfg, mesh=mesh).save(7, (cut(params), AdamWState(
            opt.step, cut(opt.mu), cut(opt.nu), cut(opt.master))))
        if rank == 0:
            for name in ("arrays.npz", "manifest.json"):
                with open(os.path.join(ckpt, "one", "step_00000007",
                                       name), "rb") as fh:
                    want = fh.read()
                with open(os.path.join(d, "step_00000007", name),
                          "rb") as fh:
                    assert fh.read() == want, (shape, name)


def _rank(rank: int, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=rank, world_size=2)
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 2, device="cpu")
    seen = {arch: _split_step(arch, mesh) for arch in ARCHS}
    _fused(mesh)
    _xent(mesh)
    _checkpoint(args.ckpt, rank)
    if rank == 0:
        print("SEEN " + json.dumps(seen), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True)
    ap.add_argument("--ckpt", required=True)
    args = ap.parse_args()
    mp.spawn(_rank, args=(args,), nprocs=2, join=True)
    print("SPLIT_OK", flush=True)


if __name__ == "__main__":
    main()
