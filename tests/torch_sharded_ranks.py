"""The port's ranks of the multi-rank sharded tests, one process a rank on
gloo (torch.multiprocessing), the group on a FileStore:

    python tests/torch_sharded_ranks.py --shape 2,4 --axes data,model \
        --npz ref.npz --store /tmp/store --steps 3 --p-local 16

Each rank (1) restores every recorded step's carry from the reference's
npz (torch_sharded_multi.py), runs the step on the reference's partitions
and holds F rel <= 1e-5 for both layouts; (2) pins the padded-row
objective: at w = 0 with no update, F = c log 2 * s_pad with s_pad the
padded sample count; (3) solves a 512-row problem to the KKT stop on both
layouts and holds F rel < 1e-4 against the local backend's solve at P =
P_local * model. Prints PORT_OK from the parent when every rank passed.
"""
import argparse
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

F_STEP_RTOL = 1e-5
F_SOLVE_RTOL = 1e-4


def _rank(rank: int, args) -> None:
    torch.set_num_threads(1)
    shape = tuple(int(a) for a in args.shape.split(","))
    axes = tuple(args.axes.split(","))
    world = int(np.prod(shape))
    dist.init_process_group("gloo", init_method=f"file://{args.store}",
                            rank=rank, world_size=world)
    from repro_torch.core import PCDNConfig, make_problem
    from repro_torch.data import make_classification
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.engine.sharded import ShardedBackend, ShardedPCDNConfig
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, axes, device="cpu")
    cfg = ShardedPCDNConfig(P_local=args.p_local, c=1.0,
                            data_axes=axes[:-1])
    ref = np.load(args.npz)
    X, y = ref["X"], ref["y"]
    for layout in ("dense", "padded_csc"):
        b = ShardedBackend(X, y, mesh, cfg, layout=layout)
        for k in range(args.steps):
            st = b.restore_state(ref[f"{layout}_w{k}"], ref[f"{layout}_z{k}"])
            idxs = list(ref[f"{layout}_idxs{k}"])
            out = b.outer(st.w, st.z, st.gen, st.active, True, 1.0,
                          idxs=idxs)
            f, f_ref = float(out[3]), float(ref[f"{layout}_f{k}"])
            assert abs(f - f_ref) <= F_STEP_RTOL * abs(f_ref), \
                (layout, k, f, f_ref)
        # the padded rows' loss: w = 0 and a sentinel-only bundle
        st = b.init_state()
        none = np.full((1, args.p_local), b.n_local, np.int32)
        out = b.outer(st.w, st.z, st.gen, st.active, True, 1.0, idxs=none)
        want = b.s_pad * math.log(2.0)
        assert abs(float(out[3]) - want) <= 1e-6 * want, (float(out[3]),
                                                          want)
    Xs, ys, _ = make_classification(512, 254, sparsity=0.7, corr=0.4, seed=3)
    M = shape[-1]
    for layout in ("dense", "padded_csc"):
        b = ShardedBackend(Xs, ys, mesh, cfg, layout=layout)
        res = engine_loop.solve(b, 1.0, max_outer=60, tol_kkt=1e-3)
        lres = engine_loop.solve(
            LocalBackend(make_problem(Xs, ys, c=1.0, layout=layout,
                                      device="cpu"),
                         PCDNConfig(P=args.p_local * M)),
            1.0, max_outer=60, tol_kkt=1e-3)
        assert res.converged and lres.converged, layout
        rel = abs(res.objective - lres.objective) / abs(lres.objective)
        assert rel < F_SOLVE_RTOL, (layout, res.objective, lres.objective)
        w = b.host_weights(res.w)
        assert w.shape == (254,)
    if rank == 0:
        print(f"[ranks] {mesh.describe()} issued {mesh.counts['issued']} "
              f"of {mesh.counts['asked']} reductions", flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", required=True)
    ap.add_argument("--axes", required=True)
    ap.add_argument("--npz", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--p-local", type=int, default=16)
    args = ap.parse_args()
    world = int(np.prod([int(a) for a in args.shape.split(",")]))
    mp.spawn(_rank, args=(args,), nprocs=world, join=True)
    print("PORT_OK", flush=True)


if __name__ == "__main__":
    main()
