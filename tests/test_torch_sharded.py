"""The port's sharded backend (`repro_torch.engine.sharded`) at a world of 1
against the reference's `ShardedBackend` on a 1x1 mesh (as
tests/test_engine.py builds it) and against the port's local backend.

Every step starts both packages from one carry and feeds the port the
reference's partitions (its key split, fold_in of the model index, then
`bundles.partition`), so the two compute the same step up to float32
summation order: F rel <= 1e-6 and w within 1e-5 * max|w|. The process
group is gloo on a FileStore under the module's tmp dir.

At a world of 1 the reference's kernel route and its plain route agree
(one data shard: the floor of the one h partial is the floor of the sum),
so the port's `use_kernels` steps (the new entries' plain versions on the
CPU) are held against the reference's plain route; the entries themselves
are held against the reference's Pallas K2/K3 in interpret mode, as the
JAX tests run them (g and h rel 1e-5).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import bundles as jB
from repro.data import make_classification
from repro.engine import ShardedBackend as JShardedBackend
from repro.engine import ShardedPCDNConfig as JShardedPCDNConfig
from repro.kernels import ops as jops
from repro_torch.core import PCDNConfig, make_problem
from repro_torch.core import bundles as B
from repro_torch.engine import LocalBackend
from repro_torch.engine import loop as engine_loop
from repro_torch.engine.sharded import (ShardedBackend, ShardedPCDNConfig,
                                        make_sharded_outer)
from repro_torch.fault.checkpoint import host_state
from repro_torch.kernels import ref
from repro_torch.launch import common
from repro_torch.launch.mesh import make_host_mesh, make_mesh

F_RTOL = 1e-6
W_RTOL = 1e-5
P_LOCAL = 32
C = 1.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a case: pytest-xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not dist.is_initialized():
        store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"),
                               1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return make_host_mesh(1, 1, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def data():
    X, y, _ = make_classification(300, 192, sparsity=0.7, corr=0.3, seed=5)
    return np.asarray(X, np.float32), np.asarray(y, np.float32)


def _ref_idxs(key, active, shrink, n_local):
    """The partition the reference's outer draws from the carry key."""
    _, sub = jax.random.split(key)
    _, sub = jax.random.split(sub)
    sub = jax.random.fold_in(sub, 0)
    if shrink:
        idxs, b_active = jB.partition_active(sub, jnp.asarray(active),
                                             P_LOCAL)
        return np.asarray(idxs), int(b_active)
    return np.asarray(jB.partition(sub, n_local, P_LOCAL)), None


def _close_w(got, want):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= W_RTOL * scale


CASES = {
    # layout, ls_scope, ls_kind, fuse, shrink, record_aux, kkt_vec, kernels
    "dense": ("dense", "full", "batched", True, False, False, False, False),
    "dense_kernels": ("dense", "full", "batched", True, False, True, True,
                      True),
    "dense_backtracking_unfused": ("dense", "full", "backtracking", False,
                                   False, False, False, False),
    "csc_full": ("padded_csc", "full", "batched", True, False, False, False,
                 False),
    "csc_full_kernels_shrink": ("padded_csc", "full", "batched", True, True,
                                True, False, True),
    "csc_support": ("padded_csc", "support", "batched", True, False, True,
                    True, False),
    "csc_support_kernels_unfused": ("padded_csc", "support", "batched",
                                    False, True, False, True, True),
    "csc_backtracking_kernels": ("padded_csc", "full", "backtracking", True,
                                 False, True, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_reference_and_local(case, mesh, jmesh, data):
    (layout, scope, ls_kind, fuse, shrink, aux, kkt_vec,
     kernels) = CASES[case]
    X, y = data
    kw = dict(P_local=P_LOCAL, c=C, ls_kind=ls_kind, fuse_collectives=fuse,
              ls_scope=scope, shrink=shrink, record_aux=aux,
              record_kkt_vec=kkt_vec)
    jb = JShardedBackend(X, y, jmesh, JShardedPCDNConfig(**kw),
                         layout=layout)
    tb = ShardedBackend(X, y, mesh, ShardedPCDNConfig(**kw,
                                                      use_kernels=kernels),
                        layout=layout)
    prob = make_problem(X, y, c=C, layout=layout, device="cpu")
    lb = LocalBackend(prob, PCDNConfig(P=P_LOCAL, ls_kind=ls_kind,
                                       ls_scope=scope, shrink=shrink,
                                       use_kernels=kernels, record_aux=aux,
                                       record_kkt_vec=kkt_vec))
    assert tb.outer.use_support == (scope == "support")
    js = jb.init_state()
    n = X.shape[1]
    for k in range(3):
        w0 = np.asarray(js.w)
        z0 = np.asarray(js.z)
        act0 = np.asarray(js.active)
        idxs, b_active = _ref_idxs(js.key, act0, shrink, n)
        jout = jb.outer(js.w, js.z, js.key, js.active, True, C)
        st = tb.restore_state(w0, z0, act0)
        tout = tb.outer(st.w, st.z, st.gen, st.active, True, C, idxs=idxs,
                        b_active=b_active)
        lout = lb.outer(torch.tensor(w0), torch.tensor(z0), st.gen,
                        torch.tensor(act0), True, C, idxs=idxs,
                        b_active=b_active)
        f_ref = float(jout[3])
        for out in (tout, lout):
            assert abs(float(out[3]) - f_ref) <= F_RTOL * abs(f_ref), k
            _close_w(out[0].numpy(), np.asarray(jout[0]))
            assert int(out[5]) == int(jout[5])             # nnz
            assert int(out[8]) == int(jout[8])             # n_active
            np.testing.assert_array_equal(out[7].numpy(),
                                          np.asarray(jout[7]))
        np.testing.assert_allclose(float(tout[4]), float(jout[4]),
                                   rtol=1e-4, atol=1e-6)
        extras = tout[9:]
        if aux:
            q, a = extras[0]
            jq, ja = jout[9]
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        if kkt_vec:
            viol = extras[-1].numpy()
            assert viol.shape == (n,)
            np.testing.assert_allclose(viol, np.asarray(jout[-1])[:n],
                                       rtol=1e-4, atol=1e-5)
        js = js._replace(w=jout[0], z=jout[1], key=jout[2], active=jout[7])


def test_solves_to_the_local_objective(mesh, data):
    """End to end: a converged sharded solve's F within 1e-4 of the local
    solve's, both layouts."""
    X, y = data
    for layout in ("dense", "padded_csc"):
        tb = ShardedBackend(X, y, mesh, ShardedPCDNConfig(P_local=P_LOCAL,
                                                          c=C),
                            layout=layout)
        res = engine_loop.solve(tb, C, max_outer=100, tol_kkt=1e-3)
        lres = engine_loop.solve(
            LocalBackend(make_problem(X, y, c=C, layout=layout,
                                      device="cpu"), PCDNConfig(P=P_LOCAL)),
            C, max_outer=100, tol_kkt=1e-3)
        assert res.converged and lres.converged
        assert abs(res.objective - lres.objective) <= \
            1e-4 * abs(lres.objective)
        assert tb.host_weights(res.w).shape == (X.shape[1],)


def _slab(rng, P, K, s):
    rows = rng.integers(0, s + 1, size=(P, K)).astype(np.int32)
    vals = rng.standard_normal((P, K)).astype(np.float32)
    vals[rows == s] = 0.0
    return rows, vals


@pytest.mark.parametrize("kind", ["logistic", "squared_hinge"])
def test_entry_plain_versions_match_reference_pallas(kind):
    """The three new entries' plain versions against what the reference's
    sharded backend computes: its Pallas K2 and K3 with l2 = 0 (interpret
    mode) for the partials, its jnp scatter for X_B d."""
    from repro.core.losses import get_loss
    rng = np.random.default_rng(3)
    s, P, K, n = 200, 24, 9, 60
    z = rng.standard_normal(s).astype(np.float32)
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    jl = get_loss(kind)
    u = np.asarray(C * jl.dz(jnp.asarray(z), jnp.asarray(y)))
    v = np.asarray(C * jl.d2z(jnp.asarray(z), jnp.asarray(y)))
    w_B = np.zeros(P, np.float32)
    rows, vals = _slab(rng, P, K, s)
    _, jg, jh = jops.pcdn_sparse_direction(jnp.asarray(rows),
                                           jnp.asarray(vals), jnp.asarray(u),
                                           jnp.asarray(v),
                                           jnp.asarray(w_B), l2=0.0)
    g, h = ref.pcdn_sparse_direction_partials_ref(
        torch.tensor(rows), torch.tensor(vals), torch.tensor(z),
        torch.tensor(y), C, kind=kind)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-12)
    XT = rng.standard_normal((n, s)).astype(np.float32)
    idx = rng.choice(n, P, replace=False).astype(np.int32)
    idx[-3:] = n
    slab = np.where(idx[None, :] < n, XT[np.minimum(idx, n - 1)].T, 0.0)
    _, jg, jh = jops.pcdn_direction(jnp.asarray(slab, jnp.float32),
                                    jnp.asarray(u), jnp.asarray(v),
                                    jnp.asarray(w_B), l2=0.0)
    g, h = ref.pcdn_direction_partials_ref(
        torch.tensor(XT), torch.tensor(idx), torch.tensor(z),
        torch.tensor(y), C, kind=kind)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-12)
    d = rng.standard_normal(P).astype(np.float32)
    jdelta = jnp.zeros((s,), jnp.float32).at[jnp.asarray(rows)].add(
        jnp.asarray(vals) * jnp.asarray(d)[:, None], mode="drop")
    delta = ref.pcdn_sparse_scatter_ref(torch.tensor(rows),
                                        torch.tensor(vals), torch.tensor(d),
                                        s)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta),
                               rtol=1e-5, atol=1e-6)


def test_restore_state_round_trips_and_crosses_backends(mesh, data):
    """host image -> restore_state gives the same carry; a sharded image
    restores on the local backend and back, bit-equal."""
    X, y = data
    cfg = ShardedPCDNConfig(P_local=P_LOCAL, c=C, shrink=True)
    tb = ShardedBackend(X, y, mesh, cfg, layout="padded_csc")
    st = tb.init_state()
    out = tb.outer(st.w, st.z, st.gen, st.active, True, C)
    st = st._replace(w=out[0], z=out[1], gen=out[2], active=out[7])
    snap = host_state(tb, st)
    gen_state = st.gen.get_state()
    back = tb.restore_state(**snap, gen_state=gen_state)
    assert torch.equal(back.w, st.w) and torch.equal(back.z, st.z)
    assert torch.equal(back.active, st.active)
    assert torch.equal(back.gen.get_state(), gen_state)
    lb = LocalBackend(make_problem(X, y, c=C, layout="padded_csc",
                                   device="cpu"), PCDNConfig(P=P_LOCAL))
    local = lb.restore_state(**snap, gen_state=gen_state)
    again = tb.restore_state(**host_state(lb, local), gen_state=gen_state)
    assert torch.equal(again.w, st.w) and torch.equal(again.z, st.z)
    assert torch.equal(again.active, st.active)
    # without z the margins are recomputed from w
    recomputed = tb.restore_state(snap["w"])
    torch.testing.assert_close(recomputed.z, st.z, rtol=1e-5, atol=1e-5)


class _ModelTwoMesh:
    """Just enough of a Mesh for make_sharded_outer's checks: a model axis
    of size 2."""

    def size(self, axes):
        return 2 if axes == "model" else 1

    def index(self, axes):
        return 0


def test_refusals(mesh, data):
    X, y = data
    design = make_problem(X, y, c=C, layout="padded_csc",
                          device="cpu").design
    with pytest.raises(ValueError, match="model axis of size 1"):
        make_sharded_outer(ShardedPCDNConfig(P_local=8, c=C,
                                             ls_scope="support"),
                           _ModelTwoMesh(), design, torch.ones(300))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_host_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    ap = argparse.ArgumentParser()
    args = argparse.Namespace(dtype="bf16", backend="sharded", tol=1e-3)
    with pytest.raises(SystemExit):
        common.check_dtype_envelope(args, ap, loss="logistic")


def test_partitions_are_drawn_per_model_shard(mesh, data):
    """One seed a step from the carry, then model shard m's own generator:
    the same carry gives the same partition; the carry advances."""
    X, y = data
    tb = ShardedBackend(X, y, mesh, ShardedPCDNConfig(P_local=P_LOCAL, c=C),
                        layout="dense")
    st = tb.init_state()
    st2 = tb.init_state()
    a = tb.outer(st.w, st.z, st.gen, st.active, True, C)
    b = tb.outer(st2.w, st2.z, st2.gen, st2.active, True, C)
    assert torch.equal(a[0], b[0]) and float(a[3]) == float(b[3])
    assert not torch.equal(a[2].get_state(),
                           torch.Generator().manual_seed(0).get_state())
    from repro_torch.engine.sharded import draw_step_seed, shard_generator
    g0 = torch.Generator().manual_seed(0)
    idxs = B.partition(shard_generator(draw_step_seed(g0), 0),
                       X.shape[1], P_LOCAL)
    c = tb.outer(st.w, st.z, torch.Generator().manual_seed(0), st.active,
                 True, C, idxs=idxs)
    assert torch.equal(c[0], a[0])
