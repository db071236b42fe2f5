"""K5's dense batch entry (`ref.scdn_dense_batch_ref`, `ops.scdn_dense_batch`,
`ops.scdn_dense_plan`): one whole SCDN batch on the dense layout, read from
the design's feature-major copy, against the JAX package's dense batch on
the same numpy inputs.

Tolerances: alphas exactly equal; w and z rtol 1e-5, atol 1e-6
(`torch_parity.TOL`: float32 sums in another order); the loss deltas
against `jax.vmap` of the reference's K5 oracle on the reference's (P, s)
deltas rel 1e-5 (the same terms, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro.core import bundles as jB
from repro.core import problem as jprob
from repro.core import scdn as jscdn
from repro.core.direction import newton_direction
from repro.data import make_classification
from repro.kernels import ref as jref
from repro_torch.core import problem as tprob
from repro_torch.core import scdn as tscdn
from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
from repro_torch.kernels import ops, ref
from test_torch_baselines import _reference_batch

S, N = 400, 96


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a case: under pytest-xdist several workers share
    the machine's cores, and torch's default of a thread a core in each of
    them makes these small problems wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(loss, seed=0, l2=0.0):
    X, y, _ = make_classification(S, N, sparsity=0.5, seed=seed)
    return (jprob.make_problem(X, y, c=2.0, loss=loss, elastic_net_l2=l2,
                               layout="dense"),
            tprob.make_problem(X, y, c=2.0, loss=loss, elastic_net_l2=l2,
                               layout="dense", device="cpu"))


def _batches(seed):
    """A batch of 8 with one feature drawn three times, a random batch of
    8, and a batch of 128 > n features (duplicates by necessity)."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, N, 8).astype(np.int32)
    first[4] = first[6] = first[1]
    return [first, rng.integers(0, N, 8).astype(np.int32),
            rng.integers(0, N, 128).astype(np.int32)]


def _launch_args(tp):
    arm = ArmijoParams()
    return (tp.design.feature_major(), tp.y,
            candidate_alphas(arm, torch.float32, "cpu"), tp.c), dict(
                kind=tp.loss.name, sigma=arm.sigma, gamma=arm.gamma,
                l2=tp.elastic_net_l2)


def _reference_search(jp, cfg, w, z, idx):
    """The reference's searches at the carry (w, z): `jax.vmap` of its K5
    oracle over its (P, s) per-coordinate deltas -> (loss deltas (P, Q),
    the Armijo margins c lo + |w + a d| - |w| - sigma a Delta (P, Q), the
    directions d (P,), the slab)."""
    slab = jp.design.gather_slab(idx)
    w_B, _ = jB.gather_vec(w, idx)
    g, h = jp.bundle_grad_hess(z, slab, w_B)
    d = newton_direction(g, h, w_B)
    deltas = jp.design.slab_coordinate_deltas(slab, d)
    arm = cfg.armijo
    alphas = arm.beta ** jnp.arange(arm.max_steps, dtype=jnp.float32)
    lo = jax.vmap(lambda dl: jref.pcdn_linesearch_ref(
        z, dl, jp.y, alphas, kind=jp.loss.name))(deltas)
    Delta = g * d + arm.gamma * (h * jnp.square(d)) + \
        (jnp.abs(w_B + d) - jnp.abs(w_B))
    wq = w_B[:, None] + alphas[None, :] * d[:, None]
    margin = jp.c * lo + (jnp.abs(wq) - jnp.abs(w_B)[:, None]) - \
        arm.sigma * alphas[None, :] * Delta[:, None]
    return np.asarray(lo), np.asarray(margin), d, slab


def _step_index(alpha, Q):
    """The candidate index of an accepted alpha (Q: none passed)."""
    return Q if alpha == 0.0 else int(round(-np.log2(alpha)))


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge", "squared"])
@pytest.mark.parametrize("l2", [0.0, 0.25])
def test_scdn_dense_batch_ref_matches_reference(loss, l2):
    """Three batches in turn (a feature drawn three times, then a random
    batch, then P 128 > n 96), each from the carry the reference's last
    batch left, shared: the loss deltas within rel 1e-5 of the reference's
    K5 oracle, alphas equal, w and z within TOL.

    An alpha may differ only at an Armijo boundary: where the reference's
    margin at the first candidate the two decide differently lies within
    the loss deltas' own tolerance (times c), the float32 sums of the
    two packages' transcendentals decide it (d ~ 0, or a deep backtrack
    whose margin is a tiny a Delta). There w and z are held to the
    reference's update with the port's alphas; at most 1 slot in 20 may
    flip."""
    jp, tp = _problems(loss, seed=1, l2=l2)
    cfg = jscdn.SCDNConfig(P_bar=8)
    w, z = tp_.start_carry(jp, seed=3)
    jw, jz = jnp.asarray(w), jnp.asarray(z)
    args, kw = _launch_args(tp)
    XT, y, alphas, c = args
    for idx in _batches(1):
        tw, tz = tp_.tensor(jw), tp_.tensor(jz)
        jidx = jnp.asarray(idx)
        want_lo, margin, d_ref, slab = _reference_search(jp, cfg, jw, jz,
                                                         jidx)
        w0, z0 = jw, jz
        jw, jz, ja = _reference_batch(jp, cfg, jw, jz, jidx)
        ta, lo = ref.scdn_dense_batch_ref(
            XT, tp_.tensor(idx, dtype=torch.int32), tw, tz, y, alphas, c,
            **kw)
        assert lo.shape == (idx.size, 40)
        tol_lo = 1e-5 * float(np.max(np.abs(want_lo)))
        err = float(np.max(np.abs(lo.numpy() - want_lo)))
        assert err <= tol_lo, err
        ja = np.asarray(ja)
        flips = np.flatnonzero(ta.numpy() != ja)
        assert flips.size <= idx.size // 20, flips
        for p in flips:
            q = min(_step_index(float(ta[p]), 40), _step_index(ja[p], 40))
            assert abs(margin[p, q]) <= c * tol_lo, (p, q, margin[p, q])
        w_want, z_want = jw, jz
        if flips.size:  # the reference's update with the port's alphas
            upd = jnp.asarray(ta.numpy()) * d_ref
            w_want = jB.scatter_add(w0, jidx, upd)
            z_want = z0 + jp.design.slab_matvec(slab, upd)
        np.testing.assert_allclose(tw.numpy(), np.asarray(w_want), **tp_.TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(z_want), **tp_.TOL)
    assert np.count_nonzero(np.asarray(jw) - w) > 0


def test_scdn_dense_batch_ref_adds_every_duplicate():
    """A feature drawn three times moves w by the sum of its three slots'
    steps, and z by that sum times its column."""
    jp, tp = _problems("logistic", seed=2)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=4))
    args, kw = _launch_args(tp)
    idx = torch.tensor([7, 7, 7, 30], dtype=torch.int32)
    w2, z2 = w.clone(), z.clone()
    alpha, _ = ref.scdn_dense_batch_ref(args[0], idx, w2, z2, *args[1:],
                                        **kw)
    assert float(alpha[0]) > 0 and torch.equal(alpha[:3],
                                               alpha[:1].expand(3))
    step = w2[7] - w[7]
    one = float(step) / 3
    moved = (z2 - z) - (w2[30] - w[30]) * args[0][30]
    torch.testing.assert_close(moved, 3 * one * args[0][7], rtol=1e-4,
                               atol=1e-6)
    assert float(step) != 0.0


def test_scdn_dense_batch_ref_sentinel_slot_adds_nothing():
    """A sentinel index (n) leaves w and z alone; its d is 0, so its search
    takes the first candidate with every loss delta 0."""
    jp, tp = _problems("logistic", seed=5)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=6))
    args, kw = _launch_args(tp)
    idx = torch.tensor([N, N], dtype=torch.int32)
    w2, z2 = w.clone(), z.clone()
    alpha, lo = ref.scdn_dense_batch_ref(args[0], idx, w2, z2, *args[1:],
                                         **kw)
    assert torch.equal(w2, w) and torch.equal(z2, z)
    assert alpha.tolist() == [1.0, 1.0] and not torch.any(lo)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge", "squared"])
def test_scdn_dense_batch_early_exit_takes_the_full_scans_alpha(loss):
    """The kernel's search takes the candidates ops.SCDN_DENSE_CHUNK a pass
    and stops at the first pass holding a passing one: on the full scan's
    loss deltas that rule picks each slot's alpha of the full scan. The
    dispatcher with and without the loss-delta buffer gives the same
    alpha, w and z. sigma 0.999 asks for nearly all of the predicted decrease,
    so some searches pass their first chunk."""
    jp, tp = _problems(loss, seed=7)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=8))
    args, kw = _launch_args(tp)
    kw["sigma"] = 0.999
    XT, y, alphas, c = args
    idx = tp_.tensor(_batches(7)[2], dtype=torch.int32)
    launch = ops.ScdnDenseBatchLaunch(*args, 128, **kw)
    runs = []
    for with_lo in (True, False):
        w2, z2 = w.clone(), z.clone()
        lo = torch.full((128, 40), -1.0) if with_lo else None
        a = ops.scdn_dense_batch(launch, w2, z2, idx, None, lo)
        runs.append((a, w2, z2, lo))
    (a_full, w_full, z_full, lo), (a_early, w_early, z_early, _) = runs
    assert torch.equal(a_full, a_early)
    assert torch.equal(w_full, w_early) and torch.equal(z_full, z_early)
    # the chunked rule on the full scan's loss deltas
    n = XT.shape[0]
    w_B = torch.where(idx < n, w[idx.clamp(max=n - 1).long()], 0.0)
    XB = XT[idx.long()]
    g = XB @ (c * tp.loss.dz(z, y))
    h = torch.clamp_min(torch.square(XB) @ (c * tp.loss.d2z(z, y)), 1e-12)
    from repro_torch.core.direction import newton_direction as tnd
    d = tnd(g, h, w_B)
    Delta = g * d + (torch.abs(w_B + d) - torch.abs(w_B))
    f = c * lo + (torch.abs(w_B[:, None] + alphas[None, :] * d[:, None]) -
                  torch.abs(w_B)[:, None])
    ok = f <= kw["sigma"] * alphas[None, :] * Delta[:, None]
    chunk = ops.SCDN_DENSE_CHUNK
    for p in range(128):
        want = 0.0
        for q0 in range(0, 40, chunk):
            hits = torch.nonzero(ok[p, q0:q0 + chunk])
            if hits.numel():
                want = float(alphas[q0 + int(hits[0])])
                break
        assert float(a_full[p]) == want, (p, float(a_full[p]), want)
    assert bool(torch.any(a_full < 0.5 ** (chunk - 1))), a_full


@pytest.mark.parametrize("P,s,Q,sms,cluster,clusters,cpc,sl,tile,resident", [
    (64, 6000, 40, 132, 2, 64, 1, 3000, 3000, True),   # gisette, P_bar 64
    (8, 8192, 40, 132, 8, 8, 1, 1024, 1024, True),     # a9a, P_bar 8
    (200, 6000, 40, 132, 1, 132, 2, 6000, 6000, True),  # several in turn
    (64, 57848, 40, 132, 2, 64, 1, 28924, 8192, False),  # streamed tiles
    (1, 10, 1, 132, 8, 1, 1, 4, 4, True),
    (20, 1001, 7, 132, 6, 20, 1, 168, 168, True),       # s not 4-aligned
    (3, 100, 40, 1, 1, 1, 3, 100, 100, True),           # one SM
])
def test_scdn_dense_plan(P, s, Q, sms, cluster, clusters, cpc, sl, tile,
                         resident):
    plan = ops.scdn_dense_plan(P, s, Q, sms)
    assert (plan.cluster, plan.clusters, plan.cpc, plan.sl, plan.tile,
            plan.resident) == (cluster, clusters, cpc, sl, tile, resident)
    assert plan.ctas <= sms and plan.cluster <= ops.SCDN_DENSE_MAX_CLUSTER
    assert plan.clusters * plan.cpc >= P and plan.cluster * plan.sl >= s
    assert plan.sl % 4 == 0 and plan.tile <= plan.sl
    assert plan.smem_bytes <= ops.SCDN_DENSE_SMEM_BUDGET
    assert plan.smem_bytes == ops.scdn_dense_smem_bytes(plan.tile)


@pytest.mark.parametrize("P,s,Q,sms,match", [
    (64, 6000, 41, 132, "Q=41 candidates, the kernel takes 1 to 40"),
    (64, 6000, 0, 132, "Q=0 candidates"),
    (0, 6000, 40, 132, "empty batch"),
    (64, 0, 40, 132, "empty batch"),
    (64, 2 ** 31, 40, 132, "below 2\\*\\*31"),
    (64, 6000, 40, 0, "a card of 0 SMs"),
])
def test_scdn_dense_plan_refusals(P, s, Q, sms, match):
    with pytest.raises(ValueError, match=match):
        ops.scdn_dense_plan(P, s, Q, sms)


def test_scdn_dense_batch_refuses_a_bf16_design_and_41_candidates():
    _, tp = _problems("logistic")
    args, kw = _launch_args(tp)
    with pytest.raises(TypeError, match="takes float32"):
        ops.ScdnDenseBatchLaunch(args[0].to(torch.bfloat16), *args[1:], 8,
                                 **kw)
    with pytest.raises(ValueError, match="Q=41"):
        ops.ScdnDenseBatchLaunch(args[0], args[1], torch.ones(41), args[3],
                                 8, **kw)


def test_scdn_dense_batch_dispatcher_takes_the_plain_version_on_the_cpu():
    """On the CPU `ops.scdn_dense_batch` is `ref.scdn_dense_batch_ref`, into
    the caller's buffers, and counts no launch."""
    jp, tp = _problems("squared_hinge", seed=9, l2=0.1)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=10))
    idx = tp_.tensor(_batches(9)[0], dtype=torch.int32)
    args, kw = _launch_args(tp)
    launch = ops.ScdnDenseBatchLaunch(*args, 8, **kw)
    assert launch.on_cpu and launch.design_args[0] is args[0]
    w_k, z_k, w_p, z_p = w.clone(), z.clone(), w.clone(), z.clone()
    alpha = torch.full((8,), -1.0)
    lo = torch.full((8, 40), -1.0)
    before = ops.launch_counts()["scdn_dense_batch"]
    out = ops.scdn_dense_batch(launch, w_k, z_k, idx, alpha, lo)
    assert ops.launch_counts()["scdn_dense_batch"] == before
    a_p, lo_p = ref.scdn_dense_batch_ref(args[0], idx, w_p, z_p, *args[1:],
                                         **kw)
    assert out is alpha and torch.equal(alpha, a_p) and torch.equal(lo, lo_p)
    assert torch.equal(w_k, w_p) and torch.equal(z_k, z_p)


@pytest.mark.parametrize("l2", [0.0, 0.25])
def test_scdn_round_dense_is_the_batch_function(l2):
    """On dense a round's batch is `ops.scdn_dense_batch` (the plain version
    here, counting no launch), and the `_batch` hook swaps it: both give
    the same bits, and each batch is `ref.scdn_dense_batch_ref` on the
    carry; `solve` takes the same hook."""
    _, tp = _problems("logistic", seed=11, l2=l2)
    cfg = tscdn.SCDNConfig(P_bar=8)
    idxs = np.random.default_rng(11).integers(0, N, (12, 8))
    w0, z0 = torch.zeros(N), torch.zeros(S)
    gen = torch.Generator()
    ops.reset_launch_counts()
    out_k = tscdn.make_round(tp, cfg)(w0, z0, gen, idxs=idxs)
    assert sum(ops.launch_counts().values()) == 0
    out_p = tscdn.make_round(tp, cfg, _batch=ref.scdn_dense_batch_ref)(
        w0, z0, gen, idxs=idxs)
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    args, kw = _launch_args(tp)
    w, z = w0.clone(), z0.clone()
    for idx in idxs:
        ref.scdn_dense_batch_ref(args[0], torch.tensor(idx, dtype=torch.int32),
                                 w, z, *args[1:], **kw)
    assert torch.equal(out_k[0], w) and torch.equal(out_k[1], z)
    assert torch.count_nonzero(w) > 0
    scfg = tscdn.SCDNConfig(P_bar=8, max_rounds=3)
    r_k = tscdn.solve(tp, scfg)
    r_p = tscdn.solve(tp, scfg, _batch=ref.scdn_dense_batch_ref)
    np.testing.assert_array_equal(r_k.history["objective"],
                                  r_p.history["objective"])
    assert torch.equal(r_k.w, r_p.w)
