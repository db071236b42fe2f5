"""K5's batch entry (`ref.scdn_batch_ref`, `ops.scdn_batch`,
`ops.scdn_batch_plan`): one whole SCDN batch on the padded-CSC layout,
against the JAX package's batch on the same numpy inputs.

The data come from `make_sparse_classification`, which samples each
column's rows with replacement: columns hold duplicate rows, which the
batch must merge before phi. Tolerances: alphas exactly equal; w and z
rtol 1e-5, atol 1e-6 (`torch_parity.TOL`: float32 sums in another order);
the loss deltas against K5's rows version on the materialized (P, s)
deltas rel 1e-5 (the same terms summed over distinct rows instead of all
samples).
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
from repro.core.direction import delta_decrement, newton_direction
from repro.core.linesearch import armijo_batched
from repro_torch.core import bundles as B
from repro_torch.core import problem as tprob
from repro_torch.core import scdn as tscdn
from repro_torch.core.design_matrix import PaddedCSCDesign
from repro_torch.core.linesearch import ArmijoParams, candidate_alphas
from repro_torch.data import make_sparse_classification
from repro_torch.kernels import ops, ref

S, N, NNZ = 600, 120, 40


def _reference_batch(jp, cfg, w, z, idx):
    """The reference's SCDN batch (`repro.core.scdn.make_round`'s
    one_batch) on given indices -> (w, z, alphas)."""
    slab = jp.design.gather_slab(idx)
    w_B, _ = jB.gather_vec(w, idx)
    g, h = jp.bundle_grad_hess(z, slab, w_B)
    d = newton_direction(g, h, w_B)
    deltas = jp.design.slab_coordinate_deltas(slab, d)

    def ls_one(delta_j, wj, dj, gj, hj):
        Delta = delta_decrement(gj[None], hj[None], wj[None], dj[None],
                                cfg.armijo.gamma)
        return armijo_batched(jp.loss, jp.c, z, delta_j, jp.y, wj[None],
                              dj[None], Delta, cfg.armijo).alpha

    alphas = jax.vmap(ls_one)(deltas, w_B, d, g, h)
    upd = alphas * d
    w = jB.scatter_add(w, idx, upd)
    z = z + jp.design.slab_matvec(slab, upd)
    return w, z, alphas


def _problems(loss, seed=0, l2=0.0):
    csc, y, _ = make_sparse_classification(S, N, nnz_per_col=NNZ, seed=seed)
    jp = jprob.make_problem(csc, y, c=2.0, loss=loss, elastic_net_l2=l2)
    tp = tprob.make_problem(csc, y, c=2.0, loss=loss, elastic_net_l2=l2,
                            device="cpu")
    return csc, jp, tp


def _has_duplicate_row(csc, j):
    rows = csc.col_rows[j]
    rows = rows[rows < csc.shape[0]]
    return np.unique(rows).size < rows.size


def _batches(csc, seed):
    """Three batches of 8: the first with one feature drawn twice and
    holding a column with a duplicate row, the others random draws."""
    rng = np.random.default_rng(seed)
    dup_cols = [j for j in range(N) if _has_duplicate_row(csc, j)]
    assert dup_cols, "the data must hold a column with a duplicate row"
    first = rng.integers(0, N, 8).astype(np.int32)
    first[1] = dup_cols[seed % len(dup_cols)]
    first[5] = first[2]
    return [first] + [rng.integers(0, N, 8).astype(np.int32)
                      for _ in range(2)]


def _launch_args(tp, P=8, **kw):
    arm = ArmijoParams()
    design = tp.design
    return (design.col_rows, design.col_vals, tp.y,
            candidate_alphas(arm, torch.float32, "cpu"), tp.c), dict(
                kind=tp.loss.name, sigma=arm.sigma, gamma=arm.gamma,
                l2=tp.elastic_net_l2, **kw)


@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scdn_batch_ref_matches_reference(loss, seed):
    csc, jp, tp = _problems(loss, seed=seed)
    batches = _batches(csc, seed)
    assert any(_has_duplicate_row(csc, j) for j in batches[0])
    assert len(set(batches[0].tolist())) < 8          # a duplicate index
    cfg = jscdn.SCDNConfig(P_bar=8)
    w, z = tp_.start_carry(jp, seed=2 + seed)
    jw, jz = jnp.asarray(w), jnp.asarray(z)
    tw, tz = tp_.tensor(w), tp_.tensor(z)
    args, kw = _launch_args(tp)
    for idx in batches:
        jw, jz, ja = _reference_batch(jp, cfg, jw, jz, jnp.asarray(idx))
        col_rows, col_vals, y, alphas, c = args
        ta, _ = ref.scdn_batch_ref(col_rows, col_vals,
                                   tp_.tensor(idx, dtype=torch.int32), tw,
                                   tz, y, alphas, c, **kw)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
    assert torch.count_nonzero(tw - tp_.tensor(w)) > 0


@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_scdn_batch_ref_loss_deltas_match_materialized(kind):
    """The loss deltas over each coordinate's distinct rows are K5's rows
    version on the (P, s) deltas that `slab_coordinate_deltas` builds
    (duplicate rows added before phi there by index_add_)."""
    csc, jp, tp = _problems(kind, seed=3)
    idx = tp_.tensor(_batches(csc, 3)[0], dtype=torch.int32)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=4))
    design = tp.design
    slab = design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    g, h = tp.bundle_grad_hess(z, slab, w_B)
    from repro_torch.core.direction import newton_direction as tnd
    deltas = design.slab_coordinate_deltas(slab, tnd(g, h, w_B))
    args, kw = _launch_args(tp)
    want = ref.pcdn_linesearch_ref(z, deltas, tp.y, args[3], kind=kind)
    _, got = ref.scdn_batch_ref(args[0], args[1], idx, w.clone(), z.clone(),
                                tp.y, args[3], args[4], **kw)
    assert got.shape == (8, 40)
    assert torch.count_nonzero(got) > 0
    err = float(torch.max(torch.abs(got - want)))
    assert err <= 1e-5 * float(torch.max(torch.abs(want))), err


def test_scdn_batch_ref_merges_duplicate_rows():
    """One column holding row 2 twice: the merged loss delta is phi(z +
    a (x1 + x2) d) - phi(z) at that row, which the sum of the two
    one-entry terms is not; the test would fail on an unmerged sum."""
    s = 8
    col_rows = torch.tensor([[2, 2, 5, s], [1, 3, s, s]], dtype=torch.int32)
    col_vals = torch.tensor([[0.9, 0.7, -0.4, 0.0], [0.5, 0.2, 0.0, 0.0]])
    z = torch.linspace(-1.0, 1.5, s)
    y = torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0, 1.0, -1.0, 1.0])
    w = torch.tensor([0.8, 0.0])
    alphas = 0.5 ** torch.arange(6, dtype=torch.float32)
    idx = torch.tensor([0], dtype=torch.int32)
    alpha, lo = ref.scdn_batch_ref(col_rows, col_vals, idx, w.clone(),
                                   z.clone(), y, alphas, 3.0)
    design = PaddedCSCDesign(col_rows, col_vals, s)
    slab = design.gather_slab(idx)
    from repro_torch.core.losses import get_loss
    loss = get_loss("logistic")
    u = 3.0 * loss.dz(z, y)
    v = 3.0 * loss.d2z(z, y)
    rows = slab.rows[0].long().clamp(max=s - 1)
    live = slab.rows[0] < s
    g = torch.sum(torch.where(live, u[rows], 0.0) * slab.vals[0])
    h = torch.sum(torch.where(live, v[rows], 0.0) * slab.vals[0] ** 2)
    from repro_torch.core.direction import newton_direction as tnd
    d = tnd(g[None], h[None], w[:1])
    assert float(d[0]) != 0.0
    merged = ref.pcdn_linesearch_ref(
        z, design.slab_coordinate_deltas(slab, d), y, alphas)
    torch.testing.assert_close(lo, merged, rtol=1e-6, atol=1e-7)
    # the unmerged sum: each entry's term on its own
    zr, yr = z[rows[live]], y[rows[live]]
    terms = loss.value(zr[None, :] + alphas[:, None] * (d[0] * slab.vals[0][
        live])[None, :], yr[None, :]) - loss.value(zr, yr)[None, :]
    unmerged = torch.sum(terms, dim=1)
    assert float(torch.max(torch.abs(unmerged - lo[0]))) > \
        1e-3 * float(torch.max(torch.abs(lo[0])))


def test_scdn_batch_ref_sentinel_slot_adds_nothing():
    """A sentinel index (n) leaves w and z alone; its d is 0, so its
    search takes the first candidate."""
    csc, jp, tp = _problems("logistic", seed=5)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=6))
    args, kw = _launch_args(tp)
    idx = torch.tensor([N, N], dtype=torch.int32)
    w2, z2 = w.clone(), z.clone()
    alpha, lo = ref.scdn_batch_ref(args[0], args[1], idx, w2, z2, tp.y,
                                   args[3], args[4], **kw)
    assert torch.equal(w2, w) and torch.equal(z2, z)
    assert alpha.tolist() == [1.0, 1.0] and not torch.any(lo)


@pytest.mark.parametrize("P,k_max,Q,s,cluster,cpc,slots", [
    (8, 278, 40, 57848, 8, 1, 1024),    # real-sim at the paper's P_bar
    (3, 1, 1, 10, 3, 1, 2),
    (64, 278, 40, 57848, 8, 8, 1024),
    (9, 256, 40, 1000, 8, 2, 512),
])
def test_scdn_batch_plan(P, k_max, Q, s, cluster, cpc, slots):
    plan = ops.scdn_batch_plan(P, k_max, Q, s)
    assert (plan.cluster, plan.cpc, plan.slots) == (cluster, cpc, slots)
    assert plan.cluster * plan.cpc >= P and plan.slots >= 2 * k_max
    assert plan.smem_bytes <= ops.SCDN_SMEM_BUDGET
    assert plan.smem_bytes == ops.scdn_batch_smem_bytes(k_max, slots, cpc, P)


@pytest.mark.parametrize("P,k_max,Q,s,match", [
    (8, 278, 41, 57848, "Q=41 candidates, the kernel takes 1 to 40"),
    (8, 278, 0, 57848, "Q=0 candidates"),
    (0, 278, 40, 57848, "empty batch"),
    (8, 0, 40, 57848, "empty batch"),
    (8, 278, 40, 2 ** 31, "below 2\\*\\*31"),
    (8, 6000, 40, 57848, "k_max = 6000 needs .* more than the 231424"),
    (1000, 278, 40, 57848, "P = 1000 coordinates \\(125 a CTA of one 8-CTA "
                           "cluster\\)"),
])
def test_scdn_batch_plan_refusals(P, k_max, Q, s, match):
    with pytest.raises(ValueError, match=match):
        ops.scdn_batch_plan(P, k_max, Q, s)


def test_scdn_batch_dispatcher_takes_the_plain_version_on_the_cpu():
    """On the CPU `ops.scdn_batch` is `ref.scdn_batch_ref`, into the
    caller's buffers, and counts no launch."""
    csc, jp, tp = _problems("logistic", seed=7)
    w, z = (tp_.tensor(x) for x in tp_.start_carry(jp, seed=8))
    idx = tp_.tensor(_batches(csc, 7)[0], dtype=torch.int32)
    args, kw = _launch_args(tp)
    launch = ops.ScdnBatchLaunch(*args, 8, **kw)
    assert launch.on_cpu
    w_k, z_k, w_p, z_p = w.clone(), z.clone(), w.clone(), z.clone()
    alpha = torch.full((8,), -1.0)
    lo = torch.full((8, 40), -1.0)
    before = ops.launch_counts()["scdn_batch"]
    out = ops.scdn_batch(launch, w_k, z_k, idx, alpha, lo)
    assert ops.launch_counts()["scdn_batch"] == before
    a_p, lo_p = ref.scdn_batch_ref(*args[:2], idx, w_p, z_p, *args[2:],
                                   **kw)
    assert out is alpha and torch.equal(alpha, a_p) and torch.equal(lo, lo_p)
    assert torch.equal(w_k, w_p) and torch.equal(z_k, z_p)


def test_scdn_batch_refuses_a_bf16_design():
    csc, jp, tp = _problems("logistic")
    args, kw = _launch_args(tp)
    with pytest.raises(TypeError, match="takes float32"):
        ops.ScdnBatchLaunch(args[0], args[1].to(torch.bfloat16), *args[2:],
                            8, **kw)


@pytest.mark.parametrize("l2", [0.0, 0.25])
def test_scdn_round_padded_csc_is_the_batch_function(l2):
    """On padded-CSC a round's batch is `ops.scdn_batch` (the plain version
    here, counting no launch), and the `_batch` hook swaps it: both give
    the same bits, and each batch is `ref.scdn_batch_ref` on the carry."""
    csc, jp, tp = _problems("logistic", seed=9, l2=l2)
    cfg = tscdn.SCDNConfig(P_bar=8)
    idxs = np.random.default_rng(9).integers(0, N, (15, 8))
    w0, z0 = torch.zeros(N), torch.zeros(S)
    gen = torch.Generator()
    ops.reset_launch_counts()
    out_k = tscdn.make_round(tp, cfg)(w0, z0, gen, idxs=idxs)
    assert sum(ops.launch_counts().values()) == 0
    out_p = tscdn.make_round(tp, cfg, _batch=ref.scdn_batch_ref)(
        w0, z0, gen, idxs=idxs)
    assert torch.equal(out_k[0], out_p[0]) and torch.equal(out_k[1], out_p[1])
    args, kw = _launch_args(tp)
    w, z = w0.clone(), z0.clone()
    for idx in idxs:
        ref.scdn_batch_ref(*args[:2], torch.tensor(idx, dtype=torch.int32),
                           w, z, *args[2:], **kw)
    assert torch.equal(out_k[0], w) and torch.equal(out_k[1], z)
    assert torch.count_nonzero(w) > 0
