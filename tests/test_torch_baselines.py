"""The paper's baselines in the port (`repro_torch.core.scdn`, `tron`) and
the host loop's divergence results, against the JAX package on the same
numpy inputs.

* One SCDN batch from a shared carry and shared indices (one duplicated),
  against the reference's public functions composed in its `one_batch`
  order: alphas equal, w and z rtol 1e-5 (atol 1e-6; float32 sums in
  another order).
* Whole SCDN solves draw different indices (torch.Generator vs
  jax.random), so they are compared where they converge (tol 1e-3): F rel
  <= 1e-3 between the packages and against PCDN's.
* TRON: F and KKT of the first 5 iterations at rel 1e-4 (the CG breaks
  compare floats, so later iterations may part by an ulp's decision), the
  final F at tol 1e-3 at rel 1e-4.
* The loop's `diverged` / `nonfinite` / rollback and divergence guard,
  the same outer through both loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro.core import bundles as jB
from repro.core import pcdn as jpcdn
from repro.core import problem as jprob
from repro.core import scdn as jscdn
from repro.core import tron as jtron
from repro.core.direction import delta_decrement, newton_direction
from repro.core.linesearch import armijo_batched
from repro.data import make_classification
from repro.engine import loop as jloop
from repro_torch.core import pcdn as tpcdn
from repro_torch.core import problem as tprob
from repro_torch.core import scdn as tscdn
from repro_torch.core import tron as ttron
from repro_torch.engine import loop as tloop


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


def _problems(layout, loss, seed=0):
    X, y, _ = make_classification(400, 96, sparsity=0.5 if layout == "dense"
                                  else 0.93, seed=seed)
    return (jprob.make_problem(X, y, c=2.0, loss=loss, layout=layout),
            tprob.make_problem(X, y, c=2.0, loss=loss, layout=layout,
                               device="cpu"))


# P_bar 8 with feature 5 drawn twice, then a batch of distinct features
BATCHES = [np.array([5, 17, 40, 5, 88, 63, 11, 95], np.int32),
           np.array([0, 2, 31, 64, 70, 77, 90, 91], np.int32)]


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_scdn_batch_matches_reference(layout, loss):
    jp, tp = _problems(layout, loss)
    cfg = jscdn.SCDNConfig(P_bar=8)
    round_ = tscdn.make_round(tp, tscdn.SCDNConfig(P_bar=8))
    w, z = tp_.start_carry(jp, seed=2)
    jw, jz = jnp.asarray(w), jnp.asarray(z)
    tw, tz = tp_.tensor(w), tp_.tensor(z)
    for idx in BATCHES:
        w_before, z_before = tw.clone(), tz.clone()
        jw, jz, ja = _reference_batch(jp, cfg, jw, jz, jnp.asarray(idx))
        ta = round_.one_batch(tw, tz, tp_.tensor(idx, dtype=torch.int32))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
        moved = tw - w_before
        assert torch.count_nonzero(moved) > 0
        if idx[0] == idx[3]:
            # both of the duplicate's updates landed (index_add_, not a
            # gather-modify-write that would keep one)
            d = _direction(tp, w_before, z_before, idx)
            want = float(ta[0] * d[0] + ta[3] * d[3])
            assert float(moved[5]) == pytest.approx(want, rel=1e-5)


def _direction(tp, w, z, idx):
    from repro_torch.core import bundles as B
    from repro_torch.core.direction import newton_direction as tnd
    idx = tp_.tensor(idx, dtype=torch.int32)
    slab = tp.design.gather_slab(idx)
    w_B, _ = B.gather_vec(w, idx)
    g, h = tp.bundle_grad_hess(z, slab, w_B)
    return tnd(g, h, w_B)


def test_scdn_round_takes_indices_and_copies_the_carry():
    """A round on given (n_batches, P_bar) indices is the batches in turn,
    and leaves its input carry alone."""
    _, tp = _problems("padded_csc", "logistic")
    round_ = tscdn.make_round(tp, tscdn.SCDNConfig(P_bar=8))
    assert round_.n_batches == 12
    w0 = torch.zeros(tp.n_features)
    z0 = torch.zeros(tp.n_samples)
    idxs = np.random.default_rng(3).integers(0, tp.n_features, (12, 8))
    gen = torch.Generator().manual_seed(0)
    w, z, _, f, kkt = round_(w0, z0, gen, idxs=idxs)
    assert not torch.any(w0) and not torch.any(z0)
    wb, zb = w0.clone(), z0.clone()
    for idx in idxs:
        round_.one_batch(wb, zb, torch.tensor(idx, dtype=torch.int32))
    assert torch.equal(w, wb) and torch.equal(z, zb)
    assert float(f) == float(tp.objective_from_margins(z, w))
    assert float(kkt) == float(tp.kkt_violation(w, z))
    # drawn from the generator: the same seed gives the same round
    r1 = round_(w0, z0, torch.Generator().manual_seed(4))
    r2 = round_(w0, z0, torch.Generator().manual_seed(4))
    assert torch.equal(r1[0], r2[0])


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_scdn_solve_converges_to_reference_objective(layout):
    jp, tp = _problems(layout, "logistic", seed=1)
    kw = dict(P_bar=8, max_rounds=300, tol_kkt=1e-3)
    ja = jscdn.solve(jp, jscdn.SCDNConfig(**kw))
    ta = tscdn.solve(tp, tscdn.SCDNConfig(**kw))
    f_pcdn = tpcdn.solve(tp, tpcdn.PCDNConfig(P=8, max_outer=300,
                                              tol_kkt=1e-3)).objective
    assert ja.converged and ta.converged and not ta.diverged
    assert abs(ta.objective - ja.objective) <= 1e-3 * abs(ja.objective)
    assert abs(ta.objective - f_pcdn) <= 1e-3 * abs(f_pcdn)
    h = ta.history
    assert set(h) == set(ja.history) and len(h["round"]) == ta.n_rounds
    assert h["kkt"][-1] <= 1e-3


def test_scdn_diverges_under_correlation():
    """The reference's divergence case (tests/test_system.py): P_bar 64 on
    correlated dense data trips the guard in the port too."""
    X, y, _ = make_classification(300, 200, sparsity=0.0, corr=0.95,
                                  seed=2, row_normalize=False)
    tp = tprob.make_problem(X, y, c=1.0, device="cpu")
    res = tscdn.solve(tp, tscdn.SCDNConfig(P_bar=64, max_rounds=30))
    assert res.diverged and not res.converged
    assert res.n_rounds < 30


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_tron_matches_reference(layout):
    jp, tp = _problems(layout, "logistic", seed=5)
    cfg = dict(max_outer=60, tol_kkt=1e-3)
    ja = jtron.solve(jp, jtron.TRONConfig(**cfg))
    ta = ttron.solve(tp, ttron.TRONConfig(**cfg))
    np.testing.assert_allclose(ta.history["objective"][:5],
                               ja.history["objective"][:5], rtol=1e-4)
    # the KKT is |g_j| - 1 near convergence, |g_j| about 1: one float32
    # ulp of g (1.2e-7) moves it by rel 2e-4 at 5e-4, so 2 ulps absolute
    np.testing.assert_allclose(ta.history["kkt"][:5], ja.history["kkt"][:5],
                               rtol=1e-4, atol=2 * 2.0 ** -23)
    assert ja.converged and ta.converged
    assert ta.objective == pytest.approx(ja.objective, rel=1e-4)
    assert set(ta.history) == set(ja.history)
    assert ta.w.dtype == torch.float32 and ta.w.shape == (96,)


def test_tron_and_pcdn_agree_at_the_optimum():
    _, tp = _problems("padded_csc", "squared_hinge", seed=5)
    f_tron = ttron.solve(tp, ttron.TRONConfig(tol_kkt=1e-4)).objective
    f_pcdn = tpcdn.solve(tp, tpcdn.PCDNConfig(P=16, max_outer=300,
                                              tol_kkt=1e-4)).objective
    assert abs(f_tron - f_pcdn) <= 1e-4 * abs(f_pcdn)


# -- the host loop: diverged / nonfinite / the divergence guard --------------

def _counting_outer(xp, f_of_k):
    """The same outer in either framework: w += 1 a call, f = f_of_k(k)."""
    calls = []

    def outer(w, z, gen, active, recheck, c):
        k = len(calls)
        calls.append(k)
        return (w + 1.0, z + 1.0, gen, f_of_k(k), 0.5, k + 1, 1.0, active,
                3)

    return outer


def _both_loops(f_of_k, **kw):
    w = np.zeros(3, np.float32)
    jstate = jloop.EngineState(jnp.asarray(w), jnp.asarray(w),
                               jax.random.PRNGKey(0), jnp.ones(3, bool))
    tstate = tloop.EngineState(torch.zeros(3), torch.zeros(3),
                               torch.Generator().manual_seed(0),
                               torch.ones(3, dtype=torch.bool))
    jst, jres = jloop.run_outer_loop(_counting_outer(jnp, f_of_k), jstate,
                                     1.0, max_outer=10, tol_kkt=0.0, **kw)
    tst, tres = tloop.run_outer_loop(_counting_outer(torch, f_of_k), tstate,
                                     1.0, max_outer=10, tol_kkt=0.0, **kw)
    return (jst, jres), (tst, tres)


def test_nonfinite_trip_sets_diverged_as_the_reference():
    """A NaN objective at the third iteration: both loops stop with
    diverged = nonfinite = True, the last good objective and the carry of
    the second iteration (w = 2)."""
    (jst, jres), (tst, tres) = _both_loops(
        lambda k: float("nan") if k == 2 else 10.0 - k)
    assert tres.diverged and tres.nonfinite and not tres.converged
    assert (tres.diverged, tres.nonfinite, tres.converged) == \
        (jres.diverged, jres.nonfinite, jres.converged)
    assert tres.objective == jres.objective == 9.0
    assert tres.n_outer == jres.n_outer == 3
    np.testing.assert_array_equal(tres.w.numpy(), np.asarray(jres.w))
    np.testing.assert_array_equal(tst.z.numpy(), np.asarray(jst.z))
    assert tres.w.tolist() == [2.0, 2.0, 2.0]
    # the trip attaches the reference's post-mortem, from the same rows
    assert tres.postmortem is not None and jres.postmortem is not None
    assert sorted(tres.postmortem) == sorted(jres.postmortem)
    for k, v in jres.postmortem.items():
        np.testing.assert_array_equal(tres.postmortem[k], v)


def test_divergence_guard_trips_as_the_reference():
    """A guard on f > 11 trips at the iteration whose f is 12: diverged,
    not nonfinite, that iteration's carry kept (w = 3)."""
    (jst, jres), (tst, tres) = _both_loops(
        lambda k: 10.0 + k, divergence_guard=lambda f: f > 11.0)
    assert tres.diverged and not tres.nonfinite and not tres.converged
    assert (tres.diverged, tres.nonfinite) == (jres.diverged,
                                               jres.nonfinite)
    assert tres.objective == jres.objective == 12.0
    assert tres.n_outer == jres.n_outer == 3
    np.testing.assert_array_equal(tres.w.numpy(), np.asarray(jres.w))
    np.testing.assert_array_equal(tres.history.objective,
                                  jres.history.objective)


def test_solve_result_fields_match_the_reference():
    assert {"diverged", "postmortem", "nonfinite"} <= \
        set(tloop.SolveResult._fields)
    common = [f for f in jloop.SolveResult._fields
              if f in tloop.SolveResult._fields]
    assert common == list(tloop.SolveResult._fields)


def test_scdn_and_tron_are_exported():
    import repro.core as jcore
    import repro_torch.core as tcore
    assert tcore.scdn is tscdn and tcore.tron is ttron
    assert {"scdn", "tron"} <= set(tcore.__all__) & set(jcore.__all__)
    assert jpcdn.PCDNConfig(P=1).dtype == tpcdn.PCDNConfig(P=1).dtype
