"""Outer iterations of the port against the reference's
`make_path_outer`, fed the reference's own partition draws through
`repro_torch.engine.bridge`. Two iterations, each from the reference's
carry (the second one sees the first one's shrinking). w, z, f, kkt:
rtol 1e-5, atol 1e-6; nnz, mean line-search depth, active set equal."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_parity as tp_
from repro.core import pcdn as jpcdn
from repro_torch.core import pcdn as tpcdn
from repro_torch.engine import bridge

CASES = [(layout, scope, kernels, True)
         for layout, scope in tp_.ROUTES for kernels in (False, True)] + \
        [(layout, scope, False, False) for layout, scope in tp_.ROUTES]


@pytest.mark.parametrize("layout,scope,use_kernels,shrink", CASES)
def test_outer_iteration_matches_reference(layout, scope, use_kernels,
                                           shrink):
    jp, tp = tp_.problems(layout, seed=5)
    P = 16
    jcfg, tcfg = tp_.configs(P, scope, use_kernels, shrink)
    jouter = jpcdn.make_path_outer(jp, jcfg)
    touter = tpcdn.make_path_outer(tp, tcfg)
    w, z = tp_.start_carry(jp, seed=6)
    key = jax.random.PRNGKey(0)
    active = np.ones(jp.n_features, bool)
    c = 2.0
    for it in range(2):
        idxs, b_active = tp_.reference_partition(key, active, P, shrink)
        jout = jouter(jax.numpy.asarray(w), jax.numpy.asarray(z), key,
                      jax.numpy.asarray(active), jax.numpy.asarray(True),
                      jax.numpy.float32(c))
        st = bridge.state_from_numpy(w, z, active, device="cpu")
        w_in = st.w.clone()
        tout = touter(st.w, st.z, st.gen, st.active, True, c,
                      idxs=bridge.partition_from_numpy(idxs, device="cpu"),
                      b_active=b_active)
        jw, jz, key, jf, jkkt, jnnz, jq, jact, jnact = jout
        tw, tz, _, tf, tkkt, tnnz, tq, tact, tnact = tout
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
        np.testing.assert_allclose(float(tf), float(jf), rtol=1e-5)
        np.testing.assert_allclose(float(tkkt), float(jkkt), **tp_.TOL)
        assert int(tnnz) == int(jnnz)
        assert float(tq) == pytest.approx(float(jq), abs=1e-6)
        assert np.array_equal(tact.numpy(), np.asarray(jact))
        assert int(tnact) == int(jnact)
        assert tp_.torch.equal(st.w, w_in)   # the input carry is kept
        w, z, active = np.asarray(jw), np.asarray(jz), np.asarray(jact)
    if shrink:
        assert int(jnact) < jp.n_features   # shrinking took features out


def test_bridge_design_from_numpy():
    from repro.data import make_sparse_classification
    csc, _, _ = make_sparse_classification(50, 20, nnz_per_col=4, seed=1)
    d = bridge.design_from_numpy(csc.col_rows, csc.col_vals, csc.shape,
                                 device="cpu")
    assert d.shape == (50, 20) and d.k_max == 4
    X = np.arange(6, dtype=np.float64).reshape(2, 3)
    dd = bridge.design_from_numpy(X=X, device="cpu")
    assert dd.X.dtype == tp_.torch.float32 and dd.shape == (2, 3)


def _backend(max_outer=40):
    from repro_torch.engine import LocalBackend
    _, tp = tp_.problems("padded_csc", seed=7)
    cfg = tpcdn.PCDNConfig(P=16, tol_kkt=0.0, max_outer=max_outer, seed=0)
    return tp, cfg, LocalBackend(tp, cfg)


def test_solve_stops_on_relative_objective():
    """tol_rel_obj with f_star stops at the first iteration whose F is
    within tol_rel_obj * |f_star| of f_star, and reports convergence."""
    tp, cfg, _ = _backend()
    free = tpcdn.solve(tp, cfg)
    F = free.history.objective
    assert free.n_outer == cfg.max_outer and not free.converged
    f_star, tol = float(F.min()), 1e-3
    first = int(np.argmax(F - f_star <= tol * abs(f_star)))
    assert 0 < first < cfg.max_outer - 1
    res = tpcdn.solve(tp, dataclasses.replace(cfg, tol_rel_obj=tol),
                      f_star=f_star)
    assert res.converged and not res.nonfinite
    assert res.n_outer == first + 1
    np.testing.assert_array_equal(res.history.objective, F[:first + 1])


def test_loop_rolls_back_a_nonfinite_iteration():
    """A NaN objective at iteration 2 stops the loop and hands back the
    carry of iteration 1, generator state included."""
    from repro_torch.engine import loop
    _, _, backend = _backend()

    calls = []

    def poisoned(w, z, gen, active, recheck, c):
        out = list(backend.outer(w, z, gen, active, recheck, c))
        calls.append(1)
        if len(calls) == 3:
            out[3] = float("nan")   # the objective f
        return tuple(out)

    state, res = loop.run_outer_loop(poisoned, backend.init_state(), 2.0,
                                     max_outer=10, tol_kkt=0.0)
    clean, ref = loop.run_outer_loop(backend.outer, backend.init_state(),
                                     2.0, max_outer=2, tol_kkt=0.0)
    assert res.nonfinite and not res.converged and res.n_outer == 3
    assert res.objective == ref.objective == ref.history.objective[-1]
    assert tp_.torch.equal(res.w, ref.w) and tp_.torch.equal(state.z,
                                                             clean.z)
    assert tp_.torch.equal(state.gen.get_state(), clean.gen.get_state())
    assert np.isnan(res.history.objective[-1])
