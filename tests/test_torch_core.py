"""The port's core modules against the JAX reference on the CPU.

Same numpy inputs from a seed through both packages. Tolerances: atol 1e-6
for the elementwise losses, directions and decrements (float32 on both
sides, the same formulas); exact equality for integer outputs (support,
pos, n_steps) and for gathers and scatters of single values; rtol 1e-5
(atol 1e-6) for reductions, whose float32 summation order differs between
XLA and PyTorch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bundles as jB
from repro.core import design_matrix as jdm
from repro.core import direction as jdir
from repro.core import linesearch as jls
from repro.core import losses as jlosses
from repro.core import problem as jprob
from repro.data import make_classification
from repro_torch.core import bundles as tB
from repro_torch.core import design_matrix as tdm
from repro_torch.core import direction as tdir
from repro_torch.core import linesearch as tls
from repro_torch.core import losses as tlosses
from repro_torch.core import problem as tprob

RED = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)  # a copy: ops run in place


@pytest.mark.parametrize("name", ["logistic", "squared_hinge", "squared"])
def test_losses_match(name):
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(257) * 30).astype(np.float32)
    z[:5] = [0.0, 1.0, -1.0, 88.0, -88.0]
    y = np.where(rng.random(257) < 0.5, -1.0, 1.0).astype(np.float32)
    jl, tl = jlosses.get_loss(name), tlosses.get_loss(name)
    for f in ("value", "dz", "d2z"):
        np.testing.assert_allclose(_np(getattr(tl, f)(_t(z), _t(y))),
                                   _np(getattr(jl, f)(jnp.asarray(z),
                                                      jnp.asarray(y))),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert tl.theta == jl.theta
    assert tlosses.HESSIAN_FLOOR == jlosses.HESSIAN_FLOOR


def test_direction_and_decrement_match():
    rng = np.random.default_rng(1)
    g = rng.standard_normal(61).astype(np.float32) * 3
    h = np.abs(rng.standard_normal(61)).astype(np.float32) + 0.1
    w = rng.standard_normal(61).astype(np.float32)
    w[:10] = 0.0
    g[10:13] = [1.0, -1.0, 0.0]   # branch boundaries at w = 0
    w[10:13] = 0.0
    d_j = jdir.newton_direction(jnp.asarray(g), jnp.asarray(h),
                                jnp.asarray(w))
    d_t = tdir.newton_direction(_t(g), _t(h), _t(w))
    np.testing.assert_allclose(_np(d_t), _np(d_j), rtol=1e-6, atol=1e-6)
    for gamma in (0.0, 0.5):
        a = jdir.delta_decrement(jnp.asarray(g), jnp.asarray(h),
                                 jnp.asarray(w), d_j, gamma)
        b = tdir.delta_decrement(_t(g), _t(h), _t(w), d_t, gamma)
        np.testing.assert_allclose(float(b), float(a), **RED)


def test_partition_layout_and_sentinels():
    gen = torch.Generator().manual_seed(0)
    idxs = tB.partition(gen, 23, 5)
    assert idxs.shape == (5, 5) and idxs.dtype == torch.int32
    flat = idxs.reshape(-1)
    assert sorted(flat[:23].tolist()) == list(range(23))
    assert flat[23:].tolist() == [23, 23]
    active = torch.zeros(23, dtype=torch.bool)
    active[[1, 4, 9, 17, 22, 3, 5]] = True
    idxs, b_active = tB.partition_active(gen, active, 5)
    assert b_active == 2
    lead = idxs[:2].reshape(-1)
    assert sorted(lead[lead < 23].tolist()) == [1, 3, 4, 5, 9, 17, 22]
    assert bool(torch.all(idxs[2:] == 23))
    # same seed, same partitions: the property the solve phases rely on
    a = tB.partition(torch.Generator().manual_seed(7), 50, 8)
    b = tB.partition(torch.Generator().manual_seed(7), 50, 8)
    assert torch.equal(a, b)


def test_gather_and_scatter_drop_sentinels():
    rng = np.random.default_rng(2)
    w = rng.standard_normal(10).astype(np.float32)
    idx = np.array([3, 10, 0, 10, 9], np.int32)
    upd = rng.standard_normal(5).astype(np.float32)
    a, va = jB.gather_vec(jnp.asarray(w), jnp.asarray(idx))
    b, vb = tB.gather_vec(_t(w), _t(idx, torch.int32))
    assert np.array_equal(_np(b), _np(a)) and np.array_equal(_np(vb),
                                                              _np(va))
    ja = jB.scatter_add(jnp.asarray(w), jnp.asarray(idx), jnp.asarray(upd))
    tb = tB.scatter_add(_t(w), _t(idx, torch.int32), _t(upd))
    assert np.array_equal(_np(tb), _np(ja))


def _designs(layout, s=96, n=40, sparsity=0.8, seed=3):
    X, y, _ = make_classification(s, n, sparsity=sparsity, seed=seed)
    jd = jdm.as_design(X, layout=layout)
    td = tdm.as_design(X, layout=layout)
    return X, y, jd, td


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_design_whole_matrix_ops_match(layout):
    X, _, jd, td = _designs(layout)
    rng = np.random.default_rng(4)
    w = rng.standard_normal(X.shape[1]).astype(np.float32)
    u = rng.standard_normal(X.shape[0]).astype(np.float32)
    assert td.shape == jd.shape and td.layout == jd.layout
    np.testing.assert_allclose(_np(td.matvec(_t(w))),
                               _np(jd.matvec(jnp.asarray(w))), **RED)
    np.testing.assert_allclose(_np(td.rmatvec(_t(u))),
                               _np(jd.rmatvec(jnp.asarray(u))), **RED)
    np.testing.assert_allclose(_np(td.column_norms_sq()),
                               _np(jd.column_norms_sq()), **RED)
    assert np.array_equal(_np(td.to_dense()), _np(jd.to_dense()))
    if layout == "padded_csc":
        assert np.array_equal(_np(td.col_rows), _np(jd.col_rows))
        assert np.array_equal(_np(td.col_vals), _np(jd.col_vals))


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_design_slab_ops_match(layout):
    X, _, jd, td = _designs(layout)
    s, n = X.shape
    rng = np.random.default_rng(5)
    idx = np.array([7, 0, n, 39, 12, n, 3], np.int32)   # with sentinels
    u = rng.standard_normal(s).astype(np.float32)
    v = np.abs(rng.standard_normal(s)).astype(np.float32)
    d = rng.standard_normal(idx.shape[0]).astype(np.float32)
    js = jd.gather_slab(jnp.asarray(idx))
    ts = td.gather_slab(_t(idx, torch.int32))
    for a, b in zip(ts, js):
        assert np.array_equal(_np(a), _np(b))
    for a, b in zip(td.slab_grad_hess(ts, _t(u), _t(v)),
                    jd.slab_grad_hess(js, jnp.asarray(u), jnp.asarray(v))):
        np.testing.assert_allclose(_np(a), _np(b), **RED)
    np.testing.assert_allclose(_np(td.slab_matvec(ts, _t(d))),
                               _np(jd.slab_matvec(js, jnp.asarray(d))),
                               **RED)


def test_row_support_ops_match():
    X, _, jd, td = _designs("padded_csc", s=128, n=48, sparsity=0.9)
    s, n = X.shape
    rng = np.random.default_rng(6)
    idx = np.array([5, n, 17, 2, 44, 30, n, 9, 1], np.int32)
    js = jd.gather_slab(jnp.asarray(idx))
    ts = td.gather_slab(_t(idx, torch.int32))
    jsup, jpos = jd.slab_row_support(js)
    tsup, tpos = td.slab_row_support(ts)
    assert np.array_equal(_np(tsup), _np(jsup))
    assert np.array_equal(_np(tpos), _np(jpos))
    assert tsup.dtype == tpos.dtype == torch.int32
    R = tsup.shape[0]
    u_R = rng.standard_normal(R).astype(np.float32)
    v_R = np.abs(rng.standard_normal(R)).astype(np.float32)
    d = rng.standard_normal(idx.shape[0]).astype(np.float32)
    for a, b in zip(td.slab_grad_hess_support(ts, tpos, _t(u_R), _t(v_R)),
                    jd.slab_grad_hess_support(js, jpos, jnp.asarray(u_R),
                                              jnp.asarray(v_R))):
        np.testing.assert_allclose(_np(a), _np(b), **RED)
    t_dR = td.slab_matvec_support(ts, tpos, _t(d))
    j_dR = jd.slab_matvec_support(js, jpos, jnp.asarray(d))
    np.testing.assert_allclose(_np(t_dR), _np(j_dR), **RED)
    assert np.all(_np(t_dR)[_np(tsup) == s] == 0.0)
    z = rng.standard_normal(s).astype(np.float32)
    a = td.scatter_support(_t(z), tsup, t_dR)
    b = jd.scatter_support(jnp.asarray(z), jsup, j_dR)
    np.testing.assert_allclose(_np(a), _np(b), **RED)


def test_row_support_of_all_sentinel_rows():
    rows = torch.full((3, 4), 50, dtype=torch.int32)
    rows[0, 0] = 7
    sup, pos = tdm.padded_row_support(rows, 50)
    jsup, jpos = jdm.padded_row_support(jnp.asarray(rows.numpy()), 50)
    assert np.array_equal(_np(sup), _np(jsup))
    assert np.array_equal(_np(pos), _np(jpos))


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_problem_quantities_match(layout, l2):
    X, y, _, _ = _designs(layout)
    jp = jprob.make_problem(X, y, c=2.0, layout=layout, elastic_net_l2=l2)
    tp = tprob.make_problem(X, y, c=2.0, layout=layout, elastic_net_l2=l2,
                            device="cpu")
    rng = np.random.default_rng(7)
    w = rng.standard_normal(X.shape[1]).astype(np.float32) * 0.3
    w[::3] = 0.0
    jz, tz = jp.margins(jnp.asarray(w)), tp.margins(_t(w))
    np.testing.assert_allclose(_np(tz), _np(jz), **RED)
    pairs = [
        (tp.objective_from_margins(tz, _t(w)),
         jp.objective_from_margins(jz, jnp.asarray(w))),
        (tp.full_grad(tz, _t(w)), jp.full_grad(jz, jnp.asarray(w))),
        (tp.kkt_violation(_t(w), tz), jp.kkt_violation(jnp.asarray(w), jz)),
        (tp.grad_factor(tz), jp.grad_factor(jz)),
        (tp.hess_factor(tz), jp.hess_factor(jz)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(_np(a), _np(b), **RED)
    assert tp.c_max() == pytest.approx(jp.c_max(), rel=1e-5)
    idx = np.array([3, 11, X.shape[1], 0], np.int32)
    ts = tp.design.gather_slab(_t(idx, torch.int32))
    js = jp.design.gather_slab(jnp.asarray(idx))
    w_B = np.where(idx < X.shape[1], w[np.minimum(idx, X.shape[1] - 1)], 0)
    for a, b in zip(tp.bundle_grad_hess(tz, ts, _t(w_B)),
                    jp.bundle_grad_hess(jz, js, jnp.asarray(w_B))):
        np.testing.assert_allclose(_np(a), _np(b), **RED)
    assert tp.with_c(0.5).c == 0.5


def _ls_inputs(seed, s=200, P=9, scale=1.0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(s).astype(np.float32)
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    delta = (rng.standard_normal(s) * scale).astype(np.float32)
    w_B = rng.standard_normal(P).astype(np.float32)
    d_B = (rng.standard_normal(P) * scale).astype(np.float32)
    return z, delta, y, w_B, d_B


LS = ["armijo_backtracking", "armijo_batched", "armijo_chunked",
      "armijo_support"]


# (case, loss, l2): a plain descent step, a step so long that backtracking
# runs deep, and a decrement no candidate can meet (alpha = 0)
LS_CASES = [("descent", "logistic", 0.0), ("steep", "squared_hinge", 0.2),
            ("all_fail", "logistic", 0.2)]


@pytest.mark.parametrize("fn", LS)
@pytest.mark.parametrize("case,kind,l2", LS_CASES)
def test_line_searches_match(fn, case, kind, l2):
    z, delta, y, w_B, d_B = _ls_inputs(8, scale=30.0 if case == "steep"
                                       else 0.1)
    Delta = -1.0 if case != "all_fail" else -1e9
    a = getattr(jls, fn)(jlosses.get_loss(kind), 4.0, jnp.asarray(z),
                         jnp.asarray(delta), jnp.asarray(y),
                         jnp.asarray(w_B), jnp.asarray(d_B),
                         jnp.float32(Delta), jls.ArmijoParams(), l2=l2)
    b = getattr(tls, fn)(tlosses.get_loss(kind), 4.0, _t(z), _t(delta),
                         _t(y), _t(w_B), _t(d_B),
                         torch.tensor(Delta, dtype=torch.float32),
                         tls.ArmijoParams(), l2=l2)
    assert float(b.alpha) == float(a.alpha), (b, a)
    assert int(b.n_steps) == int(a.n_steps), (b, a)
    assert bool(b.accepted) == bool(a.accepted)
    if case == "steep":
        assert int(b.n_steps) > 1
    if case == "all_fail":
        assert float(b.alpha) == 0.0
        assert int(b.n_steps) == (40 if fn in ("armijo_chunked",
                                               "armijo_backtracking") else 1)


def test_candidate_alphas_match():
    a = jls.candidate_alphas(jls.ArmijoParams())
    b = tls.candidate_alphas(tls.ArmijoParams())
    assert np.array_equal(_np(b), _np(a))
