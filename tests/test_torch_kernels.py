"""The port's plain kernel versions (repro_torch.kernels.ref, reached
through the CPU branch of repro_torch.kernels.ops) against the reference's
kernels (repro.kernels.ops: Pallas in interpret mode here, as
tests/test_kernels.py runs them; REPRO_AUTOTUNE=off from conftest pins the
Pallas route).

K1's whole step (`ops.pcdn_bundle`) is held against the reference's
support-scope bundle step in tests/test_torch_bundle_step.py; here its
building block `ref.pcdn_bundle_ref` is held against the reference kernel.

Tolerance: rtol 1e-5 with atol 1e-6 on d/g/h, delta and upd_* (float32
sums in another order); alpha and n_steps exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core.design_matrix import _take_fill, padded_row_support
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


KINDS = ["logistic", "squared_hinge", "squared"]


def _dense_bundle(s, P, n, seed, n_sentinel=0):
    """A dense design X (s, n), a bundle idx (P,) of distinct columns whose
    last n_sentinel slots hold the sentinel n (the ragged last bundle), z,
    y and w_B (0 at the sentinels, as gather_vec gives it)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((s, n)).astype(np.float32)
    idx = rng.choice(n, P, replace=False).astype(np.int32)
    z = rng.standard_normal(s).astype(np.float32)
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.standard_normal(P).astype(np.float32)
    w[::2] = 0.0
    if n_sentinel:
        idx[-n_sentinel:] = n
        w[-n_sentinel:] = 0.0
    return X, idx, z, y, w


def _dense_reference(X, idx, z, y, w, c, kind, l2):
    """The reference's dense full step around its kernel: gather_slab, u/v
    from the reference loss, repro.kernels.ops.pcdn_direction -> (d, g, h)
    and the design and slab, for slab_matvec."""
    from repro.core.design_matrix import DenseDesign
    from repro.core.losses import get_loss
    design = DenseDesign(X=jnp.asarray(X))
    slab = design.gather_slab(jnp.asarray(idx))
    loss = get_loss(kind)
    u = c * loss.dz(jnp.asarray(z), jnp.asarray(y))
    v = c * loss.d2z(jnp.asarray(z), jnp.asarray(y))
    dgh = jops.pcdn_direction(slab.XB, u, v, jnp.asarray(w), l2=l2)
    return dgh, design, slab


def _rounding_atol(XB, u, d, h):
    """Each output's float32 rounding scale, added to TOL's atol: g and
    delta are sums of terms of either sign (u_i X_ij; X_ij d_j) that may
    cancel far below their size, so their atol is 1e-7 (about float32's
    epsilon) times the sum of the terms' magnitudes, as for K5's sums in
    tests/test_torch_serve_kernels.py; d inherits g's over h (Eq. 5
    divides by h). delta is compared at the port's own d. h sums positive
    terms: TOL alone."""
    XB = np.abs(np.asarray(XB, np.float64))                  # (s, P)
    a_g = 1e-7 * (np.abs(u) @ XB) + TOL["atol"]
    a_d = a_g / np.asarray(h) + TOL["atol"]
    a_delta = 1e-7 * (XB @ np.abs(d)) + TOL["atol"]
    return a_g, a_d, a_delta


def _check_dense_direction(X, idx, z, y, w, c, kind, l2):
    (a, design, slab) = _dense_reference(X, idx, z, y, w, c, kind, l2)
    b = tops.pcdn_direction(_t(np.ascontiguousarray(X.T)),
                            _t(idx, torch.int32), _t(z), _t(y), _t(w), c,
                            kind=kind, l2=l2)
    from repro.core.losses import get_loss
    u = c * np.asarray(get_loss(kind).dz(jnp.asarray(z), jnp.asarray(y)))
    a_g, a_d, a_delta = _rounding_atol(slab.XB, u, _np(a[0]), _np(a[2]))
    for x, y_, nm, atol in zip(b, a, "dgh", (a_d, a_g, TOL["atol"])):
        np.testing.assert_array_less(np.abs(_np(x) - _np(y_)),
                                     atol + TOL["rtol"] * np.abs(_np(y_)),
                                     err_msg=nm)
    want = _np(design.slab_matvec(slab, jnp.asarray(_np(b[0]))))
    assert b[3].shape == (X.shape[0],)
    np.testing.assert_array_less(np.abs(_np(b[3]) - want),
                                 a_delta + TOL["rtol"] * np.abs(want),
                                 err_msg="delta")
    return b


@pytest.mark.parametrize("s,P", [(64, 8), (77, 5), (300, 37)])
@pytest.mark.parametrize("l2", [0.0, 0.3])
@pytest.mark.parametrize("kind", KINDS)
def test_pcdn_direction_ref_matches(s, P, l2, kind):
    """K3's plain version (the slab gather from the feature-major copy,
    the loss factors, the direction, the margin delta) against the
    reference kernel fed the reference's gathered slab and u, v from the
    reference loss at the same z, y; delta against the reference
    DenseDesign.slab_matvec."""
    X, idx, z, y, w = _dense_bundle(s, P, 3 * P + 5, s * P)
    _check_dense_direction(X, idx, z, y, w, 1.5, kind, l2)


@pytest.mark.parametrize("l2", [0.0, 0.3])
@pytest.mark.parametrize("kind", KINDS)
def test_pcdn_direction_ref_with_sentinel_columns(l2, kind):
    """A ragged last bundle: the sentinel columns give d = g = 0, h =
    max(l2, 1e-12), and add nothing to delta, as in the reference."""
    X, idx, z, y, w = _dense_bundle(120, 24, 50, 7, n_sentinel=9)
    d, g, h, _ = _check_dense_direction(X, idx, z, y, w, 2.0, kind, l2)
    assert not torch.any(d[-9:]) and not torch.any(g[-9:])
    assert torch.all(h[-9:] == max(l2, 1e-12))




def _jax_design(rows, vals, s):
    from repro.core.design_matrix import PaddedCSCDesign, SparseSlab
    design = PaddedCSCDesign(col_rows=jnp.asarray(rows),
                             col_vals=jnp.asarray(vals), _n_samples=s)
    slab = SparseSlab(rows=jnp.asarray(rows), vals=jnp.asarray(vals),
                      valid=jnp.ones((rows.shape[0],), bool))
    return design, slab


@pytest.mark.parametrize("s,P,k", [(64, 8, 4), (300, 37, 9), (100, 13, 3)])
@pytest.mark.parametrize("l2", [0.0, 0.3])
@pytest.mark.parametrize("kind", KINDS)
def test_pcdn_sparse_direction_ref_matches(s, P, k, l2, kind):
    """K2's plain version (loss factors, direction, margin scatter) against
    the reference kernel fed u, v from the reference loss at the same z, y,
    and delta against the reference design's slab_matvec."""
    from repro.core.losses import get_loss
    rng = np.random.default_rng(s + P + k)
    rows = rng.integers(0, s + 1, size=(P, k)).astype(np.int32)  # s: pad
    rows[0, :] = s                                  # an all-padding feature
    vals = rng.standard_normal((P, k)).astype(np.float32)
    vals[rows == s] = 0.0
    z = rng.standard_normal(s).astype(np.float32)
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.standard_normal(P).astype(np.float32)
    c = 1.5
    loss = get_loss(kind)
    u = c * loss.dz(jnp.asarray(z), jnp.asarray(y))
    v = c * loss.d2z(jnp.asarray(z), jnp.asarray(y))
    a = jops.pcdn_sparse_direction(jnp.asarray(rows), jnp.asarray(vals), u,
                                   v, jnp.asarray(w), l2=l2)
    b = tops.pcdn_sparse_direction(_t(rows, torch.int32), _t(vals), _t(z),
                                   _t(y), _t(w), c, kind=kind, l2=l2)
    for x, y_, nm in zip(b, a, "dgh"):
        np.testing.assert_allclose(_np(x), _np(y_), err_msg=nm, **TOL)
    design, slab = _jax_design(rows, vals, s)
    want = design.slab_matvec(slab, jnp.asarray(_np(b[0])))
    assert b[3].shape == (s,)
    np.testing.assert_allclose(_np(b[3]), _np(want), err_msg="delta", **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_pcdn_sparse_direction_ref_on_the_support(kind):
    """The backtracking support step's call: pos as the rows, z_R, y_R at
    the support (sentinel slots z = 0, y = 1); delta is delta_R, against
    the reference design's slab_matvec_support."""
    vals, pos, z_R, y_R, w, _ = _bundle_inputs(11, 200, 12, 6)
    s = 200
    b = tops.pcdn_sparse_direction(_t(pos, torch.int32), _t(vals), _t(z_R),
                                   _t(y_R), _t(w), 2.0, kind=kind, l2=0.2)
    design, slab = _jax_design(np.full(pos.shape, s, np.int32), vals, s)
    want = design.slab_matvec_support(slab, jnp.asarray(pos),
                                      jnp.asarray(_np(b[0])))
    np.testing.assert_allclose(_np(b[3]), _np(want), **TOL)
    from repro.core.losses import get_loss
    loss = get_loss(kind)
    u = 2.0 * loss.dz(jnp.asarray(z_R), jnp.asarray(y_R))
    v = 2.0 * loss.d2z(jnp.asarray(z_R), jnp.asarray(y_R))
    a = jops.pcdn_sparse_direction(jnp.asarray(pos), jnp.asarray(vals), u, v,
                                   jnp.asarray(w), l2=0.2)
    for x, y_, nm in zip(b, a, "dgh"):
        np.testing.assert_allclose(_np(x), _np(y_), err_msg=nm, **TOL)


def _bundle_inputs(seed, s, P, k, z_scale=1.0):
    """A support-scope bundle the way the solver builds one: slab rows with
    sentinel padding -> padded_row_support -> (pos, z_R, y_R)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, k + 1, size=P)
    rows = np.full((P, k), s, np.int32)
    vals = np.zeros((P, k), np.float32)
    for j in range(P):
        rows[j, :counts[j]] = rng.integers(0, s, size=counts[j])
        vals[j, :counts[j]] = rng.standard_normal(counts[j]) / 2
    support, pos = padded_row_support(torch.tensor(rows), s)
    z = (rng.standard_normal(s) * z_scale).astype(np.float32)
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    z_R = _take_fill(_t(z), support, 0.0)
    y_R = _take_fill(_t(y), support, 1.0)
    w = (0.1 * rng.standard_normal(P)).astype(np.float32)
    w[::3] = 0.0
    alphas = (0.5 ** np.arange(40)).astype(np.float32)
    return vals, pos.numpy(), z_R.numpy(), y_R.numpy(), w, alphas


CASES = [
    # (kind, l2, sigma, P, c): P not a multiple of 8; all_fail needs a
    # decrease no candidate can give (sigma = 1e6), so alpha = 0 and
    # n_steps = 1 (argmax of an all-false mask)
    ("logistic", 0.0, 0.01, 13, 4.0),
    ("logistic", 0.3, 0.01, 24, 1.0),
    ("squared_hinge", 0.0, 0.01, 7, 0.5),
    ("squared_hinge", 0.2, 0.01, 16, 2.0),
    ("logistic", 0.0, 1e6, 9, 4.0),
]


@pytest.mark.parametrize("kind,l2,sigma,P,c", CASES)
def test_pcdn_bundle_ref_matches(kind, l2, sigma, P, c):
    vals, pos, z_R, y_R, w, alphas = _bundle_inputs(P, 200, P, 6)
    a = jops.pcdn_bundle(jnp.asarray(vals), jnp.asarray(pos),
                         jnp.asarray(z_R), jnp.asarray(y_R), jnp.asarray(w),
                         jnp.asarray(alphas), c, kind=kind, l2=l2,
                         sigma=sigma)
    b = tref.pcdn_bundle_ref(_t(vals), _t(pos, torch.int32), _t(z_R),
                             _t(y_R), _t(w), _t(alphas), c, kind=kind, l2=l2,
                             sigma=sigma)
    assert float(b[2]) == float(a[2])
    assert int(b[3]) == int(a[3])
    assert b[3].dtype == torch.int32
    np.testing.assert_allclose(_np(b[0]), _np(a[0]), **TOL)
    np.testing.assert_allclose(_np(b[1]), _np(a[1]), **TOL)
    if sigma > 1:
        assert float(b[2]) == 0.0 and int(b[3]) == 1
        assert not torch.any(b[0]) and not torch.any(b[1])


def test_pcdn_bundle_backtracks_like_reference():
    # 11 features over 4 rows, all of one sign: strongly correlated, so the
    # diagonal Newton step overshoots and alpha = 1 fails
    vals, pos, z_R, y_R, w, alphas = _bundle_inputs(3, 4, 11, 5)
    vals = np.abs(vals)
    a = jops.pcdn_bundle(*map(jnp.asarray, (vals, pos, z_R, y_R, w,
                                            alphas)), 8.0)
    b = tref.pcdn_bundle_ref(_t(vals), _t(pos, torch.int32), _t(z_R),
                             _t(y_R), _t(w), _t(alphas), 8.0)
    assert int(b[3]) == int(a[3]) > 1
    assert float(b[2]) == float(a[2])
    np.testing.assert_allclose(_np(b[0]), _np(a[0]), **TOL)
    np.testing.assert_allclose(_np(b[1]), _np(a[1]), **TOL)
