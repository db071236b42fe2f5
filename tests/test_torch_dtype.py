"""bf16 design storage in the port against the JAX package's.

The stored bf16 values must be bit-equal between the packages (both round
float32 to nearest even) before any solve is compared; the labels and the
solver state stay float32. Products, one bundle step from a shared carry
(each route, plain versions and kernels' plain versions) and the per-
coordinate deltas: rtol 1e-5, atol 1e-6 (float32 sums in another order).
A 10-iteration bf16 PCDN solve on the plain path, fed the reference's
partitions: F rel <= 1e-4 each iteration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro.core import design_matrix as jdm
from repro.core import pcdn as jpcdn
from repro.core import problem as jprob
from repro.data import make_classification
from repro_torch.core import design_matrix as tdm
from repro_torch.core import pcdn as tpcdn
from repro_torch.core import problem as tprob
from repro_torch.engine import LocalBackend, bridge


def _bits_j(x):
    return np.asarray(x).view(np.uint16)


def _bits_t(x):
    return x.view(torch.int16).numpy().view(np.uint16)


def bf16_problems(layout, seed=0, loss="logistic", s=400, n=96):
    sparsity = 0.5 if layout == "dense" else 0.93
    X, y, _ = make_classification(s, n, sparsity=sparsity, seed=seed)
    jp = jprob.make_problem(X, y, c=2.0, loss=loss, layout=layout,
                            dtype=jnp.bfloat16)
    tp = tprob.make_problem(X, y, c=2.0, loss=loss, layout=layout,
                            dtype=torch.bfloat16, device="cpu")
    return jp, tp


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_stored_values_bit_equal_and_state_float32(layout):
    jp, tp = bf16_problems(layout)
    if layout == "dense":
        assert tp.design.X.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits_t(tp.design.X),
                                      _bits_j(jp.design.X))
    else:
        assert tp.design.col_vals.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits_t(tp.design.col_vals),
                                      _bits_j(jp.design.col_vals))
        np.testing.assert_array_equal(tp.design.col_rows.numpy(),
                                      np.asarray(jp.design.col_rows))
    assert tp.dtype == torch.bfloat16
    assert tp.solve_dtype == tp.design.acc_dtype == tp.y.dtype == \
        torch.float32
    assert jp.solve_dtype == jnp.float32
    st = LocalBackend(tp, tpcdn.PCDNConfig(P=8)).init_state()
    assert st.w.dtype == st.z.dtype == torch.float32
    st = LocalBackend(tp, tpcdn.PCDNConfig(P=8)).init_state(
        np.ones(tp.n_features))
    assert st.w.dtype == st.z.dtype == torch.float32


def test_float64_input_rounds_as_the_reference():
    """float64 values reach bf16 through float32 in the port, directly in
    the reference: the same bits on this input (a double rounding differs
    only where float32 lands exactly halfway between two bf16 values)."""
    X = np.random.default_rng(0).standard_normal((300, 40))
    jd = jdm.as_design(X, dtype=jnp.bfloat16)
    td = tdm.as_design(X, dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits_t(td.X), _bits_j(jd.X))
    jc = jdm.as_design(X, dtype=jnp.bfloat16, layout="padded_csc")
    tc = tdm.as_design(X, dtype=torch.bfloat16, layout="padded_csc")
    np.testing.assert_array_equal(_bits_t(tc.col_vals), _bits_j(jc.col_vals))


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_products_accumulate_in_float32(layout, dtype):
    X, _, _ = make_classification(300, 50, sparsity=0.8, seed=3)
    jd = jdm.as_design(X, dtype=getattr(jnp, dtype), layout=layout)
    td = tdm.as_design(X, dtype=getattr(torch, dtype), layout=layout)
    assert td.acc_dtype == torch.float32
    rng = np.random.default_rng(4)
    w = rng.standard_normal(50).astype(np.float32)
    u = rng.standard_normal(300).astype(np.float32)
    v = np.abs(u)
    idx = np.array([3, 9, 9, 40, 50], np.int32)     # a duplicate, a sentinel
    d = rng.standard_normal(5).astype(np.float32)
    js, ts = jd.gather_slab(jnp.asarray(idx)), td.gather_slab(
        tp_.tensor(idx, torch.int32))
    pairs = [(jd.matvec(jnp.asarray(w)), td.matvec(tp_.tensor(w))),
             (jd.rmatvec(jnp.asarray(u)), td.rmatvec(tp_.tensor(u))),
             (jd.column_norms_sq(), td.column_norms_sq()),
             (jd.slab_matvec(js, jnp.asarray(d)),
              td.slab_matvec(ts, tp_.tensor(d))),
             (jd.slab_coordinate_deltas(js, jnp.asarray(d)),
              td.slab_coordinate_deltas(ts, tp_.tensor(d)))]
    pairs += list(zip(jd.slab_grad_hess(js, jnp.asarray(u), jnp.asarray(v)),
                      td.slab_grad_hess(ts, tp_.tensor(u), tp_.tensor(v))))
    for a, b in pairs:
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tp_.TOL)
    # the dense K3 copy keeps the storage dtype
    if layout == "dense":
        assert td.feature_major().dtype == getattr(torch, dtype)


@pytest.mark.parametrize("layout,scope", tp_.ROUTES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_bf16_bundle_step_matches_reference(layout, scope, use_kernels):
    jp, tp = bf16_problems(layout)
    jcfg, tcfg = tp_.configs(12, scope, use_kernels)
    w, z = tp_.start_carry(jp)
    n = jp.n_features
    idx = np.array([5, 17, 40, 2, 88, 63, 11, 0, 95, 30, 71, n], np.int32)
    (jw, jz), (jq, ja) = jpcdn.make_bundle_step(jp, jcfg)(
        (jnp.asarray(w), jnp.asarray(z)), jnp.asarray(idx))
    (tw, tz), (tq, ta) = tpcdn.make_bundle_step(tp, tcfg)(
        (tp_.tensor(w), tp_.tensor(z)), tp_.tensor(idx, dtype=torch.int32))
    assert tw.dtype == tz.dtype == torch.float32
    assert int(tq) == int(jq) and float(ta) == float(ja)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
    assert not np.array_equal(tw.numpy(), w)


@pytest.mark.parametrize("layout,scope", tp_.ROUTES)
def test_bf16_solve_matches_reference(layout, scope):
    """Ten outer iterations in each package at bf16 storage, the port fed
    the reference's partition of each iteration and chaining its own
    carry: F rel <= 1e-4 at every iteration."""
    jp, tp = bf16_problems(layout, seed=6)
    P = 16
    jcfg, tcfg = tp_.configs(P, scope, False)
    jouter = jpcdn.make_path_outer(jp, jcfg)
    touter = tpcdn.make_path_outer(tp, tcfg)
    n, s = jp.n_features, jp.n_samples
    jw, jz = jnp.zeros(n), jnp.zeros(s)
    key = jax.random.PRNGKey(0)
    active = np.ones(n, bool)
    st = bridge.state_from_numpy(np.zeros(n, np.float32),
                                 np.zeros(s, np.float32), active,
                                 device="cpu")
    tw, tz = st.w, st.z
    for _ in range(10):
        idxs, _ = tp_.reference_partition(key, active, P, False)
        jw, jz, key, jf, *_ = jouter(jw, jz, key, jnp.asarray(active),
                                     jnp.asarray(True), jnp.float32(2.0))
        tw, tz, _, tf, *_ = touter(
            tw, tz, st.gen, st.active, True, 2.0,
            idxs=bridge.partition_from_numpy(idxs, device="cpu"))
        assert float(tf) == pytest.approx(float(jf), rel=1e-4)
    # w itself parts where an Armijo decision flips on the last bit; F
    # is what the comparison holds
    assert tw.dtype == torch.float32 and bool(torch.isfinite(tw).all())


def test_pcdn_config_records_the_storage_dtype():
    from repro_torch.launch import common
    assert tpcdn.PCDNConfig(P=4).dtype == "float32"
    assert common.DTYPE_NAMES == {"fp32": "float32", "bf16": "bfloat16"}
    assert common.DTYPES["bf16"] == torch.bfloat16
    assert common.BF16_MIN_TOL == 1e-3
    assert common.BF16_LOSSES == ("logistic", "squared_hinge")
