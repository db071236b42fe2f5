"""One PCDN bundle step in the port against the reference, from a shared
carry, in each route (dense-full, CSC-full, CSC-support), with and without
the kernels (the port's plain versions on the CPU; the reference's Pallas
kernels in interpret mode). w, z: rtol 1e-5, atol 1e-6; alpha and n_steps
equal."""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity as tp_
from repro.core import pcdn as jpcdn
from repro_torch.core import pcdn as tpcdn


@pytest.mark.parametrize("layout,scope", tp_.ROUTES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_bundle_step_matches_reference(layout, scope, use_kernels):
    jp, tp = tp_.problems(layout)
    jcfg, tcfg = tp_.configs(12, scope, use_kernels)
    assert tpcdn.resolve_ls_scope(tcfg, tp) == \
        jpcdn.resolve_ls_scope(jcfg, jp) == scope
    w, z = tp_.start_carry(jp)
    n = jp.n_features
    idx = np.array([5, 17, 40, 2, 88, 63, 11, 0, 95, 30, 71, n], np.int32)
    (jw, jz), (jq, ja) = jpcdn.make_bundle_step(jp, jcfg)(
        (jnp.asarray(w), jnp.asarray(z)), jnp.asarray(idx))
    tw, tz = tp_.tensor(w), tp_.tensor(z)
    (tw, tz), (tq, ta) = tpcdn.make_bundle_step(tp, tcfg)(
        (tw, tz), tp_.tensor(idx, dtype=tp_.torch.int32))
    assert int(tq) == int(jq)
    assert float(ta) == float(ja)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
    assert not np.array_equal(tw.numpy(), w)   # the step moved w


def test_cdn_config_and_bundle_size():
    cfg = tpcdn.cdn_config(max_outer=3)
    assert cfg.P == 1 and cfg.ls_kind == "backtracking"
    assert tpcdn.with_bundle_size(cfg, 8).P == 8
    assert tpcdn.AUTO_SUPPORT_MARGIN == jpcdn.AUTO_SUPPORT_MARGIN == 4


@pytest.mark.parametrize("layout,scope", tp_.ROUTES)
def test_backtracking_step_matches_reference(layout, scope):
    jp, tp = tp_.problems(layout, seed=3)
    kw = dict(P=12, ls_scope=scope, ls_kind="backtracking")
    jcfg, tcfg = jpcdn.PCDNConfig(**kw), tpcdn.PCDNConfig(**kw)
    w, z = tp_.start_carry(jp, seed=4)
    idx = np.arange(3, 15, dtype=np.int32)
    (jw, jz), (jq, ja) = jpcdn.make_bundle_step(jp, jcfg)(
        (jnp.asarray(w), jnp.asarray(z)), jnp.asarray(idx))
    (tw, tz), (tq, ta) = tpcdn.make_bundle_step(tp, tcfg)(
        (tp_.tensor(w), tp_.tensor(z)),
        tp_.tensor(idx, dtype=tp_.torch.int32))
    assert int(tq) == int(jq) and float(ta) == float(ja)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
