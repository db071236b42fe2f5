"""K1's whole function on the CPU: `ops.pcdn_bundle` (the plain whole step,
`ref.pcdn_bundle_step_ref`, on CPU tensors) against one support-scope
bundle step of the reference's `make_bundle_step`, from the same carry.
The kernel itself runs only on the card (tests/test_torch_gpu.py).

Tolerance: w and z rtol 1e-5, atol 1e-6 (float32 sums in another order);
alpha and n_steps exactly equal; w and z outside the bundle unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp_
from repro.core import linesearch as jls
from repro.core import pcdn as jpcdn
from repro.core import problem as jprob
from repro.data import make_classification
from repro_torch.core import linesearch as tls
from repro_torch.core import pcdn as tpcdn
from repro_torch.core import problem as tprob
from repro_torch.kernels import ops

P = 12


def _problems(kind, l2, seed=0, s=400, n=96, c=2.0):
    X, y, _ = make_classification(s, n, sparsity=0.93, seed=seed)
    if kind == "squared":
        y = y * 0.5 + 0.25     # real-valued targets
    jp = jprob.make_problem(X, y, c=c, loss=kind, elastic_net_l2=l2,
                            layout="padded_csc")
    tp = tprob.make_problem(X, y, c=c, loss=kind, elastic_net_l2=l2,
                            layout="padded_csc", device="cpu")
    return jp, tp


def _configs(sigma=0.01, jax_kernels=False):
    kw = dict(P=P, ls_scope="support", seed=0)
    return (jpcdn.PCDNConfig(armijo=jls.ArmijoParams(sigma=sigma),
                             use_kernels=jax_kernels, **kw),
            tpcdn.PCDNConfig(armijo=tls.ArmijoParams(sigma=sigma),
                             use_kernels=True, **kw))


def _run_both(jp, tp, idx, sigma=0.01, jax_kernels=False, seed=1):
    jcfg, tcfg = _configs(sigma, jax_kernels)
    w, z = tp_.start_carry(jp, seed=seed)
    (jw, jz), (jq, ja) = jpcdn.make_bundle_step(jp, jcfg)(
        (jnp.asarray(w), jnp.asarray(z)), jnp.asarray(idx))
    step = tpcdn.make_bundle_step(tp, tcfg)
    tw, tz = tp_.tensor(w), tp_.tensor(z)
    (tw, tz), (tq, ta) = step((tw, tz), tp_.tensor(idx, dtype=torch.int32))
    assert int(tq) == int(jq)
    assert float(ta) == float(ja)
    assert tq.dtype == torch.int32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **tp_.TOL)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tp_.TOL)
    # nothing moves outside the bundle's features and rows
    n = jp.n_features
    live = idx[idx < n]
    out_w = np.setdiff1d(np.arange(n), live)
    assert np.array_equal(tw.numpy()[out_w], w[out_w])
    rows = tp.design.col_rows[torch.as_tensor(live, dtype=torch.long)]
    touched = np.unique(rows.numpy())
    out_z = np.setdiff1d(np.arange(jp.n_samples), touched)
    assert np.array_equal(tz.numpy()[out_z], z[out_z])
    return w, tw.numpy(), int(tq), float(ta)


@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_whole_step_matches_reference_support_step(kind, l2):
    jp, tp = _problems(kind, l2)
    n = jp.n_features
    idx = np.array([5, 17, 40, 2, 88, 63, 11, 0, 95, 30, 71, n], np.int32)
    w0, w1, _, _ = _run_both(jp, tp, idx)
    assert not np.array_equal(w0, w1)   # the step moved w


@pytest.mark.parametrize("kind", ["logistic", "squared_hinge"])
def test_whole_step_matches_the_reference_kernel_route(kind):
    """The same step against the reference's fused Pallas route (interpret
    mode here)."""
    jp, tp = _problems(kind, 0.0, seed=2)
    idx = np.arange(20, 20 + P, dtype=np.int32)
    _run_both(jp, tp, idx, jax_kernels=True)


def test_whole_step_backtracks_past_the_first_chunk():
    """sigma = 0.99 asks for nearly the whole predicted decrease: alpha = 1
    and 1/2 fail, so the in-kernel search goes past its first chunk of
    ops.BUNDLE_CHUNK candidates."""
    jp, tp = _problems("logistic", 0.0, seed=4)
    idx = np.arange(40, 40 + P, dtype=np.int32)
    _, _, q, a = _run_both(jp, tp, idx, sigma=0.99)
    assert q > ops.BUNDLE_CHUNK and 0.0 < a < 0.5 ** ops.BUNDLE_CHUNK


def test_whole_step_when_no_candidate_passes():
    """No candidate gives the asked decrease: alpha = 0 and n_steps = 1 (the
    argmax of an all-false mask), w and z unchanged."""
    jp, tp = _problems("logistic", 0.0, seed=3)
    idx = np.arange(P, dtype=np.int32)
    w0, w1, q, a = _run_both(jp, tp, idx, sigma=1e6)
    assert (q, a) == (1, 0.0)
    assert np.array_equal(w0, w1)


def test_all_sentinel_last_bundle():
    """The padding bundle at the end of a partition: every index is the
    sentinel n, nothing moves, and the search accepts alpha = 1 at once
    (a zero decrease passes a zero bound), as in the reference."""
    jp, tp = _problems("logistic", 0.0)
    idx = np.full((P,), jp.n_features, np.int32)
    w0, w1, q, a = _run_both(jp, tp, idx)
    assert (q, a) == (1, 1.0)
    assert np.array_equal(w0, w1)


def test_step_records_each_bundle_at_its_slot():
    """`update(w, z, idx, t)` writes bundle t's n_steps and alpha at t of
    the (n_bundles,) outputs, as the outer iteration reads them; a second
    step from the same carry with the first's arguments agrees."""
    _, tp = _problems("logistic", 0.0)
    _, tcfg = _configs()
    n = tp.n_features
    step = tpcdn.make_bundle_step(tp, tcfg, n_bundles=3)
    z = tp.margins(torch.zeros(n))
    w = torch.zeros(n)
    idxs = torch.arange(3 * P, dtype=torch.int32).reshape(3, P)
    for t in range(3):
        step.update(w, z, idxs[t], t)
    assert step.n_steps.shape == (3,) and step.alpha.shape == (3,)
    assert torch.all(step.n_steps >= 1) and torch.all(step.alpha > 0)
    again = tpcdn.make_bundle_step(tp, tcfg)
    w2, z2 = torch.zeros(n), tp.margins(torch.zeros(n))
    (w2, z2), (q, a) = again((w2, z2), idxs[0])
    assert int(q) == int(step.n_steps[0]) and float(a) == float(step.alpha[0])
