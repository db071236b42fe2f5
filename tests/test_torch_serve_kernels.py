"""The plain versions of the serving-margin kernels (K4a, K4b) and of the
batched line search (K5), reached through the CPU branch of
repro_torch.kernels.ops, against the reference's oracles
(repro.kernels.ref) and the reference's kernels (repro.kernels.ops:
Pallas in interpret mode here, as tests/test_serve.py runs them;
REPRO_AUTOTUNE=off from conftest pins the Pallas route).

Inputs carry sentinels (idx == n in the model rows, row id == B in the
request columns), bf16 model values, and active widths A that are not a
multiple of 32. Tolerance: rtol 1e-5, atol 1e-6 (float32 sums in another
order). K5's sums cancel: each is a sum over samples of differences
phi(z + a delta) - phi(z) of losses of size ~1-10, and for the small
candidates the sum is far below the rounding of its terms in either
package. Its atol is therefore 1e-7 (about float32's epsilon) times
sum_i |phi(z_i)|, the scale of that rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bank(seed, K, A, n):
    """idx/val (K, A), sorted active ids then sentinel n; model 0 is all
    padding when K > 1. Padding slots carry a nonzero value, so only the
    sentinel keeps them out of the sums."""
    rng = np.random.default_rng(seed)
    idx = np.full((K, A), n, np.int32)
    val = np.full((K, A), 7.0, np.float32)
    for k in range(1 if K > 1 else 0, K):
        a = int(rng.integers(1, A + 1))
        idx[k, :a] = np.sort(rng.choice(n, a, replace=False))
        val[k, :a] = rng.standard_normal(a)
    return idx, val


def _requests_csc(seed, B, n, k_max):
    """A padded-CSC request batch: row ids with sentinel B at padding,
    where the values are nonzero (only the sentinel drops them)."""
    rng = np.random.default_rng(seed)
    rows = np.full((n, k_max), B, np.int32)
    vals = np.full((n, k_max), 5.0, np.float32)
    for j in range(n):
        c = int(rng.integers(0, k_max + 1))
        rows[j, :c] = np.sort(rng.choice(B, min(c, B), replace=False))[:c] \
            if c <= B else rng.integers(0, B, c)
        vals[j, :c] = rng.standard_normal(c)
    return rows, vals


DENSE_CASES = [(8, 40, 1, 5), (24, 30, 3, 6), (64, 257, 5, 45),
               (17, 512, 8, 33)]


@pytest.mark.parametrize("B,n,K,A", DENSE_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_serve_margins_dense_plain_matches_reference(B, n, K, A, bf16):
    rng = np.random.default_rng(B * n + K)
    X = rng.standard_normal((B, n)).astype(np.float32)
    idx, val = _bank(B + A, K, A, n)
    jval = jnp.asarray(val, jnp.bfloat16 if bf16 else jnp.float32)
    tval = torch.tensor(val).to(torch.bfloat16 if bf16 else torch.float32)
    got = tops.serve_margins_dense(torch.tensor(X), torch.tensor(idx), tval)
    assert got.dtype == torch.float32 and got.shape == (B, K)
    oracle = jref.serve_margins_dense_ref(jnp.asarray(X), jnp.asarray(idx),
                                          jval)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL)
    if bf16 is False and B % 8 == 0:
        # the Pallas kernel (interpret mode) takes tile-multiple batches
        kern = jops.serve_margins_dense(jnp.asarray(X), jnp.asarray(idx),
                                        jval)
        np.testing.assert_allclose(_np(got), _np(kern), **TOL)
    if K > 1:
        assert not torch.any(got[:, 0])       # the all-padding model


CSC_CASES = [(24, 30, 4, 3, 6), (64, 96, 9, 5, 45), (33, 200, 12, 8, 33)]


@pytest.mark.parametrize("B,n,k_max,K,A", CSC_CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_serve_margins_csc_plain_matches_reference(B, n, k_max, K, A, bf16):
    rows, vals = _requests_csc(B + n, B, n, k_max)
    idx, val = _bank(n + A, K, A, n)
    vdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    got = tops.serve_margins_csc(torch.tensor(rows),
                                 torch.tensor(vals).to(vdt[1]),
                                 torch.tensor(idx),
                                 torch.tensor(val).to(vdt[1]), B)
    assert got.shape == (B, K)
    args = (jnp.asarray(rows), jnp.asarray(vals, vdt[0]), jnp.asarray(idx),
            jnp.asarray(val, vdt[0]))
    np.testing.assert_allclose(
        _np(got), _np(jref.serve_margins_csc_ref(*args, n_requests=B)),
        **TOL)
    np.testing.assert_allclose(
        _np(got), _np(jops.serve_margins_csc(*args, n_requests=B)), **TOL)


def test_serve_margins_plain_versions_agree_with_dense_matmul():
    """Both layouts of one request batch give X @ W.T."""
    rng = np.random.default_rng(5)
    B, n, K, A = 40, 70, 4, 19
    X = ((rng.random((B, n)) < 0.2) *
         rng.standard_normal((B, n))).astype(np.float32)
    idx, val = _bank(9, K, A, n)
    W = np.zeros((K, n + 1), np.float32)
    for k in range(K):
        W[k, idx[k]] = val[k]              # padding lands in column n
    want = X @ W[:, :n].T
    from repro_torch.data.libsvm import CSRMatrix, csr_to_padded_csc
    pc = csr_to_padded_csc(CSRMatrix.from_dense(X))
    z_dense = tops.serve_margins_dense(torch.tensor(X), torch.tensor(idx),
                                       torch.tensor(val))
    z_csc = tops.serve_margins_csc(torch.tensor(pc.col_rows),
                                   torch.tensor(pc.col_vals),
                                   torch.tensor(idx), torch.tensor(val), B)
    np.testing.assert_allclose(_np(z_dense), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(z_csc), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
@pytest.mark.parametrize("s,Q", [(64, 40), (300, 7), (1000, 1)])
def test_linesearch_plain_matches_reference(kind, s, Q):
    rng = np.random.default_rng(s + Q)
    z = (2.0 * rng.standard_normal(s)).astype(np.float32)
    delta = (0.3 * rng.standard_normal(s)).astype(np.float32)
    delta[::4] = 0.0
    y = np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    alphas = (0.5 ** np.arange(Q)).astype(np.float32)
    got = tops.pcdn_linesearch(*(torch.tensor(a) for a in
                                 (z, delta, y, alphas)), kind=kind)
    assert got.shape == (Q,)
    jargs = tuple(jnp.asarray(a) for a in (z, delta, y, alphas))
    oracle = _np(jref.pcdn_linesearch_ref(*jargs, kind=kind))
    from repro.core.losses import get_loss
    terms = np.abs(np.asarray(get_loss(kind).value(jargs[0], jargs[2])))
    tol = dict(rtol=1e-5, atol=1e-7 * float(terms.sum()))
    np.testing.assert_allclose(_np(got), oracle, **tol)
    np.testing.assert_allclose(
        _np(got), _np(jops.pcdn_linesearch(*jargs, kind=kind)), **tol)


def test_new_wrappers_take_plain_version_on_cpu_without_counting():
    tops.reset_launch_counts()
    idx, val = _bank(1, 2, 3, 10)
    tops.serve_margins_dense(torch.zeros(2, 10), torch.tensor(idx),
                             torch.tensor(val))
    tops.serve_margins_csc(torch.full((10, 2), 4, dtype=torch.int32),
                           torch.zeros(10, 2), torch.tensor(idx),
                           torch.tensor(val), 4)
    tops.pcdn_linesearch(torch.zeros(5), torch.ones(5), torch.ones(5),
                         torch.ones(2))
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    with pytest.raises(KeyError, match="loss"):
        tops.pcdn_linesearch(torch.zeros(5), torch.ones(5), torch.ones(5),
                             torch.ones(2), kind="hinge")
