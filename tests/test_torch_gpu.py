"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; the `cuda` fixture skips every test when no CUDA device is
present (decided at run time, never at import, so every pytest worker
collects the same tests). On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| for d/g/h and upd_*
(float32 sums in another order; K1 scatters with atomicAdd, in a
run-dependent order), bf16 storage against the plain version on the same
bf16 values; alpha and n_steps exactly equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.design_matrix import _take_fill, padded_row_support
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu
RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    return torch.device("cuda")


def _close(got, want):
    err = float(torch.max(torch.abs(got.float() - want.float())))
    scale = float(torch.max(torch.abs(want.float())))
    assert err <= RTOL * max(scale, 1e-30), (err, scale)


def _rng(*seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("P,K,s", [(1, 1, 10), (37, 9, 300), (33, 300, 1000),
                                   (512, 278, 57848)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_sparse_direction_kernel(cuda, P, K, s, dtype, l2):
    rng = _rng(P, K, s)
    rows = rng.integers(0, s + 1, size=(P, K)).astype(np.int32)
    vals = rng.standard_normal((P, K)).astype(np.float32)
    vals[rows == s] = 0.0
    args = [torch.tensor(rows, device=cuda),
            torch.tensor(vals, device=cuda).to(dtype),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.abs(rng.standard_normal(s)) + 0.01,
                         dtype=torch.float32, device=cuda),
            torch.tensor(rng.standard_normal(P), dtype=torch.float32,
                         device=cuda)]
    before = ops.launch_counts()["pcdn_sparse_direction"]
    got = ops.pcdn_sparse_direction(*args, l2=l2)
    want = ref.pcdn_sparse_direction_ref(*args, l2=l2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b)
    assert ops.launch_counts()["pcdn_sparse_direction"] == before + 1


@pytest.mark.parametrize("s,P", [(1, 1), (77, 5), (1000, 37), (6000, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_direction_kernel(cuda, s, P, dtype, l2):
    rng = _rng(s, P)
    args = [torch.tensor(rng.standard_normal((s, P)), dtype=torch.float32,
                         device=cuda).to(dtype),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.abs(rng.standard_normal(s)) + 0.01,
                         dtype=torch.float32, device=cuda),
            torch.tensor(rng.standard_normal(P), dtype=torch.float32,
                         device=cuda)]
    got = ops.pcdn_direction(*args, l2=l2)
    want = ref.pcdn_direction_ref(*args, l2=l2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b)


def _bundle_args(cuda, seed, s, P, k, scale=1.0, same_sign=False):
    rng = _rng(seed)
    counts = rng.integers(1, k + 1, size=P)
    rows = np.full((P, k), s, np.int32)
    vals = np.zeros((P, k), np.float32)
    for j in range(P):
        rows[j, :counts[j]] = rng.integers(0, s, size=counts[j])
        vals[j, :counts[j]] = rng.standard_normal(counts[j]) * scale
    if same_sign:
        vals = np.abs(vals)
    support, pos = padded_row_support(torch.tensor(rows, device=cuda), s)
    z = torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                     device=cuda)
    y = torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                     dtype=torch.float32, device=cuda)
    w = 0.1 * rng.standard_normal(P)
    w[::3] = 0.0
    return [torch.tensor(vals, device=cuda), pos,
            _take_fill(z, support, 0.0), _take_fill(y, support, 1.0),
            torch.tensor(w, dtype=torch.float32, device=cuda),
            torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                         device=cuda)]


@pytest.mark.parametrize("kind,l2,gamma,sigma,P,k,s", [
    ("logistic", 0.0, 0.0, 0.01, 32, 278, 57848),   # the support solve
    ("logistic", 0.3, 0.0, 0.01, 13, 6, 200),
    ("squared_hinge", 0.0, 0.5, 0.01, 7, 6, 200),
    ("squared", 0.2, 0.0, 0.01, 40, 20, 500),
    ("logistic", 0.0, 0.0, 1e6, 9, 6, 200),          # nothing passes
])
def test_bundle_kernel(cuda, kind, l2, gamma, sigma, P, k, s):
    args = _bundle_args(cuda, P, s, P, k)
    kw = dict(kind=kind, l2=l2, sigma=sigma, gamma=gamma)
    got = ops.pcdn_bundle(*args, 4.0, **kw)
    want = ref.pcdn_bundle_ref(*args, 4.0, **kw)
    torch.cuda.synchronize()
    assert float(got[2]) == float(want[2])
    assert int(got[3]) == int(want[3])
    _close(got[0], want[0])
    _close(got[1], want[1])
    if sigma > 1:
        assert float(got[2]) == 0.0 and int(got[3]) == 1


def test_bundle_kernel_backtracks(cuda):
    args = _bundle_args(cuda, 3, 4, 11, 5, same_sign=True)
    got = ops.pcdn_bundle(*args, 8.0)
    want = ref.pcdn_bundle_ref(*args, 8.0)
    assert int(got[3]) == int(want[3]) > 1
    assert float(got[2]) == float(want[2])
    _close(got[0], want[0])


def test_bundle_kernel_bf16_values(cuda):
    args = _bundle_args(cuda, 5, 300, 24, 10)
    args[0] = args[0].to(torch.bfloat16)
    got = ops.pcdn_bundle(*args, 2.0)
    want = ref.pcdn_bundle_ref(*args, 2.0)
    assert int(got[3]) == int(want[3])
    _close(got[0], want[0])


def test_wrappers_refuse_what_kernels_do_not_take(cuda):
    rows = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    vals = torch.zeros((4, 3), device=cuda)
    u = torch.zeros(10, device=cuda)
    w = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        ops.pcdn_sparse_direction(rows, vals, u, u, w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pcdn_direction(torch.zeros((4, 10), device=cuda).T, u, u, w)
    with pytest.raises(ValueError, match="devices"):
        ops.pcdn_direction(torch.zeros((10, 4), device=cuda), u.cpu(), u, w)


@pytest.mark.parametrize("layout,P,scope,kernel", [
    ("padded_csc", 8, "support", "pcdn_bundle"),
    ("padded_csc", 64, "full", "pcdn_sparse_direction"),
    ("dense", 64, "full", "pcdn_direction"),
])
def test_solve_runs_through_kernel(cuda, layout, P, scope, kernel):
    from repro_torch.core import PCDNConfig, make_problem
    from repro_torch.data import make_classification
    from repro_torch.engine import LocalBackend, solve
    X, y, _ = make_classification(2000, 256, sparsity=0.95, seed=2)
    prob = make_problem(X, y, c=1.0, layout=layout, device=cuda)
    res = {}
    for use_kernels in (True, False):
        cfg = PCDNConfig(P=P, ls_scope=scope, use_kernels=use_kernels,
                         max_outer=5, tol_kkt=0.0)
        ops.reset_launch_counts()
        res[use_kernels] = solve(LocalBackend(prob, cfg), 1.0, max_outer=5,
                                 tol_kkt=0.0)
        counts = ops.launch_counts()
        assert (counts[kernel] > 0) == use_kernels, counts
    f_k, f_p = res[True].objective, res[False].objective
    assert abs(f_k - f_p) <= 1e-4 * abs(f_p)


# -- serving margins (K4a, K4b) and the batched line search (K5) --------------

def _bank_arrays(cuda, seed, K, A, n):
    """idx/val (K, A) with sentinel n at padding, where the values are
    nonzero (only the sentinel keeps them out); model 0 all padding."""
    rng = _rng(seed)
    idx = np.full((K, A), n, np.int32)
    val = np.full((K, A), 7.0, np.float32)
    for k in range(1, K):
        a = int(rng.integers(1, A + 1))
        idx[k, :a] = np.sort(rng.choice(n, a, replace=False))
        val[k, :a] = rng.standard_normal(a)
    return (torch.tensor(idx, device=cuda), torch.tensor(val, device=cuda))


def _close_to(got, want, rtol):
    err = float(torch.max(torch.abs(got.float() - want.float())))
    scale = float(torch.max(torch.abs(want.float())))
    assert err <= rtol * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("B,n,K,A", [(1, 10, 1, 1), (17, 300, 5, 37),
                                     (256, 20958, 8, 3000),
                                     (70, 5000, 3, 2500)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
def test_serve_margins_dense_kernel(cuda, B, n, K, A, x_dtype, v_dtype):
    rng = _rng(B, n, K)
    idx, val = _bank_arrays(cuda, B + K, K, min(A, n), n)
    X = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                     device=cuda).to(x_dtype)
    val = val.to(v_dtype)
    before = ops.launch_counts()["serve_margins_dense"]
    got = ops.serve_margins_dense(X, idx, val)
    want = ref.serve_margins_dense_ref(X, idx, val)
    torch.cuda.synchronize()
    assert got.shape == (B, K)
    # a fixed sum order, no atomics: held to 1e-5
    _close_to(got, want, 1e-5)
    assert not torch.any(got[:, 0])              # the all-padding model
    assert ops.launch_counts()["serve_margins_dense"] == before + 1


@pytest.mark.parametrize("B,n,k_max,K,A", [(1, 10, 1, 1, 1),
                                           (33, 300, 9, 5, 40),
                                           (256, 20958, 80, 8, 3000),
                                           (60000, 2000, 40, 2, 500)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serve_margins_csc_kernel(cuda, B, n, k_max, K, A, dtype):
    rng = _rng(B, n, k_max)
    rows = rng.integers(0, B + 1, size=(n, k_max)).astype(np.int32)
    vals = rng.standard_normal((n, k_max)).astype(np.float32)
    vals[rows == B] = 5.0                  # the sentinel row drops it
    idx, val = _bank_arrays(cuda, B + n, K, min(A, n), n)
    args = (torch.tensor(rows, device=cuda),
            torch.tensor(vals, device=cuda).to(dtype), idx, val.to(dtype), B)
    got = ops.serve_margins_csc(*args)
    want = ref.serve_margins_csc_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, K)
    _close_to(got, want, RTOL)


@pytest.mark.parametrize("s,Q", [(1, 1), (1000, 7), (57848, 40),
                                 (300000, 40)])
@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_linesearch_kernel(cuda, s, Q, kind):
    rng = _rng(s, Q)
    delta = rng.standard_normal(s) * 0.1
    delta[::3] = 0.0
    args = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(delta, dtype=torch.float32, device=cuda),
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda),
            torch.tensor(0.5 ** np.arange(Q), dtype=torch.float32,
                         device=cuda)]
    got = ops.pcdn_linesearch(*args, kind=kind)
    want = ref.pcdn_linesearch_ref(*args, kind=kind)
    again = ops.pcdn_linesearch(*args, kind=kind)
    torch.cuda.synchronize()
    _close_to(got, want, RTOL)
    assert torch.equal(got, again)               # block order: deterministic


def test_serve_loop_swaps_in_place_on_the_card(cuda):
    from repro_torch.kernels import build
    from repro_torch.serve import artifact as art
    from repro_torch.serve.loop import ServeLoop
    from repro_torch.serve.predict import margins_dense

    def family(seed, nnz):
        rng = _rng(seed)
        w = np.zeros(500)
        w[rng.choice(500, nnz, replace=False)] = rng.standard_normal(nnz)
        return art.ModelFamily("binary", (art.artifact_from_solution(
            w, "logistic", 1.0),))

    X = _rng(3).standard_normal((40, 500)).astype(np.float32)
    with ServeLoop(family(1, 20), buckets=(1, 4, 16), use_kernels=True,
                   default_budget_s=0.01, device=cuda) as loop:
        ptrs = loop.storage_ptrs()
        libs = build.loaded()
        first = [f.result(timeout=30) for f in loop.submit_many(X[:20])]
        assert loop.swap(model=family(2, 30)).installed.wait(timeout=30)
        second = [f.result(timeout=30) for f in loop.submit_many(X[20:])]
        assert loop.storage_ptrs() == ptrs
        assert build.loaded() == libs
        assert loop.libraries_loaded_since_warmup() == ()
        want = margins_dense(loop.bank(), X[20:]).cpu().numpy()
    assert {r.version for r in first} == {1}
    assert {r.version for r in second} == {2}
    np.testing.assert_allclose(np.stack([r.margins for r in second]), want,
                               rtol=1e-5, atol=1e-5)
