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
