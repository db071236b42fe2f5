"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; the `cuda` fixture skips every test when no CUDA device is
present (decided at run time, never at import, so every pytest worker
collects the same tests). On a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| for d/g/h and upd_*
(float32 sums in another order), bf16 storage against the plain version on
the same bf16 values; alpha and n_steps exactly equal. Two calls of K1, K2
(with its partials and scatter entries) or K3 on the same inputs are
bit-equal: every sum runs in a fixed order.
"""
import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_sparse_direction_kernel(cuda, P, K, s, dtype, l2, kind):
    rng = _rng(P, K, s)
    rows = rng.integers(0, s + 1, size=(P, K)).astype(np.int32)
    vals = rng.standard_normal((P, K)).astype(np.float32)
    vals[rows == s] = 0.0
    args = [torch.tensor(rows, device=cuda),
            torch.tensor(vals, device=cuda).to(dtype),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda),
            torch.tensor(rng.standard_normal(P), dtype=torch.float32,
                         device=cuda), 1.5]
    before = ops.launch_counts()["pcdn_sparse_direction"]
    got = ops.pcdn_sparse_direction(*args, kind=kind, l2=l2)
    want = ref.pcdn_sparse_direction_ref(*args, kind=kind, l2=l2)
    torch.cuda.synchronize()
    assert got[3].shape == (s,)
    for a, b in zip(got, want):   # d, g, h, delta
        _close(a, b)
    assert ops.launch_counts()["pcdn_sparse_direction"] == before + 1


@pytest.mark.parametrize("s,P,n,n_sentinel", [
    (1, 1, 1, 0), (77, 5, 20, 0), (1000, 37, 100, 5),
    (6000, 512, 5000, 120),       # gisette's ragged last bundle
    (9000, 40, 50, 3),            # 13 clusters of 3 columns
    (48000, 512, 600, 10),        # not resident: rows in two tiles
    (6000, 1000, 2000, 0)])       # 16 clusters: two waves
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [0.0, 0.3])
@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_direction_kernel(cuda, s, P, n, n_sentinel, dtype, l2, kind):
    rng = _rng(s, P)
    XT = torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32,
                      device=cuda).to(dtype)
    idx = rng.choice(n, P, replace=False).astype(np.int32)
    w = rng.standard_normal(P)
    if n_sentinel:
        idx[-n_sentinel:] = n
        w[-n_sentinel:] = 0.0
    args = [XT, torch.tensor(idx, device=cuda),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda),
            torch.tensor(w, dtype=torch.float32, device=cuda), 1.5]
    before = ops.launch_counts()["pcdn_direction"]
    got = ops.pcdn_direction(*args, kind=kind, l2=l2)
    again = ops.pcdn_direction(*args, kind=kind, l2=l2)
    want = ref.pcdn_direction_ref(*args, kind=kind, l2=l2)
    torch.cuda.synchronize()
    assert got[3].shape == (s,)
    for a, b in zip(got, want):   # d, g, h, delta
        _close(a, b)
    # every sum in a fixed order; the arrival counters back at 0
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert not torch.any(ops._direction_counter(XT.device))
    if n_sentinel:
        assert not torch.any(got[0][-n_sentinel:])
    assert ops.launch_counts()["pcdn_direction"] == before + 2


def test_direction_plan_matches_the_kernel(cuda):
    """The plan's shared-memory layout is the kernel's (a tile's floats)."""
    from repro_torch.kernels import build
    lib = build.load("pcdn_direction")
    for tile in (8, 80, 752, 4096):
        floats = ops.direction_smem_bytes(tile, 1, False, 4) // 4
        assert lib.pcdn_direction_smem_floats(tile) == floats


def _bundle_design(cuda, seed, s, n, K, same_sign=False, dtype=None):
    """A padded-CSC design (col_rows, col_vals) of n columns of up to K
    distinct rows of s, sentinel s at padding; z, y, a sparse w."""
    rng = _rng(seed)
    rows = np.full((n, K), s, np.int32)
    vals = np.zeros((n, K), np.float32)
    for j in range(n):
        r = np.unique(rng.integers(0, s, size=int(rng.integers(1, K + 1))))
        rows[j, :r.size] = r
        vals[j, :r.size] = rng.standard_normal(r.size)
    if same_sign:
        vals = np.abs(vals)
    w = np.where(rng.random(n) < 0.3, 0.1 * rng.standard_normal(n), 0.0)
    col_vals = torch.tensor(vals, device=cuda)
    return dict(
        col_rows=torch.tensor(rows, device=cuda),
        col_vals=col_vals.to(dtype) if dtype is not None else col_vals,
        z=torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                       device=cuda),
        y=torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                       dtype=torch.float32, device=cuda),
        w=torch.tensor(w, dtype=torch.float32, device=cuda))


def _bundle_step_check(cuda, d, idx, c, kind="logistic", l2=0.0,
                       sigma=0.01, gamma=0.0):
    """K1 on one clone of the carry, its plain version on another: w and z
    close, alpha and n_steps equal, w and z bit-equal outside the bundle,
    the slot map all -1 again. -> (n_steps, alpha)."""
    n, K = d["col_rows"].shape
    s = d["z"].shape[0]
    idx = torch.tensor(idx, dtype=torch.int32, device=cuda)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    launch = ops.BundleLaunch(d["col_rows"], d["col_vals"], d["y"], alphas,
                              c, idx.shape[0], 1, kind=kind, l2=l2,
                              sigma=sigma, gamma=gamma)
    w_k, z_k = d["w"].clone(), d["z"].clone()
    w_p, z_p = d["w"].clone(), d["z"].clone()
    before = ops.launch_counts()["pcdn_bundle"]
    ops.pcdn_bundle(launch, w_k, z_k, idx, 0)
    q, a = ref.pcdn_bundle_step_ref(d["col_rows"], d["col_vals"], idx, z_p,
                                    d["y"], w_p, alphas, c, kind=kind,
                                    l2=l2, sigma=sigma, gamma=gamma)
    torch.cuda.synchronize()
    assert ops.launch_counts()["pcdn_bundle"] == before + 1
    assert int(launch.n_steps[0]) == int(q)
    assert float(launch.alpha[0]) == float(a)
    _close(w_k, w_p)
    _close(z_k, z_p)
    live = idx[idx < n].long()
    out_w = torch.ones(n, dtype=torch.bool, device=cuda)
    out_w[live] = False
    assert torch.equal(w_k[out_w], d["w"][out_w])
    touched = d["col_rows"][live].reshape(-1).long()
    out_z = torch.ones(s + 1, dtype=torch.bool, device=cuda)
    out_z[touched] = False
    assert torch.equal(z_k[out_z[:s]], d["z"][out_z[:s]])
    # the owner map, the list heads and the slots' rows are back to
    # INT32_MAX, 0 and -1 for the next bundle
    _workspace_reset(launch, s, idx.shape[0] * K)
    return int(q), float(a)


def _workspace_reset(launch, s, R):
    ws = launch.workspace
    assert bool(torch.all(ws[:s] == 2 ** 31 - 1))
    assert bool(torch.all(ws[s:2 * s] == 0))
    assert bool(torch.all(ws[2 * s:2 * s + R] == -1))


@pytest.mark.parametrize("kind,l2,gamma,P,K,s,n", [
    ("logistic", 0.0, 0.0, 32, 278, 57848, 300),    # the support solve
    ("logistic", 0.3, 0.0, 13, 6, 200, 40),
    ("squared_hinge", 0.3, 0.5, 7, 6, 200, 40),
    ("squared", 0.2, 0.0, 40, 20, 500, 80),
    ("logistic", 0.1, 0.0, 300, 40, 60000, 600),    # several rounds
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bundle_kernel(cuda, kind, l2, gamma, P, K, s, n, dtype):
    d = _bundle_design(cuda, P, s, n, K, dtype=dtype)
    idx = _rng(P, 1).permutation(n)[:P]
    q, _ = _bundle_step_check(cuda, d, idx, 4.0, kind=kind, l2=l2,
                              gamma=gamma)
    assert q >= 1


def test_bundle_kernel_backtracks(cuda):
    """Eleven same-sign columns over 4 rows: strongly correlated, so alpha
    = 1 overshoots; c scaled up."""
    d = _bundle_design(cuda, 3, 4, 11, 5, same_sign=True)
    q, _ = _bundle_step_check(cuda, d, np.arange(11), 8.0)
    assert q > 1


def test_bundle_kernel_first_chunk_fails(cuda):
    """sigma = 0.99: the search goes past its first chunk of candidates."""
    d = _bundle_design(cuda, 8, 57848, 300, 278)
    q, _ = _bundle_step_check(cuda, d, np.arange(32), 4.0, sigma=0.99)
    assert q > ops.BUNDLE_CHUNK


def test_bundle_kernel_nothing_passes(cuda):
    d = _bundle_design(cuda, 9, 200, 40, 6)
    assert _bundle_step_check(cuda, d, np.arange(9), 4.0,
                              sigma=1e6) == (1, 0.0)


def test_bundle_kernel_all_sentinel_bundle(cuda):
    d = _bundle_design(cuda, 10, 300, 50, 8)
    assert _bundle_step_check(cuda, d, np.full(16, 50), 4.0) == (1, 1.0)


def test_bundle_kernel_at_kdda_rows(cuda):
    """s = 8,407,752 (kdda's published rows) with a narrow design: the slot
    map covers every row, no sort over s."""
    d = _bundle_design(cuda, 11, 8_407_752, 64, 32)
    _bundle_step_check(cuda, d, np.arange(0, 64, 2), 2.0)


def test_bundle_kernel_runs_bundles_back_to_back(cuda):
    """One launch object over a partition: each bundle leaves the map as it
    found it, and the plain version, bundle for bundle, agrees."""
    d = _bundle_design(cuda, 12, 2000, 96, 30)
    perm = torch.tensor(_rng(12).permutation(96).reshape(8, 12),
                        dtype=torch.int32, device=cuda)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    launch = ops.BundleLaunch(d["col_rows"], d["col_vals"], d["y"], alphas,
                              2.0, 12, 8)
    w_k, z_k = d["w"].clone(), d["z"].clone()
    w_p, z_p = d["w"].clone(), d["z"].clone()
    for t in range(8):
        ops.pcdn_bundle(launch, w_k, z_k, perm[t], t)
        q, a = ref.pcdn_bundle_step_ref(d["col_rows"], d["col_vals"],
                                        perm[t], z_p, d["y"], w_p, alphas,
                                        2.0)
        assert int(launch.n_steps[t]) == int(q)
        assert float(launch.alpha[t]) == float(a)
        # from the kernel's carry, so an Armijo flip cannot compound
        w_p.copy_(w_k)
        z_p.copy_(z_k)
    _workspace_reset(launch, 2000, 12 * 30)


def test_bundle_kernel_checks_a_view_at_the_bound_address(cuda):
    """After a bundle on z, a shorter view of z (the same address) is
    refused, not handed to the kernel."""
    d = _bundle_design(cuda, 14, 300, 40, 6)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    launch = ops.BundleLaunch(d["col_rows"], d["col_vals"], d["y"], alphas,
                              2.0, 8, 2)
    idx = torch.arange(8, dtype=torch.int32, device=cuda)
    ops.pcdn_bundle(launch, d["w"], d["z"], idx, 0)
    with pytest.raises(ValueError, match="shape"):
        ops.pcdn_bundle(launch, d["w"], d["z"][:100], idx, 1)
    with pytest.raises(TypeError, match="dtype"):
        ops.pcdn_bundle(launch, d["w"].view(torch.int32), d["z"], idx, 1)


def test_wrappers_refuse_what_kernels_do_not_take(cuda):
    rows = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    vals = torch.zeros((4, 3), device=cuda)
    u = torch.zeros(10, device=cuda)
    w = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        ops.pcdn_sparse_direction(rows, vals, u, u, w, 1.0)
    launch = ops.BundleLaunch(rows.int(), vals, u, torch.ones(40,
                              device=cuda), 1.0, 4, 1)
    with pytest.raises(ValueError, match="int32"):
        ops.pcdn_bundle(launch, w, u, rows[:, 0], 0)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pcdn_direction(torch.zeros((10, 4), device=cuda).T, idx, u, u, w,
                           1.0)
    with pytest.raises(ValueError, match="devices"):
        ops.pcdn_direction(torch.zeros((4, 10), device=cuda), idx.cpu(), u,
                           u, w, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        ops.pcdn_direction(torch.zeros((4, 10), device=cuda), idx.long(), u,
                           u, w, 1.0)


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


# -- the record_aux plane, telemetry and the batch solver on the card --------

def _support_problem(cuda, s=4000, n=512, seed=3):
    from repro_torch.core import make_problem
    from repro_torch.data import make_classification
    X, y, _ = make_classification(s, n, sparsity=0.97, seed=seed)
    return make_problem(X, y, c=2.0, layout="padded_csc", device=cuda)


def test_record_aux_plane_from_k1_equals_plain_step(cuda):
    """The outer iteration's (q, alpha) with record_aux is K1's own
    (n_bundles,) output; bundle for bundle from one carry and one
    partition, the plain step gives the same q and alpha."""
    from repro_torch.core import PCDNConfig, bundles, pcdn
    prob = _support_problem(cuda)
    kw = dict(P=8, ls_scope="support", tol_kkt=0.0, seed=0)
    gen = torch.Generator().manual_seed(0)
    idxs = bundles.partition(gen, prob.n_features, 8, device=cuda)
    b = idxs.shape[0]
    outer = pcdn.make_path_outer(prob, PCDNConfig(use_kernels=True,
                                                  record_aux=True, **kw))
    w0 = torch.zeros(prob.n_features, device=cuda)
    z0 = torch.zeros(prob.n_samples, device=cuda)
    active = torch.ones(prob.n_features, dtype=torch.bool, device=cuda)
    ops.reset_launch_counts()
    out = outer(w0, z0, gen, active, True, 2.0, idxs=idxs)
    assert ops.launch_counts()["pcdn_bundle"] == b and len(out) == 10
    q, alpha = out[9]
    assert q.shape == alpha.shape == (b,) and q.device.type == "cuda"
    assert float(out[6]) == pytest.approx(float(q.float().mean()),
                                          rel=1e-6)
    k_step = pcdn.make_bundle_step(prob, PCDNConfig(use_kernels=True, **kw),
                                   n_bundles=b)
    p_step = pcdn.make_bundle_step(prob, PCDNConfig(use_kernels=False, **kw),
                                   n_bundles=b)
    w_k, z_k = w0.clone(), z0.clone()
    for t in range(b):
        w_p, z_p = w_k.clone(), z_k.clone()
        k_step.update(w_k, z_k, idxs[t], t)
        p_step.update(w_p, z_p, idxs[t], t)
        assert int(k_step.n_steps[t]) == int(p_step.n_steps[t]), t
        assert float(k_step.alpha[t]) == float(p_step.alpha[t]), t
    # the outer's plane: each bundle's accepted alpha is beta^(q-1), or 0
    # when no candidate passed (q = 1)
    q_np, a_np = q.cpu().numpy(), alpha.cpu().numpy()
    assert np.all((q_np >= 1) & (q_np <= 40))
    assert np.all((a_np == 0.5 ** (q_np - 1)) | ((a_np == 0) & (q_np == 1)))


def test_launch_counter_equals_bundles_run(cuda):
    from repro_torch import obs
    from repro_torch.core import PCDNConfig, pcdn
    prob = _support_problem(cuda)
    cfg = PCDNConfig(P=8, ls_scope="support", use_kernels=True,
                     record_aux=True, tol_kkt=0.0, max_outer=3)
    ops.reset_launch_counts()
    obs.enable(metrics=True, trace_=True)
    try:
        res = pcdn.solve(prob, cfg)
        snap = obs.registry.get_registry().snapshot()
        events = obs.trace.get_tracer().to_dict()["traceEvents"]
    finally:
        obs.disable()
        obs.registry.reset()
    b = -(-prob.n_features // 8)
    assert ops.launch_counts()["pcdn_bundle"] == 3 * b
    assert snap["counters"]["kernels.pcdn_bundle.launches"] == 3 * b
    assert snap["histograms"]["solver.bundle_q"]["count"] == 3 * b
    assert int(np.sum(res.history.bundle_q >= 1)) == 3 * b
    spans = [e for e in events if e["name"] == "kernels.pcdn_bundle"]
    assert len(spans) == 3 * b
    assert {e["args"]["impl"] for e in spans} == {"cuda"}
    obs.validate_trace({"traceEvents": events})


def test_solve_batch_on_cuda_matches_solo_solves(cuda):
    from repro_torch.core import PCDNConfig, pcdn
    from repro_torch.path import problem_grid, solve_batch
    prob = _support_problem(cuda)
    cfg = PCDNConfig(P=8, ls_scope="support", use_kernels=True,
                     tol_kkt=0.0, max_outer=5)
    cs = problem_grid(prob, n_points=3, span=20.0)
    seeds = [0, 1, 2]
    ops.reset_launch_counts()
    res = solve_batch(prob, cfg, cs, seeds=seeds)
    b = -(-prob.n_features // 8)
    assert ops.launch_counts()["pcdn_bundle"] == 3 * 5 * b
    for i, c in enumerate(cs):
        solo = pcdn.solve(prob.with_c(c), PCDNConfig(
            P=8, ls_scope="support", use_kernels=True, tol_kkt=0.0,
            max_outer=5, seed=seeds[i]))
        f = float(res.objective[i])
        assert abs(f - solo.objective) <= 1e-4 * abs(solo.objective), i


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
                                           (256, 20958, 6, 8, 10901),
                                           (256, 20958, 80, 8, 3000),
                                           (60000, 2000, 40, 2, 500)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
def test_serve_margins_csc_kernel(cuda, B, n, k_max, K, A, x_dtype, v_dtype):
    rng = _rng(B, n, k_max)
    rows = rng.integers(0, B + 1, size=(n, k_max)).astype(np.int32)
    vals = rng.standard_normal((n, k_max)).astype(np.float32)
    vals[rows == B] = 5.0                  # the sentinel row drops it
    idx, val = _bank_arrays(cuda, B + n, K, min(A, n), n)
    val = val.to(v_dtype)
    head = (torch.tensor(rows, device=cuda),
            torch.tensor(vals, device=cuda).to(x_dtype))
    want = ref.serve_margins_csc_ref(*head, idx, val, B)
    before = ops.launch_counts()["serve_margins_csc"]
    got = ops.serve_margins_csc(*head, idx, val, B)
    torch.cuda.synchronize()
    assert got.shape == (B, K) and got.is_contiguous()
    _close_to(got, want, RTOL)
    assert ops.launch_counts()["serve_margins_csc"] == before + 1


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


@pytest.mark.parametrize("P,s,Q,ld", [(1, 10, 1, 10), (8, 57848, 40, 57849),
                                      (64, 6000, 40, 6000),
                                      (3, 300000, 7, 300001)])
@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_linesearch_kernel_rows(cuda, P, s, Q, ld, kind):
    """P rows of deltas (mostly zero, as SCDN's are) in one launch, rows
    ld apart (the padded-CSC coordinate deltas are a (P, s + 1) buffer's
    first s columns)."""
    rng = _rng(P, s, Q)
    buf = rng.standard_normal((P, ld)) * 0.1
    buf[rng.random((P, ld)) < 0.99] = 0.0
    delta = torch.tensor(buf, dtype=torch.float32, device=cuda)[:, :s]
    args = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda), delta,
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda),
            torch.tensor(0.5 ** np.arange(Q), dtype=torch.float32,
                         device=cuda)]
    before = ops.launch_counts()["pcdn_linesearch"]
    got = ops.pcdn_linesearch(*args, kind=kind)
    assert ops.launch_counts()["pcdn_linesearch"] == before + 1
    want = ref.pcdn_linesearch_ref(*args, kind=kind)
    again = ops.pcdn_linesearch(*args, kind=kind)
    torch.cuda.synchronize()
    assert got.shape == (P, Q)
    _close_to(got, want, RTOL)
    assert torch.equal(got, again)               # block order: deterministic
    one = ops.pcdn_linesearch(args[0], delta[P - 1].contiguous(), *args[2:],
                              kind=kind)
    _close_to(one, want[P - 1], RTOL)


def _scdn_batch_inputs(cuda, P, s, n, k_max, seed):
    """make_sparse_classification data on the card (columns hold duplicate
    rows), a sparse carry w and its margins, and a batch of P indices with
    a duplicate index and a column holding a duplicate row."""
    from repro_torch.core import make_problem
    from repro_torch.data import make_sparse_classification
    csc, y, _ = make_sparse_classification(s, n, nnz_per_col=k_max,
                                           seed=seed)
    prob = make_problem(csc, y, c=2.0, layout="padded_csc", device=cuda)
    rng = _rng(seed, P)
    w = np.where(rng.random(n) < 0.3, 0.3 * rng.standard_normal(n), 0.0)
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    idx = rng.integers(0, n, P)
    dup = [j for j in range(n) if np.unique(
        csc.col_rows[j][csc.col_rows[j] < s]).size <
        int((csc.col_rows[j] < s).sum())]
    if dup:
        idx[0] = dup[0]
    if P > 2:
        idx[-1] = idx[1]
    return prob, w, prob.margins(w), torch.tensor(idx, dtype=torch.int32,
                                                  device=cuda)


@pytest.mark.parametrize("P,s,n,k_max,kind,l2", [
    (8, 57848, 2000, 278, "logistic", 0.0),     # real-sim's rows, k_max
    (8, 600, 120, 40, "squared_hinge", 0.0),    # rows shared across CTAs
    (3, 500, 50, 30, "squared", 0.2),
    (20, 3000, 400, 60, "logistic", 0.1),       # 3 coordinates a CTA
    (64, 6000, 500, 100, "logistic", 0.0),      # 8 coordinates a CTA
    (1, 10, 4, 5, "logistic", 0.0),
    (8, 100000, 300, 50, "logistic", 0.0),      # rows past the map's 65,536
    (8, 2000, 100, 1500, "logistic", 0.0),      # two load rounds a column
])
def test_scdn_batch_kernel(cuda, P, s, n, k_max, kind, l2):
    """K5's batch entry against `ref.scdn_batch_ref` from one carry, with
    duplicate indices and duplicate rows: the loss deltas rel <= 1e-4,
    alpha equal, w and z rel <= 1e-5; one launch; two calls give the same
    bits; without the loss-delta buffer (the early-exit search) the same
    alpha, w and z."""
    prob, w, z, idx = _scdn_batch_inputs(cuda, P, s, n, k_max, P + s)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    d = prob.design
    launch = ops.ScdnBatchLaunch(d.col_rows, d.col_vals, prob.y, alphas,
                                 prob.c, P, kind=kind, l2=l2)
    runs = []
    for loss_buf in (True, True, False):
        w_k, z_k = w.clone(), z.clone()
        a_k = torch.empty(P, device=cuda)
        lo_k = torch.empty((P, 40), device=cuda) if loss_buf else None
        before = ops.launch_counts()["scdn_batch"]
        ops.scdn_batch(launch, w_k, z_k, idx, a_k, lo_k)
        assert ops.launch_counts()["scdn_batch"] == before + 1
        runs.append((w_k, z_k, a_k, lo_k))
    w_p, z_p = w.clone(), z.clone()
    a_p, lo_p = ref.scdn_batch_ref(d.col_rows, d.col_vals, idx, w_p, z_p,
                                   prob.y, alphas, prob.c, kind=kind, l2=l2)
    torch.cuda.synchronize()
    w_k, z_k, a_k, lo_k = runs[0]
    assert torch.equal(a_k, a_p), (a_k, a_p)
    _close(lo_k, lo_p)
    _close_to(w_k, w_p, 1e-5)
    _close_to(z_k, z_p, 1e-5)
    assert torch.equal(w_k != w, w_p != w)        # the same coordinates moved
    if P > 1:  # the one coordinate of (1, 10, 4, 5) has d = 0 at its carry
        assert torch.count_nonzero(w_p - w) > 0   # the batch moves w
    for w2, z2, a2, lo2 in runs[1:]:              # deterministic
        assert torch.equal(w2, w_k) and torch.equal(z2, z_k)
        assert torch.equal(a2, a_k)
        assert lo2 is None or torch.equal(lo2, lo_k)


def test_scdn_batch_refuses_what_the_kernel_does_not_take(cuda):
    prob, w, z, idx = _scdn_batch_inputs(cuda, 8, 600, 120, 40, 1)
    alphas = torch.ones(40, device=cuda)
    d = prob.design
    with pytest.raises(TypeError, match="float32"):
        ops.ScdnBatchLaunch(d.col_rows, d.col_vals.to(torch.bfloat16),
                            prob.y, alphas, 1.0, 8)
    launch = ops.ScdnBatchLaunch(d.col_rows, d.col_vals, prob.y, alphas,
                                 1.0, 8)
    with pytest.raises(ValueError, match="int32"):
        ops.scdn_batch(launch, w, z, idx.long())
    with pytest.raises(ValueError, match="shape"):
        ops.scdn_batch(launch, w, z[:100], idx)
    with pytest.raises(ValueError, match="alpha"):
        ops.scdn_batch(launch, w, z, idx, torch.empty(7, device=cuda))


def _scdn_dense_inputs(cuda, P, s, n, seed, kind="logistic", l2=0.0):
    """make_classification data (half the values zero) on the card as a
    dense problem, its feature-major copy, a sparse carry w and its
    margins, and a batch of P indices with a duplicate index."""
    from repro_torch.core import make_problem
    from repro_torch.data import make_classification
    X, y, _ = make_classification(s, n, sparsity=0.5, seed=seed)
    prob = make_problem(X, y, c=2.0, loss=kind, elastic_net_l2=l2,
                        layout="dense", device=cuda)
    rng = _rng(seed, P)
    w = np.where(rng.random(n) < 0.3, 0.3 * rng.standard_normal(n), 0.0)
    w = torch.tensor(w, dtype=torch.float32, device=cuda)
    idx = rng.integers(0, n, P)
    if P > 2:
        idx[-1] = idx[1]
    return prob, w, prob.margins(w), torch.tensor(idx, dtype=torch.int32,
                                                  device=cuda)


@pytest.mark.parametrize("P,s,n,kind,l2", [
    (64, 6000, 5000, "logistic", 0.0),      # gisette's batch: 2 CTAs each
    (8, 8192, 123, "squared_hinge", 0.0),   # a9a's: 8 CTAs each
    (3, 501, 50, "squared", 0.2),           # s not a multiple of 4
    (200, 3000, 400, "logistic", 0.1),      # 2 coordinates a cluster
    (1, 10, 4, "logistic", 0.0),
    (64, 57848, 300, "logistic", 0.0),      # streamed tiles
])
def test_scdn_dense_batch_kernel(cuda, P, s, n, kind, l2):
    """K5's dense batch entry against `ref.scdn_dense_batch_ref` from one
    carry, with a duplicate index: the loss deltas rel <= 1e-4, alpha
    equal, w and z rel <= 1e-5; one call counted a batch; two calls give
    the same bits; without the loss-delta buffer (the early-exit search)
    the same alpha, w and z."""
    prob, w, z, idx = _scdn_dense_inputs(cuda, P, s, n, P + s, kind, l2)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    XT = prob.design.feature_major()
    launch = ops.ScdnDenseBatchLaunch(XT, prob.y, alphas, prob.c, P,
                                      kind=kind, l2=l2)
    runs = []
    for loss_buf in (True, True, False):
        w_k, z_k = w.clone(), z.clone()
        a_k = torch.empty(P, device=cuda)
        lo_k = torch.empty((P, 40), device=cuda) if loss_buf else None
        before = ops.launch_counts()["scdn_dense_batch"]
        ops.scdn_dense_batch(launch, w_k, z_k, idx, a_k, lo_k)
        assert ops.launch_counts()["scdn_dense_batch"] == before + 1
        runs.append((w_k, z_k, a_k, lo_k))
    w_p, z_p = w.clone(), z.clone()
    a_p, lo_p = ref.scdn_dense_batch_ref(XT, idx, w_p, z_p, prob.y, alphas,
                                         prob.c, kind=kind, l2=l2)
    torch.cuda.synchronize()
    w_k, z_k, a_k, lo_k = runs[0]
    assert torch.equal(a_k, a_p), (a_k, a_p)
    _close(lo_k, lo_p)
    _close_to(w_k, w_p, 1e-5)
    _close_to(z_k, z_p, 1e-5)
    assert torch.equal(w_k != w, w_p != w)        # the same coordinates moved
    if P > 1:
        assert torch.count_nonzero(w_p - w) > 0   # the batch moves w
    for w2, z2, a2, lo2 in runs[1:]:              # deterministic
        assert torch.equal(w2, w_k) and torch.equal(z2, z_k)
        assert torch.equal(a2, a_k)
        assert lo2 is None or torch.equal(lo2, lo_k)


def test_scdn_dense_batch_refuses_what_the_kernel_does_not_take(cuda):
    prob, w, z, idx = _scdn_dense_inputs(cuda, 8, 600, 120, 1)
    alphas = torch.ones(40, device=cuda)
    XT = prob.design.feature_major()
    with pytest.raises(TypeError, match="float32"):
        ops.ScdnDenseBatchLaunch(XT.to(torch.bfloat16), prob.y, alphas,
                                 1.0, 8)
    with pytest.raises(ValueError, match="Q=41"):
        ops.ScdnDenseBatchLaunch(XT, prob.y, torch.ones(41, device=cuda),
                                 1.0, 8)
    launch = ops.ScdnDenseBatchLaunch(XT, prob.y, alphas, 1.0, 8)
    with pytest.raises(ValueError, match="int32"):
        ops.scdn_dense_batch(launch, w, z, idx.long())
    with pytest.raises(ValueError, match="shape"):
        ops.scdn_dense_batch(launch, w, z[:100], idx)
    with pytest.raises(ValueError, match="alpha"):
        ops.scdn_dense_batch(launch, w, z, idx, torch.empty(7, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        ops.scdn_dense_batch(launch, w, z, idx, None,
                             torch.empty((8, 39), device=cuda))


@pytest.mark.parametrize("layout", ["dense", "padded_csc"])
def test_scdn_round_kernel_matches_plain(cuda, layout):
    """One SCDN round from one carry and one set of indices, through the
    kernels and through their plain versions: one call of K5's batch entry
    a batch on padded-CSC, of its dense batch entry on dense (no other
    kernel); F rel <= 1e-4."""
    from repro_torch.core import make_problem, scdn
    from repro_torch.data import make_classification
    X, y, _ = make_classification(3000, 400, sparsity=0.95, seed=3)
    prob = make_problem(X, y, c=1.0, layout=layout, device=cuda)
    cfg = scdn.SCDNConfig(P_bar=8)
    idxs = _rng(7).integers(0, 400, (50, 8))
    w0 = torch.zeros(400, device=cuda)
    z0 = torch.zeros(3000, device=cuda)
    gen = torch.Generator()
    kernel = "scdn_batch" if layout == "padded_csc" else "scdn_dense_batch"
    ops.reset_launch_counts()
    out_k = scdn.make_round(prob, cfg)(w0, z0, gen, idxs=idxs)
    assert ops.launch_counts()[kernel] == 50
    assert sum(ops.launch_counts().values()) == 50
    plain = (ref.scdn_batch_ref if layout == "padded_csc"
             else ref.scdn_dense_batch_ref)
    out_p = scdn.make_round(prob, cfg, _batch=plain)(w0, z0, gen, idxs=idxs)
    assert sum(ops.launch_counts().values()) == 50
    f_k, f_p = float(out_k[3]), float(out_p[3])
    assert abs(f_k - f_p) <= 1e-4 * abs(f_p)


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


# -- flash attention (K6) and the LM serving path ------------------------------

# per query row, the row's max abs error over its max |plain| (a row's
# size falls with the keys it averages). bf16: inputs and output in bf16,
# K6 casts p to bf16 before p v (as the Pallas kernel does), the plain
# version keeps it in float32; both round the output to bf16
FLASH_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rows_close_to(got, want, rtol):
    err = torch.abs(got.float() - want.float()).amax(dim=-1)
    scale = torch.abs(want.float()).amax(dim=-1).clamp_min(1e-30)
    worst = float((err / scale).max())
    assert worst <= rtol, worst


@pytest.mark.parametrize("q_shape,kv_shape", [
    ((4, 4096, 14, 64), (4, 4096, 2, 64)),      # qwen2-0.5b prefill
    ((1, 2048, 32, 128), (1, 2048, 4, 128)),    # yi-6b heads
    ((1, 2048, 16, 256), (1, 2048, 16, 256)),   # gemma-7b heads
    ((1, 4000, 4, 64), (1, 4000, 2, 64)),       # tail tiles
    ((3, 200, 64), (3, 328, 64)),               # Sq != Skv, (BH, S, D)
    ((8, 100, 128), (2, 100, 128)),             # grouped (BH, S, D)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(cuda, q_shape, kv_shape, dtype, causal):
    g = torch.Generator(device=cuda).manual_seed(sum(q_shape))
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in (q_shape, kv_shape, kv_shape))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype
    _rows_close_to(got, want, FLASH_RTOL[dtype])
    assert ops.launch_counts()["flash_attention"] == before + 1


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((2, 64, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2)[:, :64], q, q)


def test_lm_prefill_agrees_with_plain_route_f32(cuda):
    """Reduced qwen2-0.5b at head_dim 64, float32, a 2100-token prompt:
    the prefill through K6 against the same weights through its plain
    version, then two decode steps from each cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode as dec
    from repro_torch.models.decls import init_params
    from repro_torch.models.transformer import Model
    cfg = get_config("qwen2-0.5b", reduced=True).replace(head_dim=64)
    model = Model(cfg, cuda)
    init_params(model, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 2100), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    out, tok = {}, None
    for use_kernels in (True, False):
        model.use_kernels = use_kernels
        ops.reset_launch_counts()
        logits, cache = dec.prefill(model, toks, 2102)
        assert ops.launch_counts()["flash_attention"] == \
            (cfg.n_layers if use_kernels else 0)
        if tok is None:     # both routes decode the kernel route's token
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        out[use_kernels] = [logits]
        for _ in range(2):
            logits, cache = dec.decode_step(model, cache, tok)
            out[use_kernels].append(logits)
    for got, want in zip(out[True], out[False]):
        _close_to(got, want, 1e-4)


# -- K6's variants: wgmma/TMA (bf16, D 64 and 128), mma.sync (bf16, D 256) --

def _flash_inputs(cuda, seed, q_shape, kv_shape, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(s, generator=g, device=cuda).to(dtype)
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("Sq,Skv", [(4000, 4000), (200, 328), (328, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_variant_by_head_dim(cuda, D, G, Sq, Skv, causal):
    """Grouped heads (G query heads a kv head), tails on both sides: the
    variant the dispatcher's rule picks, held per row to the plain
    version, and counted under its own name."""
    q, k, v = _flash_inputs(cuda, D * G + Sq, (1, Sq, 2 * G, D),
                            (1, Skv, 2, D))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _rows_close_to(got, want, FLASH_RTOL[torch.bfloat16])
    variant = "wgmma" if D < 256 else "mma"
    assert ops.flash_variant(torch.bfloat16, D) == variant
    assert ops.flash_variant_counts()[variant] == 1
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("D", [64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mma_variant_agrees_where_wgmma_runs(cuda, D,
                                                            causal):
    """The mma.sync kernel, named by `variant`, at the LM's head dim,
    where the wgmma kernel is the rule: both held to the plain version
    per row."""
    q, k, v = _flash_inputs(cuda, D, (2, 1000, 14, D), (2, 1000, 2, D))
    want = ref.attention_ref(q, k, v, causal=causal)
    for variant in ("wgmma", "mma"):
        got = ops.flash_attention(q, k, v, causal=causal, variant=variant)
        torch.cuda.synchronize()
        _rows_close_to(got, want, FLASH_RTOL[torch.bfloat16])


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_strided_views_of_a_fused_projection(cuda, D):
    """q, k, v as `Attention.project_qkv` hands them over with a fused
    projection: views of one (B, S, H + 2 Kv, D) tensor, rows strided by
    (H + 2 Kv) D elements, read in place through the tensor maps."""
    B, S, H, Kv = 2, 2100, 8, 2
    g = torch.Generator(device=cuda).manual_seed(D)
    out = torch.randn((B, S, H + 2 * Kv, D), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = out[..., :H, :], out[..., H:H + Kv, :], out[..., H + Kv:, :]
    assert not q.is_contiguous() and not v.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, sm_scale=D ** -0.5)
    want = ref.attention_ref(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True, sm_scale=D ** -0.5)
    torch.cuda.synchronize()
    _rows_close_to(got, want, FLASH_RTOL[torch.bfloat16])


def test_flash_attention_variant_names_are_checked(cuda):
    q, k, v = _flash_inputs(cuda, 0, (1, 256, 4, 256), (1, 256, 4, 256))
    with pytest.raises(ValueError, match="variant"):
        ops.flash_attention(q, k, v, variant="wgmma")   # D 256: no
    with pytest.raises(ValueError, match="variant"):
        ops.flash_attention(q, k, v, variant="f32")     # bf16 inputs
    with pytest.raises(ValueError, match="variant"):
        ops.flash_attention(q.float(), k.float(), v.float(), variant="mma")
    q, k, v = _flash_inputs(cuda, 0, (1, 256, 4, 128), (1, 256, 4, 128))
    with pytest.raises(ValueError, match="variant"):
        ops.flash_attention(q, k, v, variant="mma")     # D 128: no


def test_flash_attention_encodes_tensor_maps_on_the_host(cuda):
    q, k, v = _flash_inputs(cuda, 1, (1, 512, 4, 64), (1, 512, 2, 64))
    ops.flash_attention(q, k, v)
    us = ops.flash_encode_us()
    assert 0.0 < us < 1e4, us


# -- K4a: column tiles of X, staged once for all models ----------------------

@pytest.mark.parametrize("B,n,K,A", [(1, 31, 2, 7), (33, 2000, 3, 900),
                                     (257, 20958, 8, 10901),
                                     (70, 200_000, 4, 30_000)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_dtype", [torch.float32, torch.bfloat16])
def test_serve_margins_dense_column_tiles(cuda, B, n, K, A, x_dtype,
                                          v_dtype):
    """Rows not a multiple of the 32-row tile, n from below one column
    tile to far beyond what shared memory holds as whole rows, sentinel
    padding with nonzero values: 1e-5 against the plain version, and the
    same bits from a second call."""
    rng = _rng(B, n, K, A)
    idx, val = _bank_arrays(cuda, B + n, K, min(A, n), n)
    X = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                     device=cuda).to(x_dtype)
    val = val.to(v_dtype)
    got = ops.serve_margins_dense(X, idx, val)
    again = ops.serve_margins_dense(X, idx, val)
    want = ref.serve_margins_dense_ref(X, idx, val)
    torch.cuda.synchronize()
    _close_to(got, want, 1e-5)
    assert torch.equal(got, again)
    assert not torch.any(got[:, 0])              # the all-padding model


def _warp_lower_bound(ids, target):
    """The kernel's warp-wide search: 32 probes a round, the count of
    probes below the target narrows [lo, hi]. For ascending ids the first
    position whose id is >= target; for any ids a position in [0, A]."""
    lo, hi = 0, len(ids)
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        below = sum(1 for p in range(lo, lo + 32 * step, step)
                    if p < hi and ids[p] < target)
        if below == 0:
            return lo
        lo, hi = lo + (below - 1) * step + 1, min(hi, lo + below * step)
    return lo + sum(1 for p in range(lo, lo + 32) if p < hi and
                    ids[p] < target)


def test_serve_margins_dense_unsorted_ids_drop_terms(cuda):
    """The kernel's contract is ascending ids (the artifact's). With ids
    out of order, each column tile sums only the entries between the
    search's bounds whose id lies in the tile: terms are dropped, none
    counted twice, nothing read out of bounds. A numpy model of that rule
    gives the kernel's margins; the sorted models stay exact."""
    B, n, K, A = 40, 5000, 3, 2000
    rng = _rng(7)
    idx = np.stack([np.sort(rng.choice(n, A, replace=False))
                    for _ in range(K)]).astype(np.int32)
    idx[1] = rng.permutation(idx[1])             # model 1 out of order
    val = rng.standard_normal((K, A)).astype(np.float32)
    X = rng.standard_normal((B, n)).astype(np.float32)
    args = (torch.tensor(X, device=cuda), torch.tensor(idx, device=cuda),
            torch.tensor(val, device=cuda))
    got = ops.serve_margins_dense(*args).cpu().numpy()
    want = ref.serve_margins_dense_ref(*args).cpu().numpy()
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=1e-5,
                               atol=1e-5)
    width = ops.dense_tile_width(B, n, K, ops._sm_count(args[0].device))
    kept = np.zeros(A, bool)
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        e = np.arange(_warp_lower_bound(idx[1], c0),
                      _warp_lower_bound(idx[1], c1))
        assert not np.any(kept[e] & (idx[1][e] >= c0) & (idx[1][e] < c1))
        kept[e] |= (idx[1][e] >= c0) & (idx[1][e] < c1)
    model = X[:, idx[1][kept]] @ val[1][kept]
    assert 0 < kept.sum() < A
    np.testing.assert_allclose(got[:, 1], model, rtol=1e-5, atol=1e-5)
    assert np.max(np.abs(got[:, 1] - want[:, 1])) > 0.1


# -- diagnostics and fault tolerance on the card -----------------------------

def test_certify_on_a_cuda_design_matches_the_cpu_port(cuda):
    """The power iteration's products on the card (index_add_ and
    gathers) give the CPU port's rho to rel 1e-5, and the same omega and
    bounds."""
    from repro_torch.core import make_problem
    from repro_torch.data import make_classification
    from repro_torch.diag import safep
    X, y, _ = make_classification(4000, 512, sparsity=0.97, seed=3)
    for layout in ("padded_csc", "dense"):
        got = safep.certify(make_problem(X, y, c=2.0, layout=layout,
                                         device=cuda).design)
        want = safep.certify(make_problem(X, y, c=2.0, layout=layout,
                                          device="cpu").design)
        assert got["rho_normalized"] == pytest.approx(
            want["rho_normalized"], rel=1e-5)
        for k in ("omega", "P_eso", "P_spectral", "P_cert"):
            assert got[k] == want[k], (layout, k)


def test_checkpoint_image_of_a_cuda_carry(cuda, tmp_path):
    """A carry solved on the card through K1 checkpoints as host arrays
    that restore bit for bit on the CPU and on the card, generator state
    included."""
    from repro_torch.core import PCDNConfig, make_problem
    from repro_torch.data import make_classification
    from repro_torch.engine import LocalBackend
    from repro_torch.engine import loop as engine_loop
    from repro_torch.fault import SolveCheckpointer
    X, y, _ = make_classification(4000, 512, sparsity=0.97, seed=3)
    cfg = PCDNConfig(P=4, use_kernels=True, tol_kkt=0.0)
    gpu = LocalBackend(make_problem(X, y, c=2.0, layout="padded_csc",
                                    device=cuda), cfg)
    cpu = LocalBackend(make_problem(X, y, c=2.0, layout="padded_csc",
                                    device="cpu"), cfg)
    ck = SolveCheckpointer(str(tmp_path / "ck"), every=2)
    ops.reset_launch_counts()
    state, _ = engine_loop.run_outer_loop(
        gpu.outer, gpu.init_state(), 2.0, max_outer=4, tol_kkt=0.0,
        state_callback=ck.solve_callback(gpu))
    assert ops.launch_counts()["pcdn_bundle"] == 4 * 128
    leaves = ck.manager.load_raw(3)
    for k in ("w", "z", "active"):
        np.testing.assert_array_equal(getattr(state, k).cpu().numpy(),
                                      leaves[k])
    for backend in (cpu, gpu):
        st, meta = ck.restore_solve(backend)
        assert meta["outer_iter"] == 3
        assert st.w.device.type == backend.device.type
        for k in ("w", "z", "active"):
            np.testing.assert_array_equal(getattr(st, k).cpu().numpy(),
                                          leaves[k])
        assert torch.equal(st.gen.get_state(), state.gen.get_state())


def test_rollback_through_k2_then_k1(cuda):
    """A NaN at iteration 2 of a P 8 solve (the full scope: K2) rolls back
    and backs off to P 4 (the support scope: K1); the launches are the
    iterations each attempt ran times its bundle count."""
    from repro_torch.core import (PCDNConfig, make_problem,
                                  resolve_ls_scope, with_bundle_size)
    from repro_torch.data import make_classification
    from repro_torch.engine import LocalBackend
    from repro_torch.fault import FaultPlan, resilient_solve
    X, y, _ = make_classification(4000, 512, sparsity=0.97, seed=3)
    prob = make_problem(X, y, c=2.0, layout="padded_csc", device=cuda)
    cfg = PCDNConfig(P=8, use_kernels=True, tol_kkt=1e-3, max_outer=15)
    assert resolve_ls_scope(cfg, prob) == "full"

    def factory(P):
        return LocalBackend(prob, with_bundle_size(cfg, P))

    ops.reset_launch_counts()
    res = resilient_solve(factory, 2.0, P=8, max_outer=15, tol_kkt=1e-3,
                          design=prob.design,
                          plan=FaultPlan(nan_at_iter=2))
    counts = ops.launch_counts()
    p_new = res.faults["p_schedule"][1]
    assert res.faults["p_schedule"] == [8, 4] and res.faults["rollbacks"] == 1
    assert resolve_ls_scope(with_bundle_size(cfg, p_new), prob) == "support"
    n_iter = res.history.outer_iter.shape[0]
    assert counts["pcdn_sparse_direction"] == 3 * 64
    assert counts["pcdn_bundle"] == (n_iter - 2) * 128
    assert np.isfinite(res.objective) and np.all(np.isfinite(res.w))
    assert (np.diff(res.history.outer_iter) == 1).all()


# -- the sharded backend's entries and the fixed-order margin sums ----------

def _sparse_slab(cuda, P, K, s, dtype, seed=0, dup_rows=False):
    rng = _rng(P, K, s, seed)
    if dup_rows:      # each row in many columns: lists past the sort cap
        rows = rng.integers(0, s, size=(P, K)).astype(np.int32)
    else:
        rows = rng.integers(0, s + 1, size=(P, K)).astype(np.int32)
    vals = rng.standard_normal((P, K)).astype(np.float32)
    vals[rows == s] = 0.0
    return (torch.tensor(rows, device=cuda),
            torch.tensor(vals, device=cuda).to(dtype),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda),
            torch.tensor(rng.standard_normal(P), dtype=torch.float32,
                         device=cuda))


@pytest.mark.parametrize("P,K,s", [(1, 1, 10), (37, 9, 300),
                                   (512, 278, 57848)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["logistic", "squared_hinge", "squared"])
def test_sparse_direction_partials_kernel(cuda, P, K, s, dtype, kind):
    rows, vals, z, y, _ = _sparse_slab(cuda, P, K, s, dtype)
    before = ops.launch_counts()["pcdn_sparse_direction_partials"]
    got = ops.pcdn_sparse_direction_partials(rows, vals, z, y, 1.5,
                                             kind=kind)
    again = ops.pcdn_sparse_direction_partials(rows, vals, z, y, 1.5,
                                               kind=kind)
    want = ref.pcdn_sparse_direction_partials_ref(rows, vals, z, y, 1.5,
                                                  kind=kind)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):   # g, h
        _close(a, b)
        assert torch.equal(a, c)
    assert float(torch.min(got[1])) >= 1e-12
    assert ops.launch_counts()["pcdn_sparse_direction_partials"] == \
        before + 2


@pytest.mark.parametrize("s,P,n,n_sentinel", [
    (1, 1, 1, 0), (1000, 37, 100, 5), (6000, 512, 5000, 120),
    (48000, 512, 600, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["logistic", "squared"])
def test_direction_partials_kernel(cuda, s, P, n, n_sentinel, dtype, kind):
    rng = _rng(s, P, 7)
    XT = torch.tensor(rng.standard_normal((n, s)), dtype=torch.float32,
                      device=cuda).to(dtype)
    idx = rng.choice(n, P, replace=False).astype(np.int32)
    if n_sentinel:
        idx[-n_sentinel:] = n
    args = [XT, torch.tensor(idx, device=cuda),
            torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                         device=cuda),
            torch.tensor(np.where(rng.random(s) < 0.5, -1.0, 1.0),
                         dtype=torch.float32, device=cuda), 1.5]
    before = ops.launch_counts()["pcdn_direction_partials"]
    got = ops.pcdn_direction_partials(*args, kind=kind)
    again = ops.pcdn_direction_partials(*args, kind=kind)
    want = ref.pcdn_direction_partials_ref(*args, kind=kind)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        _close(a, b)
        assert torch.equal(a, c)
    assert not torch.any(ops._direction_counter(XT.device))
    assert ops.launch_counts()["pcdn_direction_partials"] == before + 2


@pytest.mark.parametrize("P,K,s,dup", [(1, 1, 10, False),
                                       (37, 9, 300, False),
                                       (512, 278, 57848, False),
                                       (100, 10, 10, True),    # lists > 64
                                       (64, 40, 50, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_scatter_kernel_sums_in_entry_order(cuda, P, K, s, dup,
                                                   dtype):
    """delta = X_B d in ascending entry id: bit-equal from call to call and
    to the plain version's index_add_ on the CPU (the same products, added
    from 0 in the same order)."""
    rows, vals, _, _, d = _sparse_slab(cuda, P, K, s, dtype, dup_rows=dup)
    before = ops.launch_counts()["pcdn_sparse_scatter"]
    got = ops.pcdn_sparse_scatter(rows, vals, d, s)
    again = ops.pcdn_sparse_scatter(rows, vals, d, s)
    cpu = ref.pcdn_sparse_scatter_ref(rows.cpu(), vals.cpu(), d.cpu(), s)
    torch.cuda.synchronize()
    assert got.shape == (s,)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), cpu)
    assert ops.launch_counts()["pcdn_sparse_scatter"] == before + 2


@pytest.mark.parametrize("P,K,s,dup", [(37, 9, 300, False),
                                       (512, 278, 57848, False),
                                       (100, 10, 10, True)])
def test_sparse_direction_delta_is_bit_equal_across_calls(cuda, P, K, s,
                                                          dup):
    args = _sparse_slab(cuda, P, K, s, torch.float32, dup_rows=dup)
    got = ops.pcdn_sparse_direction(*args, 1.5)
    again = ops.pcdn_sparse_direction(*args, 1.5)
    want = ref.pcdn_sparse_direction_ref(*args, 1.5)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):    # d, g, h, delta
        assert torch.equal(a, b)
        _close(a, c)
    # delta from the kernel's own d, in the plain version's order
    delta = ref.pcdn_sparse_scatter_ref(args[0].cpu(), args[1].cpu(),
                                        got[0].cpu(), s)
    assert torch.equal(got[3].cpu(), delta)


@pytest.mark.parametrize("P,K,s,n", [(32, 278, 57848, 300),
                                     (100, 10, 10, 100),   # lists > 64
                                     (300, 40, 60000, 600)])
def test_bundle_kernel_is_bit_equal_across_calls(cuda, P, K, s, n):
    d = _bundle_design(cuda, P, s, n, K)
    idx = torch.tensor(_rng(P, 2).permutation(n)[:P], dtype=torch.int32,
                       device=cuda)
    alphas = torch.tensor(0.5 ** np.arange(40), dtype=torch.float32,
                          device=cuda)
    outs = []
    for _ in range(2):
        launch = ops.BundleLaunch(d["col_rows"], d["col_vals"], d["y"],
                                  alphas, 4.0, P, 1)
        w, z = d["w"].clone(), d["z"].clone()
        ops.pcdn_bundle(launch, w, z, idx, 0)
        outs.append((w, z, launch.n_steps.clone(), launch.alpha.clone()))
        _workspace_reset(launch, s, P * K)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- tuned launch plans (kernels.autotune) ------------------------------------
# non-default configs within each kernel's limits at bench_kernels' smoke
# cells, each against the plain version at the kernels phase's limits

TUNED_CONFIGS = [
    ("pcdn_bundle", {"cluster": 1, "nseg": 1}),
    ("pcdn_bundle", {"cluster": 3, "nseg": 16}),
    ("pcdn_bundle", {"cluster": 8, "nseg": 2}),
    ("pcdn_sparse_direction", {"warps": 1}),
    ("pcdn_sparse_direction", {"warps": 2}),
    ("pcdn_direction", {"cc": 8}),
    ("pcdn_direction", {"cc": 64, "resident": False, "tile": 512}),
    ("pcdn_direction", {"resident": False}),
    ("serve_margins_dense", {"width": 64}),
    ("serve_margins_dense", {"width": 1536}),
    ("serve_margins_csc", {"cluster": 1}),
    ("serve_margins_csc", {"cluster": 5}),
    ("pcdn_linesearch", {"blocks": 1}),
    ("pcdn_linesearch", {"blocks": 4}),
    ("scdn_batch", {"cluster": 1}),
    ("scdn_batch", {"cluster": 3}),
    ("scdn_dense_batch", {"cluster": 1, "clusters": 8}),
    ("scdn_dense_batch", {"cluster": 8, "clusters": 16}),
]


@pytest.fixture(scope="module")
def tuned_cells():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card)")
    import sys
    from pathlib import Path
    bench = str(Path(__file__).resolve().parents[1] / "benchmarks" / "port")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import bench_kernels as bk
    cells = bk.make_cells(torch, bk.build_data(smoke=True), smoke=True,
                          dtypes=("float32",))
    return {c.kernel: c for c in cells}


@pytest.mark.parametrize("kernel,config", TUNED_CONFIGS,
                         ids=[f"{k}-{c}" for k, c in TUNED_CONFIGS])
def test_tuned_plan_agrees_with_plain_version(tuned_cells, kernel, config):
    cell = tuned_cells[kernel]
    cell.runner(config)()            # the plan is legal at this shape
    torch.cuda.synchronize()
    res = cell.agree(config)
    assert res["ok"], res
