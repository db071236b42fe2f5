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
