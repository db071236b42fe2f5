"""The port's serving engine against the JAX package's: artifacts written
by either package load in the other, `ModelBank.from_family` builds the
same layouts, the four scorer routes give the JAX scorers' margins and
the dense matmul ground truth, `pick_route` agrees once both crossover
tables are pinned, and `MicroBatcher` returns the same margins and row /
padding accounting in both request layouts. All on the CPU (the kernel
routes take their plain versions). Margins: rtol 1e-5, atol 1e-5
(float32 sums in another order); layouts and accounting: equal.
"""
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.design_matrix import PaddedCSCDesign as JPaddedCSCDesign
from repro.data.libsvm import CSRMatrix as JCSRMatrix
from repro.serve import artifact as jart
from repro.serve import batcher as jbatcher
from repro_torch.core.design_matrix import PaddedCSCDesign
from repro_torch.data.libsvm import CSRMatrix
from repro_torch.serve import artifact as tart
from repro_torch.serve import batcher as tbatcher
from repro_torch.serve import policy as tpolicy

# the packages export a function `predict` that hides the module of the
# same name from `from ... import predict`
jpredict = importlib.import_module("repro.serve.predict")
tpredict = importlib.import_module("repro_torch.serve.predict")

MTOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _weights(K, n, nnz, seed, with_empty=False):
    rng = np.random.default_rng(seed)
    W = np.zeros((K, n))
    for k in range(int(with_empty), K):
        W[k, rng.choice(n, nnz + k, replace=False)] = rng.standard_normal(
            nnz + k)
    return W


def _families(n=48, seed=0):
    """The same binary, path and ovr families in both packages."""
    W = _weights(3, n, 5, seed, with_empty=True)
    out = {}
    for mod, key in ((jart, "jax"), (tart, "torch")):
        models = [mod.artifact_from_solution(W[k], "logistic", 2.0 ** k,
                                             bias=0.25 * k,
                                             meta={"val_accuracy": 0.5 + k})
                  for k in range(3)]
        ovr = [mod.artifact_from_solution(W[k], "logistic", 1.0,
                                          bias=-0.5 * k,
                                          label=float(3 + 2 * k))
               for k in range(3)]
        out[key] = {
            "binary": mod.ModelFamily("binary", (models[1],)),
            "path": mod.ModelFamily("path", tuple(models)),
            "ovr": mod.ModelFamily("ovr", tuple(ovr)),
        }
    return out


# -- artifacts, both ways -----------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "path", "ovr"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_artifact_written_by_either_package_loads_in_the_other(
        tmp_path, kind, writer):
    fams = _families()
    save = {"jax": jart.save_model, "torch": tart.save_model}[writer]
    load_other = {"jax": tart.load_model, "torch": jart.load_model}[writer]
    p = str(tmp_path / f"{kind}.json")
    save(p, fams[writer][kind])
    assert json.load(open(p))["schema"] == jart.SCHEMA == tart.SCHEMA
    got = load_other(p)
    want = fams[writer][kind]
    assert got.kind == want.kind and len(got) == len(want)
    assert got.n_features == want.n_features
    assert got.loss_name == want.loss_name
    for a, b in zip(got.models, want.models):
        np.testing.assert_array_equal(a.w_indices, b.w_indices)
        np.testing.assert_array_equal(a.w_values, b.w_values)
        assert (a.c, a.bias, a.label, a.meta) == (b.c, b.bias, b.label,
                                                  b.meta)
    if kind == "ovr":
        np.testing.assert_array_equal(got.classes, want.classes)
    if kind == "path":
        for metric in ("val_accuracy", "nnz"):
            assert jart.pick_best_c(got if writer == "torch" else want,
                                    metric)[0] == \
                tart.pick_best_c(got if writer == "jax" else want,
                                 metric)[0]


def test_artifact_validation_matches_reference():
    for mod in (jart, tart):
        with pytest.raises(ValueError, match="sorted"):
            mod.ModelArtifact(10, np.asarray([4, 2]), np.asarray([1.0, 2.0]),
                              "logistic", 1.0)
        with pytest.raises(ValueError, match="ascending label order"):
            mod.ModelFamily("ovr", tuple(
                mod.artifact_from_solution(np.ones(4), "logistic", 1.0,
                                           label=lb) for lb in (7.0, 3.0)))
        with pytest.raises(ValueError, match="path"):
            mod.pick_best_c(mod.ModelFamily("binary", (
                mod.artifact_from_solution(np.ones(4), "logistic", 1.0),)))


def test_artifact_from_a_device_tensor():
    w = torch.tensor([0.0, 1.5, 0.0, -2.0])
    m = tart.artifact_from_solution(w, "logistic", 1.0)
    np.testing.assert_array_equal(m.w_indices, [1, 3])
    np.testing.assert_array_equal(m.w_values, [1.5, -2.0])


# -- ModelBank layouts ------------------------------------------------------

BANK_CASES = [("binary", None, None), ("path", None, None),
              ("ovr", None, None), ("path", 16, 40), ("binary", 11, 12),
              ("ovr", 9, 30)]


@pytest.mark.parametrize("kind,a_cap,u_cap", BANK_CASES)
def test_model_bank_layouts_identical(kind, a_cap, u_cap):
    fams = _families()
    jb = jpredict.ModelBank.from_family(fams["jax"][kind], a_cap=a_cap,
                                        u_cap=u_cap)
    tb = tpredict.ModelBank.from_family(fams["torch"][kind], a_cap=a_cap,
                                        u_cap=u_cap, device="cpu")
    for name in ("idx", "val", "union_idx", "union_val", "bias"):
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tb.idx.dtype == tb.union_idx.dtype == torch.int32
    assert (tb.n_features, tb.kind, tb.n_models, tb.a_max) == \
        (jb.n_features, jb.kind, jb.n_models, jb.a_max)
    np.testing.assert_array_equal(tb.nnz, jb.nnz)
    assert tb.sparsity() == pytest.approx(jb.sparsity(), abs=1e-12)
    np.testing.assert_array_equal(_np(tb.dense_matrix()),
                                  np.asarray(jb.dense_matrix()))
    if kind == "ovr":
        np.testing.assert_array_equal(tb.classes, jb.classes)


def test_model_bank_bf16_storage_and_capacity_errors():
    W = _weights(2, 32, 4, 3).astype(np.float32)
    jb = jpredict.ModelBank.from_dense(W, dtype=jnp.bfloat16)
    tb = tpredict.ModelBank.from_dense(W, dtype=torch.bfloat16, device="cpu")
    assert tb.val.dtype == tb.union_val.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jb.val, np.float32),
                                  _np(tb.val))
    dense = np.ones((2, 32), np.float32)
    for mod, kw in ((jpredict, {}), (tpredict, {"device": "cpu"})):
        with pytest.raises(ValueError, match="capacity"):
            mod.ModelBank.from_dense(dense, a_cap=4, **kw)
        with pytest.raises(ValueError, match="capacity"):
            mod.ModelBank.from_dense(dense, u_cap=8, **kw)


# -- scorer routes ------------------------------------------------------------

@pytest.mark.parametrize("B,n,K", [(17, 40, 1), (64, 96, 5), (130, 33, 4)])
@pytest.mark.parametrize("caps", [False, True])
def test_margins_all_four_routes_match_reference_and_matmul(B, n, K, caps):
    rng = np.random.default_rng(B + n)
    W = _weights(K, n, max(1, n // 8), n, with_empty=K > 1).astype(
        np.float32)
    kw = dict(a_cap=2 * n // 3, u_cap=n) if caps else {}
    jb = jpredict.ModelBank.from_dense(W, kind="path", **kw)
    tb = tpredict.ModelBank.from_dense(W, kind="path", device="cpu", **kw)
    X = ((rng.random((B, n)) < 0.3) *
         rng.standard_normal((B, n))).astype(np.float32)
    want = X @ W.T
    jcsc = JPaddedCSCDesign.from_dense(X)
    tcsc = PaddedCSCDesign.from_dense(X)
    got = {
        "sparse": tpredict.margins_dense(tb, X),
        "dense": tpredict.margins_dense(tb, X, route="dense"),
        "kernel_dense": tpredict.margins_dense(tb, X, use_kernels=True),
        "csc": tpredict.margins_padded_csc(tb, tcsc),
        "kernel_csc": tpredict.margins_padded_csc(tb, tcsc,
                                                  use_kernels=True),
    }
    ref = {
        "sparse": jpredict.margins_dense(jb, X),
        "dense": jpredict.margins_dense(jb, X, route="dense"),
        "kernel_dense": jpredict.margins_dense(jb, X, use_kernels=True),
        "csc": jpredict.margins_padded_csc(jb, jcsc),
        "kernel_csc": jpredict.margins_padded_csc(jb, jcsc,
                                                  use_kernels=True),
    }
    for name, z in got.items():
        assert z.dtype == torch.float32 and tuple(z.shape) == (B, K)
        np.testing.assert_allclose(_np(z), np.asarray(ref[name]),
                                   err_msg=name, **MTOL)
        np.testing.assert_allclose(_np(z), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_margins_accept_numpy_padded_csc_and_bias_and_decide():
    from repro_torch.data.libsvm import csr_to_padded_csc
    W = np.zeros((2, 8), np.float32)
    W[0, 1] = 1.0
    W[1, 2] = 1.0
    tb = tpredict.ModelBank.from_dense(W, bias=[0.0, 10.0], kind="ovr",
                                       classes=np.asarray([5.0, 6.0]),
                                       device="cpu")
    jb = jpredict.ModelBank.from_dense(W, bias=[0.0, 10.0], kind="ovr",
                                       classes=np.asarray([5.0, 6.0]))
    X = np.zeros((3, 8), np.float32)
    X[0, 1] = 20.0
    pc = csr_to_padded_csc(CSRMatrix.from_dense(X))
    for requests in (X, pc):
        z = tpredict.predict(tb, requests)
        np.testing.assert_allclose(_np(z), np.asarray(jpredict.predict(
            jb, X)), **MTOL)
        np.testing.assert_array_equal(tpredict.decide(tb, z),
                                      jpredict.decide(jb, np.asarray(z)))
    wb = tpredict.ModelBank.from_dense(W[0], kind="binary", device="cpu")
    assert tpredict.decide(wb, np.asarray([[0.5], [-0.5], [0.0]])).tolist() \
        == [1.0, -1.0, 1.0]
    with pytest.raises(ValueError, match="route"):
        tpredict.margins_dense(tb, X, route="csc")
    with pytest.raises(ValueError, match="requests"):
        tpredict.margins_dense(tb, np.zeros((2, 9), np.float32))


TABLES = [
    [{"sparsity": 0.9, "min_batch_sparse": None},
     {"sparsity": 0.99, "min_batch_sparse": 256},
     {"sparsity": 0.999, "min_batch_sparse": 64}],
    [{"sparsity": 0.5, "min_batch_sparse": 8},
     {"sparsity": 0.95, "min_batch_sparse": 1}],
]


@pytest.mark.parametrize("table", TABLES)
def test_pick_route_agrees_with_reference_when_pinned(table):
    try:
        jpredict.set_route_crossover(table)
        tpredict.set_route_crossover(table)
        for sp in (0.0, 0.5, 0.9, 0.95, 0.99, 0.995, 0.999, 0.9999):
            for b in (1, 7, 8, 63, 64, 255, 256, 4096):
                assert tpredict.pick_route(sp, b) == \
                    jpredict.pick_route(sp, b), (sp, b)
    finally:
        jpredict.set_route_crossover(None)
        tpredict.set_route_crossover(None)
    # unpinned: the committed H100 run's table
    committed = json.loads(tpredict.bench_serve_path().read_text())
    assert committed["smoke"] is False
    assert list(tpredict.route_crossover()) == committed["route_crossover"]


def test_route_auto_matches_a_fixed_route():
    rng = np.random.default_rng(5)
    W = (rng.standard_normal((4, 40)) * (rng.random((4, 40)) < 0.15)) \
        .astype(np.float32)
    tb = tpredict.ModelBank.from_dense(W, kind="path", device="cpu")
    X = rng.standard_normal((13, 40)).astype(np.float32)
    want = _np(tpredict.margins_dense(tb, X))
    np.testing.assert_allclose(_np(tpredict.margins_dense(tb, X,
                                                          route="auto")),
                               want, rtol=1e-4, atol=1e-4)


# -- batcher ------------------------------------------------------------------

def test_default_buckets_match_reference():
    for m in (1, 48, 64, 100):
        assert tpolicy.default_buckets(m) == jbatcher.default_buckets(m)


BATCH_CASES = [("dense", (4, 16), 41), ("dense", (1, 8, 32), 70),
               ("padded_csc", (8, 16), 23), ("padded_csc", (4, 64), 130)]


@pytest.mark.parametrize("layout,buckets,B", BATCH_CASES)
def test_batcher_margins_and_accounting_match_reference(layout, buckets, B):
    rng = np.random.default_rng(B)
    n = 32
    W = _weights(3, n, 4, B).astype(np.float32)
    X = ((rng.random((B, n)) < 0.3) *
         rng.standard_normal((B, n))).astype(np.float32)
    jb = jpredict.ModelBank.from_dense(W, kind="path")
    tb = tpredict.ModelBank.from_dense(W, kind="path", device="cpu")
    if layout == "dense":
        jreq, treq, k_max = X, X, None
    else:
        jreq, treq = JCSRMatrix.from_dense(X), CSRMatrix.from_dense(X)
        k_max = treq.max_col_nnz()
        assert k_max == jreq.max_col_nnz()
    jm = jbatcher.MicroBatcher(jb, buckets=buckets, layout=layout,
                               k_max=k_max)
    tm = tbatcher.MicroBatcher(tb, buckets=buckets, layout=layout,
                               k_max=k_max)
    for use_kernels in (False, True):
        jm.use_kernels = tm.use_kernels = use_kernels
        z = tm.predict(treq)
        assert isinstance(z, np.ndarray) and z.shape == (B, 3)
        np.testing.assert_allclose(z, jm.predict(jreq), **MTOL)
        np.testing.assert_allclose(z, X @ W.T, rtol=1e-4, atol=1e-4)
    js, ts = jm.stats(), tm.stats()
    keys = ("bucket", "calls", "rows", "pad_rows", "warmup_rows")
    assert [{k: b[k] for k in keys} for b in ts["buckets"]] == \
        [{k: b[k] for k in keys} for b in js["buckets"]]
    assert ts["total_rows"] == js["total_rows"] == 2 * B
    assert ts["warmup_calls"] == js["compiles"]


def test_batcher_guards():
    tb = tpredict.ModelBank.from_dense(_weights(2, 16, 2, 0), device="cpu")
    # with no fixed k_max a padded-CSC batcher packs each chunk at its own
    # width (the JAX policy requires one)
    assert tbatcher.MicroBatcher(tb, layout="padded_csc").k_max is None
    b = tbatcher.MicroBatcher(tb, buckets=(4,), layout="dense")
    with pytest.raises(ValueError, match="features"):
        b.predict(np.zeros((2, 9), np.float32))
    # a chunk whose column nnz overflows the fixed k_max raises
    X = np.zeros((4, 16), np.float32)
    X[:, 3] = 1.0                              # column 3 has nnz 4
    csr = CSRMatrix.from_dense(X)
    b = tbatcher.MicroBatcher(tb, buckets=(4,), layout="padded_csc",
                              k_max=2)
    with pytest.raises(ValueError, match="k_max"):
        b.predict(csr)


@pytest.mark.parametrize("buckets,B", [((8, 16), 23), ((4, 64), 130)])
def test_batcher_packs_each_chunk_at_its_own_width(buckets, B):
    """No fixed k_max: each chunk's padded-CSC width is its own largest
    column nnz, and the margins equal the JAX batcher's at the stream's
    fixed width."""
    rng = np.random.default_rng(B)
    n = 32
    W = _weights(3, n, 4, B).astype(np.float32)
    X = ((rng.random((B, n)) < 0.3) *
         rng.standard_normal((B, n))).astype(np.float32)
    X[:5, 7] = 1.0                  # one dense column in the first chunk
    treq, jreq = CSRMatrix.from_dense(X), JCSRMatrix.from_dense(X)
    pol = tpolicy.BucketPolicy(buckets=buckets, layout="padded_csc")
    start = 0
    while start < B:
        stop = min(start + pol.max_bucket, B)
        packed = pol.pack_csc(treq, start, stop, pol.bucket_for(stop - start),
                              n)
        assert packed.k_max == treq.rows(start, stop).max_col_nnz()
        start = stop
    assert pol.pack_csc(treq, 0, 4, 4, n).k_max == 4
    jm = jbatcher.MicroBatcher(
        jpredict.ModelBank.from_dense(W, kind="path"), buckets=buckets,
        layout="padded_csc", k_max=jreq.max_col_nnz())
    tm = tbatcher.MicroBatcher(
        tpredict.ModelBank.from_dense(W, kind="path", device="cpu"),
        buckets=buckets, layout="padded_csc")
    for use_kernels in (False, True):
        jm.use_kernels = tm.use_kernels = use_kernels
        np.testing.assert_allclose(tm.predict(treq), jm.predict(jreq),
                                   **MTOL)


def test_latency_model_and_histogram():
    lm = tpolicy.LatencyModel(default_s=0.01, alpha=0.5)
    assert lm.estimate(8) == 0.01 and not lm.seeded(8)
    lm.observe(8, 0.002)
    lm.observe(8, 0.004)
    assert lm.estimate(8) == pytest.approx(0.003)
    assert lm.as_dict() == {"8": pytest.approx(0.003)}
    from repro.obs import Histogram as JHistogram
    from repro.obs import LATENCY_BOUNDS_S as JBOUNDS
    from repro_torch.obs import LATENCY_BOUNDS_S, Histogram
    assert LATENCY_BOUNDS_S == JBOUNDS
    vals = np.random.default_rng(0).exponential(1e-3, 500)
    h, jh = Histogram(), JHistogram(JBOUNDS)
    for v in vals:
        h.observe(v)
        jh.observe(v)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
