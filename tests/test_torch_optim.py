"""The port's optimizer substrate and token pipeline against the JAX
package's, on the CPU: AdamW (`repro_torch.optim.adamw`), the schedules,
top-k compression and `data.tokens.TokenPipeline`, fed the same numpy
inputs.

Tolerances: AdamW's parameters, moments and master copy rtol 1e-6 (atol
1e-7) after several steps: both evaluate the same float32 expressions in
the same order; the global norm sums its leaves in another order (rtol
1e-6). bf16 parameters: equal to within one bf16 ulp (the float32 value
they round from agrees to 1e-6, so the two roundings can part only at a
tie). The schedules rtol 1e-6 (XLA's and PyTorch's float32 cos may
differ by an ulp), the warmup's step-0 rate exactly 0. Compression masks
and TokenPipeline batches are equal bit for bit; the residuals equal
exactly (where, subtraction).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.tokens import TokenPipeline as JaxPipeline
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.optim import adamw, compression, schedules

RTOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (7, 5), "b.w": (33,), "c": (4, 3, 2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("keep_master", [False, True])
@pytest.mark.parametrize("clip", [0.0, 1.0, 100.0])
def test_adamw_matches_reference_over_steps(dtype, keep_master, clip):
    """Five updates from the same params and grads: clip 1.0 is active
    (grad norms ~ 20), 100 is not, 0 is off; a schedule's tensor lr on
    odd steps, the config's float lr on even ones."""
    cfg_kw = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                  grad_clip=clip, keep_master=keep_master)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    js, ts = jadamw.adamw_init(jp, jcfg), adamw.adamw_init(tp, tcfg)
    jlr = jsched.linear_warmup_cosine(1e-2, 2, 5)
    tlr = schedules.linear_warmup_cosine(1e-2, 2, 5)
    for step in range(5):
        g = _tree(rng, scale=4.0)
        lr_j = jlr(js.step) if step % 2 else None
        lr_t = tlr(ts.step) if step % 2 else None
        jp, js, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jcfg,
            lr_j)
        tp, ts, tm = adamw.adamw_update(
            tp, {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, ts,
            tcfg, lr_t)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        np.testing.assert_allclose(_np(tm["grad_norm"]),
                                   _np(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tm["lr"]), _np(jm["lr"]), rtol=1e-6)
        assert tm["grad_norm"].dtype == tm["lr"].dtype == torch.float32
        for k in SHAPES:
            assert tp[k].dtype == tdt and ts.mu[k].dtype == torch.float32
            np.testing.assert_allclose(_np(ts.mu[k]), _np(js.mu[k]), **RTOL)
            np.testing.assert_allclose(_np(ts.nu[k]), _np(js.nu[k]),
                                       rtol=1e-6, atol=1e-9)
            if keep_master:
                np.testing.assert_allclose(_np(ts.master[k]),
                                           _np(js.master[k]), **RTOL)
            if dtype == "float32":
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **RTOL)
            else:   # one bf16 ulp (2^-8 of the value) where roundings part
                np.testing.assert_allclose(_np(tp[k]), _np(jp[k]),
                                           rtol=2 ** -8, atol=1e-7)
        assert (ts.master is None) == (not keep_master)


def test_adamw_changes_none_of_its_inputs():
    cfg = adamw.AdamWConfig(keep_master=True)
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    grads = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    state = adamw.adamw_init(params, cfg)
    state, _ = adamw.adamw_update(params, grads, state, cfg)[1:]
    before = [t.clone() for t in (*params.values(), *grads.values(),
                                  *state.mu.values(), *state.nu.values(),
                                  *state.master.values(), state.step)]
    adamw.adamw_update(params, grads, state, cfg)
    after = [*params.values(), *grads.values(), *state.mu.values(),
             *state.nu.values(), *state.master.values(), state.step]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("fn,args", [
    ("cosine_schedule", (3e-3, 50)),
    ("cosine_schedule", (1e-2, 7, 0.0)),
    ("linear_warmup_cosine", (3e-3, 2, 50)),
    ("linear_warmup_cosine", (1e-3, 5, 20, 0.2)),
])
def test_schedules_match_reference(fn, args):
    jf, tf = getattr(jsched, fn)(*args), getattr(schedules, fn)(*args)
    for step in range(0, 60):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tf(step).numpy(), want, rtol=1e-6,
                                   atol=0)
    if fn == "linear_warmup_cosine":
        assert float(tf(0)) == 0.0     # the first step's rate under warmup


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_mask_equals_reference(frac):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((37, 11)).astype(np.float32)
    x[3, :4] = x[0, 0]             # ties at whatever the threshold is
    x[5, 5] = -x[0, 0]
    got = compression.topk_mask(torch.from_numpy(x), frac).numpy()
    want = np.asarray(jcomp.topk_mask(jnp.asarray(x), frac))
    np.testing.assert_array_equal(got, want)
    k = max(1, int(frac * x.size))
    assert got.sum() >= k


def test_topk_mask_keeps_ties_with_the_threshold():
    x = torch.tensor([3.0, -3.0, 3.0, 1.0, 0.5])
    assert compression.topk_mask(x, 0.2).tolist() == [True, True, True,
                                                      False, False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_compress_update_matches_reference(dtype):
    """Three steps of error feedback: the sent grads and the residuals
    equal the reference's, and sent + residual == grads + old residual
    (mass conservation) exactly in float32."""
    rng = np.random.default_rng(3)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    p = _tree(rng)
    jr = jcomp.init_residual({k: jnp.asarray(v) for k, v in p.items()})
    tr = compression.init_residual({k: torch.from_numpy(v)
                                    for k, v in p.items()})
    for _ in range(3):
        g = _tree(rng)
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tdt) for k, v in g.items()}
        jc, jr_new = jcomp.topk_compress_update(jg, jr, frac=0.1)
        tc, tr_new = compression.topk_compress_update(tg, tr, frac=0.1)
        for k in SHAPES:
            assert tc[k].dtype == tdt and tr_new[k].dtype == torch.float32
            np.testing.assert_array_equal(_np(tc[k]), _np(jc[k]))
            np.testing.assert_array_equal(_np(tr_new[k]), _np(jr_new[k]))
            total = tg[k].float() + tr[k]
            sent = torch.where(tc[k] != 0, total, 0.0)
            assert torch.equal(sent + tr_new[k], total)
        jr, tr = jr_new, tr_new


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "pixtral-12b",
                                  "whisper-small"])
def test_token_pipeline_batches_bit_equal(arch):
    """dense, vlm (patches, labels and loss mask over them) and encdec
    (frames): batch_at(i) equals the reference's bit for bit, and
    `iterate` yields the same batches in order."""
    jp = JaxPipeline(jax_config(arch, reduced=True), 3, 17, seed=5)
    tp = TokenPipeline(get_config(arch, reduced=True), 3, 17, seed=5)
    for i in (0, 1, 9):
        want, got = jp.batch_at(i), tp.batch_at(i)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for i, (a, b) in enumerate(zip(tp.iterate(start=2, stop=5),
                                   jp.iterate(start=2, stop=5))):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert i == 2
