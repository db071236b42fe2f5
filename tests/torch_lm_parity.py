"""Shared set-up of the LM family parity tests (tests/test_torch_moe.py,
tests/test_torch_ssm.py, tests/test_torch_hybrid.py,
tests/test_torch_vlm.py, tests/test_torch_encdec.py): one reduced config
in both packages, the reference's weights carried into the port, and a
prefill plus greedy decode through both.

The reference model is built on a (1, 1) mesh with Auto axes: jax 0.9's
`make_mesh` default (Explicit axes) makes `Model._constrain` raise.
Tolerances: 2e-4 (rtol and atol) per module and for prefill logits, atol
5e-4 for decode logits, as `tests/test_torch_lm_model.py` states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import decode as jdec
from repro.models import sharding as jsh
from repro.models.transformer import Model as JaxModel
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.models import decode as tdec
from repro_torch.models.convert import load_jax_params
from repro_torch.models.transformer import Model
from repro_torch.train.steps import make_serve_step

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-4, atol=5e-4)
RULES = jsh.default_rules()


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def setup(jcfg, tcfg, perturbed=(), seed=0):
    """(reference model, its params as numpy, the port's model on the
    CPU with those params). Leaves named in `perturbed` (norm scales,
    biases, constants) get noise, so that they matter."""
    jm = JaxModel(jcfg, mesh())
    # jitted: one compile instead of one a leaf
    tree = jax.tree.map(np.asarray,
                        jax.jit(jm.init_params)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        if str(path[-1].key) in perturbed:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    tm = Model(tcfg, "cpu")
    load_jax_params(tm, tree)
    return jm, tree, tm


def layer(tree, i=0):
    """Layer i of the reference's stacked `layers`."""
    return jax.tree.map(lambda a: a[i], tree["layers"])


def x(shape, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def prefix_inputs(cfg, B, seed):
    """vlm's patch embeddings or encdec's frame embeddings (numpy, normal
    * 0.02, float32) for a batch of B, or {}."""
    if cfg.family == "vlm":
        return {"patches": x((B, cfg.vlm.n_patches, cfg.d_model), seed + 100,
                             0.02)}
    if cfg.family == "encdec":
        return {"frames": x((B, cfg.encdec.encoder_frames, cfg.d_model),
                            seed + 100, 0.02)}
    return {}


def prefix_len(cfg):
    """Positions ahead of the text: vlm's patches."""
    return cfg.vlm.n_patches if cfg.family == "vlm" else 0


def serve_both(jm, tree, tm, S, cache_keys, n_new=3, B=2, seed=3):
    """Prefill S prompt tokens (after vlm's patches, beside encdec's
    frames), then n_new greedy decode steps, in both packages: the
    logits, the greedy tokens and the caches' leaves at `cache_keys`
    (paths into the cache dict) agree."""
    cfg = jm.cfg
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    pre = prefix_inputs(cfg, B, seed)
    S += prefix_len(cfg)
    max_len = S + n_new
    jl, jc = jdec.prefill(jm, tree, {"tokens": jnp.asarray(toks),
                                     **{k: jnp.asarray(a)
                                        for k, a in pre.items()}}, max_len)
    tl, tc = tdec.prefill(tm, t(toks), max_len,
                          **{k: t(a) for k, a in pre.items()})
    close(tl, jl)

    def leaves(cache_t, cache_j, tol):
        for path in cache_keys:
            a, b = cache_t, cache_j
            for k in path:
                a, b = a[k], b[k]
            close(a, b, tol)

    assert tc["length"] == int(jc["length"]) == S
    leaves(tc, jc, TOL)
    jstep = jax.jit(jax_serve_step(jm))
    tstep = make_serve_step(tm)
    jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], dim=-1)[:, None]
    for _ in range(n_new):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(tree, jc, jtok)
        tl, tc = tstep(tc, ttok)
        close(tl, jl, DECODE_TOL)
        jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1], dim=-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tc["length"] == int(jc["length"]) == S + n_new
    leaves(tc, jc, DECODE_TOL)


def decode_continues_prefill(tm, S, B=2, seed=5, n_steps=1):
    """The port against itself: decoding tokens S .. S + n_steps - 1
    after prefilling S gives, at each step, the last-position logits of
    prefilling that many tokens more."""
    cfg = tm.cfg
    toks = t(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (B, S + n_steps)))
    pre = {k: t(a) for k, a in prefix_inputs(cfg, B, seed).items()}
    P = prefix_len(cfg)
    _, cache = tdec.prefill(tm, toks[:, :S], P + S + n_steps, **pre)
    for i in range(n_steps):
        want, _ = tdec.prefill(tm, toks[:, :S + i + 1], P + S + i + 1, **pre)
        got, cache = tdec.decode_step(tm, cache, toks[:, S + i:S + i + 1])
        close(got, want.numpy(), DECODE_TOL)
    assert cache["length"] == P + S + n_steps
