"""The port's dense LM stack against the JAX package's, on the CPU.

Reduced qwen2-0.5b (GQA, QKV bias, tied embeddings), gemma-7b (GeGLU,
scaled embeddings, plus-one RMSNorm, head_dim 32 != d / H = 16 in the
reduced config) and yi-6b (untied embeddings), float32. The reference's
`init_params` weights, with the biases and norm scales perturbed so that
they matter, are carried into the port with `params_from_jax`; inputs are
made from a seed with numpy. The reference model is built on a (1, 1)
mesh with Auto axes: jax 0.9's `make_mesh` default (Explicit axes) makes
`Model._constrain` raise.

Tolerances: 2e-4 (rtol and atol) per module and for prefill logits,
atol 5e-4 for decode logits, as `tests/test_models.py` holds the
reference to itself (float32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import layers as jL
from repro.models.transformer import Model as JaxModel
from repro.train.steps import make_serve_step as jax_serve_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_jax_params, params_from_jax
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import PORTED_FAMILIES, Model
from repro_torch.train.steps import make_prefill_step, make_serve_step
from repro_torch.utils.params import param_count

DENSE = ["qwen2-0.5b", "gemma-7b", "yi-6b"]
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-4, atol=5e-4)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _setup(cfg, seed=0):
    """(reference model, its params as numpy, the port's model)."""
    jm = JaxModel(cfg, _mesh())
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1].key)
        if name == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name.startswith("b"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    tm = Model(_torch_cfg(cfg), "cpu")
    load_jax_params(tm, tree)
    return jm, tree, tm


def _torch_cfg(jcfg):
    """The port's ModelConfig with the same fields as a reference one
    (the sub-configs of other families stay None: dense only)."""
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


_CACHE = {}


def setup(arch):
    if arch not in _CACHE:
        _CACHE[arch] = _setup(jax_config(arch, reduced=True))
    return _CACHE[arch]


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


# -- per module -------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_rmsnorm(arch):
    jm, tree, tm = setup(arch)
    x = _x((2, 5, jm.cfg.d_model))
    for jname, norm in (("norm1", tm.layers[0].norm1),
                        ("norm2", tm.layers[0].norm2)):
        want = jL.apply_norm(jm.cfg, _layer0(tree)[jname], jnp.asarray(x))
        _close(norm(_t(x)), want)
    want = jL.apply_norm(jm.cfg, tree["final_norm"], jnp.asarray(x))
    _close(tm.final_norm(_t(x)), want)
    assert tm.layers[0].norm1.plus_one == arch.startswith("gemma")


@pytest.mark.parametrize("arch", DENSE)
def test_mlp(arch):
    jm, tree, tm = setup(arch)
    x = _x((2, 5, jm.cfg.d_model))
    want = jL.apply_mlp(jm.cfg, _layer0(tree)["mlp"], jnp.asarray(x))
    _close(tm.layers[0].mlp(_t(x)), want)


@pytest.mark.parametrize("arch", DENSE)
def test_rope(arch):
    cfg = jax_config(arch, reduced=True)
    x = _x((2, 40, cfg.n_heads, cfg.resolved_head_dim))
    pos = np.arange(40)
    want = jL.rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    _close(tL.rope(_t(x), _t(pos), cfg.rope_theta), want)
    # one decode position per batch row, (B, 1)
    pos_b = np.array([[7], [3000]])
    want = jL.rope(jnp.asarray(x[:, :1]), jnp.asarray(pos_b), cfg.rope_theta)
    _close(tL.rope(_t(x[:, :1]), _t(pos_b), cfg.rope_theta), want)


def test_rope_is_half_split():
    """Dh = 4, one position, angle pi/2 on the first frequency: element 0
    pairs with element 2 (half split), not with element 1 (interleaved)."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).reshape(1, 1, 1, 4)
    theta = 1.0   # every frequency 1
    out = tL.rope(x, torch.tensor([np.pi / 2]), theta)
    np.testing.assert_allclose(out.reshape(-1).numpy(), [-3, -4, 1, 2],
                               atol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_embed_unembed(arch):
    jm, tree, tm = setup(arch)
    cfg = jm.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    want = jL.apply_embed(cfg, tree["embed"], jnp.asarray(toks))
    _close(tm.embed.apply_embed(_t(toks)), want)
    h = _x((2, 7, cfg.d_model))
    want = jL.apply_unembed(cfg, tree["embed"], jnp.asarray(h))
    _close(tm.embed.apply_unembed(_t(h)), want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-6b"])
def test_unembed_masks_the_padded_vocab(arch):
    """vocab 250 pads to 256: the six pad logits sit at -1e9 (tied and
    untied unembedding)."""
    jcfg = jax_config(arch, reduced=True).replace(vocab_size=250)
    jm, tree, tm = _setup(jcfg)
    assert tm.embed.embedding.shape[0] == 256
    h = _x((2, 3, jcfg.d_model))
    got = tm.embed.apply_unembed(_t(h))
    _close(got, jL.apply_unembed(jcfg, tree["embed"], jnp.asarray(h)))
    assert torch.all(got[..., 250:] < -1e8)
    assert torch.all(got[..., :250] > -1e3)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("S", [24, 2100])
def test_attend_full(arch, S):
    """Dense route at S = 24; at S = 2100 the blockwise route (K6's plain
    version here, the reference's scan twin there) with a tail of 52 past
    its 512-key blocks. Also the rotated keys and values the cache keeps."""
    jm, tree, tm = setup(arch)
    cfg = jm.cfg
    x = _x((2, S, cfg.d_model), seed=S)
    pos = np.arange(S)
    p = _layer0(tree)["attn"]
    want = jattn.attend_full(cfg, p, jnp.asarray(x), jnp.asarray(pos))
    got, k, v = tattn.attend_full(cfg, tm.layers[0].attn, _t(x), _t(pos))
    _close(got, want)
    jk, jv = jattn._project_kv(cfg, p, jnp.asarray(x))
    _close(k, jL.rope(jk, jnp.asarray(pos), cfg.rope_theta))
    _close(v, jv)


def test_attend_full_routes_by_length(monkeypatch):
    """K6 is called from BLOCKWISE_MIN_KV keys on, never below it."""
    from repro_torch.kernels import ops
    _, _, tm = setup("qwen2-0.5b")
    cfg = tm.cfg
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    for S in (tattn.BLOCKWISE_MIN_KV - 1, tattn.BLOCKWISE_MIN_KV):
        tattn.attend_full(cfg, tm.layers[0].attn,
                          _t(_x((1, S, cfg.d_model))), torch.arange(S))
    assert calls == [(1, tattn.BLOCKWISE_MIN_KV, cfg.n_heads,
                      cfg.resolved_head_dim)]


def test_blockwise_refuses_a_window():
    """Named for the refusal it replaced: the blockwise route with a
    window (K6 and K6b with the band; their plain versions here) is
    differentiable. The gradient with respect to the layer's input
    against torch's autograd through K6's plain version with the same
    window (`use_kernels=False`)."""
    _, _, tm = setup("qwen2-0.5b")
    cfg = tm.cfg
    S = tattn.BLOCKWISE_MIN_KV
    x = _t(_x((1, S, cfg.d_model))).requires_grad_(True)
    w = _t(_x((1, S, cfg.d_model), seed=4))
    out, _, _ = tattn.attend_full(cfg, tm.layers[0].attn, x,
                                  torch.arange(S), window=128)
    with torch.no_grad():
        full, _, _ = tattn.attend_full(cfg, tm.layers[0].attn, x,
                                       torch.arange(S))
    assert not torch.allclose(out, full)
    got, = torch.autograd.grad((out * w).sum(), x)
    dense, _, _ = tattn.attend_full(cfg, tm.layers[0].attn, x,
                                    torch.arange(S), window=128,
                                    use_kernels=False)
    want, = torch.autograd.grad((dense * w).sum(), x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# -- the slice: prefill + greedy decode ---------------------------------------

def _serve_both(jm, tree, tm, S, n_new=4, B=2, seed=3):
    """Prefill S prompt tokens then n_new greedy decode steps in both
    packages; asserts logits, cache and tokens agree."""
    cfg = jm.cfg
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    max_len = S + n_new
    jl, jc = jdec.prefill(jm, tree, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tdec.prefill(tm, _t(toks), max_len)
    _close(tl, jl)
    assert tc["length"] == int(jc["length"]) == S
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    jstep = jax.jit(jax_serve_step(jm))
    tstep = make_serve_step(tm)
    jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], dim=-1)[:, None]
    for _ in range(n_new):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jstep(tree, jc, jtok)
        tl, tc = tstep(tc, ttok)
        _close(tl, jl, DECODE_TOL)
        jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl[:, -1], dim=-1)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tc["length"] == int(jc["length"]) == S + n_new
    _close(tc["kv"]["k"], jc["kv"]["k"], DECODE_TOL)
    return tl


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("S", [24, 2100])
def test_prefill_and_decode_match_reference(arch, S):
    jm, tree, tm = setup(arch)
    _serve_both(jm, tree, tm, S)


@pytest.mark.parametrize("variant", [dict(fused_qkv=True),
                                     dict(pad_heads=6, pad_kv_heads=3),
                                     dict(attn_window=8)])
def test_config_options_match_reference(variant):
    """The fused wqkv projection, zero-padded heads and a sliding window
    (options no published dense config sets) serve as the reference does,
    with the same cache: max_len slots, the window masked by position."""
    jcfg = jax_config("qwen2-0.5b", reduced=True).replace(**variant)
    jm, tree, tm = _setup(jcfg)
    if "pad_heads" in variant:
        wq = tm.layers[0].attn.wq
        assert wq.shape[1] == 6
    _serve_both(jm, tree, tm, 24, n_new=2)


def test_decode_continues_the_full_forward():
    """The port against itself, as the reference's consistency test: the
    logits of decoding the last 4 tokens after prefilling the rest equal
    the full forward's."""
    _, _, tm = setup("yi-6b")
    toks = _t(np.random.default_rng(5).integers(0, 256, (2, 24)))
    full = make_prefill_step(tm)({"tokens": toks})
    last, cache = tdec.prefill(tm, toks[:, :20], max_len=24)
    _close(last[:, 0], full[:, 19].numpy())
    for t in range(20, 24):
        lg, cache = tdec.decode_step(tm, cache, toks[:, t:t + 1])
        _close(lg[:, 0], full[:, t].numpy(), DECODE_TOL)


# -- parameters ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "yi-6b", "gemma-7b",
                                  "qwen1.5-32b"])
def test_param_count_matches_the_model(arch):
    """At full width on the meta device (nothing allocated): the analytic
    count plus the vocab padding is the model's parameter count."""
    cfg = get_config(arch)
    model = Model(cfg, "meta")
    actual = sum(p.numel() for p in model.parameters())
    pad = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * \
        (1 if cfg.tie_embeddings else 2)
    assert actual == param_count(cfg) + pad
    if arch == "qwen2-0.5b":
        assert 490e6 < actual < 500e6


def test_state_dict_names_match_the_reference_tree():
    jm, tree, tm = setup("qwen2-0.5b")
    assert set(params_from_jax(tm.cfg, tree)) == set(tm.state_dict())


def test_init_distributions_and_seed():
    cfg = get_config("yi-6b", reduced=True).replace(d_model=256, d_ff=512)
    a, b, c = (Model(cfg, "cpu") for _ in range(3))
    init_params(a, torch.Generator().manual_seed(0))
    init_params(b, torch.Generator().manual_seed(0))
    init_params(c, torch.Generator().manual_seed(1))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert name.endswith("scale") or not torch.equal(pa, pc), name
    sd = a.state_dict()
    assert abs(float(sd["embed.embedding"].std()) - 0.02) < 0.002
    assert abs(float(sd["embed.unembed"].std()) - 256 ** -0.5) < 0.01
    assert abs(float(sd["layers.0.mlp.w_down"].std()) - 512 ** -0.5) < 0.005
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    assert abs(float(sd["layers.1.attn.wo"].std()) - (H * Dh) ** -0.5) < 0.01
    assert torch.all(sd["final_norm.scale"] == 1)


@pytest.mark.parametrize("arch,first,last", [
    ("qwen2-0.5b", [-0.022516796365380287, -0.023047203198075294],
     0.1287376880645752),
    ("gemma-7b", [-0.022516796365380287, -0.023047203198075294],
     -0.05587165430188179)])
def test_dense_init_draws_are_unchanged(arch, first, last):
    """The dense family's draws from seed 0, as the port made them before
    the moe and ssm families (a per-parameter dtype, the const init):
    the embedding's first values, and the last value of the last layer's
    w_down, which every earlier draw's size moves."""
    m = Model(get_config(arch, reduced=True), "cpu")
    init_params(m, torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert sd["embed.embedding"].flatten()[:2].tolist() == first
    assert float(sd["layers.1.mlp.w_down"].flatten()[-1]) == last


def test_init_zeroes_padded_heads_and_biases():
    cfg = get_config("qwen2-0.5b", reduced=True).replace(pad_heads=6,
                                                          pad_kv_heads=3)
    m = Model(cfg, "cpu")
    init_params(m, torch.Generator().manual_seed(0))
    at = m.layers[0].attn
    assert torch.all(at.wq[:, 4:] == 0) and torch.any(at.wq[:, :4] != 0)
    assert torch.all(at.wk[:, 2:] == 0) and torch.all(at.wv[:, 2:] == 0)
    assert torch.all(at.wo[4:] == 0)
    assert torch.all(at.bq == 0) and torch.all(at.bk == 0)


def test_kv_cache_layout():
    cfg = get_config("gemma-7b", reduced=True)
    m = Model(cfg, "meta")
    cache = tdec.init_cache(m, batch=3, max_len=40)
    assert cache["kv"]["k"].shape == (2, 3, 40, 4, 32)
    assert cache["length"] == 0
    layer = tattn.init_cache(cfg.replace(attn_window=16), 3, 40, "cpu")
    assert layer.k.shape == (3, 40, 4, 32) and layer.length == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_registry_is_the_reference_data(arch, reduced):
    assert dataclasses.asdict(get_config(arch, reduced)) == \
        dataclasses.asdict(jax_config(arch, reduced))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "pixtral-12b",
                                  "whisper-small"])
def test_other_families_are_not_ported(arch):
    """The last three families the port took (hybrid, vlm, encdec) build;
    a family outside PORTED_FAMILIES is refused."""
    cfg = get_config(arch, reduced=True)
    assert cfg.family in PORTED_FAMILIES
    Model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg.replace(family=cfg.family + "-x"), "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_builds(arch):
    """All ten architectures, reduced on the CPU and at full width on the
    meta device; every family is ported."""
    assert get_config(arch).family in PORTED_FAMILIES
    Model(get_config(arch, reduced=True), "cpu")
    Model(get_config(arch), "meta")
