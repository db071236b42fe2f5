"""The port's encdec family (whisper: `Model.encode`, `DecoderLayer` in
`models/transformer.py`, cross-attention in `models/attention.py`, the
"cross" cache in `models/decode.py`, `layers.sinusoidal_positions`)
against the JAX package's, on the CPU.

Reduced whisper-small (2 encoder and 2 decoder layers, d 64, 4 heads,
head_dim 16, 16 frames, qkv and MLP biases, layernorm, no rope),
float32. The reference's `init_params` weights, with the norm scales and
every bias perturbed, are carried into the port with `params_from_jax`;
tokens, labels and frame embeddings are made from a seed with numpy. The
reference model is built once (module scope). Tolerances as
`tests/torch_lm_parity.py` states (2e-4 rtol and atol; decode logits
atol 5e-4); the sinusoid table bit-equal, one position's sinusoid in
float32 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.transformer import Model
from repro_torch.utils.params import param_count
from torch_lm_parity import (close, decode_continues_prefill, prefix_inputs,
                             serve_both, setup, t, x)

ARCH = "whisper-small"
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models():
    if not _CACHE:
        _CACHE["m"] = setup(jax_config(ARCH, reduced=True),
                            get_config(ARCH, reduced=True),
                            perturbed=("scale", "bias", "bq", "bk", "bv",
                                       "b_up", "b_down"))
    return _CACHE["m"]


def _frames(cfg, B, seed):
    return prefix_inputs(cfg, B, seed)["frames"]


@pytest.mark.parametrize("n_pos,d", [(16, 64), (1500, 768), (448, 768),
                                     (3, 10)])
def test_sinusoid_table_is_the_reference_s(n_pos, d):
    got = tlayers.sinusoidal_positions(n_pos, d)
    assert got.dtype == torch.float32 and got.shape == (n_pos, d)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jlayers.sinusoidal_positions(n_pos, d)))


@pytest.mark.parametrize("pos", [0, 7, 447])
def test_one_position_s_sinusoid_is_the_decode_step_s(pos):
    """What the reference's decode step adds at `length` (float32 math:
    a frequency one ulp apart moves the angle by up to pos x 2^-24, 3e-5
    at 447, hence 1e-4), and near the table's row (float64 math, cast)."""
    d = 768
    half = d // 2
    freqs = jnp.exp(-jnp.arange(half) * (jnp.log(10000.0) / (half - 1)))
    ang = jnp.asarray(pos).astype(jnp.float32) * freqs
    want = np.asarray(jnp.concatenate([jnp.sin(ang), jnp.cos(ang)]))
    got = tlayers.sinusoid_at(pos, d, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), tlayers.sinusoidal_positions(pos + 1, d)[pos].numpy(),
        rtol=0, atol=1e-4 * max(pos, 1) ** 0.5)


def test_encoder_matches_reference():
    jm, tree, tm = models()
    f = _frames(jm.cfg, 2, 1)
    close(tm.encode(t(f)), jm.encode(tree, jnp.asarray(f)))


def test_cross_attention_matches_reference():
    """attend_full with kv_x: queries from x, keys and values from the
    encoder's output, unmasked, no rope."""
    jm, tree, tm = models()
    cfg = jm.cfg
    p = jax.tree.map(lambda a: a[1], tree["dec_layers"]["cross_attn"])
    xs, enc = x((2, 9, cfg.d_model), 2), x((2, 16, cfg.d_model), 3)
    want = jattn.attend_full(cfg, p, jnp.asarray(xs), jnp.arange(9),
                             causal=False, kv_x=jnp.asarray(enc),
                             kv_positions=jnp.arange(16))
    got, k, v = tattn.attend_full(cfg, tm.dec_layers[1].cross_attn, t(xs),
                                  torch.arange(9), causal=False, kv_x=t(enc))
    close(got, want)
    jk, jv = jattn._project_kv(cfg, p, jnp.asarray(enc))
    close(k, jk)
    close(v, jv)


def test_logits_and_loss():
    jm, tree, tm = models()
    cfg = jm.cfg
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (2, 20))
    labels = rng.integers(0, 256, (2, 20))
    f = _frames(cfg, 2, 9)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(f)}
    close(tm.logits(t(toks), frames=t(f)), jm.logits(tree, jb))
    want = jm.loss_fn(tree, dict(jb, labels=jnp.asarray(labels)))
    got = tm.loss_fn({"tokens": t(toks), "frames": t(f),
                      "labels": t(labels)})
    close(got, want)


@pytest.mark.parametrize("S", [5, 30])
def test_prefill_and_decode_match_reference(S):
    """Self-attention's cache and the cross cache, projected once."""
    jm, tree, tm = models()
    serve_both(jm, tree, tm, S, [("kv", "k"), ("kv", "v"), ("cross", "k"),
                                 ("cross", "v")])


def test_decode_continues_a_longer_prefill():
    _, _, tm = models()
    decode_continues_prefill(tm, 12, n_steps=2)


def test_no_kernel_at_whisper_s_shapes(monkeypatch):
    """1500 frames and at most 448 target positions: every attention
    under BLOCKWISE_MIN_KV keys takes the dense route, as in the
    reference."""
    cfg = get_config(ARCH)
    assert cfg.encdec.encoder_frames < tattn.BLOCKWISE_MIN_KV
    assert cfg.encdec.max_target_positions < tattn.BLOCKWISE_MIN_KV
    _, _, tm = models()
    calls = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1))
    toks = torch.zeros((1, 30), dtype=torch.int64)
    _, cache = tdec.prefill(tm, toks, 32, frames=t(_frames(tm.cfg, 1, 2)))
    tdec.decode_step(tm, cache, toks[:, :1])
    assert calls == []


def test_params_round_trip():
    """enc_layers and dec_layers stacked both ways, enc_norm beside."""
    jm, tree, tm = models()
    cfg = tm.cfg
    state = params_from_jax(cfg, tree)
    assert set(state) == set(tm.state_dict())
    assert "enc_norm.bias" in state and "dec_layers.1.norm_x.scale" in state
    back = params_to_jax(cfg, state)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path])
    assert back["enc_layers"]["mlp"]["b_up"].shape == (2, 128)


def test_param_count_and_cache_at_full_width():
    """whisper-small on the meta device: 12 + 12 layers, the vocab padded
    to 51,968, every leaf of the reference's declarations (the analytic
    `param_count` leaves out the norms' and the MLPs' biases); the cross
    cache holds 1500 frames."""
    from repro.models.transformer import Model as JaxModel
    from torch_lm_parity import mesh
    cfg = get_config(ARCH)
    model = Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    leaves = jax.tree.leaves(JaxModel(jax_config(ARCH), mesh())
                             .abstract_params())
    assert n == sum(int(np.prod(a.shape)) for a in leaves)
    assert 0 < n - param_count(cfg) < 1e6
    assert len(model.enc_layers) == len(model.dec_layers) == 12
    cache = tdec.init_cache(model, 4, 416)
    assert cache["cross"]["k"].shape == (12, 4, 1500, 12, 64)
    assert cache["kv"]["v"].shape == (12, 4, 416, 12, 64)
