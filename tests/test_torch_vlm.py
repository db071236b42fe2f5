"""The port's vlm family (pixtral: the dense stack with patch embeddings
prepended to the tokens; `Model.embed_inputs`, the "kv" cache over
patches + text in `models/decode.py`) against the JAX package's, on the
CPU.

Reduced pixtral-12b (2 layers, d 64, 4 heads over 2, head_dim 16, 8
patches), float32. The reference's `init_params` weights, with the norm
scales perturbed, are carried into the port with `params_from_jax`;
tokens, labels and patch embeddings are made from a seed with numpy. The
reference model is built once (module scope). Tolerances as
`tests/torch_lm_parity.py` states (2e-4 rtol and atol; decode logits
atol 5e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.transformer import Model
from repro_torch.utils.params import param_count
from torch_lm_parity import (close, decode_continues_prefill, prefix_inputs,
                             serve_both, setup, t)

ARCH = "pixtral-12b"
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
                            perturbed=("scale",))
    return _CACHE["m"]


def _batch(cfg, B, S, seed):
    """tokens, labels over patches + text, the patch embeddings, and a
    loss mask zero on the patches and on a few text positions (numpy)."""
    rng = np.random.default_rng(seed)
    P = cfg.vlm.n_patches
    mask = np.ones((B, P + S), np.float32)
    mask[:, :P] = 0.0
    mask[0, P + 3:P + 7] = 0.0
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, P + S)),
            "patches": prefix_inputs(cfg, B, seed)["patches"],
            "loss_mask": mask}


def test_logits_cover_patches_and_text():
    jm, tree, tm = models()
    b = _batch(jm.cfg, 2, 24, seed=1)
    want = jm.logits(tree, {k: jnp.asarray(b[k])
                            for k in ("tokens", "patches")})
    got = tm.logits(t(b["tokens"]), patches=t(b["patches"]))
    assert got.shape == (2, 8 + 24, jm.cfg.padded_vocab)
    close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_with_and_without_loss_mask(masked):
    """The loss over patches + text, and with a mask that leaves out the
    patch positions and some text (the train batches' layout)."""
    jm, tree, tm = models()
    b = _batch(jm.cfg, 2, 24, seed=2)
    if not masked:
        del b["loss_mask"]
    want = jm.loss_fn(tree, {k: jnp.asarray(a) for k, a in b.items()})
    got = tm.loss_fn({k: t(a) for k, a in b.items()})
    close(got, want)


@pytest.mark.parametrize("S", [12, 30])
def test_prefill_and_decode_match_reference(S):
    """The cache holds n_patches + S positions before decode starts."""
    jm, tree, tm = models()
    serve_both(jm, tree, tm, S, [("kv", "k"), ("kv", "v")])


def test_decode_continues_a_longer_prefill():
    _, _, tm = models()
    decode_continues_prefill(tm, 20, n_steps=2)


def test_patches_move_the_logits():
    """The same tokens after other patch embeddings give other logits:
    the patches are attended, not dropped."""
    _, _, tm = models()
    b = _batch(tm.cfg, 1, 10, seed=3)
    a = tm.logits(t(b["tokens"]), patches=t(b["patches"]))
    c = tm.logits(t(b["tokens"]), patches=t(b["patches"]) * 3.0)
    assert not torch.allclose(a[:, -1], c[:, -1])


def test_patches_count_toward_the_blockwise_route(monkeypatch):
    """n_patches + S >= BLOCKWISE_MIN_KV runs K6 (its plain version here)
    once a layer, one position short of it the dense route."""
    _, _, tm = models()
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    P = tm.cfg.vlm.n_patches
    pre = {"patches": t(prefix_inputs(tm.cfg, 1, 4)["patches"])}
    for S in (tattn.BLOCKWISE_MIN_KV - P - 1, tattn.BLOCKWISE_MIN_KV - P):
        toks = torch.zeros((1, S), dtype=torch.int64)
        _, cache = tdec.prefill(tm, toks, P + S + 1, **pre)
        assert cache["length"] == P + S
    assert calls == [(1, tattn.BLOCKWISE_MIN_KV, 4, 16)] * 2


def test_params_round_trip():
    jm, tree, tm = models()
    cfg = tm.cfg
    state = params_from_jax(cfg, tree)
    assert set(state) == set(tm.state_dict())
    back = params_to_jax(cfg, state)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, flat_b[path])


def test_param_count_at_full_width():
    """pixtral-12b on the meta device: 40 layers, 12.25 B parameters (the
    patch frontend is a stub: the embeddings come in projected)."""
    cfg = get_config(ARCH)
    model = Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(cfg) and 12.2e9 < n < 12.3e9
    assert len(model.layers) == 40
    cache = tdec.init_cache(model, 4, 256 + 4096 + 32)
    assert cache["kv"]["k"].shape == (40, 4, 4384, 8, 128)
