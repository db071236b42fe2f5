"""K6's plain version (`repro_torch.kernels.ref.attention_ref`, what
`ops.flash_attention` returns for CPU tensors) against the JAX package's
flash attention: `repro.kernels.ops.flash_attention` (the Pallas kernel, in
interpret mode on the CPU) and `repro.kernels.ref.attention_ref`.

Shapes are `tests/test_kernels.py`'s, both causal and not, at its
tolerance (rtol 2e-4 / atol 2e-5 in float32; 5e-2 in bfloat16). Tails
(200 x 200, 200 x 328) go only to the reference's `attention_ref`: its
Pallas wrapper falls back to it there. Inputs come from a seed with numpy.
The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-5)
SHAPES = [(4, 128, 128, 64), (2, 256, 512, 128), (1, 384, 384, 256),
          (3, 128, 256, 64)]


def _qkv(BH, Sq, Skv, D, seed, BH_kv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, Sq, D)).astype(np.float32),
            rng.standard_normal((BH_kv or BH, Skv, D)).astype(np.float32),
            rng.standard_normal((BH_kv or BH, Skv, D)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("BH,Sq,Skv,D", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel(BH, Sq, Skv, D, causal):
    q, k, v = _qkv(BH, Sq, Skv, D, seed=BH * Sq + D)
    got = ops.flash_attention(*_torch(q, k, v), causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_bf16():
    q, k, v = _qkv(2, 128, 128, 64, seed=7)
    got = ops.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("Sq,Skv", [(200, 200), (200, 328), (4000, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_tails_match_reference(Sq, Skv, causal):
    """Lengths that are no multiple of any tile; causal stays aligned
    top-left (query i sees keys 0..i) when Sq != Skv."""
    q, k, v = _qkv(2, Sq, Skv, 64, seed=Sq + Skv)
    got = ops.flash_attention(*_torch(q, k, v), causal=causal)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_mask_is_top_left():
    """Row 0 attends to key 0 alone, whatever Skv."""
    q, k, v = _torch(*_qkv(1, 3, 9, 64, seed=0))
    out = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("G", [1, 2, 7])
def test_grouped_heads_read_their_kv_head(G):
    """(BH, S, D) with BH / G kv heads, and the model's (B, S, H, D)
    layout with H / G kv heads, both equal the reference on kv heads
    repeated out to the query heads."""
    B, H, S, D = 2, 14, 40, 64
    q, k, v = _qkv(B * H, S, S, D, seed=G, BH_kv=B * H // G)
    want = jref.attention_ref(*(jnp.asarray(np.repeat(a, reps, axis=0))
                                for a, reps in ((q, 1), (k, G), (v, G))),
                              True)
    got = ops.flash_attention(*_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def bshd(a):
        return torch.from_numpy(a).reshape(B, -1, S, D).permute(0, 2, 1, 3)

    got4 = ops.flash_attention(bshd(q), bshd(k), bshd(v))
    assert got4.shape == (B, S, H, D)
    np.testing.assert_allclose(got4.permute(0, 2, 1, 3).reshape(B * H, S, D)
                               .numpy(), np.asarray(want), **TOL)


def test_sm_scale_is_passed_through():
    q, k, v = _qkv(1, 16, 16, 64, seed=3)
    got = ops.flash_attention(*_torch(q, k, v), sm_scale=0.3)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              True, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launch_counts()
    q, k, v = _torch(*_qkv(1, 32, 32, 24, seed=4))   # any D on the CPU
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out, ref.attention_ref(q, k, v))
    assert ops.launch_counts()["flash_attention"] == 0
