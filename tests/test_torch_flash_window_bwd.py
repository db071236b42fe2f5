"""K6b's sliding window on the CPU, against the JAX package.

`ref.attention_bwd_ref(..., window=)` (K6b's plain version, the function
the kernel is held to on the card) from `attention_ref`'s (out, lse)
against `jax.vjp` of the reference's blockwise attention
(`_blockwise_sdpa`, whose custom vjp is `_flash_mha_bwd` with the band of
`_block_mask`), its blocks patched to 8 so that a window falls inside one
block, across blocks, or covers the whole sequence; G 1 and G > 1; ragged
Sq; with and without the causal mask; at head dim 256 too (K6b's tensor-
core kernels at D 256 are held to this plain version on the card). Then `ops.flash_attention(...,
window=)` on CPU tensors under autograd (the `FlashAttention` Function,
whose backward passes its window to `flash_attention_bwd`) against
`jax.grad` of the same loss, and the wrapper's refusal of a negative
window.

Tolerance: rtol 1e-5 with atol 1e-5 x the tensor's largest entry
(float32 sums in another order), as `tests/test_torch_train.py` holds the
causal backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """The reference's blockwise route in blocks of 8 (a 37-row sequence
    has a ragged tail)."""
    monkeypatch.setattr(jattn, "BLOCKWISE_MIN_KV", 16)
    monkeypatch.setattr(jattn, "BLOCK_Q", 8)
    monkeypatch.setattr(jattn, "BLOCK_KV", 8)
    monkeypatch.setattr(tattn, "BLOCKWISE_MIN_KV", 16)


# (B, Sq, Skv, H, Kv, D, causal, window)
CASES = [
    (2, 37, 37, 4, 2, 16, True, 5),     # GQA, the band inside one block
    (2, 37, 37, 4, 2, 16, True, 13),    # across blocks, ragged Sq
    (1, 40, 40, 3, 3, 8, True, 9),      # G 1, whole blocks
    (1, 37, 37, 2, 2, 16, True, 37),    # a window of Sq: nothing masked
    (1, 33, 33, 4, 1, 8, True, 100),    # MQA, a window past Sq
    (2, 24, 37, 4, 4, 16, False, 7),    # no causal mask, Sq != Skv
    # head dim 256, the shapes K6b's wgmma variant takes at D 256
    (1, 40, 40, 2, 2, 256, True, 13),   # G 1 (gemma-7b's grouping)
    (1, 45, 45, 5, 1, 256, True, 21),   # G 5, ragged, a window off 64
    (2, 24, 37, 4, 2, 256, False, 70),  # no causal mask, Sq != Skv
]


def _inputs(B, Sq, Skv, H, Kv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D),
                      (B, Sq, H, D))]


def _jax_blockwise(q, k, v, causal, window):
    return jattn._blockwise_sdpa(None, q, k, v, jnp.arange(q.shape[1]),
                                 jnp.arange(k.shape[1]), causal, window)


def _close(got, want):
    want = np.asarray(want, np.float64)
    atol = TOL * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_window_matches_flash_vjp(case):
    *shape, causal, window = case
    q, k, v, do = _inputs(*shape)
    out_j, vjp = jax.vjp(lambda a, b, c: _jax_blockwise(a, b, c, causal,
                                                        window),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.attention_ref(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    _close(out.numpy(), out_j)
    got = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=causal,
                                window=window)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # the wrapper on CPU tensors is the plain version, window and all
    wrapped = ops.flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                      causal=causal, window=window)
    for a, b in zip(wrapped, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a window shorter than the sequence changes the gradient
    if window < shape[1]:
        full = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                     causal=causal)
        assert not torch.allclose(full[1], got[1])


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_window_grad_matches_jax_grad(case):
    """d/d(q, k, v) of sum(out * w) through the autograd Function with a
    window against jax.grad through the reference's blockwise attention."""
    *shape, causal, window = case
    q, k, v, w = _inputs(*shape, seed=3)

    def jloss(a, b, c):
        return jnp.sum(_jax_blockwise(a, b, c, causal, window) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, wnt in zip(got, want):
        _close(g.numpy(), wnt)


def test_flash_attention_bwd_refuses_a_negative_window():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16))
    out, lse = ref.attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_bwd(q, k, v, out, lse, do, window=-1)
