"""The port's hybrid family (`models/rglru.py`, `RecLayer`/`Triple` in
`models/transformer.py`, the ring cache in `models/attention.py` and
`models/decode.py`) and K6's sliding window (`ops.flash_attention` /
`ref.attention_ref` with `window`) against the JAX package's, on the CPU.

Reduced recurrentgemma-2b (one (rec, rec, attn) triple and 2 tail rec
layers, d 64, 4 heads over 1, head_dim 16, lru_width 64, conv 4, window
16), float32. The reference's `init_params` weights, with the norm
scales, the biases and Lambda perturbed, are carried into the port with
`params_from_jax`; inputs are made from a seed with numpy. The reference
model is built once (module scope). Tolerances as `tests/torch_lm_parity.py`
states (2e-4 rtol and atol; decode logits atol 5e-4); the windowed
attention's plain version against the reference's blockwise scan 2e-5
(float32 sums in another order), bit-equal where the window masks
nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import rglru as jrg
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import rglru as trg
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.utils.params import param_count
from torch_lm_parity import (DECODE_TOL, close, decode_continues_prefill,
                             serve_both, setup, t, x)

ARCH = "recurrentgemma-2b"
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
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
                            perturbed=("scale", "conv_b", "b_a", "b_i",
                                       "Lambda"))
    return _CACHE["m"]


def _rec(tree, name="rec1"):
    """The first triple's `name` rec layer's RG-LRU leaves."""
    return jax.tree.map(lambda a: a[0], tree["triples"][name]["rec"])


def _state(cfg, B, seed):
    W, Kc = cfg.hybrid.lru_width, cfg.hybrid.conv_width
    return x((B, W), seed), x((B, Kc - 1, W), seed + 1)


# -- the RG-LRU block ------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block(carried):
    """The block over 37 positions, from zeros or from a carried state
    (h folded into the first position, the conv's tail ahead of x)."""
    jm, tree, tm = models()
    cfg = jm.cfg
    xs = x((2, 37, cfg.d_model), seed=3)
    jst = tst = None
    if carried:
        h, conv = _state(cfg, 2, 4)
        jst = jrg.LRUState(jnp.asarray(h), jnp.asarray(conv), jnp.int32(5))
        tst = trg.LRUState(t(h), t(conv), 5)
    out, st = jrg.apply_rglru_block(cfg, _rec(tree, "rec2"),
                                    jnp.asarray(xs), jst)
    tout, tst = trg.apply_rglru_block(cfg, tm.triples[0].rec2.rec, t(xs),
                                      tst)
    close(tout, out)
    close(tst.h, st.h)
    close(tst.conv, st.conv)
    assert tst.h.dtype == torch.float32
    assert tst.length == int(st.length) == 37 + (5 if carried else 0)


def test_rglru_decode_step():
    jm, tree, tm = models()
    cfg = jm.cfg
    xs = x((3, 1, cfg.d_model), seed=7)
    h, conv = _state(cfg, 3, 8)
    out, st = jrg.rglru_decode_step(
        cfg, _rec(tree), jnp.asarray(xs),
        jrg.LRUState(jnp.asarray(h), jnp.asarray(conv), jnp.int32(9)))
    tout, tst = trg.rglru_decode_step(cfg, tm.triples[0].rec1.rec, t(xs),
                                      trg.LRUState(t(h), t(conv), 9))
    close(tout, out, DECODE_TOL)
    close(tst.h, st.h, DECODE_TOL)
    close(tst.conv, st.conv)
    assert tst.length == 10


def test_gates_clamp_where_a_reaches_one():
    """a -> 1 (Lambda large): the input's weight sqrt(max(1 - a^2, 1e-12))
    is clamped, not the root of a negative rounding, as in the reference."""
    jm, tree, tm = models()
    cfg = jm.cfg
    p = _rec(tree)
    p = dict(p, Lambda=np.full_like(p["Lambda"], 40.0))
    rec = tm.triples[0].rec1.rec
    xc = x((2, 5, cfg.hybrid.lru_width), seed=9)
    with torch.no_grad():
        saved = rec.Lambda.clone()
        rec.Lambda.fill_(40.0)
        try:
            a, gated = trg._gates(cfg, rec, t(xc))
        finally:
            rec.Lambda.copy_(saved)
    ja, jg = jrg._gates(cfg, p, jnp.asarray(xc))
    close(a, ja)
    close(gated, jg)
    assert torch.all(torch.isfinite(gated))


# -- the model ---------------------------------------------------------------

def test_logits_and_loss():
    jm, tree, tm = models()
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (2, 40))
    labels = rng.integers(0, 256, (2, 40))
    close(tm.logits(t(toks)), jm.logits(tree, {"tokens": jnp.asarray(toks)}))
    want = jm.loss_fn(tree, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
    close(tm.loss_fn({"tokens": t(toks), "labels": t(labels)}), want)


@pytest.mark.parametrize("S", [10, 40])
def test_prefill_and_decode_match_reference(S):
    """S 10 (inside the window of 16) and S 40, past twice the window: the
    ring holds the last 16 keys rolled by S % 16, and the decode steps
    write past its wrap. The port's own case of the reference's
    `test_window_attention_ring_buffer`."""
    jm, tree, tm = models()
    keys = [("kv", "k"), ("kv", "v"), ("lru1_h",), ("lru1_conv",),
            ("lru2_h",), ("lru2_conv",), ("tail0_h",), ("tail1_conv",)]
    serve_both(jm, tree, tm, S, keys, n_new=4)


def test_decode_continues_a_longer_prefill():
    """Decode steps from a prefill of 30 past the ring's wrap (window
    16) against prefills of 31 .. 35."""
    _, _, tm = models()
    decode_continues_prefill(tm, 30, n_steps=5)


def test_cache_is_a_ring_and_constant_in_length():
    """The attention layers keep min(max_len, window) slots; the state
    bytes after a prompt of 20 and of 60 are equal."""
    _, _, tm = models()
    sizes = []
    for S in (20, 60):
        toks = t(np.random.default_rng(S).integers(0, 256, (2, S)))
        _, cache = tdec.prefill(tm, toks, max_len=S + 4)
        assert cache["kv"]["k"].shape == (1, 2, 16, 1, 16)
        assert cache["lru1_h"].shape == (1, 2, 64)
        assert cache["lru1_h"].dtype == torch.float32
        assert cache["tail1_conv"].shape == (2, 3, 64)
        sizes.append(sum(c.numel() * c.element_size()
                         for v in cache.values() if not isinstance(v, int)
                         for c in (v.values() if isinstance(v, dict)
                                   else (v,))))
    assert sizes[0] == sizes[1]
    m = Model(get_config(ARCH, reduced=True), "meta")
    assert tdec.init_cache(m, 1, 8)["kv"]["k"].shape[2] == 8


def test_fill_cache_is_the_reference_s_fit():
    """The prefill's ring fill: slot j holds the key of the position p
    with p % S_max == j."""
    from repro.models.decode import _fit
    for S, S_max in ((5, 16), (16, 16), (40, 16), (33, 8)):
        k = x((2, S, 1, 4), seed=S)
        got = torch.zeros((2, S_max, 1, 4))
        tattn.fill_cache(got, t(k))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(_fit(jnp.asarray(k), S_max)))


def test_ring_decode_step_matches_reference():
    """One attention decode step at position 37 on a ring of 16 slots."""
    jm, tree, tm = models()
    cfg = jm.cfg
    p = jax.tree.map(lambda a: a[0], tree["triples"]["attn"]["attn"])
    xs = x((2, 1, cfg.d_model), seed=11)
    k, v = x((2, 16, 1, 16), seed=12), x((2, 16, 1, 16), seed=13)
    out, jc = jattn.decode_step(cfg, p, jnp.asarray(xs), jattn.KVCache(
        jnp.asarray(k), jnp.asarray(v), jnp.int32(37)), window=16)
    tc = tattn.KVCache(t(k), t(v), 37)
    tout, tc = tattn.decode_step(cfg, tm.triples[0].attn.attn, t(xs), tc,
                                 window=16)
    close(tout, out, DECODE_TOL)
    close(tc.k, jc.k)
    assert tc.length == 38


def test_remat_loss_matches_without_remat():
    _, _, tm = models()
    tr = Model(tm.cfg.replace(remat=True), "cpu")
    tr.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(10)
    batch = {"tokens": t(rng.integers(0, 256, (2, 20))),
             "labels": t(rng.integers(0, 256, (2, 20)))}
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in tr.named_parameters()}
    loss = torch.func.functional_call(tr, leaves, (batch,))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(tm.loss_fn(batch)),
                                                 rel=1e-6)
    assert all(torch.isfinite(g).all() for g in grads)


# -- parameters ----------------------------------------------------------------

def test_params_round_trip_keeps_the_lru_leaves_float32():
    """`triples` stacked both ways, the tail rec layers unstacked; in a
    bf16 model b_a, b_i and Lambda stay float32, bit for bit."""
    jcfg = jax_config(ARCH, reduced=True).replace(dtype="bfloat16")
    tcfg = get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    from repro.models.transformer import Model as JaxModel
    from torch_lm_parity import mesh
    _, tree32, _ = models()
    tree = jax.tree.map(lambda a, spec: np.asarray(jnp.asarray(
        a).astype(spec.dtype)), tree32,
        JaxModel(jcfg, mesh()).abstract_params())
    state = params_from_jax(tcfg, tree)
    assert state["triples.0.rec1.rec.Lambda"].dtype == torch.float32
    assert state["tail_rec1.rec.b_a"].dtype == torch.float32
    assert state["triples.0.attn.attn.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["tail_rec0.rec.Lambda"].numpy(),
                                  tree["tail_rec0"]["rec"]["Lambda"])
    m = Model(tcfg, "cpu")
    m.load_state_dict(state, strict=True)
    back = params_to_jax(tcfg, state)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, np.asarray(flat_b[path], np.float32))
    assert back["triples"]["rec1"]["rec"]["w_a"].shape == (1, 64, 64)


def test_float32_leaves_and_const_init():
    cfg = get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    m = Model(cfg, "cpu")
    init_params(m, torch.Generator().manual_seed(0))
    r = m.tail_rec1.rec
    assert r.Lambda.dtype == r.b_a.dtype == r.b_i.dtype == torch.float32
    assert r.w_a.dtype == torch.bfloat16
    assert torch.all(r.Lambda == 3.0) and torch.all(r.b_i == 0)
    assert abs(float(r.conv_w.float().std()) - 0.5) < 0.1   # fan-in Kc 4


def test_param_count_and_stack_at_full_width():
    """recurrentgemma-2b on the meta device: 8 triples and 2 tail rec
    layers in forward order, 3.55 B parameters (untied embeddings)."""
    cfg = get_config(ARCH)
    model = Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(cfg) and 3.5e9 < n < 3.6e9
    assert len(model.triples) == 8 and len(model.tails()) == 2
    stack = model.stack()
    assert len(stack) == 26 and stack[2] is model.triples[0].attn
    assert stack[-1] is model.tail_rec1
    assert model.triples[0].attn.window == 2048


# -- K6's sliding window -------------------------------------------------------

def _qkv(B, S, H, Kv, D, seed):
    return (x((B, S, H, D), seed), x((B, S, Kv, D), seed + 1),
            x((B, S, Kv, D), seed + 2))


def _blockwise(q, k, v, window, block, monkeypatch):
    monkeypatch.setattr(jattn, "BLOCK_Q", block)
    monkeypatch.setattr(jattn, "BLOCK_KV", block)
    S = q.shape[1]
    pos = jnp.arange(S)
    return jattn._blockwise_sdpa(None, jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), pos, pos, True, window)


@pytest.mark.parametrize("S,H,Kv,window,block", [
    (100, 2, 2, 20, 32),      # a window that is not a multiple of the block
    (96, 6, 2, 40, 32),       # grouped-query, 3 query heads a kv head
    (77, 4, 1, 7, 16),        # MQA, ragged tail
])
def test_attention_ref_window_matches_blockwise(S, H, Kv, window, block,
                                                monkeypatch):
    q, k, v = _qkv(2, S, H, Kv, 16, seed=S)
    want = _blockwise(q, k, v, window, block, monkeypatch)
    got = ref.attention_ref(t(q), t(k), t(v), window=window)
    close(got, want, ATTN_TOL)
    # ops.flash_attention on CPU tensors is the plain version
    assert torch.equal(ops.flash_attention(t(q), t(k), t(v), window=window),
                       got)
    # the band does mask: the unwindowed result differs
    assert not torch.allclose(got, ref.attention_ref(t(q), t(k), t(v)))


@pytest.mark.parametrize("window", [64, 65, 1000])
def test_window_of_at_least_s_is_bit_equal_to_causal(window, monkeypatch):
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=3)
    causal = ref.attention_ref(t(q), t(k), t(v))
    got = ref.attention_ref(t(q), t(k), t(v), window=window)
    assert torch.equal(got, causal)
    out, lse = ref.attention_ref(t(q), t(k), t(v), window=window,
                                 return_lse=True)
    assert torch.equal(out, causal)
    close(got, _blockwise(q, k, v, window, 32, monkeypatch), ATTN_TOL)


def test_windowed_lse_matches_the_blockwise_scan():
    """The row log-sum-exp K6 writes, with a window, against the
    reference's `_flash_fwd_scan`'s."""
    q, k, v = _qkv(1, 64, 2, 1, 16, seed=4)
    _, lse = ref.attention_ref(t(q), t(k), t(v), window=9, return_lse=True)
    _, jlse = jattn._flash_fwd_scan(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 16, 16, True, 9, 64, 64)
    close(lse, np.asarray(jlse).reshape(1, 2, 64), ATTN_TOL)


def test_attend_full_blockwise_route_with_a_window():
    """The attention layer at S 2048 (the blockwise route: K6's plain
    version here) with the hybrid's window of 16, against the reference's
    attend_full (its blockwise scan)."""
    jm, tree, tm = models()
    cfg = jm.cfg
    S = tattn.BLOCKWISE_MIN_KV
    p = jax.tree.map(lambda a: a[0], tree["triples"]["attn"]["attn"])
    xs = x((1, S, cfg.d_model), seed=21)
    want = jattn.attend_full(cfg, p, jnp.asarray(xs), jnp.arange(S),
                             causal=True, window=16)
    got, k, v = tattn.attend_full(cfg, tm.triples[0].attn.attn, t(xs),
                                  torch.arange(S), causal=True, window=16)
    close(got, want)
    assert k.shape == (1, S, 1, 16)


def test_flash_backward_refuses_a_window(monkeypatch):
    """Named for the refusal it replaced: K6b now takes the window. The
    gradient of sum(out * w) through `ops.flash_attention(..., window=8)`
    (the autograd Function, K6b's plain version here) against jax.grad
    through the reference's blockwise attention with the band; it
    differs from the gradient without a window."""
    q, k, v = _qkv(1, 32, 2, 1, 64, 5)
    w = x((1, 32, 2, 64), 8)

    def jloss(a, b, c):
        return jnp.sum(_blockwise(a, b, c, 8, 16, monkeypatch) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad((ops.flash_attention(tq, tk, tv, window=8)
                               * t(w)).sum(), (tq, tk, tv))
    for g, wnt in zip(got, want):
        close(g, wnt)
    causal = torch.autograd.grad((ops.flash_attention(tq, tk, tv)
                                  * t(w)).sum(), (tq, tk, tv))
    assert not torch.allclose(causal[1], got[1])


def test_flash_attention_refuses_a_negative_window():
    q, k, v = (t(a) for a in _qkv(1, 8, 2, 1, 64, 6))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)
