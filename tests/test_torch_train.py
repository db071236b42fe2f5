"""LM training in the port against the JAX package's, on the CPU.

The reduced qwen2-0.5b (GQA, QKV bias, tied embeddings) and yi-6b
(untied), float32, on a (1, 1) Auto-axes mesh for the reference (jax
0.9's default Explicit axes make `Model._constrain` raise). Weights are
the reference's `init_params` with biases and norm scales perturbed,
carried over with `models.convert`; inputs come from numpy seeds.

Checked: `softmax_xent`; the plain flash backward `attention_bwd_ref`
against `jax.vjp` of the reference's blockwise attention (`_flash_mha`'s
custom vjp, its block sizes patched small so that the ragged tails and
several blocks are covered); the autograd `FlashAttention` on CPU tensors
against `jax.grad`; the loss and every parameter's gradient against
`jax.value_and_grad(model.loss_fn)` on the dense route and on the
blockwise route (remat on there, so the Function runs under
`torch.utils.checkpoint`); one `make_train_step` step from a shared carry
(params, a non-trivial AdamW state, a batch) through `models.convert`;
and that the step changes none of its inputs.

Tolerances (float32 sums in another order): softmax_xent rtol 1e-6; the
attention backward rtol 1e-5 with atol 1e-5 x the tensor's largest entry;
loss rtol 1e-5; gradients rtol 1e-4 with atol 1e-4 x the leaf's largest
entry (two passes through two layers and the unembedding); the step's
new params, moments and master rtol 1e-5 with atol 1e-6 x the leaf's
largest entry, metrics rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models.transformer import Model as JaxModel
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (load_jax_params, opt_state_from_jax,
                                        opt_state_to_jax, params_from_jax,
                                        params_to_jax)
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, schedules
from repro_torch.train.steps import make_train_step

GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_blocks(monkeypatch):
    """The blockwise route from 16 keys, in blocks of 8 (reference) on
    both packages: a 21-token sequence takes it with a ragged tail."""
    monkeypatch.setattr(jattn, "BLOCKWISE_MIN_KV", 16)
    monkeypatch.setattr(jattn, "BLOCK_Q", 8)
    monkeypatch.setattr(jattn, "BLOCK_KV", 8)
    monkeypatch.setattr(tattn, "BLOCKWISE_MIN_KV", 16)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _torch_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _setup(arch, remat=False, seed=0):
    """(reference model, its numpy params, the port's model)."""
    jcfg = jax_config(arch, reduced=True).replace(remat=remat)
    jm = JaxModel(jcfg, _mesh())
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
    tm = Model(_torch_cfg(jcfg), "cpu")
    load_jax_params(tm, tree)
    return jm, tree, tm


def _batch(cfg, B, S, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return out


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _tree_close(got, want, rtol, atol_frac):
    gl, gd = jax.tree_util.tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert gd == wd, (gd, wd)
    for g, w in zip(gl, wl):
        _close(g, w, rtol, atol_frac)


# -- the loss -------------------------------------------------------------

@pytest.mark.parametrize("mask", [False, True])
def test_softmax_xent_matches_reference(mask):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 200)).astype(np.float32) * 3
    logits[..., 190:] = -1e9            # pad-vocab logits
    labels = rng.integers(0, 190, (3, 9)).astype(np.int32)
    m = (rng.random((3, 9)) < 0.5).astype(np.float32) if mask else None
    want = jL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m))
    got = tL.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # bf16 logits are widened to float32 first, as in the reference
    want = jL.softmax_xent(jnp.asarray(logits, jnp.bfloat16),
                           jnp.asarray(labels))
    got = tL.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16),
                          torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- the flash backward ------------------------------------------------------

ATTN_CASES = [  # (B, Sq, Skv, H, Kv, D, causal)
    (2, 37, 37, 4, 2, 16, True),      # GQA, ragged against blocks of 8
    (1, 40, 40, 3, 1, 8, True),       # MQA, whole blocks
    (2, 24, 37, 4, 4, 16, False),     # Sq != Skv, no mask
]


def _attn_inputs(B, Sq, Skv, H, Kv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Kv, D), (B, Skv, Kv, D),
                      (B, Sq, H, D))]


def _jax_blockwise(q, k, v, causal):
    Sq, Skv = q.shape[1], k.shape[1]
    return jattn._blockwise_sdpa(None, q, k, v, jnp.arange(Sq),
                                 jnp.arange(Skv), causal, 0)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_ref_matches_flash_vjp(small_blocks, case):
    """`ref.attention_bwd_ref` from `attention_ref`'s (out, lse) against
    the reference's custom-vjp flash backward `_flash_mha_bwd`."""
    *shape, causal = case
    q, k, v, do = _attn_inputs(*shape)
    out_j, vjp = jax.vjp(lambda a, b, c: _jax_blockwise(a, b, c, causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = ref.attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    B, Sq, H, _ = q.shape
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(out.numpy(), out_j, 1e-5, 1e-5)
    got = ref.attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=causal)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5, 1e-5)
    # the heads-first layout (G query heads a kv head) is a view of it
    G = H // k.shape[2]
    if k.shape[2] == 1:
        hf = [t.transpose(1, 2).flatten(0, 1) for t in (tq, out, tdo)]
        kf, vf = tk[:, :, 0], tv[:, :, 0]
        _, lse_hf = ref.attention_ref(hf[0], kf, vf, causal=causal,
                                      return_lse=True)
        torch.testing.assert_close(lse_hf, lse.flatten(0, 1))
        dq, dk, dv = ref.attention_bwd_ref(hf[0], kf, vf, hf[1], lse_hf,
                                           hf[2], causal=causal)
        assert dq.shape == (B * G, Sq, q.shape[-1])
        torch.testing.assert_close(dq, got[0].transpose(1, 2).flatten(0, 1))
        torch.testing.assert_close(dk, got[1][:, :, 0])
        torch.testing.assert_close(dv, got[2][:, :, 0])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_function_grad_matches_jax_grad(small_blocks, case):
    """`ops.flash_attention` on CPU tensors that require grad runs the
    autograd Function (plain forward with lse, plain backward):
    d/d(q, k, v) of sum(out * w) against jax.grad of the same through
    the reference's blockwise attention."""
    *shape, causal = case
    q, k, v, w = _attn_inputs(*shape, seed=3)

    def jloss(a, b, c):
        return jnp.sum(_jax_blockwise(a, b, c, causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, wnt in zip(got, want):
        _close(g.numpy(), wnt, 1e-5, 1e-5)
    # without grad the plain forward runs, with the same output
    with torch.no_grad():
        torch.testing.assert_close(ops.flash_attention(tq, tk, tv,
                                                       causal=causal), out)


# -- the model's loss and gradients -----------------------------------------

def _port_loss_and_grads(tm, batch):
    params = {k: p.detach().requires_grad_(True)
              for k, p in tm.named_parameters()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = torch.func.functional_call(tm, params, (tb,))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


@pytest.mark.parametrize("arch,route,mask", [
    ("qwen2-0.5b", "dense", False),
    ("qwen2-0.5b", "blockwise", True),
    ("yi-6b", "dense", True),
    ("yi-6b", "blockwise", False),
])
def test_loss_and_grads_match_value_and_grad(request, arch, route, mask):
    """`Model.loss_fn` and the gradient of every parameter against
    `jax.value_and_grad(model.loss_fn)`; the blockwise route (21 tokens
    over blocks of 8) with remat on in both packages."""
    if route == "blockwise":
        request.getfixturevalue("small_blocks")
    jm, tree, tm = _setup(arch, remat=route == "blockwise")
    batch = _batch(jm.cfg, 2, 21 if route == "blockwise" else 13, mask=mask)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ops.reset_launch_counts()
    loss, grads = _port_loss_and_grads(tm, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(dict(tm.named_parameters()))
    _tree_close(params_to_jax(tm.cfg, grads),
                jax.tree.map(np.asarray, jgrads), GRAD_RTOL, GRAD_RTOL)


def test_remat_recomputes_each_layer_in_the_backward(small_blocks,
                                                     monkeypatch):
    """With remat each layer's forward runs twice a step, so the flash
    Function's forward runs 2 x n_layers times and its backward
    n_layers times; without remat once each."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops._flash_forward, ops.flash_attention_bwd

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ops, "_flash_forward", count_fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", count_bwd)
    for remat, want in ((True, 2), (False, 1)):
        calls.update(fwd=0, bwd=0)
        jm, _, tm = _setup("qwen2-0.5b", remat=remat)
        _port_loss_and_grads(tm, _batch(jm.cfg, 1, 20))
        L = jm.cfg.n_layers
        assert calls == {"fwd": want * L, "bwd": L}, (remat, calls)


# -- one train step ------------------------------------------------------------

def _carry(tree, cfg_kw, rng):
    """A non-trivial AdamW state over `tree` (step 3, moments of a few
    steps' size, the master copy when kept), numpy."""
    def like(scale, positive=False):
        def f(a):
            x = scale * rng.standard_normal(a.shape).astype(np.float32)
            return np.abs(x) if positive else x
        return jax.tree.map(f, tree)

    master = (jax.tree.map(lambda a: a.astype(np.float32), tree)
              if cfg_kw["keep_master"] else None)
    return jadamw.AdamWState(np.asarray(3, np.int32), like(1e-2),
                             like(1e-4, positive=True), master)


@pytest.mark.parametrize("keep_master", [False, True])
def test_train_step_matches_reference_from_a_shared_carry(keep_master):
    jm, tree, tm = _setup("qwen2-0.5b")
    cfg_kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0,
                  keep_master=keep_master)
    rng = np.random.default_rng(7)
    jopt = _carry(tree, cfg_kw, rng)
    batch = _batch(jm.cfg, 2, 13, seed=4)
    jstep, _, _ = jax_train_step(jm, jadamw.AdamWConfig(**cfg_kw),
                                 jsched.linear_warmup_cosine(1e-2, 2, 10))
    jp, js, jmet = jstep(jax.tree.map(jnp.asarray, tree),
                         jax.tree.map(jnp.asarray, jopt),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tm.cfg
    step = make_train_step(tm, adamw.AdamWConfig(**cfg_kw),
                           schedules.linear_warmup_cosine(1e-2, 2, 10))
    params = params_from_jax(cfg, tree)
    opt = opt_state_from_jax(cfg, jopt)
    tp, ts, tmet = step(params, opt,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=STEP_RTOL)
    _tree_close(params_to_jax(cfg, tp), jax.tree.map(np.asarray, jp),
                STEP_RTOL, 1e-6)
    fields = opt_state_to_jax(cfg, ts)
    assert int(fields[0]) == int(js.step) == 4
    _tree_close(fields[1], jax.tree.map(np.asarray, js.mu), STEP_RTOL, 1e-6)
    _tree_close(fields[2], jax.tree.map(np.asarray, js.nu), STEP_RTOL, 1e-6)
    if keep_master:
        _tree_close(fields[3], jax.tree.map(np.asarray, js.master),
                    STEP_RTOL, 1e-6)
    else:
        assert fields[3] is None and js.master is None


def test_train_step_changes_none_of_its_inputs():
    _, tree, tm = _setup("qwen2-0.5b")
    cfg = adamw.AdamWConfig(lr=1e-2, keep_master=True)
    step = make_train_step(tm, cfg)
    params = params_from_jax(tm.cfg, tree)
    opt = adamw.adamw_init(params, cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tm.cfg, 2, 9).items()}
    params, opt, _ = step(params, opt, batch)      # moments non-zero now
    own = {k: p.clone() for k, p in tm.named_parameters()}
    snap = [t.clone() for t in (*params.values(), *opt.mu.values(),
                                *opt.nu.values(), *opt.master.values(),
                                opt.step, *batch.values())]
    new_params, new_opt, _ = step(params, opt, batch)
    after = [*params.values(), *opt.mu.values(), *opt.nu.values(),
             *opt.master.values(), opt.step, *batch.values()]
    assert all(torch.equal(a, b) for a, b in zip(snap, after))
    assert all(not p.requires_grad for p in params.values())
    assert all(torch.equal(p, own[k]) for k, p in tm.named_parameters())
    assert int(new_opt.step) == 2 and int(opt.step) == 1
    assert any(not torch.equal(new_params[k], params[k]) for k in params)


def test_convert_round_trips_params_and_opt_state():
    _, tree, tm = _setup("yi-6b")
    cfg = tm.cfg
    back = params_to_jax(cfg, params_from_jax(cfg, tree))
    _tree_close(back, tree, 0, 0)
    jopt = _carry(tree, {"keep_master": True}, np.random.default_rng(2))
    fields = opt_state_to_jax(cfg, opt_state_from_jax(cfg, jopt))
    assert int(fields[0]) == 3
    for got, want in zip(fields[1:], tuple(jopt)[1:]):
        _tree_close(got, want, 0, 0)
