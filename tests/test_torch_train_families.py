"""Training of the moe, ssm, hybrid, vlm and encdec families in the port
against the JAX package's, on the CPU.

Reduced deepseek-moe-16b (a dense first layer, shared experts), grok-1-314b
(no shared experts), falcon-mamba-7b, recurrentgemma-2b (two (rec, rec,
attn) triples' worth: one triple and two tail rec layers, window 16),
pixtral-12b (8 patch embeddings ahead of the tokens) and whisper-small (16
encoder frames), float32, on a (1, 1) Auto-axes mesh for the reference
(jax 0.9's default Explicit axes make `Model._constrain` raise). Weights
are the reference's `init_params` with norm scales and biases perturbed,
carried into the port with `models.convert`; batches are
`data.tokens.TokenPipeline`'s (numpy, bit-equal to the reference's), so
vlm's carry its patches and `loss_mask` and encdec's its frames.

Checked, for each arch: `Model.loss_fn` and the gradient of every
parameter against `jax.value_and_grad(model.loss_fn)`, on the dense
attention route without remat, and on the blockwise route (blocks of 8
from 16 keys in both packages) with remat on, where the hybrid's window
of 16 is shorter than the 37-token sequence and whisper's cross-attention
over 16 frames is blockwise too; moe with a capacity factor of 1, low
enough that tokens drop; one `make_train_step` step from a shared carry
(params and a non-trivial AdamW state) against the reference's
`train_step`, for the new params, moments, step and metrics.

Tolerances (float32 sums in another order): loss rtol 1e-5; gradients
rtol 1e-4 with atol 1e-4 x the leaf's largest entry, as
`tests/test_torch_train.py` holds the dense family's, but the key
biases': their gradient is 0 in exact arithmetic (a query row's scores
all shift by q . bk, which the softmax ignores), so both packages' are
held to atol 1e-4 x the model's largest gradient entry; the step's
moments and metrics rtol 1e-5 (moments with atol 1e-6 x the leaf's
largest entry), its new params rtol 1e-5 with atol 1e-5 x the leaf's
largest entry: Adam divides a gradient's error by sqrt(nu), and an entry
with a small gradient and a small nu (deepseek's first norm scale, whose
gradient sums over the MoE layers' gathers in another order) carries
2e-6 x its leaf's largest entry into the step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models.transformer import Model as JaxModel
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train.steps import make_train_step as jax_train_step
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (load_jax_params, opt_state_from_jax,
                                        opt_state_to_jax, params_from_jax,
                                        params_to_jax)
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, schedules
from repro_torch.train.steps import make_train_step

GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
ARCHS = ["deepseek-moe-16b", "grok-1-314b", "falcon-mamba-7b",
         "recurrentgemma-2b", "pixtral-12b", "whisper-small"]
SHORT, LONG = 13, 37          # the dense route; the blockwise one


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(jattn, "BLOCKWISE_MIN_KV", 16)
    monkeypatch.setattr(jattn, "BLOCK_Q", 8)
    monkeypatch.setattr(jattn, "BLOCK_KV", 8)
    monkeypatch.setattr(tattn, "BLOCKWISE_MIN_KV", 16)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _configs(arch, remat, capacity=None):
    jcfg = jax_config(arch, reduced=True).replace(remat=remat)
    tcfg = get_config(arch, reduced=True).replace(remat=remat)
    if capacity is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity))
        tcfg = tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity))
    return jcfg, tcfg


_MODELS = {}


def _setup(arch, remat=False, capacity=None, seed=0):
    """(reference model, its numpy params, the port's model), built once
    a file (neither package's model changes under a step)."""
    key = (arch, remat, capacity, seed)
    if key not in _MODELS:
        _MODELS[key] = _build(arch, remat, capacity, seed)
    return _MODELS[key]


def _build(arch, remat, capacity, seed):
    jcfg, tcfg = _configs(arch, remat, capacity)
    jm = JaxModel(jcfg, _mesh())
    tree = jax.tree.map(np.asarray,
                        jax.jit(jm.init_params)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1].key)
        if name == "scale":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name in ("bq", "bk", "bv", "bo", "b_in", "b_out", "b1", "b2"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    tm = Model(tcfg, "cpu")
    load_jax_params(tm, tree)
    return jm, tree, tm


def _batch(cfg, S, seed=1, B=2):
    return TokenPipeline(cfg, B, S, seed=seed).batch_at(0)


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = atol_frac * max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _tree_close(got, want, rtol, atol_frac, zero=()):
    """Leaf by leaf; a leaf named in `zero` (0 in exact arithmetic) with
    atol atol_frac x the largest entry of the whole tree."""
    gl, gd = jax.tree_util.tree_flatten(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert gd == jax.tree_util.tree_structure(want)
    top = max(float(np.max(np.abs(w))) for _, w in wl)
    for g, (path, w) in zip(gl, wl):
        try:
            if str(path[-1].key) in zero:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=atol_frac * top)
            else:
                _close(g, w, rtol, atol_frac)
        except AssertionError as e:
            raise AssertionError(f"{jax.tree_util.keystr(path)}: {e}")


def _port_loss_and_grads(tm, batch):
    params = {k: p.detach().requires_grad_(True)
              for k, p in tm.named_parameters()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = torch.func.functional_call(tm, params, (tb,))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


def _check_loss_and_grads(jm, tree, tm, batch):
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(tm, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(dict(tm.named_parameters()))
    _tree_close(params_to_jax(tm.cfg, grads),
                jax.tree.map(np.asarray, jgrads), GRAD_RTOL, GRAD_RTOL,
                zero=("bk",))
    return grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad_dense_route(arch):
    jm, tree, tm = _setup(arch)
    batch = _batch(jm.cfg, SHORT)
    if arch == "pixtral-12b":
        assert batch["loss_mask"][:, :jm.cfg.vlm.n_patches].sum() == 0
    grads = _check_loss_and_grads(jm, tree, tm, batch)
    # every parameter takes part: none of the gradients is all zero
    # (grok's and deepseek's experts are all routed to at this size)
    dead = [k for k, g in grads.items() if not bool(g.abs().sum() > 0)]
    assert dead == [], dead


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_value_and_grad_blockwise_remat(small_blocks,
                                                              arch):
    """The blockwise route (the hybrid's window of 16 shorter than the
    sequence; whisper's encoder and cross-attention over 16 frames
    blockwise too) with each layer checkpointed (`Model._layer`)."""
    jm, tree, tm = _setup(arch, remat=True)
    cfg = jm.cfg
    if cfg.family == "hybrid":
        assert 0 < cfg.hybrid.window < LONG
    _check_loss_and_grads(jm, tree, tm, _batch(cfg, LONG, seed=2))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_moe_grads_match_with_dropped_tokens(arch, monkeypatch):
    """A capacity factor of 1: some (token, expert) pairs overflow their
    expert's capacity and are dropped, in both packages alike."""
    jm, tree, tm = _setup(arch, capacity=1.0)
    kept = []
    real = tmoe.dispatch

    def recorded(cfg, ids):
        out = real(cfg, ids)
        kept.append(bool(out.keep.all()))
        return out

    monkeypatch.setattr(tmoe, "dispatch", recorded)
    _check_loss_and_grads(jm, tree, tm, _batch(jm.cfg, LONG, seed=5))
    assert kept and not all(kept), kept


def _carry(tree, keep_master, rng):
    """A non-trivial AdamW state over `tree` (step 3, moments of a few
    steps' size, the master copy when kept), numpy."""
    def like(scale, positive=False):
        def f(a):
            x = scale * rng.standard_normal(a.shape).astype(np.float32)
            return np.abs(x) if positive else x
        return jax.tree.map(f, tree)

    master = (jax.tree.map(lambda a: a.astype(np.float32), tree)
              if keep_master else None)
    return jadamw.AdamWState(np.asarray(3, np.int32), like(1e-2),
                             like(1e-4, positive=True), master)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_from_a_shared_carry(arch):
    jm, tree, tm = _setup(arch)
    cfg_kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0,
                  keep_master=arch == "recurrentgemma-2b")
    jopt = _carry(tree, cfg_kw["keep_master"], np.random.default_rng(7))
    batch = _batch(jm.cfg, SHORT, seed=4)
    jstep, _, _ = jax_train_step(jm, jadamw.AdamWConfig(**cfg_kw),
                                 jsched.linear_warmup_cosine(1e-2, 2, 10))
    jp, js, jmet = jax.jit(jstep)(jax.tree.map(jnp.asarray, tree),
                         jax.tree.map(jnp.asarray, jopt),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = tm.cfg
    step = make_train_step(tm, adamw.AdamWConfig(**cfg_kw),
                           schedules.linear_warmup_cosine(1e-2, 2, 10))
    tp, ts, tmet = step(params_from_jax(cfg, tree),
                        opt_state_from_jax(cfg, jopt),
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=STEP_RTOL)
    _tree_close(params_to_jax(cfg, tp), jax.tree.map(np.asarray, jp),
                STEP_RTOL, 1e-5)
    fields = opt_state_to_jax(cfg, ts)
    assert int(fields[0]) == int(js.step) == 4
    _tree_close(fields[1], jax.tree.map(np.asarray, js.mu), STEP_RTOL, 1e-6)
    _tree_close(fields[2], jax.tree.map(np.asarray, js.nu), STEP_RTOL, 1e-6)
    if cfg_kw["keep_master"]:
        _tree_close(fields[3], jax.tree.map(np.asarray, js.master),
                    STEP_RTOL, 1e-6)
    # the float32 leaves stay float32 through the step
    declared = {k: p.dtype for k, p in tm.named_parameters()}
    assert all(tp[k].dtype == declared[k] for k in tp)
