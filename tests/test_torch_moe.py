"""The port's moe family (`models/moe.py`, the MoE layers of
`models/transformer.py`, their caches in `models/decode.py`) against the
JAX package's, on the CPU.

Reduced deepseek-moe-16b (8 experts top-2, 2 shared experts, a dense
first layer) and grok-1-314b (4 experts top-2, no shared experts, no
dense layer), float32. The reference's `init_params` weights, with the
norm scales perturbed, are carried into the port with `params_from_jax`;
inputs are made from a seed with numpy. Each reference model is built
once (module scope). Tolerances as `tests/torch_lm_parity.py` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.utils.params import param_count
from torch_lm_parity import (DECODE_TOL, RULES, close,
                             decode_continues_prefill, layer, mesh,
                             serve_both, setup, t, x)

MOE = ["deepseek-moe-16b", "grok-1-314b"]
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch):
    if arch not in _CACHE:
        _CACHE[arch] = setup(jax_config(arch, reduced=True),
                             get_config(arch, reduced=True),
                             perturbed=("scale",))
    return _CACHE[arch]


def _with_capacity(cfg, cf):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# -- one layer --------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_apply_moe(arch):
    jm, tree, tm = models(arch)
    xs = x((2, 16, jm.cfg.d_model))
    want = jmoe.apply_moe(jm.cfg, layer(tree)["moe"], jnp.asarray(xs),
                          jm.mesh, RULES)
    close(tmoe.apply_moe(tm.cfg, tm.layers[0].moe, t(xs)), want)


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_dense(arch):
    jm, tree, tm = models(arch)
    xs = x((3, 1, jm.cfg.d_model), seed=2)
    want = jmoe.apply_moe_dense(jm.cfg, layer(tree, 1)["moe"],
                                jnp.asarray(xs))
    close(tmoe.apply_moe_dense(tm.cfg, tm.layers[1].moe, t(xs)), want)


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_dense_bf16_keeps_float32_accumulators(arch, monkeypatch):
    """In bf16 the expert products keep float32 accumulators, as the
    reference's (preferred_element_type=float32) do: one layer's routed
    experts (the shared ones left out: their bf16 matmuls round as each
    library does) agree with the reference's within one bf16 ulp, and
    nearly every element is bit-equal. Rounding each expert product to
    bf16 first moves over half the elements. XLA:CPU has no bf16 x bf16
    = float32 dot, so the reference's einsums get their inputs widened,
    which is exact, and keep their float32 accumulation."""
    jm, tree, tm = models(arch)
    einsum = jnp.einsum

    def widened(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [jnp.asarray(o).astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=
                      preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", widened)

    def routed_only(cfg):
        return cfg.replace(dtype="bfloat16", moe=dataclasses.replace(
            cfg.moe, n_shared=0))

    jp = {k: a if k == "router" else jnp.asarray(a).astype(jnp.bfloat16)
          for k, a in layer(tree, 1)["moe"].items() if k != "shared"}
    tcfg = routed_only(tm.cfg)
    m = tmoe.MoE(tcfg, "cpu")
    m.load_state_dict({k: v for k, v in tm.layers[1].moe.state_dict().items()
                       if not k.startswith("shared.")}, strict=True)
    assert m.router.dtype == torch.float32
    assert m.w_gate.dtype == torch.bfloat16
    for seed in (2, 3, 4):
        xs = jnp.asarray(x((3, 1, jm.cfg.d_model), seed=seed)).astype(
            jnp.bfloat16)
        want = np.asarray(jmoe.apply_moe_dense(routed_only(jm.cfg), jp, xs)
                          .astype(jnp.float32))
        got = tmoe.apply_moe_dense(tcfg, m, t(xs.astype(
            jnp.float32)).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
        assert np.mean(got != want) <= 0.05, np.mean(got != want)


@pytest.mark.parametrize("arch", MOE)
def test_tokens_past_capacity_drop_where_the_reference_drops_them(arch):
    """capacity_factor 0.5 at T = 128 (batch 2 x 64): the queues overflow.
    The dropped (token, expert) pairs are those a numpy replay of the
    reference's routing drops (stable sort by expert, position >= cap),
    and the layer's output agrees with the reference's."""
    jm, tree, tm = models(arch)
    jcfg = _with_capacity(jm.cfg, 0.5)
    tcfg = _with_capacity(tm.cfg, 0.5)
    p = layer(tree)["moe"]
    xs = x((2, 64, jcfg.d_model), seed=4)
    T, K, E = 128, jcfg.moe.top_k, jcfg.moe.n_experts
    cap = max(8, -(-int(0.5 * T * K / E) // 8) * 8)
    # the reference's routing, replayed in numpy
    logits = jnp.asarray(xs.reshape(T, -1)) @ p["router"]
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    ids = np.asarray(ids)
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    pos = np.empty(T * K, np.int64)
    pos[order] = np.arange(T * K) - np.searchsorted(flat[order], flat[order])
    want_dropped = sorted(zip(*np.nonzero(pos.reshape(T, K) >= cap)))
    want_dropped = sorted((int(i), int(ids[i, k])) for i, k in want_dropped)
    # the port's
    _, tids = tmoe.route(tcfg, tm.layers[0].moe.router, t(xs.reshape(T, -1)))
    dp = tmoe.dispatch(tcfg, tids)
    assert dp.cap == tmoe.capacity(tcfg, T) == cap
    drop = (~dp.keep).reshape(T, K).numpy()
    got_dropped = sorted((int(i), int(tids[i, k]))
                         for i, k in zip(*np.nonzero(drop)))
    assert len(got_dropped) > 0.1 * T * K
    assert got_dropped == want_dropped
    want = jmoe.apply_moe(jcfg, p, jnp.asarray(xs), jm.mesh, RULES)
    close(tmoe.apply_moe(tcfg, tm.layers[0].moe, t(xs)), want)


def test_dispatch_fills_slots_in_token_order():
    """A hand-made routing: 3 tokens top-2 over 2 experts at capacity
    factor 1, cap 8 (the floor; int(1 * 3 * 2 / 2) = 3): expert 0's slots
    read tokens 0, 1, 2, expert 1's the same, the rest of the slots the
    zero row (T); nothing dropped."""
    cfg = get_config("grok-1-314b", reduced=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=2,
                                              capacity_factor=1.0))
    ids = torch.tensor([[0, 1], [1, 0], [0, 1]])
    dp = tmoe.dispatch(cfg, ids)
    assert dp.cap == 8
    assert dp.src[:, :3].tolist() == [[0, 1, 2], [0, 1, 2]]
    assert torch.all(dp.src[:, 3:] == 3)
    assert dp.keep.all()
    assert dp.slot.tolist() == [0, 8, 9, 1, 2, 10]


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_logits_and_loss(arch):
    jm, tree, tm = models(arch)
    V = jm.cfg.vocab_size
    rng = np.random.default_rng(6)
    toks = rng.integers(0, V, (2, 24))
    labels = rng.integers(0, V, (2, 24))
    close(tm.logits(t(toks)), jm.logits(tree, {"tokens": jnp.asarray(toks)}))
    want = jm.loss_fn(tree, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
    got = tm.loss_fn({"tokens": t(toks), "labels": t(labels)})
    close(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    jm, tree, tm = models(arch)
    keys = [("kv", "k"), ("kv", "v")]
    if jm.cfg.moe.first_layer_dense:
        keys += [("kv0", "k"), ("kv0", "v")]
    serve_both(jm, tree, tm, 24, keys)


@pytest.mark.parametrize("arch", MOE)
def test_decode_continues_a_longer_prefill(arch):
    _, _, tm = models(arch)
    decode_continues_prefill(tm, 20)


def test_remat_loss_and_grads_match_without_remat():
    """With cfg.remat the MoE layers (and the dense first layer) run
    checkpointed (`Model._layer`): the loss and the gradients are the
    same, the router's nonzero."""
    _, tree, tm = models("deepseek-moe-16b")
    tr = Model(tm.cfg.replace(remat=True), "cpu")
    tr.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(7)
    batch = {"tokens": t(rng.integers(0, 256, (2, 16))),
             "labels": t(rng.integers(0, 256, (2, 16)))}
    grads = {}
    for name, m in (("plain", tm), ("remat", tr)):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in m.named_parameters()}
        loss = torch.func.functional_call(m, leaves, (batch,))
        g = torch.autograd.grad(loss, list(leaves.values()))
        grads[name] = (float(loss.detach()), dict(zip(leaves, g)))
    assert grads["plain"][0] == pytest.approx(grads["remat"][0], rel=1e-6)
    for k, g in grads["plain"][1].items():
        close(grads["remat"][1][k], g.numpy(), DECODE_TOL)
    assert float(grads["plain"][1]["layers.0.moe.router"].abs().sum()) > 0


# -- parameters -------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_params_round_trip_keeps_the_router_float32(arch):
    """In a bf16 model the router stays float32 both ways, bit for bit,
    and layer0 is not stacked."""
    jcfg = jax_config(arch, reduced=True).replace(dtype="bfloat16")
    tcfg = get_config(arch, reduced=True).replace(dtype="bfloat16")
    # the float32 weights in the reference's declared dtypes for bf16
    _, tree32, _ = models(arch)
    tree = jax.tree.map(lambda a, spec: np.asarray(jnp.asarray(
        a).astype(spec.dtype)), tree32,
        JaxModel(jcfg, mesh()).abstract_params())
    assert tree["layers"]["moe"]["router"].dtype == np.float32
    state = params_from_jax(tcfg, tree)
    assert state["layers.0.moe.router"].dtype == torch.float32
    assert state["layers.0.moe.w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["layers.1.moe.router"].numpy(),
                                  tree["layers"]["moe"]["router"][1])
    m = Model(tcfg, "cpu")
    m.load_state_dict(state, strict=True)
    back = params_to_jax(tcfg, state)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(a, np.asarray(flat_b[path], np.float32))
    assert ("layer0" in back) == jcfg.moe.first_layer_dense
    assert back["layers"]["moe"]["router"].shape[0] == len(m.layers)


@pytest.mark.parametrize("arch", MOE)
def test_param_count_matches_the_model(arch):
    """At full width on the meta device: the analytic count is the
    model's; deepseek-moe-16b has 16.38 B parameters."""
    cfg = get_config(arch)
    model = Model(cfg, "meta")
    assert cfg.padded_vocab == cfg.vocab_size
    assert sum(p.numel() for p in model.parameters()) == param_count(cfg)
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.w_up.dtype == torch.bfloat16
    if arch == "deepseek-moe-16b":
        assert 16.3e9 < param_count(cfg) < 16.4e9
        assert model.layer0.mlp.w_up.shape == (2048, 10944)
        assert model.layers[0].moe.shared.w_down.shape == (2816, 2048)
        assert len(model.layers) == 27


def test_init_draws_every_expert_weight():
    cfg = get_config("deepseek-moe-16b", reduced=True)
    m = Model(cfg, "cpu")
    init_params(m, torch.Generator().manual_seed(0))
    moe = m.layers[0].moe
    E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
    assert abs(float(moe.w_gate.std()) - E ** -0.5) < 0.02
    assert abs(float(moe.w_down.std()) - F ** -0.5) < 0.02
    assert abs(float(moe.router.std()) - cfg.d_model ** -0.5) < 0.02


def test_cache_layout():
    m = Model(get_config("deepseek-moe-16b", reduced=True), "meta")
    cache = tdec.init_cache(m, batch=3, max_len=40)
    assert cache["kv"]["k"].shape == (2, 3, 40, 4, 16)
    assert cache["kv0"]["v"].shape == (1, 3, 40, 4, 16)
    assert cache["length"] == 0
    m = Model(get_config("grok-1-314b", reduced=True), "meta")
    assert "kv0" not in tdec.init_cache(m, batch=1, max_len=8)
