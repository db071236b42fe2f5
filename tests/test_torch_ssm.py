"""The port's ssm family (`models/ssm.py`, `SSMLayer` in
`models/transformer.py`, its cache in `models/decode.py`) against the JAX
package's, on the CPU.

Reduced falcon-mamba-7b (2 layers, d 64, d_inner 128, d_state 4, conv
4), float32. The reference's `init_params` weights, with the norm scales,
the conv and dt biases, A_log and D perturbed, are carried into the port
with `params_from_jax`; inputs are made from a seed with numpy. The
reference model is built once (module scope). Tolerances as
`tests/torch_lm_parity.py` states.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import decode as tdec
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.decls import init_params
from repro_torch.models.transformer import Model
from repro_torch.utils.params import param_count
from torch_lm_parity import (DECODE_TOL, close, decode_continues_prefill,
                             layer, serve_both, setup, t, x)

ARCH = "falcon-mamba-7b"
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
                            perturbed=("scale", "conv_b", "dt_bias", "A_log",
                                       "D"))
    return _CACHE["m"]


def _state(cfg, B, seed):
    """A nonzero carried state, as numpy: (h, conv)."""
    Di, _, N, Kc = tssm._dims(cfg)
    return x((B, Di, N), seed), x((B, Kc - 1, Di), seed + 1)


def test_chunk_size_and_dims_are_the_reference_s():
    cfg = get_config(ARCH)
    assert tssm._dims(cfg) == jssm._dims(jax_config(ARCH)) == \
        (8192, 256, 16, 4)
    for S in (1, 7, 256, 300, 1024, 1025, 4096):
        assert tssm._chunk_size(S) == jssm._chunk_size(S)
    assert tssm._chunk_size(300) == 150


def test_scan_is_the_recurrence():
    """The Hillis-Steele scan against the sequential recurrence, at
    lengths that are and are not powers of two."""
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 5, 8, 13):
        a = torch.rand((2, n, 3, 2), generator=g)
        b = torch.randn((2, n, 3, 2), generator=g)
        h, want = torch.zeros_like(b[:, 0]), []
        for i in range(n):
            h = a[:, i] * h + b[:, i]
            want.append(h)
        close(tssm._scan(a, b), torch.stack(want, 1).numpy())


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_core(with_h0):
    """S 300: two chunks of 150, h carried across them."""
    jm, tree, tm = models()
    cfg = jm.cfg
    Di = tssm._dims(cfg)[0]
    xb = x((2, 300, Di), seed=3)
    h0 = _state(cfg, 2, 4)[0] if with_h0 else None
    y, h = jssm._ssm_core(cfg, layer(tree)["ssm"], jnp.asarray(xb),
                          None if h0 is None else jnp.asarray(h0))
    ty, th = tssm._ssm_core(cfg, tm.layers[0].ssm, t(xb),
                            None if h0 is None else t(h0))
    close(ty, y)
    close(th, h)
    assert th.dtype == torch.float32


def test_apply_ssm_block_from_a_carried_state():
    jm, tree, tm = models()
    cfg = jm.cfg
    xs = x((2, 37, cfg.d_model), seed=5)
    h, conv = _state(cfg, 2, 6)
    out, st = jssm.apply_ssm_block(
        cfg, layer(tree, 1)["ssm"], jnp.asarray(xs),
        jssm.SSMState(jnp.asarray(h), jnp.asarray(conv), jnp.int32(5)))
    tout, tst = tssm.apply_ssm_block(cfg, tm.layers[1].ssm, t(xs),
                                     tssm.SSMState(t(h), t(conv), 5))
    close(tout, out)
    close(tst.h, st.h)
    close(tst.conv, st.conv)
    assert tst.length == int(st.length) == 42


def test_ssm_decode_step():
    jm, tree, tm = models()
    cfg = jm.cfg
    xs = x((3, 1, cfg.d_model), seed=7)
    h, conv = _state(cfg, 3, 8)
    out, st = jssm.ssm_decode_step(
        cfg, layer(tree)["ssm"], jnp.asarray(xs),
        jssm.SSMState(jnp.asarray(h), jnp.asarray(conv), jnp.int32(9)))
    tout, tst = tssm.ssm_decode_step(cfg, tm.layers[0].ssm, t(xs),
                                     tssm.SSMState(t(h), t(conv), 9))
    close(tout, out, DECODE_TOL)
    close(tst.h, st.h, DECODE_TOL)
    close(tst.conv, st.conv)
    assert tst.length == 10


def test_logits_and_loss():
    jm, tree, tm = models()
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (2, 40))
    labels = rng.integers(0, 256, (2, 40))
    close(tm.logits(t(toks)), jm.logits(tree, {"tokens": jnp.asarray(toks)}))
    want = jm.loss_fn(tree, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
    close(tm.loss_fn({"tokens": t(toks), "labels": t(labels)}), want)


def test_prefill_and_decode_match_reference():
    jm, tree, tm = models()
    serve_both(jm, tree, tm, 30, [("h",), ("conv",)])


def test_decode_continues_a_longer_prefill():
    _, _, tm = models()
    decode_continues_prefill(tm, 24)


def test_state_is_float32_and_constant_in_length():
    """The cache holds h (L, B, Di, N) float32 and the conv tail, the same
    bytes after a prompt of 8 or of 80."""
    _, _, tm = models()
    sizes = []
    for S in (8, 80):
        toks = t(np.random.default_rng(S).integers(0, 256, (2, S)))
        _, cache = tdec.prefill(tm, toks, max_len=S + 4)
        assert cache["h"].shape == (2, 2, 128, 4)
        assert cache["h"].dtype == torch.float32
        assert cache["conv"].shape == (2, 2, 3, 128)
        sizes.append(sum(c.numel() * c.element_size()
                         for c in (cache["h"], cache["conv"])))
    assert sizes[0] == sizes[1]


def test_remat_loss_matches_without_remat():
    _, _, tm = models()
    tr = Model(tm.cfg.replace(remat=True), "cpu")
    tr.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(10)
    batch = {"tokens": t(rng.integers(0, 256, (2, 16))),
             "labels": t(rng.integers(0, 256, (2, 16)))}
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in tr.named_parameters()}
    loss = torch.func.functional_call(tr, leaves, (batch,))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(tm.loss_fn(batch)),
                                                 rel=1e-6)
    assert all(torch.isfinite(g).all() for g in grads)


def test_float32_leaves_and_const_init():
    """In a bf16 model A_log and D stay float32 (declared and loaded);
    init_params fills A_log with the reference's constant 0.5."""
    cfg = get_config(ARCH, reduced=True).replace(dtype="bfloat16")
    m = Model(cfg, "cpu")
    init_params(m, torch.Generator().manual_seed(0))
    s = m.layers[0].ssm
    assert s.A_log.dtype == s.D.dtype == torch.float32
    assert s.in_proj.dtype == torch.bfloat16
    assert torch.all(s.A_log == 0.5) and torch.all(s.D == 1)
    assert torch.all(s.conv_b == 0)
    _, tree, _ = models()
    state = params_from_jax(cfg, tree)
    assert state["layers.1.ssm.A_log"].dtype == torch.float32
    np.testing.assert_array_equal(state["layers.1.ssm.A_log"].numpy(),
                                  tree["layers"]["ssm"]["A_log"][1])
    assert state["layers.1.ssm.x_proj"].dtype == torch.bfloat16


def test_param_count_matches_the_model():
    cfg = get_config(ARCH)
    model = Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(cfg) and 7.2e9 < n < 7.3e9
