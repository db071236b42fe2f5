"""`repro_torch.launch.specs` against the concrete half of
`repro.launch.specs`, for every arch: the same keys, shapes and dtypes,
tokens and labels in [0, vocab), vlm's loss_mask equal, embeddings at the
reference's scale. The values come from another generator (a
`torch.Generator`), so only their range and layout are compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as tspecs
from repro_torch.models.config import ShapeCell

DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same_layout(got, want, vocab):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == tuple(w.shape), k
        assert g.dtype == DTYPES[jnp.dtype(w.dtype)], k
        assert g.device.type == "cpu"
        if k in ("tokens", "labels"):
            assert int(g.min()) >= 0 and int(g.max()) < vocab, k
    if "loss_mask" in want:
        np.testing.assert_array_equal(got["loss_mask"].numpy(),
                                      np.asarray(want["loss_mask"]))
    for k in ("patches", "frames"):
        if k in want:
            # normal * 0.02 in both
            assert abs(float(got[k].float().std()) - 0.02) < 0.002, k
            assert abs(float(np.asarray(want[k], np.float32).std()) - 0.02) \
                < 0.002, k


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_batch_matches_reference_layout(arch, reduced):
    jcfg = jax_config(arch, reduced=reduced)
    cfg = get_config(arch, reduced=reduced)
    seq = 300 if cfg.family == "vlm" else 24
    want = jspecs.train_batch_specs(jcfg, 2, seq, concrete=True, seed=3)
    got = tspecs.train_batch_specs(cfg, 2, seq, seed=3, device="cpu")
    _same_layout(got, want, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_batch_matches_reference_layout(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    want = jspecs.decode_batch_specs(jcfg, 5, concrete=True, seed=1)
    got = tspecs.decode_batch_specs(cfg, 5, seed=1, device="cpu")
    _same_layout(got, want, cfg.vocab_size)


def test_vlm_text_is_at_least_one_token():
    """seq below n_patches: one text token, the mask all patches but it."""
    cfg = get_config("pixtral-12b", reduced=True)
    n = cfg.vlm.n_patches
    got = tspecs.train_batch_specs(cfg, 2, n - 3, device="cpu")
    assert got["tokens"].shape == (2, 1)
    assert got["labels"].shape == (2, n + 1)
    assert got["loss_mask"].sum(dim=1).tolist() == [1.0, 1.0]
    assert torch.all(got["loss_mask"][:, :n] == 0)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_input_specs_by_kind(kind):
    cell = ShapeCell("tiny", 32, 3, kind)
    for arch in ("qwen2-0.5b", "whisper-small"):
        jcfg, cfg = jax_config(arch, reduced=True), get_config(arch, True)
        want = jspecs.cell_input_specs(jcfg, cell, concrete=True)
        got = tspecs.cell_input_specs(cfg, cell, device="cpu")
        _same_layout(got, want, cfg.vocab_size)


def test_one_seed_one_batch():
    cfg = get_config("pixtral-12b", reduced=True)
    a, b, c = (tspecs.train_batch_specs(cfg, 2, 300, seed=s, device="cpu")
               for s in (0, 0, 1))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["patches"], c["patches"])


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tspecs.train_batch_specs(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tspecs.decode_batch_specs(cfg, 1)
