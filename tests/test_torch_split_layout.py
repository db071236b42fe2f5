"""The compute layout of a rank along "model" (`models.sharding`'s
compute half), in this process: which q and kv heads a rank's block of
the heads reads, the fused `wqkv`'s rows of them, mamba's `in_proj`
columns of a block of channels (at M = 2 rank 0 stores all of x), the
RG-LRU's `w_a` split on its rows only, the embedding's vocabulary block
at a rank's offset with the pad mask, and the vocab-parallel
`layers.softmax_xent` against the whole-vocabulary one (float32, rtol
XENT_RTOL, with a mask and with `total`). The collectives are stubbed
(`_Stub`): over a world of 1, or as one rank of two whose partners'
shares are zero (the embedding's rows of one rank). Two gloo ranks hold
the same pieces in tests/test_torch_train_split.py.
"""
import numpy as np
import pytest
import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.attention import Attention
from repro_torch.models.decls import init_params

XENT_RTOL = 1e-6
TWO = {"data": 1, "model": 2}


class _Stub:
    """A `sharding.Split` whose collectives are the identity: rank `index`
    of `size`, its partners contributing nothing; its own `mesh`, whose
    `pmax_ordered` is the identity too."""

    def __init__(self, index=0, size=1):
        self.index, self.size = index, size
        self.mesh, self.axes = self, ("model",)

    def block(self, n):
        return self.index * n

    def enter(self, x):
        return x

    leave = enter

    def pmax_ordered(self, x, axes):
        return x

    def gather(self, t, dim, partial=True):
        return t


@pytest.mark.parametrize("H,Kv,lo,n,want", [
    (14, 2, 7, 7, (1, 1)),          # qwen2-0.5b at M = 2: G 7
    (10, 1, 5, 5, (0, 1)),          # recurrentgemma-2b: one kv head, G 5
    (32, 8, 16, 16, (4, 4)),        # pixtral-12b: G 4
    (16, 16, 8, 8, (8, 8)),         # deepseek-moe-16b: G 1
    (12, 3, 0, 6, [0, 0, 0, 0, 1, 1]),   # groups that do not divide
])
def test_kv_heads_of_a_block_of_heads(H, Kv, lo, n, want):
    assert sh.kv_heads_of(H, Kv, lo, n) == want


def test_fused_wqkv_rows_are_the_ranks_q_heads_and_their_kv_heads():
    cfg = get_config("pixtral-12b", reduced=True).replace(
        dtype="float32", fused_qkv=True, qkv_bias=True)
    H, Kv = cfg.eff_heads, cfg.eff_kv_heads          # 4 over 2
    att = Attention(cfg, "cpu")
    init_params(att, torch.Generator().manual_seed(0))
    with torch.no_grad():
        att.bqkv.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    q, k, v = att.project_qkv(x)
    # the fused dim (H + 2 Kv = 8) over 2 ranks: rank 0 stores q heads
    # 0-3, rank 1 all of k and v; rank 1 computes q heads 2, 3 and kv 1
    assert sh.restrict(sh.resolve_spec(att.wqkv.shape, att.axes["wqkv"],
                                       sh.default_rules(), TWO),
                       ("model",)) == (None, "model")
    rows = sh.qkv_rows(H, Kv, 2, 2)
    assert rows == [2, 3, H + 1, H + Kv + 1]
    out = att._project(x, att.wqkv[:, rows], att.bqkv[rows])
    assert torch.equal(out[..., :2, :], q[..., 2:, :])
    assert torch.equal(out[..., 2:3, :], k[..., 1:, :])
    assert torch.equal(out[..., 3:, :], v[..., 1:, :])


def test_in_proj_columns_of_a_block_of_channels():
    cfg = get_config("falcon-mamba-7b", reduced=True)
    Di = cfg.ssm.expand * cfg.d_model
    # stored: rank 0 the first Di columns (all of x), rank 1 all of z
    spec = sh.resolve_spec((cfg.d_model, 2 * Di), ("embed", "ssm_inner"),
                           sh.default_rules(), TWO)
    assert sh.restrict(spec, ("model",)) == (None, "model")
    cx, cz = sh.in_proj_columns(Di, Di // 2, Di // 2)     # rank 1's
    assert (cx, cz) == (slice(Di // 2, Di), slice(Di + Di // 2, 2 * Di))
    cols = torch.arange(2 * Di)
    assert torch.equal(torch.cat([cols[cx], cols[cz]]),
                       torch.cat([cols[Di // 2:Di], cols[-(Di // 2):]]))


def test_rglru_gate_weights_split_on_their_rows_only():
    W = 2560
    assert sh.resolve_spec((W, W), ("lru", "lru"), sh.default_rules(),
                           TWO) == ("model",)


@pytest.mark.parametrize("tied", [True, False])
def test_vocab_block_at_the_ranks_offset_with_the_pad_mask(tied):
    cfg = get_config("whisper-small", reduced=True)
    # 6 pad rows, all in rank 1's half
    cfg = cfg.replace(dtype="float32", tie_embeddings=tied,
                      vocab_size=cfg.padded_vocab - 6)
    emb = L.Embed(cfg, "cpu")
    init_params(emb, torch.Generator().manual_seed(0))
    Vp = cfg.padded_vocab
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    tokens = torch.tensor([[0, Vp // 2 - 1, Vp // 2],
                           [Vp - 7, 5, Vp // 2 + 3]])
    whole_logits = emb.apply_unembed(x)
    whole_rows = emb.apply_embed(tokens)
    # rank 1 of 2: the second half of the rows, logits at offset Vp / 2
    half = Vp // 2
    emb.embedding = nn.Parameter(emb.embedding[half:].clone(),
                                 requires_grad=False)
    if not tied:
        emb.unembed = nn.Parameter(emb.unembed[:, half:].clone(),
                                   requires_grad=False)
    emb.split = _Stub(index=1, size=2)
    got = emb.apply_unembed(x)
    assert got.shape[-1] == half
    assert torch.equal(got, whole_logits[..., half:])
    assert (got[..., -6:] < -1e8).all() and (got[..., :-6] > -1e8).all()
    rows = emb.apply_embed(tokens)
    mine = tokens >= half
    assert torch.equal(rows[mine], whole_rows[mine])
    assert not rows[~mine].any()


@pytest.mark.parametrize("kw", ["plain", "mask", "mask and total"])
def test_vocab_parallel_xent_over_a_world_of_one(kw):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 7, 96, generator=g) * 4
    labels = torch.randint(0, 96, (3, 7), generator=g)
    mask = (torch.rand(3, 7, generator=g) > 0.3).float()
    args = {"plain": {}, "mask": {"mask": mask},
            "mask and total": {"mask": mask, "total": torch.tensor(11.0)}}[kw]
    whole = logits.clone().requires_grad_(True)
    want = L.softmax_xent(whole, labels, **args)
    (gw,) = torch.autograd.grad(want, whole)
    split = logits.clone().requires_grad_(True)
    got = L.softmax_xent(split, labels, split=_Stub(), **args)
    (gs,) = torch.autograd.grad(got, split)
    np.testing.assert_allclose(got.item(), want.item(), rtol=XENT_RTOL)
    np.testing.assert_allclose(gs.numpy(), gw.numpy(), rtol=XENT_RTOL,
                               atol=XENT_RTOL * float(gw.abs().max()))
