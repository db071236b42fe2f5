"""Host-side plans of the port's redesigned kernels, on the CPU: which K6
variant the dispatcher launches for a dtype and head dim, the
(batch, head, row) strides that K6's tensor maps are built from, and
K4a's column-tile width. The kernels themselves run only on the card
(tests/test_torch_gpu.py); here the CPU branch of each wrapper returns
the plain version and counts nothing, whatever variant is named.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

H100_SMS = 132


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "mma"), (torch.float32, 64, "f32"),
    (torch.float32, 128, "f32"), (torch.float32, 256, "f32")])
def test_flash_variant_is_fixed_by_dtype_and_head_dim(dtype, D, variant):
    assert ops.flash_variant(dtype, D) == variant
    assert D in ops.FLASH_VARIANTS[variant]


def test_every_head_dim_has_one_variant_for_each_dtype():
    for D in (64, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            chosen = ops.flash_variant(dtype, D)
            assert D in ops.FLASH_VARIANTS[chosen]


def _bshd(B, S, H, D, dtype=torch.bfloat16):
    return torch.zeros((B, S, H, D), dtype=dtype)


def test_flash_strides_of_the_model_layout():
    q, k = _bshd(2, 300, 14, 64), _bshd(2, 300, 2, 64)
    st = ops.flash_strides(q, k, k, q)
    # (batch, head, row) of q, k, v, o
    assert st == [300 * 14 * 64, 64, 14 * 64,
                  300 * 2 * 64, 64, 2 * 64,
                  300 * 2 * 64, 64, 2 * 64,
                  300 * 14 * 64, 64, 14 * 64]


def test_flash_strides_of_a_fused_projection_are_read_in_place():
    """q, k, v as views of one (B, S, H + 2 Kv, D) projection output: the
    row stride is (H + 2 Kv) D and the heads' offsets stay in the data
    pointers, so nothing is copied."""
    B, S, H, Kv, D = 2, 50, 8, 2, 128
    out = torch.zeros((B, S, H + 2 * Kv, D), dtype=torch.bfloat16)
    q, k, v = out[..., :H, :], out[..., H:H + Kv, :], out[..., H + Kv:, :]
    st = ops.flash_strides(q, k, v, torch.empty_like(q))
    row = (H + 2 * Kv) * D
    assert st[:9] == [S * row, D, row] * 3
    assert v.data_ptr() - out.data_ptr() == (H + Kv) * D * 2


def test_flash_strides_of_the_heads_first_layout():
    """(BH, S, D) with k/v (BH / G, S, D), viewed as the dispatcher views
    it: (B, S, G, D) with B = BH / G kv heads, heads G rows apart."""
    G, Bkv, S, D = 7, 2, 40, 64
    q3 = torch.zeros((Bkv * G, S, D), dtype=torch.bfloat16)
    k3 = torch.zeros((Bkv, S, D), dtype=torch.bfloat16)
    q = q3.unflatten(0, (Bkv, -1)).transpose(1, 2)
    k = k3.unsqueeze(2)
    st = ops.flash_strides(q, k, k, q)
    assert st[:3] == [G * S * D, S * D, D]
    assert st[3:6] == [S * D, D, D]


@pytest.mark.parametrize("offset,stride", [(4, None), (0, 68)])
def test_flash_strides_refuse_what_tma_cannot_read(offset, stride):
    """TMA needs 16-byte aligned bases and strides: an offset of 4 bf16
    elements, or rows 68 elements apart, are refused."""
    base = torch.zeros((4096 * 8,), dtype=torch.bfloat16)
    if stride is None:
        q = base[offset:offset + 2 * 10 * 64].view(2, 10, 1, 64)
    else:
        q = base.as_strided((2, 10, 1, 64), (10 * stride, stride, 64, 1))
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_strides(q, q, q, q)


def test_flash_attention_on_cpu_takes_the_plain_version_for_any_variant():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 33, 4, 64), (1, 33, 2, 64), (1, 33, 2, 64)))
    ops.reset_launch_counts()
    for variant in (None, "wgmma", "mma"):
        got = ops.flash_attention(q, k, v, variant=variant)
        torch.testing.assert_close(got, ref.attention_ref(q, k, v),
                                   rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention"] == 0
    assert sum(ops.flash_variant_counts().values()) == 0


@pytest.mark.parametrize("B,n,K", [(256, 20958, 8), (1, 20958, 1),
                                   (17, 300, 5), (1, 10, 1),
                                   (70, 200_000, 4), (60_000, 2000, 2),
                                   (4096, 1_000_000, 8)])
def test_dense_tile_width(B, n, K):
    width = ops.dense_tile_width(B, n, K, H100_SMS)
    assert width % 32 == 0 and 32 <= width <= 1536
    tiles = -(-n // width) * -(-B // 32)
    # about four blocks an SM, at least two (the width rounds up to 32
    # columns), unless n is too narrow or the cap binds
    assert tiles >= min(2 * H100_SMS, -(-n // 32) * -(-B // 32)) or \
        width == 32 or width == 1536
    # the partials stay within 16M floats where the width allows
    assert -(-n // width) * K * B <= (1 << 24) or width == 1536
    # staged tile and segment bounds within a block's 227 KB
    assert (32 * (width + 1) + 2 * K) * 4 <= 232_448


def test_dense_tile_width_at_the_serve_shape():
    """The serve phase's bucket on an H100: 66 column tiles of 320 x 8
    row tiles, 528 blocks, four an SM."""
    width = ops.dense_tile_width(256, 20958, 8, H100_SMS)
    assert width == 320
    assert -(-20958 // width) * 8 == 528


def _wgmma_schedule(S, H_total, D, sms=H100_SMS, causal=True, zigzag=True):
    """The K6 wgmma kernel's work plan, as flash_attention.cu lays it out:
    work tiles of 64 C query rows (C = 3 consumer warpgroups at D 64, 2 at
    D 128) x (batch * head), numbered heaviest-first, taken by
    min(tiles, SMs) persistent blocks in rounds (`tile_of`), each tile
    costing its count of 128-key tiles (`kv_tiles`). -> KV tiles a block."""
    kM, kN = 64 * (3 if D == 64 else 2), 128
    n_q = -(-S // kM)
    tiles = n_q * H_total
    grid = min(tiles, sms)
    load = [0] * grid
    for t in range(tiles):
        r, c = divmod(t, grid)
        block = grid - 1 - c if (zigzag and r % 2) else c
        q0 = (n_q - 1 - t // H_total) * kM
        n_kv = -(-S // kN)
        load[block] += min(n_kv, (q0 + kM - 1) // kN + 1) if causal else n_kv
    return load


@pytest.mark.parametrize("S,H_total,D,worst", [
    (4096, 4 * 14, 64, 1.02),      # qwen2-0.5b prefill, 4 prompts
    (2048, 32, 128, 1.04),         # yi-6b heads
    (8192, 4 * 14, 64, 1.01)])
def test_wgmma_tile_order_balances_the_blocks(S, H_total, D, worst):
    """Rounds walked in alternating directions pair each block's heavy
    causal tile with a light one: the busiest block carries at most
    `worst` times the mean (round-robin in one direction: 1.09 at the
    qwen2 prefill shape)."""
    load = _wgmma_schedule(S, H_total, D)
    mean = sum(load) / len(load)
    assert max(load) <= worst * mean
    plain = _wgmma_schedule(S, H_total, D, zigzag=False)
    assert max(plain) > max(load)
    assert sum(plain) == sum(load)


def test_wgmma_tile_order_covers_every_tile_once():
    """Every block walks tile_of(i) until it passes the tile count: the
    rounds cover each tile exactly once, the last one partial."""
    for tiles in (1, 131, 132, 133, 1232, 1300):
        grid = min(tiles, H100_SMS)
        seen = []
        for block in range(grid):
            i = 0
            while True:
                c = grid - 1 - block if i % 2 else block
                t = i * grid + c
                if t >= tiles:
                    break
                seen.append(t)
                i += 1
        assert sorted(seen) == list(range(tiles))


# -- K6b: the flash backward's variants and its two passes' work plans --------

@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt")])
def test_flash_bwd_variant_is_fixed_by_dtype_and_head_dim(dtype, D, variant):
    assert ops.flash_bwd_variant(dtype, D) == variant
    assert D in ops.FLASH_BWD_VARIANTS[variant]
    assert ops.flash_bwd_checked_variant(dtype, D) == variant


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_bwd_every_head_dim_has_one_variant_for_each_dtype(dtype, D):
    chosen = ops.flash_bwd_variant(dtype, D)
    assert D in ops.FLASH_BWD_VARIANTS[chosen]
    # float32 never reaches the tensor cores (tf32 rounding)
    assert chosen == "simt" or dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.float32, 256, "wgmma"),       # float32 stays on the CUDA cores
    (torch.float32, 64, "wgmma"),
    (torch.float32, 128, "wgmma"),
    (torch.bfloat16, 64, "mma"),         # K6's name, not K6b's
    (torch.bfloat16, 64, "f32"),
    (torch.float32, 64, "tma"),
    (torch.bfloat16, 96, "simt")])       # no kernel at D 96
def test_flash_bwd_refuses_a_variant_that_does_not_take_the_call(dtype, D,
                                                                 variant):
    with pytest.raises(ValueError, match="variant"):
        ops.flash_bwd_checked_variant(dtype, D, variant)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 256)])
def test_flash_bwd_takes_a_variant_that_fits(dtype, D):
    for variant in ops.FLASH_BWD_VARIANTS:
        fits = D in ops.FLASH_BWD_VARIANTS[variant] and \
            (variant == "simt" or dtype == torch.bfloat16)
        if fits:
            assert ops.flash_bwd_checked_variant(dtype, D, variant) == variant


@pytest.mark.parametrize("variant", [None, "wgmma", "simt"])
def test_flash_attention_bwd_on_cpu_takes_the_plain_version(variant):
    rng = np.random.default_rng(1)
    q, do = (torch.from_numpy(rng.standard_normal((1, 33, 4, 64))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 33, 2, 64))
                             .astype(np.float32)) for _ in range(2))
    out, lse = ref.attention_ref(q, k, v, return_lse=True)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, variant=variant)
    want = ref.attention_bwd_ref(q, k, v, out, lse, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert sum(ops.flash_bwd_variant_counts().values()) == 0


def _bwd_schedule(pass_, B, Sq, Skv, H, Kv, D, causal=True, zigzag=True,
                  sms=H100_SMS, window=0, splits=None):
    """K6b wgmma's work plans, as flash_attention_bwd.cu lays them out ->
    (tiles each block takes, in order; the ring steps a block).
    dQ pass (`dq_tile`): work tiles of 64 C query rows (C = 3 at D 64, 2
    at D 128, 1 at D 256, where two warpgroups split D) x (batch * head),
    heaviest-first, each costing its KV tiles of 64 keys up to the
    diagonal, and with a window from the tile of key q0 - window + 1.
    dK/dV pass (`kv_tile`): work tiles of 128 keys x (batch * kv head),
    lowest keys first, each costing G x its query tiles of 64 rows from
    the diagonal on; at D 256 (`kv_split`) 64 keys x `splits` (by default
    `ops.flash_bwd_splits`') x (batch * kv head), split c costing its
    share [c n / splits, (c + 1) n / splits) of the tile's n = G x (query
    tiles from the diagonal, and with a window up to the one holding row
    k0 + 62 + window). Both taken by min(tiles, SMs) persistent blocks in
    rounds (`tile_of`)."""
    G = H // Kv
    if pass_ == "dq":
        kM = 64 * {64: 3, 128: 2, 256: 1}[D]
        kN = 64
        n_q, n_bh, n_k = -(-Sq // kM), B * H, -(-Skv // kN)
        tiles = n_q * n_bh

        def cost(t):
            q0 = (n_q - 1 - t // n_bh) * kM
            end = min(n_k, (q0 + kM - 1) // kN + 1) if causal else n_k
            kv0 = min(max(0, q0 - window + 1) // kN, end - 1) if window \
                else 0
            return end - kv0
    elif D == 256:
        n_bkv, n_q = B * Kv, -(-Sq // 64)
        splits = ops.flash_bwd_splits("wgmma", B, Kv, Sq, Skv, H // Kv, D,
                                      causal, window, sms) \
            if splits is None else splits
        tiles = -(-Skv // 64) * n_bkv * splits

        def cost(t):
            c, k0 = (t // n_bkv) % splits, (t // n_bkv // splits) * 64
            first = min(k0 // 64, n_q) if causal else 0
            end = max(first, min(n_q, (k0 + 62 + window) // 64 + 1)) \
                if window else n_q
            n = G * (end - first)
            return (c + 1) * n // splits - c * n // splits
    else:
        n_bkv, n_q = B * Kv, -(-Sq // 64)
        tiles = -(-Skv // 128) * n_bkv

        def cost(t):
            first = min((t // n_bkv) * 128 // 64, n_q) if causal else 0
            return G * (n_q - first)
    grid = min(tiles, sms)
    taken, load = [[] for _ in range(grid)], [0] * grid
    for block in range(grid):
        i = 0
        while True:
            c = grid - 1 - block if (zigzag and i % 2) else block
            t = i * grid + c
            if t >= tiles:
                break
            taken[block].append(t)
            load[block] += cost(t)
            i += 1
    return taken, load


@pytest.mark.parametrize("pass_,tiles", [("dq", 1232), ("dkdv", 256)])
def test_flash_bwd_schedules_balance_the_blocks_at_the_train_shape(pass_,
                                                                   tiles):
    """qwen2-0.5b's train shape (B 4, S 4096, 14 heads over 2, D 64):
    rounds in alternating directions leave the busiest block at most 1.02
    times the mean (dK/dV: 448 steps against 448); round-robin in one
    direction is worse (dK/dV: 672)."""
    shape = (4, 4096, 4096, 14, 2, 64)
    taken, load = _bwd_schedule(pass_, *shape)
    assert sum(len(x) for x in taken) == tiles
    assert max(load) <= 1.02 * sum(load) / len(load)
    _, plain = _bwd_schedule(pass_, *shape, zigzag=False)
    assert max(plain) > max(load) and sum(plain) == sum(load)
    if pass_ == "dkdv":
        assert (max(load), sum(load) / len(load), max(plain)) == \
            (448, 448, 672)


@pytest.mark.parametrize("pass_", ["dq", "dkdv"])
@pytest.mark.parametrize("shape", [
    (4, 4096, 4096, 14, 2, 64),      # the train shape
    (1, 4000, 4000, 14, 2, 64),      # ragged
    (1, 2048, 2048, 32, 4, 128),     # yi-6b heads
    (8, 200, 328, 2, 1, 64),         # Sq != Skv
    (1, 33, 33, 4, 2, 128),          # one tile
    (1, 4096, 4096, 10, 1, 256),     # recurrentgemma-2b: 2 splits
    (1, 4096, 4096, 16, 16, 256),    # gemma-7b: no split
    (1, 200, 330, 4, 2, 256)])       # Sq != Skv, 8 splits
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_schedules_cover_every_tile_once(pass_, shape, causal):
    taken, load = _bwd_schedule(pass_, *shape, causal=causal)
    seen = sorted(t for x in taken for t in x)
    assert seen == list(range(len(seen))) and len(seen) >= len(taken)
    assert min(load) >= 0


@pytest.mark.parametrize("B,Kv,Sq,G,causal,window,D,variant,sms,splits", [
    (1, 1, 4096, 10, True, 2048, 256, "wgmma", 132, 6),  # recurrentgemma
    (1, 16, 4096, 1, True, 0, 256, "wgmma", 132, 1),     # gemma-7b
    (1, 1, 1000, 10, True, 300, 256, "wgmma", 132, 8),   # 16 tiles
    (1, 2, 330, 2, False, 0, 256, "wgmma", 132, 6),    # 12 tiles
    (1, 16, 300, 1, True, 0, 256, "wgmma", 132, 2),      # 80 tiles
    (3, 1, 4096, 10, True, 2048, 256, "wgmma", 132, 1),  # 192 tiles
    (1, 1, 4096, 10, True, 2048, 256, "simt", 132, 1),   # only wgmma's
    (1, 1, 4096, 10, True, 2048, 128, "wgmma", 132, 1),  # ... D 256 pass
    (1, 1, 4096, 10, True, 2048, 256, "wgmma", 64, 1)])  # tiles >= SMs
def test_flash_bwd_splits_rule(B, Kv, Sq, G, causal, window, D, variant,
                               sms, splits):
    assert ops.flash_bwd_splits(variant, B, Kv, Sq, Sq, G, D, causal,
                                window, sms) == splits
    assert 1 <= splits <= ops.FLASH_BWD_MAX_SPLITS


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4096, 4096, 10, 1, 256), True, 2048),
    ((1, 1000, 1000, 10, 1, 256), True, 300),
    ((1, 200, 330, 4, 2, 256), False, 0),
    ((2, 777, 777, 10, 1, 256), True, 77)])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_flash_bwd_dkdv_loads_mirror_the_schedule(shape, causal, window,
                                                  splits):
    """`ops.flash_bwd_dkdv_loads`, which the splits rule reads, against
    this file's own mirror of the D 256 dK/dV pass's schedule."""
    B, Sq, Skv, H, Kv, D = shape
    taken, load = _bwd_schedule("dkdv", *shape, causal=causal,
                                window=window, splits=splits)
    got = ops.flash_bwd_dkdv_loads(B, Kv, Sq, Skv, H // Kv, causal, window,
                                   splits, H100_SMS)
    assert got == [(x, len(t)) for x, t in zip(load, taken)]


def test_flash_bwd_splits_fill_the_card_at_the_hybrid_train_shape():
    """recurrentgemma-2b's train shape (B 1 x 10 query heads over 1, S
    4096, D 256, window 2048): 64 key tiles of the D 256 dK/dV pass. One
    block a key tile leaves 68 SMs idle and the busiest block 330
    query-tile steps; two splits 165 (the band's last key tiles see fewer
    query tiles, which equal splits of 128 work tiles do not even out);
    the rule's 6 splits, 384 work tiles in three rounds, 124 against a
    mean of 120."""
    shape = (1, 4096, 4096, 10, 1, 256)
    taken, load = _bwd_schedule("dkdv", *shape, window=2048)
    assert sum(len(x) for x in taken) == 384 and len(taken) == 132
    assert sum(load) == 10 * sum(
        min(64, (k0 + 62 + 2048) // 64 + 1) - k0 // 64
        for k0 in range(0, 4096, 64))
    assert (max(load), sum(load) / len(load)) == (124, 120)
    for splits, busiest in ((1, 330), (2, 165)):
        _, other = _bwd_schedule("dkdv", *shape, window=2048, splits=splits)
        assert max(other) == busiest


@pytest.mark.parametrize("variant,splits,want", [
    ("simt", 1, 10 * 1000),
    ("wgmma", 1, 2 * 10 * 1024),
    ("wgmma", 8, 2 * 10 * 1024 + 8 * 1024 * 2 * 256)])
def test_flash_bwd_scratch_size(variant, splits, want):
    """K6b's float32 scratch: simt's delta; wgmma's lse log2(e) and delta
    with rows padded to 64; the splits' dK | dV sums with keys padded to
    64 (B 1, 10 heads over 1, Sq 1000, Skv 1000, D 256)."""
    assert ops.flash_bwd_scratch(variant, 1, 10, 1, 1000, 1000, 256,
                                 splits) == want


# -- K1: one cluster a bundle; K2: warps a column ------------------------------

@pytest.mark.parametrize("P,K,cluster,nseg", [
    (32, 278, 8, 4),       # the support solve: 8896 entries, 4 warps a column
    (1, 1, 1, 1),
    (12, 20, 1, 1),        # 240 entries: one CTA, 16 warps, a column each
    (4, 300, 2, 8),        # 8 warps a feature, up to ceil(300 / 32) = 10
    (512, 278, 8, 1),      # more features than the cluster's 128 warps
    (3, 5000, 8, 16),      # long columns: a CTA's 16 warps on each
])
def test_bundle_plan_cluster_and_column_split(P, K, cluster, nseg):
    plan = ops.bundle_plan(P, K, s=57848, n=20958, Q=40)
    assert (plan.cluster, plan.nseg) == (cluster, nseg)
    assert 1 <= plan.cluster <= ops.BUNDLE_MAX_CLUSTER
    assert (ops.BUNDLE_THREADS // 32) % plan.nseg == 0


def test_bundle_plan_workspace_bytes():
    """The (s,) owner map and (s,) list heads, six int32/float32 words a
    slot over R = P K slots, and w_B and d: 677 KB at the support solve's
    shape."""
    plan = ops.bundle_plan(32, 278, s=57848, n=20958, Q=40)
    R = 32 * 278
    assert plan.workspace_ints == 2 * 57848 + 6 * R + 2 * 32
    assert plan.workspace_bytes == 4 * plan.workspace_ints == 676_544
    big = ops.bundle_plan(64, 16, s=8_407_752, n=100, Q=40)
    assert big.workspace_bytes == 4 * (2 * 8_407_752 + 6 * 64 * 16 + 128)


@pytest.mark.parametrize("kw,match", [
    (dict(Q=65), "Q=65 candidates, the kernel takes 1 to 64"),
    (dict(Q=0), "Q=0 candidates"),
    (dict(s=2 ** 31), r"below 2\*\*31"),
    (dict(P=0), "empty design or bundle"),
    (dict(s=0), "empty design or bundle"),
    (dict(P=2 ** 20, K=2 ** 11), r"below 2\*\*31"),
])
def test_bundle_plan_refusals_name_the_limit(kw, match):
    args = dict(P=32, K=278, s=57848, n=20958, Q=40)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ops.bundle_plan(**args)


def test_bundle_launch_refuses_before_any_work():
    """The launch object checks the plan on the CPU too: 65 candidates are
    refused with the kernel's limit, whatever the device."""
    rows = torch.zeros((4, 3), dtype=torch.int32)
    vals = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="1 to 64"):
        ops.BundleLaunch(rows, vals, torch.ones(10), torch.ones(65), 1.0,
                         P=2, n_bundles=1)


@pytest.mark.parametrize("view", [
    lambda z: z[:5],                            # same address, shorter
    lambda z: z[::2],                           # same address, strided
    lambda z: z.view(torch.int32),              # same address, other dtype
    lambda z: z.view(2, 5),                     # same address, 2-D
])
def test_bundle_binding_key_sees_views_at_the_same_address(view):
    """K1's wrapper checks w and z again whenever this key changes: a view
    that starts where the bound tensor starts has another key."""
    z = torch.zeros(10)
    v = view(z)
    assert v.data_ptr() == z.data_ptr()
    assert ops._tensor_key(v) != ops._tensor_key(z)
    assert ops._tensor_key(z) == ops._tensor_key(z.view(10))


def test_bundle_chunk_is_a_few_candidates():
    """The in-kernel search takes BUNDLE_CHUNK candidates a round: the
    support solve accepts the first candidate in nearly every bundle, so a
    chunk of a few bounds the loss evaluations that are never needed."""
    assert 1 <= ops.BUNDLE_CHUNK <= 4
    # fewer candidates than a chunk: the kernel's last chunk is short
    assert ops.bundle_plan(3, 4, 10, 10, Q=1).Q == 1


@pytest.mark.parametrize("K,warps", [(1, 1), (64, 1), (65, 2), (128, 2),
                                     (129, 4), (278, 4), (5000, 4)])
def test_sparse_direction_splits_long_columns(K, warps):
    assert ops.sparse_direction_warps(K) == warps


# -- K3: columns a CTA, whole clusters; K4b: a cluster a group ---------------

# clusters of 8 of the K3 kernel an H100 SXM holds at once (one CTA an
# SM; cudaOccupancyMaxActiveClusters on the card)
H100_K3_CLUSTERS = 15


@pytest.mark.parametrize("s,P,itemsize,max_clusters,cc,ctas,resident", [
    (6000, 512, 4, 15, 35, 120, True),    # gisette's dense solve, float32
    (6000, 512, 2, 15, 35, 120, True),    # the same in bf16
    (6000, 512, 4, 30, 18, 232, True),    # a card that holds 30 clusters
    (1, 1, 4, 15, 1, 8, False),           # one row: no 16-byte rows
    (77, 5, 4, 15, 1, 40, False),
    (300, 37, 2, 15, 3, 104, False),      # 13 clusters of 3 columns
    (6000, 1000, 4, 15, 64, 128, True),   # past 64 columns: two waves
    (8192, 512, 4, 15, 35, 120, True),
    (48_000, 512, 4, 15, 35, 120, False),  # rows in tiles: read twice
    (100_000, 512, 4, 15, 35, 120, False),
    (500, 5000, 4, 15, 64, 632, True),
])
def test_direction_plan(s, P, itemsize, max_clusters, cc, ctas, resident):
    plan = ops.direction_plan(s, P, itemsize, max_clusters)
    assert (plan.cc, plan.ctas, plan.resident) == (cc, ctas, resident)
    assert plan.ctas % ops.DIRECTION_CLUSTER == 0
    assert plan.clusters == plan.ctas // ops.DIRECTION_CLUSTER
    assert 1 <= plan.cc <= ops.DIRECTION_MAX_CLUSTER_COLS
    # every bundle column has a cluster, and none is empty
    assert plan.clusters * plan.cc >= P > (plan.clusters - 1) * plan.cc
    # one wave of clusters unless the columns a cluster are at their cap
    assert plan.clusters <= max_clusters or \
        plan.cc == ops.DIRECTION_MAX_CLUSTER_COLS
    # the rows in one slice a CTA, each a multiple of 8 rows
    assert plan.sl % 8 == 0
    assert plan.sl * ops.DIRECTION_CLUSTER >= s > \
        (plan.sl - 8) * ops.DIRECTION_CLUSTER
    assert plan.tile == (plan.sl if plan.resident else
                         min(plan.sl, ops.DIRECTION_TILE_ROWS))
    assert plan.smem_bytes <= ops.SMEM_BUDGET
    # 16-byte loads only where every column's rows start on 16 bytes, and
    # the bulk copies only with them
    assert plan.vec == (s % (16 // itemsize) == 0)
    assert plan.vec or not plan.resident
    # the resident segments start on 16 bytes, each a multiple of 16
    assert ops.direction_smem_bytes(plan.tile, plan.cc, False,
                                    itemsize) % 16 == 0
    assert not plan.resident or plan.tile * itemsize % 16 == 0


def test_direction_plan_at_gisette_and_its_ragged_last_bundle():
    """gisette at P 512 on an H100: 15 clusters of 8 CTAs (one wave), 35
    columns a cluster (the last 22), 752 rows a CTA (the last 736), the
    slices' columns resident beside u and v (110 KB). The last of its 10
    bundles holds 392 live columns and 120 sentinels: the plan is the
    same; clusters 12-14 hold only sentinels, cluster 11 both."""
    plan = ops.direction_plan(6000, 512, 4, H100_K3_CLUSTERS)
    assert (plan.clusters, plan.cc, plan.sl) == (15, 35, 752)
    assert plan.smem_bytes == 4 * (2 * 752 + 7 * 64 + 16) + \
        35 * 752 * 4 == 113_152
    assert 512 - 14 * plan.cc == 22 and 6000 - 7 * plan.sl == 736
    owner = [p // plan.cc for p in range(392, 512)]
    assert sorted(set(owner)) == [11, 12, 13, 14]
    assert owner.count(11) == 12 * 35 - 392


@pytest.mark.parametrize("kw,match", [
    (dict(s=0), "empty slab"), (dict(P=0), "empty slab"),
    (dict(itemsize=8), "float32 or bfloat16"),
    (dict(max_clusters=0), "holds 0 clusters")])
def test_direction_plan_refusals(kw, match):
    args = dict(s=6000, P=512, itemsize=4, max_clusters=H100_K3_CLUSTERS)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ops.direction_plan(**args)


@pytest.mark.parametrize("B,K,A,k_max,cluster,ranges", [
    (256, 8, 10_901, 6, 8, 1),      # the serve bucket, the path family
    (256, 8, 10_901, 75, 8, 1),     # the same at the request stream's width
    (256, 1, 10_901, 6, 8, 1),      # the c* model alone
    (1, 1, 1, 1, 1, 1),
    (33, 5, 40, 9, 1, 1),           # 360 pairs: one CTA a model
    (20_000, 3, 3_000, 6, 3, 1),
    (60_000, 2, 500, 40, 3, 2),     # wide rows: two ranges of 30,000
    (100_000, 1, 10, 1, 1, 3),
])
def test_csc_plan(B, K, A, k_max, cluster, ranges):
    plan = ops.csc_plan(B, K, A, k_max)
    assert (plan.cluster, plan.ranges) == (cluster, ranges)
    assert 1 <= plan.cluster <= ops.CSC_MAX_CLUSTER
    # the ranges cover the rows, none empty
    assert plan.range_rows * (plan.ranges - 1) < B <= \
        plan.range_rows * plan.ranges
    assert plan.range_rows <= ops.CSC_MAX_RANGE_ROWS
    assert plan.smem_bytes <= ops.SMEM_BUDGET
    # one round of pairs a thread, unless the cluster is at its cap
    assert A * k_max <= plan.cluster * ops.CSC_THREADS * ops.CSC_ROUND or \
        plan.cluster == ops.CSC_MAX_CLUSTER
    assert plan.ctas == plan.cluster * K * plan.ranges


def test_csc_plan_at_the_serve_shape():
    """The serve bucket (B 256, K 8, A 10,901): 8 clusters of 8 CTAs (64),
    each a 1 KB margin column and one round of 8 pairs a thread; no
    scratch."""
    plan = ops.csc_plan(256, 8, 10_901, 6)
    assert (plan.ctas, plan.smem_bytes) == (64, 1024)
    per_thread = -(-10_901 // plan.cluster) * 6 / ops.CSC_THREADS
    assert per_thread <= ops.CSC_ROUND


@pytest.mark.parametrize("kw,match", [
    (dict(B=0), "empty input"),
    (dict(A=0), "empty input"),
    (dict(A=2 ** 28, k_max=8), r"below 2\*\*31"),
    (dict(K=70_000), "65535"),
])
def test_csc_plan_refusals(kw, match):
    args = dict(B=256, K=8, A=10_901, k_max=6)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ops.csc_plan(**args)
