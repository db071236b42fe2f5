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
    """The (s,) slot map, five int32/float32 words a slot over R = P K
    slots, and w_B and d: 409 KB at the support solve's shape."""
    plan = ops.bundle_plan(32, 278, s=57848, n=20958, Q=40)
    R = 32 * 278
    assert plan.workspace_ints == 57848 + 5 * R + 2 * 32
    assert plan.workspace_bytes == 4 * plan.workspace_ints == 409_568
    big = ops.bundle_plan(64, 16, s=8_407_752, n=100, Q=40)
    assert big.workspace_bytes == 4 * (8_407_752 + 5 * 64 * 16 + 128)


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
