"""The work a kernel call must do, counted from the call's own inputs: the
bytes it must move (each input read once, each output written once) and
the operations it must do, for the bound of `chip_smoke.py`'s kernels line
and of `benchmarks/port/bench_kernels.py`'s cells, so that a kernel has
one bound. Each function returns (bytes, operations) of one call (a mean
over calls where the work depends on the call's data); `bound` turns them
into the least time on an H100 SXM at its published peaks.

Imports torch and the port (`repro_torch`) only, inside the functions.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12   # dense, tensor cores


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bundle_work(torch, col_rows, itemsize: int, bundles, n_steps, n: int,
                s: int) -> tuple:
    """K1 (`ops.pcdn_bundle`), the mean over the bundles whose call
    recorded a step count (q > 0): bytes idx, each live column's rows and
    values, w_B read and written, z/y read and z written at the live
    rows, the outputs; operations ~20 a slab entry (the loss factors, g,
    h), 12 a live row for each candidate up to the accepted one."""
    K = col_rows.shape[1]
    timed = [(idx_t, q_t) for idx_t, q_t in zip(bundles, n_steps) if q_t]
    nbytes = nops = 0.0
    for idx_t, q_t in timed:
        P = idx_t.shape[0]
        live_t = idx_t[idx_t < n].long()
        rows_t = col_rows[live_t]
        rows_live = int(torch.unique(rows_t[rows_t < s]).numel())
        nbytes += (P * 4 + int(live_t.numel()) * K * (4 + itemsize) +
                   8 * int(live_t.numel()) + 12 * rows_live + q_t * 4 + 8)
        nops += P * K * 20 + rows_live * q_t * 12
    return nbytes / len(timed), nops / len(timed)


def sparse_direction_work(torch, rows, s: int) -> tuple:
    """K2 (`ops.pcdn_sparse_direction`) on a (P, K) slab over s rows:
    bytes the slab, z/y at its distinct rows, w_B, d/g/h and the (s,)
    delta written; operations ~24 a live entry (the loss factors, g, h,
    the scatter)."""
    P, K = rows.shape
    valid = rows < s
    n_rows = int(torch.unique(rows[valid]).numel())
    return (P * K * 8 + n_rows * 8 + P * 4 + 3 * P * 4 + s * 4,
            24 * int(valid.sum()))


def direction_work(torch, idx, n: int, s: int, itemsize: int) -> tuple:
    """K3 (`ops.pcdn_direction`) for the bundle idx (sentinel n): bytes the
    live columns once, z and y, delta written, idx, w_B, d/g/h;
    operations ~7 a value (g, h, delta)."""
    P = idx.shape[0]
    n_live = int((idx < n).sum())
    return (n_live * s * itemsize + 3 * s * 4 + 2 * P * 4 + 3 * P * 4,
            7 * s * n_live)


def linesearch_work(torch, deltas, Q: int) -> tuple:
    """K5's rows entry (`ops.pcdn_linesearch`) on (P, s) deltas: bytes
    every delta row once, z and y at the samples live in any row, alphas,
    the (P, Q) output; operations ~10 a live (row, sample, candidate)
    loss term."""
    P, s = deltas.shape
    live = deltas != 0
    n_live = int(live.sum())
    rows_live = int(live.any(dim=0).sum())
    return (4 * P * s + 8 * rows_live + 4 * Q + 4 * P * Q,
            10 * n_live * Q)


def scdn_batch_work(torch, launch, w, z, batches) -> tuple:
    """K5's batch entry (`ops.scdn_batch`), the mean over `batches` run in
    turn through the plain version from the carry (w, z) (cloned): bytes
    the slab (P k_max (4 + 4)), idx, w read and written and alpha (P
    each), z and y read at each batch's distinct live rows and z written
    at those of its d != 0 coordinates; operations ~20 a live entry (the
    loss factors, g, h) and ~10 a (distinct row, candidate) pair of the
    d != 0 coordinates, for the candidates up to the accepted one."""
    from repro_torch.kernels import ref
    cr, cv = launch.col_rows, launch.col_vals
    s, K, Q = launch.plan.s, launch.plan.K, launch.plan.Q
    wc, zc = w.clone(), z.clone()
    nbytes = nops = 0.0
    for idx_t in batches:
        P = idx_t.shape[0]
        a_t, lo_t = ref.scdn_batch_ref(cr, cv, idx_t, wc, zc, launch.y,
                                       launch.alphas, launch.c,
                                       kind=launch.kind, sigma=launch.sigma,
                                       gamma=launch.gamma, l2=launch.l2)
        rows_t = cr[idx_t.long()]
        live = rows_t < s
        moved = lo_t.abs().sum(dim=1) != 0                # d != 0
        rows_read = int(torch.unique(rows_t[live]).numel())
        rows_written = int(torch.unique(rows_t[live & moved[:, None]])
                           .numel())
        steps = torch.where(a_t > 0, torch.round(-torch.log2(a_t)) + 1,
                            float(Q))
        pairs = sum(int(torch.unique(rows_t[p][live[p]]).numel()) *
                    float(steps[p]) for p in range(P) if bool(moved[p]))
        nbytes += P * K * 8 + P * 16 + rows_read * 8 + rows_written * 4
        nops += 20 * int(live.sum()) + 10 * pairs
    return nbytes / len(batches), nops / len(batches)


def scdn_dense_work(torch, launch, w, z, batches) -> tuple:
    """K5's dense batch entry (`ops.scdn_dense_batch`), the mean over
    `batches` run in turn through the plain version from the carry (w, z)
    (cloned): bytes each distinct live column (s values), z and y read
    and z written, idx, w read and written and alpha (P each); operations
    ~20 a nonzero of a slot's column (the loss factors, g, h), ~10 a
    (nonzero, candidate) pair of the d != 0 slots for the candidates up
    to the accepted one, and 2 a nonzero of a moved slot (z's update)."""
    from repro_torch.kernels import ref
    XT = launch.XT
    n, s = XT.shape
    Q = launch.plan.Q
    wc, zc = w.clone(), z.clone()
    nbytes = nops = 0.0
    for idx_t in batches:
        P = idx_t.shape[0]
        a_t, lo_t = ref.scdn_dense_batch_ref(
            *launch.design_args, idx_t, wc, zc, launch.y, launch.alphas,
            launch.c, kind=launch.kind, sigma=launch.sigma,
            gamma=launch.gamma, l2=launch.l2)
        live = idx_t < n
        nnz = torch.zeros((P,), device=XT.device)
        nnz[live] = (XT[idx_t[live].long()] != 0).sum(dim=1).float()
        moved = lo_t.abs().sum(dim=1) != 0                # d != 0
        steps = torch.where(a_t > 0, torch.round(-torch.log2(a_t)) + 1,
                            float(Q))
        n_cols = int(torch.unique(idx_t[live]).numel())
        nbytes += n_cols * s * 4 + 12 * s + 16 * P
        nops += float(20 * nnz.sum() + (10 * nnz * steps)[moved].sum() +
                      (2 * nnz)[moved & (a_t > 0)].sum())
    return nbytes / len(batches), nops / len(batches)


def dense_margins_work(torch, idx, n: int, B: int) -> tuple:
    """K4a (`ops.serve_margins_dense`) of a (K, A) bank (sentinel n) on B
    dense rows: bytes the union's columns of X once, idx/val, the output;
    operations 2 a (row, live weight)."""
    K, A = idx.shape
    live = idx < n
    U = int(torch.unique(idx[live].long()).numel())
    return B * U * 4 + K * A * 8 + B * K * 4, 2 * B * int(live.sum())


def csc_margins_work(torch, rows, idx, n: int, B: int) -> tuple:
    """K4b (`ops.serve_margins_csc`) of a (K, A) bank on a padded-CSC batch
    rows (n, k_max) of B request rows (sentinels >= B, packed last): bytes
    of each of the union's request columns its row ids up to the first
    sentinel and its live values, each column once over all models;
    idx/val; the output. Operations 2 a live (entry, model) pair."""
    K, A = idx.shape
    k_max = rows.shape[1]
    live_idx = idx[idx < n].long()
    col_nnz = torch.sum(rows < B, dim=1)
    nnz_u = col_nnz[torch.unique(live_idx)]
    need = int((4 * torch.clamp(nnz_u + 1, max=k_max) + 4 * nnz_u).sum())
    return need + K * A * 8 + B * K * 4, 2 * int(col_nnz[live_idx].sum())


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the mask lets through, per head: keys j < Skv of
    rows i < Sq, j <= i when causal, and i - j < window when window > 0
    (K6's sliding window)."""
    if window <= 0:
        if not causal:
            return Sq * Skv
        n = min(Sq, Skv)      # rows i < Skv see i + 1 keys, later rows Skv
        return n * (n + 1) // 2 + max(Sq - Skv, 0) * Skv
    # row i keeps keys max(0, i - window + 1) .. (i if causal else Skv - 1)
    return sum(max(min(i if causal else Skv - 1, Skv - 1) -
                   max(i - window + 1, 0) + 1, 0) for i in range(Sq))


def flash_bwd_work(q, k, causal: bool, window: int = 0) -> tuple:
    """K6b (`ops.flash_attention_bwd`) in the model's layout, q (B, Sq, H,
    D) with k/v (B, Skv, Kv, D): bytes q, k, v, out, do and the (B, H, Sq)
    float32 lse read once, dq, dk, dv written once; operations the five
    products of the flash backward (S = Q K^T, dP = dO V^T, dV = P^T dO,
    dQ = dS K, dK = dS^T Q), 2 D flops each for every (query, key) pair
    the mask lets through (with `window` > 0 the band's), on every query
    head."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + \
        4 * B * H * Sq
    return nbytes, 5 * 2 * D * attention_pairs(Sq, Skv, causal,
                                               window) * B * H
