"""Fully parallel liftover kernel: the speed-of-light formulation.

The reference's nested walk (src/liftover_read_alignment.rs:137-223) — and the
v1 ``lax.scan`` port in ``liftover_kernel`` — process one (op x block) update
per step.  A sequential scan of ~2k steps with per-step gathers is
latency-bound on a parallel device, so this module reformulates liftover as
a **data-parallel interval join**:

1. Every update call of the reference corresponds to one row of a static
   "update grid" of size ``U = 2*max_ops + max_blocks`` (the same bound that
   sized the scan).  Row -> (op, visit) indices come from a prefix sum of
   per-op visit counts plus one vectorized ``searchsorted``.
2. Per-row interval bounds, active map entry, and emissions are pure gathers
   and elementwise ops.
3. The only cross-row state in the reference — "has the output alignment
   started" and "reference end of the previous mapped visit" (which gates and
   sizes gap deletions) — are an argmax and an exclusive running maximum
   (``lax.cummax``), both parallel primitives.

The emission stream is bit-identical to the scan kernel's (verified by the
shared conformance tests), so the cleanup/compress stage is reused unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from portello_tpu.kernels.cigar_kernels import (
    D,
    H,
    I,
    INT32_MAX,
    M,
    N,
    PAD,
    S,
    consumes_ref,
    is_align_match,
)


def _liftover_parallel_single(ops, lens, n_ops, ref1_pos, bk, bv, nb, mm: bool = False,
                              max_rows: int | None = None):
    """Single-read parallel liftover; same contract as
    ``liftover_kernel._liftover_scan_single``: returns (emit_codes, emit_lens,
    ref2_start, row_overflow) with 2 emission slots per update row.

    ``mm`` selects the one-hot-matmul / count-compare formulation of the row
    expansions and block searches (bit-identical; kernels/expand.py).

    ``max_rows`` overrides the worst-case update-grid height ``2*max_ops +
    max_blocks`` (every op ref-consuming) with a measured-percentile bound;
    reads needing more rows set ``row_overflow`` and must be finished on the
    exact host path (the engine buckets by a host-side row count first, so
    the flag is a safety net for miscounts).
    """
    from portello_tpu.kernels.expand import (
        count_le,
        count_lt,
        expand_mask,
        onehot_eq,
        onehot_interval,
    )

    max_ops = ops.shape[0]
    max_blocks = bk.shape[0]
    U = max_rows if max_rows else 2 * max_ops + max_blocks

    idx_ops = jnp.arange(max_ops, dtype=jnp.int32)
    active = idx_ops < n_ops
    codes = jnp.where(active, ops, PAD)
    lens_ = jnp.where(active, lens, 0)

    is_ro = (codes == I) | (codes == S) | (codes == H)
    rc = consumes_ref(codes) & active

    # Op ref1 intervals.
    rl = jnp.where(rc, lens_, 0)
    s = ref1_pos + jnp.cumsum(rl) - rl      # op start (ref1)
    e = s + rl                              # op end

    # Block entry range per rc op (get_ref_range floor semantics).
    if mm:
        lo_raw = count_le(bk, s)
        hi = jnp.minimum(count_lt(bk, e), nb)
    else:
        lo_raw = jnp.searchsorted(bk, s, side="right", method="sort").astype(jnp.int32)
        hi = jnp.minimum(
            jnp.searchsorted(bk, e, side="left", method="sort").astype(jnp.int32), nb
        )
    # ``pre``: op starts before the first map key — only then is the
    # reference's first visit (no last entry -> leading SoftClip) a real
    # update.  For every other rc op that visit is provably a no-op
    # (key_lo <= s makes its interval empty), so rows are numbered from the
    # first REAL visit: visits = hi - lo + pre instead of hi - lo + 1.
    # This cuts the typical grid by ~1 row per rc op, and removes the
    # is_final special case below: the final visit's "this" entry is key_hi
    # with key_hi >= e by construction (count_lt), INT32_MAX past nb.
    pre = (lo_raw == 0).astype(jnp.int32)
    lo = jnp.clip(lo_raw - 1, 0, hi)

    visits = jnp.where(rc, hi - lo + pre, jnp.where(is_ro & active, 1, 0))
    off = jnp.cumsum(visits) - visits       # exclusive row offset per op
    total_rows = jnp.sum(visits)

    # Row -> (op, visit index)
    r = jnp.arange(U, dtype=jnp.int32)
    row_valid = r < total_rows

    # One packed-row expansion for all per-op values: one gather of
    # contiguous rows instead of a gather per value (or one one-hot
    # interval-mask matmul in mm mode).
    # Rows past total_rows expand to zero in mm mode and to op max_ops-1's
    # values in gather mode; every consumer below masks with row_valid.
    op_table = jnp.stack(
        [
            codes, lens_, rc.astype(jnp.int32), is_ro.astype(jnp.int32),
            s, lo, off, pre,
        ],
        axis=1,
    )
    if mm:
        row_vals = expand_mask(onehot_interval(off, visits, U), op_table)
    else:
        op_of = jnp.clip(
            jnp.searchsorted(
                off + visits, r, side="right", method="sort"
            ).astype(jnp.int32),
            0,
            max_ops - 1,
        )
        row_vals = jnp.take_along_axis(op_table, op_of[:, None], axis=0)
    code_r = row_vals[:, 0]
    len_r = row_vals[:, 1]
    rc_r = (row_vals[:, 2] > 0) & row_valid
    ro_r = (row_vals[:, 3] > 0) & row_valid
    s_r = row_vals[:, 4]
    e_r = s_r + row_vals[:, 2] * len_r     # e = s + ref_len (rc ops only)
    lo_r = row_vals[:, 5]
    t = r - row_vals[:, 6]
    pre_r = row_vals[:, 7]

    # this/last map entries, keys+vals packed per row.  Visit t corresponds
    # to the reference's visit t + 1 - pre (see the renumbering note above):
    # "this" = lo + t + 1 - pre, "last" = this - 1; past-the-window "this"
    # reads as +inf (the final visit's E is then e via min()).
    bkv = jnp.stack([bk, bv], axis=1)
    this_idx = lo_r + t + 1 - pre_r
    last_idx = this_idx - 1
    if mm:
        # ONE lookup for this+last: table row i packs [bk[i], bk[i-1],
        # bv[i-1]] over an extended domain [0, max_blocks] (row max_blocks
        # serves this_idx == nb == max_blocks, whose "this" key is overridden
        # to +inf below anyway; row 0's last fields are 0, matching the old
        # zero-mask rows — unread: this_idx == 0 implies have_last is False).
        # Halves the block-lookup mask build + matmul count.
        shifted_k = jnp.concatenate([jnp.zeros(1, bk.dtype), bk])
        shifted_v = jnp.concatenate([jnp.zeros(1, bv.dtype), bv])
        table3 = jnp.stack(
            [
                jnp.concatenate([bk, jnp.zeros(1, bk.dtype)]),
                shifted_k,
                shifted_v,
            ],
            axis=1,
        )
        kv3 = expand_mask(onehot_eq(this_idx, max_blocks + 1), table3)
        this_key = kv3[:, 0]
        last_key = kv3[:, 1]
        last_val = kv3[:, 2]
    else:
        both = jnp.take_along_axis(
            bkv,
            jnp.concatenate(
                [
                    jnp.clip(this_idx, 0, max_blocks - 1),
                    jnp.clip(last_idx, 0, max_blocks - 1),
                ]
            )[:, None],
            axis=0,
        )
        this_key = both[:U, 0]
        last_key = both[U:, 0]
        last_val = both[U:, 1]
    this_key = jnp.where(this_idx < nb, this_key, INT32_MAX)
    have_last = t >= pre_r

    # Interval [B, E) processed by this update.
    B = jnp.where(have_last, jnp.maximum(s_r, jnp.minimum(last_key, e_r)), s_r)
    E = jnp.minimum(this_key, e_r)
    L = E - B
    do_upd = rc_r & (L > 0)

    is_m = is_align_match(code_r)
    mapped_last = do_upd & have_last & (last_val >= 0)
    gap_last = do_upd & have_last & (last_val < 0)
    no_last = do_upd & ~have_last

    # --- alignment start: the first update with a mapped last + match op
    # (liftover_read_alignment.rs:84-88)
    start_mask = mapped_last & is_m
    any_start = jnp.any(start_mask)
    r_star = jnp.argmax(start_mask).astype(jnp.int32)
    ref2_start = jnp.where(
        any_start,
        last_val[r_star] + (B[r_star] - last_key[r_star]),
        jnp.int32(-1),
    )
    started = any_start & (r >= r_star)

    # --- gap deletions: previous mapped visit's ref2 end vs this block's val
    # (liftover_read_alignment.rs:91-100).  The chain needs "end2 of the
    # previous mapped row" — a forward-fill, done as ONE packed int32
    # exclusive cummax: (row << 17) | (end2 - window_floor).  end2 - floor
    # is within the item's ref2 window span (engine buckets enforce
    # ref_span <= max_seq <= 2^16), so the pack is exact; a defensive
    # overflow flag backstops out-of-contract inputs.  This replaces a
    # (U, U) one-hot expansion — the largest mask in the grid.
    end2 = last_val + (E - last_key)
    base = jnp.min(jnp.where(bv >= 0, bv, INT32_MAX))
    rel_end2 = end2 - base               # > 0 on mapped rows (last_val >= base)
    pack_ovf = jnp.any(mapped_last & (rel_end2 >= (1 << 17)))
    pack = jnp.where(mapped_last, (r << 17) | rel_end2, jnp.int32(-1))
    prev_pack = jnp.concatenate(
        [jnp.full(1, -1, jnp.int32), jax.lax.cummax(pack)[:-1]]
    )
    have_end = mapped_last & (prev_pack >= 0)
    prev_end2 = base + (prev_pack & ((1 << 17) - 1))
    del_len = last_val - prev_end2
    emit_del = have_end & (del_len > 0) & started

    # --- emissions
    seg_code = jnp.where(code_r == D, D, jnp.where(code_r == N, N, M))
    emit_seg = mapped_last & (is_m | started)
    emit_clip = no_last & is_m
    emit_ins = gap_last & is_m

    e0_code = jnp.where(emit_del, D, PAD)
    e0_len = jnp.where(emit_del, del_len, 0)
    e1_code = jnp.where(
        ro_r,
        code_r,
        jnp.where(
            emit_clip, S, jnp.where(emit_ins, I, jnp.where(emit_seg, seg_code, PAD))
        ),
    )
    e1_len = jnp.where(ro_r, len_r, jnp.where(emit_clip | emit_ins | emit_seg, L, 0))

    emit_codes = jnp.stack([e0_code, e1_code], axis=1).reshape(-1)
    emit_lens = jnp.stack([e0_len, e1_len], axis=1).reshape(-1)
    row_overflow = (total_rows > U) | pack_ovf
    return emit_codes, emit_lens, ref2_start, row_overflow
