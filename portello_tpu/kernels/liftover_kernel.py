"""Batched liftover kernel: the hot inner loop of the framework.

Data-parallel reformulation of the reference's liftover core
(reference src/liftover_read_alignment.rs:35-223).  The reference walks the
read->contig CIGAR with a nested iteration over contig->ref map blocks; here that
nested walk becomes a **fixed-length two-pointer ``lax.scan``**: each scan step
performs exactly one "update call" (one block visit, or the closing call of one
op, or one read-only op copy).  The step count is statically bounded by
``2*max_ops + max_blocks`` because the per-op block ranges are disjoint except
for at most one floor-block revisit per op (see SURVEY.md section 3.4).

The scan is vmapped over the read batch, so each step's scalar logic executes as
wide VPU vector ops across all reads in the batch; there is no data-dependent
control flow, shapes are static per bucket, and the whole pipeline jits into a
single XLA computation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from portello_tpu.kernels.cigar_kernels import (
    D,
    H,
    I,
    M,
    N,
    P,
    PAD,
    S,
    cleanup_and_compress,
    is_align_match,
)

NONE_VAL = -1  # block map "unmapped" sentinel (matches ops.blockmap.NONE)


def _liftover_scan_single(ops, lens, n_ops, ref1_pos, bk, bv, n_blocks):
    """Single-read liftover scan; returns raw (uncompressed) emissions.

    Inputs are padded int32 vectors: ``ops/lens`` with PAD entries, ``bk`` block
    keys padded with INT32_MAX, ``bv`` block ref positions (-1 = gap).  Returns
    ``(emit_codes, emit_lens, ref2_start)`` where emissions are 2 slots per scan
    step (slot 0: gap deletion, slot 1: main segment) and ``ref2_start < 0``
    means the read did not lift (liftover_read_alignment.rs:218).
    """
    max_ops = ops.shape[0]
    max_blocks = bk.shape[0]
    max_steps = 2 * max_ops + max_blocks

    def step(carry, _):
        (op_idx, in_op, blk_idx, hi_idx, have_last, last_key, last_val,
         block_pos, seg_start, ref2_start, ref2_end, have_end) = carry

        active = op_idx < n_ops
        safe_op = jnp.minimum(op_idx, max_ops - 1)
        code = jnp.where(active, ops[safe_op], PAD)
        ln = jnp.where(active, lens[safe_op], 0)

        is_ro = (code == I) | (code == S) | (code == H)
        is_skip = (code == P) | (code == PAD)
        is_rc = active & ~is_ro & ~is_skip
        seg_end = seg_start + ln

        # --- enter a ref-consuming op: locate its block range
        # (ReadToRefTreeMap::get_ref_range floor semantics, read_to_ref_map.rs:74-85)
        need_enter = is_rc & ~in_op
        lo0 = jnp.searchsorted(bk, seg_start, side="right").astype(jnp.int32) - 1
        hi0 = jnp.minimum(
            jnp.searchsorted(bk, seg_end, side="left").astype(jnp.int32), n_blocks
        )
        lo0 = jnp.clip(lo0, 0, hi0)
        blk_idx = jnp.where(need_enter, lo0, blk_idx)
        hi_idx = jnp.where(need_enter, hi0, hi_idx)
        have_last = jnp.where(need_enter, False, have_last)
        block_pos = jnp.where(need_enter, seg_start, block_pos)
        in_op = in_op | need_enter

        # --- one update_ref2_cigar_segment call
        # (liftover_read_alignment.rs:35-133)
        is_final = blk_idx >= hi_idx
        safe_blk = jnp.minimum(blk_idx, max_blocks - 1)
        this_key = bk[safe_blk]
        end = jnp.where(is_final, seg_end, jnp.minimum(this_key, seg_end))
        is_m = is_align_match(code)
        do_upd = is_rc & (end > block_pos)
        seg_len = end - block_pos

        no_last = do_upd & ~have_last
        gap_last = do_upd & have_last & (last_val < 0)
        map_last = do_upd & have_last & (last_val >= 0)

        # ref2 start adoption happens before the gap-deletion test (rs:84-96).
        new_start = jnp.where(
            map_last & is_m & (ref2_start < 0),
            last_val + (block_pos - last_key),
            ref2_start,
        )
        del_len = last_val - ref2_end
        emit_del = map_last & have_end & (del_len > 0) & (new_start >= 0)
        ref2_end = jnp.where(map_last, last_val + (end - last_key), ref2_end)
        have_end = have_end | map_last
        emit_seg = map_last & (is_m | (new_start >= 0))
        seg_code = jnp.where(code == D, D, jnp.where(code == N, N, M))
        ref2_start = new_start
        block_pos = jnp.where(do_upd, end, block_pos)

        # --- emissions: slot 0 = gap deletion, slot 1 = main segment / copy
        e0_code = jnp.where(emit_del, D, PAD)
        e0_len = jnp.where(emit_del, del_len, 0)
        emit_clip = no_last & is_m      # pre-mapping bases -> SoftClip (rs:117-123)
        emit_ins = gap_last & is_m      # ref1-only bases -> Ins (rs:111-115)
        copy = active & is_ro
        e1_code = jnp.where(
            copy,
            code,
            jnp.where(
                emit_clip, S, jnp.where(emit_ins, I, jnp.where(emit_seg, seg_code, PAD))
            ),
        )
        e1_len = jnp.where(
            copy, ln, jnp.where(emit_clip | emit_ins | emit_seg, seg_len, 0)
        )

        # --- advance pointers
        rc_final = is_rc & is_final
        advance_op = (active & (is_ro | is_skip)) | rc_final
        op_idx = op_idx + advance_op.astype(jnp.int32)
        seg_start = jnp.where(rc_final, seg_end, seg_start)
        in_op = jnp.where(advance_op, False, in_op)

        adv_blk = is_rc & ~is_final
        have_last = have_last | adv_blk
        last_key = jnp.where(adv_blk, this_key, last_key)
        last_val = jnp.where(adv_blk, bv[safe_blk], last_val)
        blk_idx = blk_idx + adv_blk.astype(jnp.int32)

        carry = (op_idx, in_op, blk_idx, hi_idx, have_last, last_key, last_val,
                 block_pos, seg_start, ref2_start, ref2_end, have_end)
        emits = jnp.stack(
            [jnp.stack([e0_code, e0_len]), jnp.stack([e1_code, e1_len])]
        )
        return carry, emits

    zero = jnp.int32(0)
    init = (
        zero,                # op_idx
        jnp.bool_(False),    # in_op
        zero,                # blk_idx
        zero,                # hi_idx
        jnp.bool_(False),    # have_last
        zero,                # last_key
        jnp.int32(NONE_VAL), # last_val
        zero,                # block_pos
        ref1_pos.astype(jnp.int32),  # seg_start
        jnp.int32(-1),       # ref2_start
        zero,                # ref2_end
        jnp.bool_(False),    # have_end
    )
    carry, emits = jax.lax.scan(step, init, None, length=max_steps)
    ref2_start = carry[9]
    emit_codes = emits[:, :, 0].reshape(-1)
    emit_lens = emits[:, :, 1].reshape(-1)
    return emit_codes, emit_lens, ref2_start


@partial(jax.jit, static_argnames=("max_out",))
def liftover_batch(ops, lens, n_ops, ref1_pos, bk, bv, n_blocks, *, max_out: int):
    """Lift a batch of read alignments through their block-map windows.

    All array args carry a leading batch dimension.  Returns a dict with
    ``ref2_pos`` (int32, -1 when unmapped), compressed ``codes``/``lens``
    (padded to ``max_out``), ``n_out`` op counts, ``mapped`` and ``overflow``
    flags.  Equivalent to vectorizing liftover_read_alignment
    (liftover_read_alignment.rs:137-223) over the batch.
    """
    emit_codes, emit_lens, ref2_start = jax.vmap(_liftover_scan_single)(
        ops, lens, n_ops, ref1_pos, bk, bv, n_blocks
    )
    out_codes, out_lens, n_out, shift, overflow = jax.vmap(
        lambda c, l: cleanup_and_compress(c, l, max_out)
    )(emit_codes, emit_lens)
    mapped = ref2_start >= 0
    ref2_pos = jnp.where(mapped, ref2_start + shift, -1)
    return {
        "ref2_pos": ref2_pos,
        "codes": out_codes,
        "lens": out_lens,
        "n_out": n_out,
        "mapped": mapped,
        "overflow": overflow,
    }
