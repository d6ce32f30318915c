"""Batched indel left-shift kernel (for reads on reverse-mapped contigs).

Data-parallel reformulation of left_shift_indels
(reference shift_indels/left_shift_indels.rs:17-39 + cigar_indel_shifter.rs:10-165):

- per-cluster homology lengths come from one bounded-window vectorized suffix
  compare (replacing get_indel_breakend_homology_info's base loop,
  indel_breakend_homology.rs:33-47);
- the builder's sequential match-block accounting — each cluster moves
  ``shift`` matched bases from before it to after it, so cluster i+1's budget
  depends on cluster i's shift — is a **min-plus affine recurrence**
  ``p_i = min(b_i, a_i + p_{i-1})``.  Because the additive part is scalar it
  has the closed form ``p_i = SA_i + min_{j<=i}(b_j - SA_j)`` with
  ``SA = cumsum(a)``: one prefix sum plus one running minimum, both cheap
  primitives (no explicit ``associative_scan`` over affine pairs).  Per-op
  transform terms: match
  op ``(a=len, b=+inf)`` (accumulate), cluster end ``(0, homology_cap)``
  (clamp), other op ``(0, 0)`` (flush/reset), everything else identity.

Coordinates: the cigar is already in contig-reverse orientation; ``ref_pos`` is
the alignment start relative to ``ref_win`` (a window of the reverse-complement
contig sequence), and ``win_base`` is the window's absolute offset on the
reversed contig (needed for the reference's absolute edge limit,
indel_breakend_homology.rs:33).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from portello_tpu.kernels.cigar_kernels import (
    D,
    I,
    M,
    PAD,
    cleanup_and_compress,
    is_align_match,
)
from portello_tpu.kernels.cluster_utils import find_clusters, match_run_right

# plain int: a jnp scalar here would instantiate a device array at import
# time and lock in the backend before the CLI can select one
_INF = (2**31 - 1) // 2


def _minplus_scan(a, b):
    """Inclusive scan of p_i = min(b_i, a_i + p_{i-1}), p_{-1} = +inf.

    Closed form: SA_i + cummin(b_j - SA_j) for j <= i, SA = inclusive cumsum.
    """
    sa = jnp.cumsum(a)
    return sa + jax.lax.cummin(b - sa)


def _shift_stage_a(
    codes, lens, ref_pos, win_base, ref_win, read_seq, *, max_clusters, window,
    mm=False,
):
    """Cluster detection + homology caps + per-op scan inputs.

    Kept as a separate stage so the homology gather chain cannot fuse into
    stage B's prefix scans; on the gather path the engine runs A and B as
    separate device calls with device-resident intermediates.
    """
    from portello_tpu.kernels.expand import expand_mask, onehot_eq

    cl = find_clusters(codes, lens, ref_pos, max_clusters, mm)
    dl = cl["del_len"]
    il = cl["ins_len"]
    bs = cl["ref_start"]       # window-relative
    rs = cl["read_start"]

    # Leftward homology run (indel_breakend_homology.rs:33-47): compare the
    # suffixes ending at the indel's ref/read end, limited by the absolute
    # distance to either sequence start.
    max_left = jnp.minimum(win_base + bs, rs)
    h_run, sat = match_run_right(ref_win, bs + dl, read_seq, rs + il, max_left, window, mm)
    has_indel = (dl + il) > 0
    h_cap = jnp.minimum(h_run, max_left)

    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    is_m = is_align_match(codes) & valid
    is_other = valid & ~is_indel & ~is_m
    cend = cl["cluster_end"]
    cid = jnp.clip(cl["cluster_id"], 0, max_clusters - 1)

    # One packed gather for every per-cluster value consumed at op positions
    # (one gather of contiguous rows instead of one per value).
    c_table = jnp.stack(
        [
            h_cap.astype(jnp.int32),
            (sat & has_indel).astype(jnp.int32),
            max_left.astype(jnp.int32),
            il.astype(jnp.int32),
            dl.astype(jnp.int32),
        ],
        axis=1,
    )
    if mm:
        cv = expand_mask(onehot_eq(cid, max_clusters), c_table)
    else:
        cv = jnp.take_along_axis(c_table, cid[:, None], axis=0)
    cap_at_op = cv[:, 0]

    # Per-op min-plus transforms (see module docstring).
    a = jnp.where(is_m, lens, 0)
    b = jnp.where(cend, cap_at_op, jnp.where(is_other, 0, _INF))
    return {
        "a": a, "b": b, "cend": cend, "is_other": is_other,
        "ins_at_op": cv[:, 3], "del_at_op": cv[:, 4],
        "cap_at_op": cap_at_op, "fb_sat": cv[:, 1] > 0, "ml_at_op": cv[:, 2],
        "overflow": cl["overflow"],
    }


def _shift_stage_b(
    codes, lens, ref_pos, st, *, window, max_out, mm=False
):
    """Min-plus scan + emissions + cleanup/compress over stage-A outputs."""
    n = codes.shape[0]
    a = st["a"]
    b = st["b"]
    cend = st["cend"]
    is_other = st["is_other"]

    # Exclusive scan: pending BEFORE each op, starting from p0 = 0 (the
    # leading (0, 0) element seeds min(b_0=0, ...) = 0).
    a_ext = jnp.concatenate([jnp.zeros(1, jnp.int32), a.astype(jnp.int32)])
    b_ext = jnp.concatenate([jnp.zeros(1, jnp.int32), b.astype(jnp.int32)])
    p = _minplus_scan(a_ext, b_ext)
    pending_before = p[:n]
    pending_final = p[n]

    # Emissions: at a cluster end, split the preceding match run around the
    # shifted indel (nImD order, cigar_indel_shifter.rs:140-147); at an
    # "other" op, flush the match run then copy the op.  The 3-op cluster
    # replacement [M][I][D] is split across the cluster's last TWO rows —
    # [M, I] at the second-to-last, [D] at the last — which always fits:
    # clusters needing all three ops contain both an I and a D so span >= 2
    # ops, while single-op clusters are pure and emit [M, I-or-D] from the
    # end row.  (pending_before and the per-cluster cap are identical at both
    # rows: intermediate indel ops are min-plus identities.)  Two slots per
    # op instead of three shrinks the cleanup/compress stream by a third.
    s = jnp.minimum(st["cap_at_op"], pending_before)
    is_indel = ((codes == I) | (codes == D)) & (codes != PAD)
    pre_end = is_indel & jnp.concatenate([cend[1:], jnp.zeros(1, bool)])
    prev_indel = jnp.concatenate([jnp.zeros(1, bool), is_indel[:-1]])
    single = cend & ~prev_indel
    ins_l = st["ins_at_op"]
    del_l = st["del_at_op"]
    e_codes = jnp.stack(
        [
            jnp.where(
                pre_end | (cend & single) | is_other,
                M,
                jnp.where(cend, D, PAD),
            ),
            jnp.where(
                pre_end,
                I,
                jnp.where(
                    cend & single,
                    jnp.where(ins_l > 0, I, D),
                    jnp.where(is_other, codes, PAD),
                ),
            ),
        ],
        axis=1,
    )
    e_lens = jnp.stack(
        [
            jnp.where(
                pre_end | (cend & single),
                pending_before - s,
                jnp.where(
                    is_other, pending_before, jnp.where(cend, del_l, 0)
                ),
            ),
            jnp.where(
                pre_end,
                ins_l,
                jnp.where(
                    cend & single,
                    jnp.where(ins_l > 0, ins_l, del_l),
                    jnp.where(is_other, lens, 0),
                ),
            ),
        ],
        axis=1,
    )
    # The builder pushes only nonzero segments (cigar_indel_shifter.rs:87-99,
    # :133-137); zero-length M would wrongly stop the edge cleanup walk.  The
    # "other" op itself (slot 1) is kept even when zero-length.
    keep_zero = is_other[:, None] & (jnp.arange(2) == 1)[None, :]
    e_codes = jnp.where((e_lens == 0) & ~keep_zero, PAD, e_codes)

    # Fallback: homology window saturated AND the true budget could exceed it.
    fb = cend & st["fb_sat"] & (
        jnp.minimum(st["ml_at_op"], pending_before) > window
    )
    fallback = jnp.any(fb) | st["overflow"]

    # Final flush of the trailing match run (cigar_indel_shifter.rs:155-160);
    # pushed only when nonzero.
    tail_code = jnp.where(pending_final > 0, M, PAD).astype(codes.dtype)
    flat_codes = jnp.concatenate([e_codes.reshape(-1), tail_code[None]])
    flat_lens = jnp.concatenate([e_lens.reshape(-1), pending_final[None]])

    # mm_form="search": the boundary-search compress form in stage B's
    # graph (the fwd pipeline uses the segment-sum form).
    f_codes, f_lens, n_out, shift, c_overflow = cleanup_and_compress(
        flat_codes, flat_lens, max_out, mm, mm_form="search"
    )
    fallback = fallback | c_overflow
    return f_codes, f_lens, n_out, ref_pos + shift, fallback


def _left_shift_single(
    codes, lens, ref_pos, win_base, ref_win, read_seq,
    *, max_clusters, window, max_out, mm=False,
):
    """Single-graph composition of stages A and B (tests / dry runs; the
    engine dispatches the stages separately, see shift_stage_a/b)."""
    st = _shift_stage_a(
        codes, lens, ref_pos, win_base, ref_win, read_seq,
        max_clusters=max_clusters, window=window, mm=mm,
    )
    return _shift_stage_b(
        codes, lens, ref_pos, st, window=window, max_out=max_out, mm=mm
    )


@partial(jax.jit, static_argnames=("max_clusters", "window", "mm"))
def shift_stage_a_batch(codes, lens, ref_pos, win_base, ref_win, read_seq,
                        *, max_clusters, window, mm=False):
    return jax.vmap(
        lambda c, l, p, wb, rw, rq: _shift_stage_a(
            c, l, p, wb, rw, rq, max_clusters=max_clusters, window=window, mm=mm
        )
    )(codes, lens, ref_pos, win_base, ref_win, read_seq)


@partial(jax.jit, static_argnames=("window", "max_out", "mm"))
def shift_stage_b_batch(codes, lens, ref_pos, st, *, window, max_out, mm=False):
    return jax.vmap(
        lambda c, l, p, s: _shift_stage_b(
            c, l, p, s, window=window, max_out=max_out, mm=mm
        )
    )(codes, lens, ref_pos, st)


@partial(jax.jit, static_argnames=("max_clusters", "window", "max_out", "mm"))
def left_shift_batch(
    codes, lens, ref_pos, win_base, ref_win, read_seq,
    *, max_clusters, window, max_out, mm=False,
):
    """Vectorized left_shift_indels over a batch.

    Returns (codes, lens, n_out, ref_pos, fallback).
    """
    return jax.vmap(
        lambda c, l, p, wb, rw, rq: _left_shift_single(
            c, l, p, wb, rw, rq,
            max_clusters=max_clusters, window=window, max_out=max_out, mm=mm,
        )
    )(codes, lens, ref_pos, win_base, ref_win, read_seq)
