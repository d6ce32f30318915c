"""Shared indel-cluster machinery for the sequence-dependent device kernels.

Both indel simplification (reference src/simplify_alignment_indels.rs:4-112) and
indel shifting (reference shift_indels/cigar_indel_shifter.rs:10-165) operate on
*clusters*: maximal runs of I/D ops.  This module provides the vectorized cluster
detection / per-cluster reductions, and the bounded-window base comparison that
replaces the reference's unbounded greedy base loops.  A window saturation sets a
per-read ``fallback`` flag; those reads are finished exactly on host by the
``portello_tpu.ops`` oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from portello_tpu.kernels.cigar_kernels import (
    D,
    I,
    PAD,
    consumes_read,
    consumes_ref,
)


def op_positions(codes, lens, ref_pos):
    """Per-op (ref_start, read_start) as exclusive prefix sums
    (vectorized update_ref_and_read_pos walk, cigar/mod.rs:70-78)."""
    rl = jnp.where(consumes_ref(codes), lens, 0)
    dl = jnp.where(consumes_read(codes), lens, 0)
    ref_starts = ref_pos + jnp.cumsum(rl) - rl
    read_starts = jnp.cumsum(dl) - dl
    return ref_starts, read_starts


def find_clusters(codes, lens, ref_pos, max_clusters: int, mm: bool = False):
    """Detect indel clusters and reduce their stats.

    Returns a dict of per-cluster arrays (length ``max_clusters``):
    ``ref_start``/``read_start`` (coords at cluster start), ``del_len``/
    ``ins_len`` sums, plus per-op ``cluster_id`` (-1 for non-indel ops),
    ``cluster_end`` (op is last of its cluster), ``n_clusters`` and an
    ``overflow`` flag when the cluster count exceeds the static bound.
    """
    n = codes.shape[0]
    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    prev_indel = jnp.concatenate([jnp.zeros(1, bool), is_indel[:-1]])
    next_indel = jnp.concatenate([is_indel[1:], jnp.zeros(1, bool)])
    cluster_start = is_indel & ~prev_indel
    cluster_end = is_indel & ~next_indel
    cid = jnp.where(is_indel, jnp.cumsum(cluster_start.astype(jnp.int32)) - 1, -1)
    n_clusters = jnp.sum(cluster_start.astype(jnp.int32))
    overflow = n_clusters > max_clusters

    ref_starts, read_starts = op_positions(codes, lens, ref_pos)

    # Scatter-free per-cluster reductions (segment sums, no scatter).
    k = jnp.arange(max_clusters, dtype=jnp.int32)
    cvalid = k < n_clusters
    del_src = jnp.where((codes == D) & valid, lens, 0)
    ins_src = jnp.where((codes == I) & valid, lens, 0)
    if mm:
        # ONE segment-sum matmul serves all four per-cluster stats: row k of
        # the eq mask [cid == k] sums that cluster's D/I lens, and — since
        # exactly one op per cluster has cluster_start — its start coords
        # (kernels/expand.expand_sum; replaces the boundary-search +
        # prefix-table-difference formulation: one mask instead of three).
        from portello_tpu.kernels.expand import expand_sum

        mask = (cid[None, :] == k[:, None]).astype(jnp.bfloat16)
        table = jnp.stack(
            [
                jnp.where(cluster_start, ref_starts.astype(jnp.int32), 0),
                jnp.where(cluster_start, read_starts.astype(jnp.int32), 0),
                del_src.astype(jnp.int32),
                ins_src.astype(jnp.int32),
            ],
            axis=1,
        )
        sums = expand_sum(mask, table)
        c_ref = jnp.where(cvalid, sums[:, 0], 0)
        c_read = jnp.where(cvalid, sums[:, 1], 0)
        c_del = jnp.where(cvalid, sums[:, 2], 0)
        c_ins = jnp.where(cvalid, sums[:, 3], 0)
    else:
        # cluster k starts at op index starts[k] (binary search over the
        # cluster-start prefix sum); I/D sums are prefix-sum differences over
        # [starts[k], starts[k+1]).
        cs = jnp.cumsum(cluster_start.astype(jnp.int32))
        boundary_q = jnp.arange(1, max_clusters + 2, dtype=jnp.int32)
        sboth = jnp.searchsorted(
            cs, boundary_q, side="left", method="sort"
        ).astype(jnp.int32)
        starts = sboth[:-1]
        starts_next = sboth[1:]
        safe_starts = jnp.clip(starts, 0, n - 1)
        ps_del = jnp.concatenate([jnp.zeros(1, lens.dtype), jnp.cumsum(del_src)])
        ps_ins = jnp.concatenate([jnp.zeros(1, lens.dtype), jnp.cumsum(ins_src)])
        start_table = jnp.stack(
            [ref_starts.astype(jnp.int32), read_starts.astype(jnp.int32)], axis=1
        )
        ps_table = jnp.stack(
            [ps_del.astype(jnp.int32), ps_ins.astype(jnp.int32)], axis=1
        )
        both_idx = jnp.concatenate([starts, starts_next])
        sv = jnp.take_along_axis(start_table, safe_starts[:, None], axis=0)
        pv = jnp.take_along_axis(ps_table, both_idx[:, None], axis=0)
        c_del = jnp.where(cvalid, pv[max_clusters:, 0] - pv[:max_clusters, 0], 0)
        c_ins = jnp.where(cvalid, pv[max_clusters:, 1] - pv[:max_clusters, 1], 0)
        c_ref = jnp.where(cvalid, sv[:, 0], 0)
        c_read = jnp.where(cvalid, sv[:, 1], 0)

    return {
        "ref_start": c_ref,
        "read_start": c_read,
        "del_len": c_del,
        "ins_len": c_ins,
        "cluster_id": cid,
        "cluster_end": cluster_end,
        "n_clusters": n_clusters,
        "overflow": overflow,
    }


def _window_bytes(seq, start, window: int, fill: int):
    """Extract (C, window) byte windows starting at ``start``.

    Gathers 4-byte WORDS instead of bytes (4x fewer gather elements) then
    re-aligns the sub-word
    offset with a 4-way select.  ``seq`` length must be a multiple of 4.  The
    sequence is padded with ``fill`` sentinel bytes on both sides so windows
    reaching past either end stay lane-aligned (pass DIFFERENT fills for the
    two compared sequences so out-of-data lanes always mismatch).
    """
    pad = window // 4 * 4 + 4  # even multiple of 4, >= window
    padded = jnp.concatenate(
        [
            jnp.full(pad, fill, jnp.uint8), seq, jnp.full(pad, fill, jnp.uint8),
        ]
    )
    np_ = padded.shape[0]
    nw = window // 4 + 2
    start = jnp.clip(start + pad, 0, np_ - window - 4)
    words = jax.lax.bitcast_convert_type(
        padded.reshape(np_ // 4, 4), jnp.uint32
    )
    w0 = start >> 2
    widx = jnp.clip(w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :], 0, np_ // 4 - 1)
    w = words[widx]                                   # (C, nw) uint32
    by = jnp.stack(
        [w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF],
        axis=2,
    ).reshape(start.shape[0], nw * 4).astype(jnp.uint8)  # (C, nw*4)
    off = (start & 3)[:, None]                        # 0..3
    out = by[:, 0:window]
    for k in (1, 2, 3):
        out = jnp.where(off == k, by[:, k : k + window], out)
    return out


def _window_bytes_mm(seq, start, window: int, fill: int):
    """Matmul formulation of :func:`_window_bytes` (bit-identical windows).

    Level 1: the padded sequence is viewed as 64-byte superblocks; each
    window's two covering superblocks (128 contiguous bytes) are fetched with
    one one-hot matmul over the superblock axis (exact for bytes,
    kernels/expand.py).  Level 2: the residual offset o in [0, 64) is removed
    with a 16-way 4-byte-step select then a 4-way byte select — all VPU
    elementwise.  Replaces a C*(window/4+2)-index gather with one matrix
    product and elementwise selects.

    Caller contract (same as the gather path): ``start`` >= -window and
    <= len(seq); out-of-data lanes are filled with ``fill`` so differing
    per-sequence sentinels always mismatch.
    """
    from portello_tpu.kernels.expand import expand_bytes, onehot_eq

    if window > 60:
        raise ValueError("window must be <= 60 for the 128-byte span")
    length = seq.shape[0]
    pad_lo = 64
    # high pad: 128-byte span from the last reachable superblock must stay
    # in-table for start up to len(seq); also round len up to 64
    pad_hi = 192 + (-length) % 64
    padded = jnp.concatenate(
        [
            jnp.full(pad_lo, fill, jnp.uint8),
            seq,
            jnp.full(pad_hi, fill, jnp.uint8),
        ]
    )
    nsb = padded.shape[0] // 64
    table = padded.reshape(nsb, 64)
    p = start + pad_lo
    sb = jnp.clip(p >> 6, 0, nsb - 2)
    o = p - (sb << 6)
    # Two matmuls against the raw 64-byte-superblock table rather than one
    # against a 128-wide adjacent-pair table, whose concat forces a strided
    # matmul operand.  Both share ONE one-hot mask —
    # onehot(sb+1) @ table == onehot(sb) @ table[1:] — halving the dominant
    # HBM term (the materialized (C, nsb) mask).
    mask = onehot_eq(sb, nsb - 1)
    span_lo = expand_bytes(mask, table[:-1])
    span_hi = expand_bytes(mask, table[1:])
    span = jnp.concatenate([span_lo, span_hi], axis=1)  # (C, 128)
    # Realign the residual offset o in [0, 64) at WORD granularity: a barrel
    # shifter (4 progressively-narrowing selects over the word shift bits)
    # plus a variable per-row bit-shift combine for the sub-word offset.
    nw = window // 4 + 2  # combine consumes one extra word
    words = jax.lax.bitcast_convert_type(
        span.reshape(span.shape[0], 32, 4), jnp.uint32
    )  # (C, 32) little-endian
    ow = o >> 2  # word shift in [0, 16)
    w16 = words
    for bit in (8, 4, 2, 1):
        need = nw + bit - 1
        w16 = jnp.where(
            ((ow & bit) != 0)[:, None], w16[:, bit : bit + need], w16[:, :need]
        )
    b = ((o & 3) << 3)[:, None].astype(jnp.uint32)  # 0/8/16/24
    lo_part = jnp.right_shift(w16[:, :-1], b)
    hi_part = jnp.left_shift(w16[:, 1:], jnp.uint32(32) - b)
    v = jnp.where(b == 0, w16[:, :-1], lo_part | hi_part)  # (C, nw-1)
    by = jnp.stack(
        [(v >> (8 * i)) & 0xFF for i in range(4)], axis=2
    ).reshape(v.shape[0], 4 * (nw - 1)).astype(jnp.uint8)
    return by[:, :window]


def _window_bytes_mm_t(seq, start, window: int, fill: int):
    """Transposed :func:`_window_bytes_mm`: returns (window, C) with the
    cluster axis LAST (the minor, contiguous dimension).

    The realign selects then run with the big axis minor instead of the
    ~14-wide word axis of the (C, words) layout.  With bytes on the major
    axis the realign is a plain 6-stage byte-granularity barrel shifter —
    no word bitcast or sub-word bit combine.
    """
    if window > 60:
        raise ValueError("window must be <= 60 for the 128-byte span")
    length = seq.shape[0]
    pad_lo = 64
    pad_hi = 192 + (-length) % 64
    padded = jnp.concatenate(
        [
            jnp.full(pad_lo, fill, jnp.uint8),
            seq,
            jnp.full(pad_hi, fill, jnp.uint8),
        ]
    )
    nsb = padded.shape[0] // 64
    table = padded.reshape(nsb, 64)
    p = start + pad_lo
    sb = jnp.clip(p >> 6, 0, nsb - 2)
    o = p - (sb << 6)
    # Mask-LHS expansion: span = mask @ table with the table in its NATURAL
    # layout — the table-LHS form needs a whole-table (nsb, 64) bf16
    # transpose per call; here only the small (C, 128) span is transposed.
    # One shared (C, nsb-1) bf16 mask serves both superblocks (byte values
    # <= 255 are exact in bf16 products; see kernels/expand.py).
    mask = (
        sb[:, None] == jnp.arange(nsb - 1, dtype=jnp.int32)[None, :]
    ).astype(jnp.bfloat16)
    tb = table.astype(jnp.bfloat16)
    out_lo = jax.lax.dot(mask, tb[:-1], preferred_element_type=jnp.float32)
    out_hi = jax.lax.dot(mask, tb[1:], preferred_element_type=jnp.float32)
    span = jnp.concatenate([out_lo, out_hi], axis=1).astype(jnp.uint8)  # (C, 128)
    w = span.T  # (128, C): clusters stay on the lane axis for the barrel
    for bit in (32, 16, 8, 4, 2, 1):
        need = window + bit - 1
        w = jnp.where(((o & bit) != 0)[None, :], w[bit : bit + need], w[:need])
    return w[:window]


def match_run_left(seq_a, idx_a, seq_b, idx_b, limit, window: int, mm: bool = False):
    """Length of the forward common run: how many t in [0, limit) satisfy
    ``seq_a[idx_a + t] == seq_b[idx_b + t]``, scanning at most ``window`` steps.

    idx_* are (C,) int32 vectors (one per cluster); returns (run_len, saturated)
    where ``saturated`` means the window was exhausted while still matching with
    ``limit`` unreached (exact result unknown -> caller sets fallback).
    Out-of-data lanes (index clamping) are only reachable at t >= limit, which
    the mask excludes — callers guarantee in-data reads below ``limit``.
    ``mm`` selects the superblock one-hot-matmul window fetch (bit-identical
    for -window <= idx <= len(seq), which the cluster coordinates guarantee).
    """
    if mm:
        t = jnp.arange(window, dtype=jnp.int32)[:, None]
        wa = _window_bytes_mm_t(seq_a, idx_a, window, 0xFE)
        wb = _window_bytes_mm_t(seq_b, idx_b, window, 0xFD)
        eq = (t < limit[None, :]) & (wa == wb)
        run = jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=0), axis=0)
    else:
        t = jnp.arange(window, dtype=jnp.int32)[None, :]
        wa = _window_bytes(seq_a, idx_a, window, 0xFE)
        wb = _window_bytes(seq_b, idx_b, window, 0xFD)
        eq = (t < limit[:, None]) & (wa == wb)
        run = jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=1), axis=1)
    saturated = (run >= window) & (limit > window)
    return run, saturated


def match_run_right(seq_a, end_a, seq_b, end_b, limit, window: int, mm: bool = False):
    """Length of the backward common run: how many t in [0, limit) satisfy
    ``seq_a[end_a - 1 - t] == seq_b[end_b - 1 - t]`` (right-aligned suffix
    compare), scanning at most ``window`` steps."""
    if mm:
        # suffix run without any flip: position i participates for
        # t = window-1-i, and the run is sum of REVERSE cumulative products
        i = jnp.arange(window, dtype=jnp.int32)[:, None]
        wa = _window_bytes_mm_t(seq_a, end_a - window, window, 0xFE)
        wb = _window_bytes_mm_t(seq_b, end_b - window, window, 0xFD)
        eq = ((window - 1 - i) < limit[None, :]) & (wa == wb)
        run = jnp.sum(
            jax.lax.cumprod(eq.astype(jnp.int32), axis=0, reverse=True), axis=0
        )
    else:
        t = jnp.arange(window, dtype=jnp.int32)[None, :]
        # window covering [end-window, end), compared reversed (lane w <-> t=W-1-w)
        wa = _window_bytes(seq_a, end_a - window, window, 0xFE)[:, ::-1]
        wb = _window_bytes(seq_b, end_b - window, window, 0xFD)[:, ::-1]
        eq = (t < limit[:, None]) & (wa == wb)
        run = jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=1), axis=1)
    saturated = (run >= window) & (limit > window)
    return run, saturated
