"""Batched indel-cluster simplification kernel.

Data-parallel reformulation of simplify_alignment_indels
(reference src/simplify_alignment_indels.rs:4-156): cluster detection and
reductions are data-parallel scatter/segment ops; the reference's greedy
per-base re-match loops (right edge first, then left edge, rs:54-92) become two
bounded-window vectorized common-run computations.  Window saturation sets the
per-read ``fallback`` flag (exact finish on host).

Coordinates: ``ref_pos`` is relative to the supplied ``ref_win`` window (the
host gathers a reference-genome window covering the lifted alignment span).
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
)
from portello_tpu.kernels.cluster_utils import (
    find_clusters,
    match_run_left,
    match_run_right,
)


def _cluster_cases(codes, lens, ref_pos, max_clusters, mm):
    """find_clusters + the reference's case split (rs:41-49): pure and 1/1
    clusters bypass sequence inspection; only MIXED clusters (both I and D
    present; rare in HiFi data) need sequence windows at all."""
    cl = find_clusters(codes, lens, ref_pos, max_clusters, mm)
    dl = cl["del_len"]
    il = cl["ins_len"]
    cvalid = jnp.arange(max_clusters, dtype=jnp.int32) < cl["n_clusters"]
    pure = (dl == 0) | (il == 0)
    one_one = (dl == 1) & (il == 1)
    mixed = cvalid & ~pure & ~one_one
    return cl, cvalid, pure, one_one, mixed


def _simplify_single(
    codes, lens, ref_pos, ref_win, read_seq, *, max_clusters, window, max_out,
    mm=False,
):
    cl, cvalid, pure, one_one, mixed = _cluster_cases(
        codes, lens, ref_pos, max_clusters, mm
    )
    dl = cl["del_len"]
    il = cl["ins_len"]
    bs = cl["ref_start"]
    rs = cl["read_start"]
    mixed_overflow = jnp.zeros((), bool)

    # Right-edge greedy re-match (rs:54-68), then left-edge (rs:71-85).
    # The limit only caps the run (run = min(raw, limit); saturated =
    # raw-filled-window & limit > window — the compare itself is
    # limit-independent), so with mm both directions fetch in ONE combined
    # window call per sequence (half the fetch dispatches) and the
    # sequential m1-after-post dependence becomes post-arithmetic.
    m0 = jnp.minimum(dl, il)
    if mm:
        from portello_tpu.kernels.cluster_utils import _window_bytes_mm_t
        from portello_tpu.kernels.expand import expand_sum

        # Compact the mixed clusters into a small static budget so the
        # window fetches run over far fewer lanes; reads whose mixed count
        # exceeds the budget fall back to the exact host path.  HiFi-shape
        # items carry ~0.05 mixed clusters per read, max 1, so 8 is ~an
        # order of magnitude of slack.
        mx = max(8, max_clusters // 16)
        rank = jnp.cumsum(mixed.astype(jnp.int32)) - 1
        mixed_overflow = jnp.sum(mixed.astype(jnp.int32)) > mx
        j = jnp.arange(mx, dtype=jnp.int32)
        cmask = (
            (rank[None, :] == j[:, None]) & mixed[None, :]
        ).astype(jnp.bfloat16)
        cv4 = expand_sum(
            cmask, jnp.stack([bs, rs, dl, il], axis=1).astype(jnp.int32)
        )
        bsj, rsj, dlj, ilj = cv4[:, 0], cv4[:, 1], cv4[:, 2], cv4[:, 3]
        sa = jnp.concatenate([bsj + dlj - window, bsj])
        sb = jnp.concatenate([rsj + ilj - window, rsj])
        # transposed fetch: (window, 2mx) with clusters on the lane axis
        # (full-width realign selects; see _window_bytes_mm_t)
        wa = _window_bytes_mm_t(ref_win, sa, window, 0xFE)
        wb = _window_bytes_mm_t(read_seq, sb, window, 0xFD)
        eq_r = wa[:, :mx] == wb[:, :mx]
        eq_l = wa[:, mx:] == wb[:, mx:]
        # right edge = suffix run: reverse cumulative products, no flip
        raw_r_j = jnp.sum(
            jax.lax.cumprod(eq_r.astype(jnp.int32), axis=0, reverse=True), axis=0
        )
        raw_l_j = jnp.sum(jnp.cumprod(eq_l.astype(jnp.int32), axis=0), axis=0)
        # expand back to cluster lanes (non-mixed rows get 0: never consumed)
        emask = (
            (rank[:, None] == j[None, :]) & mixed[:, None]
        ).astype(jnp.bfloat16)
        back = expand_sum(emask, jnp.stack([raw_r_j, raw_l_j], axis=1))
        raw_r = back[:, 0]
        raw_l = back[:, 1]
    else:
        # the limit-capped runs coincide with min(raw, limit) (the compare
        # mask stops at the limit), so they feed _finish_from_runs directly
        raw_r, _ = match_run_right(
            ref_win, bs + dl, read_seq, rs + il, m0, window, mm
        )
        raw_l, _ = match_run_left(
            ref_win, bs, read_seq, rs,
            jnp.minimum(dl, il) - jnp.minimum(raw_r, m0), window, mm,
        )
    out = _finish_from_runs(
        codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed, raw_r, raw_l,
        max_clusters=max_clusters, window=window, max_out=max_out, mm=mm,
    )
    f_codes, f_lens, n_out, out_pos, fallback = out
    return f_codes, f_lens, n_out, out_pos, fallback | mixed_overflow


def _finish_from_runs(
    codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed, raw_r, raw_l,
    *, max_clusters, window, max_out, mm,
):
    """Case arithmetic + emission + compress given the per-cluster window
    runs (raw or limit-capped — identical downstream, see the min() chain)."""
    from portello_tpu.kernels.expand import expand_mask, onehot_eq

    dl = cl["del_len"]
    il = cl["ins_len"]
    m0 = jnp.minimum(dl, il)
    post = jnp.minimum(raw_r, m0)
    sat_post = (raw_r >= window) & (m0 > window)
    dl1 = dl - post
    il1 = il - post
    m1 = jnp.minimum(dl1, il1)
    pre = jnp.minimum(raw_l, m1)
    sat_pre = (raw_l >= window) & (m1 > window)
    dl2 = dl1 - pre
    il2 = il1 - pre
    # Final SNP preference (rs:87-92).
    snp = (dl2 == 1) & (il2 == 1)
    post_f = post + snp.astype(post.dtype)
    dl2 = jnp.where(snp, 0, dl2)
    il2 = jnp.where(snp, 0, il2)

    # Per-cluster emission, canonical nImD order: [M pre][I][D][M post].
    c_codes = jnp.stack(
        [
            jnp.where(mixed, M, PAD),
            jnp.where(mixed | pure, I, jnp.where(one_one, M, PAD)),
            jnp.full_like(dl, D),
            jnp.where(mixed, M, PAD),
        ],
        axis=1,
    )
    c_lens = jnp.stack(
        [
            jnp.where(mixed, pre, 0),
            jnp.where(mixed, il2, jnp.where(pure, il, jnp.where(one_one, 1, 0))),
            jnp.where(mixed, dl2, jnp.where(pure, dl, 0)),
            jnp.where(mixed, post_f, 0),
        ],
        axis=1,
    )
    c_codes = jnp.where(cvalid[:, None], c_codes, PAD)
    c_lens = jnp.where(cvalid[:, None], c_lens, 0)
    # The reference pushes only nonzero elements (rpush, rs:95-99); a zero-length
    # M placeholder would wrongly stop the edge-indel cleanup walk.
    c_codes = jnp.where(c_lens == 0, PAD, c_codes)

    # Reassemble: pass-through ops emit themselves.  The (up to 4-op) cluster
    # replacement [M pre][I][D][M post] is split across the cluster's LAST TWO
    # rows — [M pre, I] at the second-to-last, [D, M post] at the last — which
    # is always enough: mixed clusters (the only ones needing >2 ops) contain
    # both an I and a D so span >= 2 ops, while single-op clusters are pure
    # and emit their <=1 nonzero op from the end row's [I, D] columns.  Two
    # emission slots per op instead of four halves the cleanup/compress
    # stream, the dominant reassembly cost.
    valid = codes != PAD
    is_indel = ((codes == I) | (codes == D)) & valid
    cend = cl["cluster_end"]
    cid = jnp.clip(cl["cluster_id"], 0, max_clusters - 1)
    pre_end = is_indel & jnp.concatenate([cend[1:], jnp.zeros(1, bool)])
    prev_indel = jnp.concatenate([jnp.zeros(1, bool), is_indel[:-1]])
    single = cend & ~prev_indel
    # one packed lookup for the cluster replacement rows (codes+lens together)
    c_packed = jnp.concatenate(
        [c_codes.astype(jnp.int32), c_lens.astype(jnp.int32)], axis=1
    )
    if mm:
        cv = expand_mask(onehot_eq(cid, max_clusters), c_packed)
    else:
        cv = jnp.take_along_axis(c_packed, cid[:, None], axis=0)
    # column pair: pre_end -> (0,1); single-op end -> (1,2); multi-op end -> (2,3)
    sel0_code = jnp.where(pre_end, cv[:, 0], jnp.where(single, cv[:, 1], cv[:, 2]))
    sel1_code = jnp.where(pre_end, cv[:, 1], jnp.where(single, cv[:, 2], cv[:, 3]))
    sel0_len = jnp.where(pre_end, cv[:, 4], jnp.where(single, cv[:, 5], cv[:, 6]))
    sel1_len = jnp.where(pre_end, cv[:, 5], jnp.where(single, cv[:, 6], cv[:, 7]))
    emit = pre_end | cend
    passthru = valid & ~is_indel
    out_codes = jnp.stack(
        [
            jnp.where(passthru, codes, jnp.where(emit, sel0_code, PAD)),
            jnp.where(emit, sel1_code, PAD),
        ],
        axis=1,
    )
    out_lens = jnp.stack(
        [
            jnp.where(passthru, lens, jnp.where(emit, sel0_len, 0)),
            jnp.where(emit, sel1_len, 0),
        ],
        axis=1,
    )

    flat_codes = out_codes.reshape(-1)
    flat_lens = out_lens.reshape(-1)
    f_codes, f_lens, n_out, shift, c_overflow = cleanup_and_compress(
        flat_codes, flat_lens, max_out, mm
    )
    fallback = (
        jnp.any(mixed & (sat_post | sat_pre)) | cl["overflow"] | c_overflow
    )
    return f_codes, f_lens, n_out, ref_pos + shift, fallback


MXI = 2    # per-item mixed-cluster slots (measured max 1 per HiFi read)
GBUDGET = 64  # batch-wide mixed-cluster slots at B=512 (measured ~26/512)


def _g_budget(b: int) -> int:
    """Global mixed-cluster slots: GBUDGET per 512 items (the measured rate
    plus ~2.5x headroom), scaled with batch size and 8-aligned."""
    return min(MXI * b, max(GBUDGET, -(-b * GBUDGET // 512) // 8 * 8))


def _slot_windows_wordgather(rows, starts, window, fill):
    """(G, L) byte rows + (G, W) window starts -> (G, W, window) bytes.

    Word-granularity take_along_axis: each window needs window//4 + 1 int32
    words from its row (re-aligned by the sub-word byte offset), so the whole
    slot-window fetch is a single ~(G, W*(window//4+1)) gather — thousands of
    elements, vs the per-slot superblock matmuls' pad/convert/dot chain.
    ``fill``
    pads out-of-range reads exactly like _window_bytes_mm_t (0xFE vs 0xFD
    never compare equal).  Bit-identical windows by construction.
    """
    g, length = rows.shape
    nw = starts.shape[1]
    assert window % 4 == 0, "word realign assumes a 4-aligned window"
    wpad = 64
    # the front pad must absorb the most negative in-contract start
    # (starts >= -window); a wider window needs a wider pad
    assert window <= wpad, f"window {window} exceeds the {wpad}-byte pad"
    padded = jnp.concatenate(
        [
            jnp.full((g, wpad), fill, jnp.uint8),
            rows,
            jnp.full((g, wpad + 64), fill, jnp.uint8),
        ],
        axis=1,
    )
    words = jax.lax.bitcast_convert_type(
        padded.reshape(g, -1, 4), jnp.uint32
    )  # (G, L'/4)
    p = jnp.clip(starts + wpad, 0, length + wpad)  # starts >= -window by contract
    wstart = p >> 2
    o = (p & 3).astype(jnp.uint32)  # sub-word byte offset
    k = window // 4
    t = jnp.arange(k + 1, dtype=jnp.int32)
    idx = (wstart[:, :, None] + t[None, None, :]).reshape(g, nw * (k + 1))
    got = jnp.take_along_axis(words, idx, axis=1).reshape(g, nw, k + 1)
    sh = (8 * o)[:, :, None]
    lo = got[:, :, :k] >> sh
    hi = jnp.where(
        (o == 0)[:, :, None], jnp.uint32(0), got[:, :, 1:] << (32 - sh)
    )
    v = lo | hi  # (G, W, k) aligned words
    shifts = (8 * jnp.arange(4, dtype=jnp.uint32))[None, None, None, :]
    b = ((v[:, :, :, None] >> shifts) & 0xFF).astype(jnp.uint8)
    return b.reshape(g, nw, window)


def _compact_core(
    codes, lens, ref_pos, runs_fn, *, max_clusters, window, max_out,
):
    """Shared batch-compaction machinery for the mm simplify variants.

    Detects each item's mixed clusters, compacts the batch's (item, cluster)
    pairs into ``_g_budget`` global slots, calls ``runs_fn(gst, gitem) ->
    (raw_r_g, raw_l_g)`` to window-compare the slots (the only part that
    differs between the per-item-table and device-resident formulations),
    scatters the runs back, and finishes.  ``gst`` is (G, 4) int32 per-slot
    [ref_start, read_start, del_len, ins_len]; ``gitem`` (G,) the slot's
    item index (0 for empty slots, whose runs are never consumed).
    """
    from portello_tpu.kernels.expand import expand_sum

    b = codes.shape[0]
    g_budget = _g_budget(b)

    def part1(c, l, p):
        cl, cvalid, pure, one_one, mixed = _cluster_cases(
            c, l, p, max_clusters, True
        )
        rank = jnp.cumsum(mixed.astype(jnp.int32)) - 1
        n_mix = jnp.sum(mixed.astype(jnp.int32))
        j = jnp.arange(MXI, dtype=jnp.int32)
        cmask = (
            (rank[None, :] == j[:, None]) & mixed[None, :]
        ).astype(jnp.bfloat16)
        st4 = expand_sum(
            cmask,
            jnp.stack(
                [cl["ref_start"], cl["read_start"], cl["del_len"], cl["ins_len"]],
                axis=1,
            ).astype(jnp.int32),
        )
        return cl, cvalid, pure, one_one, mixed, rank, n_mix, st4

    cl, cvalid, pure, one_one, mixed, rank, n_mix, st4 = jax.vmap(part1)(
        codes, lens, ref_pos
    )

    # ---- batch-level compaction of the (item, slot) pairs ----
    flat_valid = (
        jnp.arange(MXI, dtype=jnp.int32)[None, :]
        < jnp.minimum(n_mix, MXI)[:, None]
    ).reshape(-1)
    flat_st = st4.reshape(b * MXI, 4)
    grank = jnp.cumsum(flat_valid.astype(jnp.int32)) - 1
    spill = flat_valid & (grank >= g_budget)
    item_spill = spill.reshape(b, MXI).any(axis=1)
    g = jnp.arange(g_budget, dtype=jnp.int32)
    gmask = (
        (grank[None, :] == g[:, None]) & flat_valid[None, :]
    ).astype(jnp.bfloat16)
    gst = expand_sum(gmask, flat_st)                      # (G, 4)
    item_ids = jnp.repeat(jnp.arange(b, dtype=jnp.int32), MXI)
    gitem = expand_sum(gmask, item_ids[:, None])[:, 0]    # (G,)

    raw_r_g, raw_l_g = runs_fn(gst, gitem)

    # scatter runs back to (item, slot)
    smask = (
        (grank[:, None] == g[None, :]) & flat_valid[:, None]
    ).astype(jnp.bfloat16)
    runs2 = expand_sum(
        smask, jnp.stack([raw_r_g, raw_l_g], axis=1)
    ).reshape(b, MXI, 2)

    def part2(c, l, p, cl_i, cvalid_i, pure_i, one_one_i, mixed_i, rank_i,
              n_mix_i, runs2_i, spill_i):
        j = jnp.arange(MXI, dtype=jnp.int32)
        emask = (
            (rank_i[:, None] == j[None, :]) & mixed_i[:, None]
        ).astype(jnp.bfloat16)
        back = expand_sum(emask, runs2_i.astype(jnp.int32))
        out = _finish_from_runs(
            c, l, p, cl_i, cvalid_i, pure_i, one_one_i, mixed_i,
            back[:, 0], back[:, 1],
            max_clusters=max_clusters, window=window, max_out=max_out, mm=True,
        )
        f_codes, f_lens, n_out, out_pos, fb = out
        return (
            f_codes, f_lens, n_out, out_pos,
            fb | (n_mix_i > MXI) | spill_i,
        )

    return jax.vmap(part2)(
        codes, lens, ref_pos, cl, cvalid, pure, one_one, mixed, rank,
        n_mix, runs2, item_spill,
    )


def simplify_batch_compact(
    codes, lens, ref_pos, ref_win, read_seq, *, max_clusters, window, max_out,
    row_fetch="onehot", windows_mode="superblock",
):
    """Batch-level simplify with BATCH-compacted mixed-cluster windows
    (mm formulation).

    Mixed clusters are rare (~0.05/read), yet the per-item window compare
    pays two full-sequence superblock-table conversions per item.  Here the
    batch's mixed (item, cluster) pairs are compacted to ``GBUDGET`` global
    slots;
    only those slots' sequence ROWS are gathered (exact one-hot byte
    matmuls) and converted, cutting conversion traffic ~B/GBUDGET-fold.
    Reads whose mixed clusters exceed MXI per item or spill the global
    budget fall back to the exact host path (flag), preserving exactness.

    Every per-slot result is bit-identical to the per-item fetch (same
    _window_bytes_mm_t on the same bytes), so outputs equal
    ``simplify_batch`` wherever no budget flag fires.
    """
    from portello_tpu.kernels.cluster_utils import _window_bytes_mm_t
    from portello_tpu.kernels.expand import expand_bytes, onehot_eq

    b = codes.shape[0]
    w = window

    def runs_fn(gst, gitem):
        # fetch ONLY the slots' sequence rows.  Both forms are exact; the
        # one-hot dot is the default, the row take its alternative.  Empty
        # slots (gitem 0 from the zero mask row)
        # fetch row 0 harmlessly: their runs are never scattered back.
        if row_fetch == "gather":
            rows_a = jnp.take(ref_win, gitem, axis=0)
            rows_b = jnp.take(read_seq, gitem, axis=0)
        else:
            sel = onehot_eq(gitem, b)
            rows_a = expand_bytes(sel, ref_win)                # (G, L)
            rows_b = expand_bytes(sel, read_seq)
        bsg, rsg, dlg, ilg = gst[:, 0], gst[:, 1], gst[:, 2], gst[:, 3]
        if windows_mode == "wordgather":
            wa = _slot_windows_wordgather(
                rows_a, jnp.stack([bsg + dlg - w, bsg], axis=1), w, 0xFE
            )  # (G, 2, w)
            wb = _slot_windows_wordgather(
                rows_b, jnp.stack([rsg + ilg - w, rsg], axis=1), w, 0xFD
            )
            eqg = (wa == wb).astype(jnp.int32)
            raw_r_g = jnp.sum(
                jax.lax.cumprod(eqg[:, 0, :], axis=1, reverse=True), axis=1
            )
            raw_l_g = jnp.sum(jnp.cumprod(eqg[:, 1, :], axis=1), axis=1)
        else:
            wa = jax.vmap(
                lambda row, st: _window_bytes_mm_t(row, st, w, 0xFE)
            )(rows_a, jnp.stack([bsg + dlg - w, bsg], axis=1))     # (G, w, 2)
            wb = jax.vmap(
                lambda row, st: _window_bytes_mm_t(row, st, w, 0xFD)
            )(rows_b, jnp.stack([rsg + ilg - w, rsg], axis=1))
            eqg = (wa == wb).astype(jnp.int32)
            raw_r_g = jnp.sum(
                jax.lax.cumprod(eqg[:, :, 0], axis=1, reverse=True), axis=1
            )
            raw_l_g = jnp.sum(jnp.cumprod(eqg[:, :, 1], axis=1), axis=1)
        return raw_r_g, raw_l_g

    return _compact_core(
        codes, lens, ref_pos, runs_fn,
        max_clusters=max_clusters, window=window, max_out=max_out,
    )


def simplify_batch_compact_resident(
    codes, lens, ref_pos, ref_words, g_sb, g_off, read_packed,
    *, max_clusters, window, max_out,
):
    """``simplify_batch_compact`` with the reference device-resident and the
    read rows packed (kernels/resident.py; design + exactness argument in
    that module's docstring).

    ``ref_words``: (NSB, 16) uint32 global superblock table.
    ``g_sb``/``g_off``: (B,) int32 per-item global base of the window origin
    (``ref_pos`` coordinates are relative to it, exactly like ``ref_win``'s
    origin in the table variant).
    ``read_packed``: (B, max_seq//2) BAM nibble rows.

    Output-identical to ``simplify_batch_compact`` on the corresponding
    unpacked tables (tests/test_resident.py).
    """
    from portello_tpu.kernels.expand import expand_bytes, expand_mask, onehot_eq
    from portello_tpu.kernels.resident import (
        fetch_read_windows_packed,
        fetch_ref_windows_global,
    )

    b = codes.shape[0]
    w = window

    def runs_fn(gst, gitem):
        sel = onehot_eq(gitem, b)
        rows_b = expand_bytes(sel, read_packed)            # (G, Lp)
        gbase = expand_mask(sel, jnp.stack([g_sb, g_off], axis=1))  # (G, 2)
        bsg, rsg, dlg, ilg = gst[:, 0], gst[:, 1], gst[:, 2], gst[:, 3]
        # flat (2G,) window starts, slot-major [right, left] pairs
        starts_a = jnp.stack([bsg + dlg - w, bsg], axis=1).reshape(-1)
        gsb2 = jnp.repeat(gbase[:, 0], 2)
        goff2 = jnp.repeat(gbase[:, 1], 2)
        wa = fetch_ref_windows_global(ref_words, gsb2, goff2, starts_a, w)
        g = gst.shape[0]
        wa = wa.reshape(w, g, 2).transpose(1, 0, 2)        # (G, w, 2)
        wb = fetch_read_windows_packed(
            rows_b, jnp.stack([rsg + ilg - w, rsg], axis=1), w
        )                                                  # (G, w, 2)
        eqg = (wa == wb).astype(jnp.int32)
        raw_r_g = jnp.sum(
            jax.lax.cumprod(eqg[:, :, 0], axis=1, reverse=True), axis=1
        )
        raw_l_g = jnp.sum(jnp.cumprod(eqg[:, :, 1], axis=1), axis=1)
        return raw_r_g, raw_l_g

    return _compact_core(
        codes, lens, ref_pos, runs_fn,
        max_clusters=max_clusters, window=window, max_out=max_out,
    )


@partial(jax.jit, static_argnames=("max_clusters", "window", "max_out", "mm"))
def simplify_batch(
    codes, lens, ref_pos, ref_win, read_seq, *, max_clusters, window, max_out,
    mm=False,
):
    """Vectorized simplify_alignment_indels over a batch.

    Returns (codes, lens, n_out, ref_pos, fallback); reads with ``fallback``
    True must be recomputed exactly on host.
    """
    return jax.vmap(
        lambda c, l, p, rw, rq: _simplify_single(
            c, l, p, rw, rq,
            max_clusters=max_clusters, window=window, max_out=max_out, mm=mm,
        )
    )(codes, lens, ref_pos, ref_win, read_seq)
