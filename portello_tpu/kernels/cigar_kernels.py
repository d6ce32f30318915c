"""Vectorized CIGAR normalization kernels (device-side).

Data-parallel equivalents of the reference's sequential normalization walks:
``clean_up_cigar_edge_indels`` (reference cigar/mod.rs:265-291) and
``compress_cigar`` (cigar/mod.rs:204-228), operating on padded int32 code/len
vectors and returning padded outputs plus a valid-op count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Op codes (must match portello_tpu.ops.cigar).
M, I, D, N, S, H, P, EQ, X, PAD = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9

INT32_MAX = jnp.iinfo(jnp.int32).max


def is_align_match(codes):
    return (codes == M) | (codes == EQ) | (codes == X)


def consumes_ref(codes):
    return (codes == M) | (codes == D) | (codes == N) | (codes == EQ) | (codes == X)


def consumes_read(codes):
    # hard clips count (the pipeline always runs with ignore_hard_clip=False,
    # reference read_alignment_scanner.rs / contig scanner usage)
    return (
        (codes == M) | (codes == I) | (codes == S) | (codes == H)
        | (codes == EQ) | (codes == X)
    )


def clean_up_edge_indels(codes, lens):
    """Vectorized clean_up_cigar_edge_indels (cigar/mod.rs:265-291).

    Works on a padded vector: PAD entries are ignored but preserved in place.
    Edge regions are everything before the first / after the last M/=/X entry
    (including zero-length non-PAD entries, matching the reference's take_while
    over the raw element list).  Returns (codes, lens, leading_del_shift).
    """
    n = codes.shape[0]
    valid = codes != PAD
    am = is_align_match(codes) & valid
    any_am = am.any()
    idx = jnp.arange(n, dtype=jnp.int32)
    # argmax-of-flip; the masked min/max reduction form is the untried
    # alternative
    first = jnp.where(any_am, jnp.argmax(am).astype(jnp.int32), jnp.int32(n))
    last = jnp.where(
        any_am, jnp.int32(n) - 1 - jnp.argmax(am[::-1]).astype(jnp.int32),
        jnp.int32(-1),
    )
    lead = idx < first
    trail = idx > last
    edge = (lead | trail) & valid
    is_del = edge & (codes == D)
    is_ins = edge & (codes == I)
    shift = jnp.sum(jnp.where(lead & (codes == D) & valid, lens, 0))
    new_codes = jnp.where(is_del | is_ins, S, codes)
    new_lens = jnp.where(is_del, 0, lens)
    return new_codes, new_lens, shift


def compress(codes, lens, max_out: int, mm: bool = False,
             mm_form: str = "segsum"):
    """Vectorized compress_cigar (cigar/mod.rs:204-228), scatter-free.

    Drops zero-length and PAD entries, then merges adjacent equal-code runs.
    No scatter: the whole pass is built from prefix sums,
    a packed running maximum (to find each element's previous kept code) and
    either one segment-sum matmul (``mm_form="segsum"``) or boundary
    compare-counts + a one-hot prefix-table lookup (``mm_form="search"``);
    searchsorted + take_along_axis when ``mm`` is False.  The two mm forms
    are bit-identical; which is faster depends on the surrounding graph, so
    each call site picks its form.
    Returns (out_codes, out_lens, n_out, overflow); ``overflow`` is True when
    the compressed cigar exceeds ``max_out`` ops.
    """
    n = codes.shape[0]
    # The inputs often come from gather-built emission streams; a barrier here
    # keeps those gathers from being fused into the prefix scans below.
    codes, lens = jax.lax.optimization_barrier((codes, lens))
    keep = (codes != PAD) & (lens != 0)
    idx = jnp.arange(n, dtype=jnp.int32)

    # Previous kept code per position: running max of (index << 4 | code)
    # (codes are < 16), shifted to be exclusive.
    packed = jnp.where(keep, (idx << 4) | codes.astype(jnp.int32), jnp.int32(-1))
    prev_packed = jnp.concatenate(
        [jnp.full(1, -1, jnp.int32), jax.lax.cummax(packed)[:-1]]
    )
    prev_code = jnp.where(prev_packed >= 0, prev_packed & 0xF, jnp.int32(-1))
    new_run = keep & (prev_code != codes.astype(jnp.int32))
    n_runs = jnp.sum(new_run.astype(jnp.int32))
    overflow = n_runs > max_out

    r = jnp.arange(max_out, dtype=jnp.int32)
    out_valid = r < jnp.minimum(n_runs, max_out)
    if mm and mm_form == "segsum":
        # ONE segment-sum matmul: row r of the eq mask [run_id == r] sums the
        # kept lens of run r and (via the new_run gate) its start code
        # (kernels/expand.expand_sum; replaces the boundary-search +
        # prefix-table-difference formulation: one mask instead of two).
        from portello_tpu.kernels.expand import expand_sum

        rid = jnp.cumsum(new_run.astype(jnp.int32)) - 1
        mask = (
            (rid[None, :] == r[:, None]) & keep[None, :]
        ).astype(jnp.bfloat16)
        table = jnp.stack(
            [
                jnp.where(keep, lens, 0).astype(jnp.int32),
                jnp.where(new_run, codes, 0).astype(jnp.int32),
            ],
            axis=1,
        )
        sums = expand_sum(mask, table)
        out_lens = jnp.where(out_valid, sums[:, 0], 0)
        out_codes = jnp.where(out_valid, sums[:, 1], PAD)
    elif mm:
        # compare-count boundaries + adjacent-diff one-hot prefix lookup
        from portello_tpu.kernels.expand import count_lt, expand_mask, onehot_eq

        cs_runs = jnp.cumsum(new_run.astype(jnp.int32))
        boundary_q = jnp.arange(1, max_out + 2, dtype=jnp.int32)
        sboth = count_lt(cs_runs, boundary_q)
        ps = jnp.concatenate(
            [jnp.zeros(1, lens.dtype), jnp.cumsum(jnp.where(keep, lens, 0))]
        )
        table = jnp.stack(
            [ps.astype(jnp.int32),
             jnp.concatenate([codes.astype(jnp.int32), jnp.full(1, PAD, jnp.int32)])],
            axis=1,
        )
        tv2 = expand_mask(onehot_eq(sboth, n + 1), table)
        out_lens = jnp.where(out_valid, tv2[1:, 0] - tv2[:-1, 0], 0)
        out_codes = jnp.where(out_valid, tv2[:-1, 1], PAD)
    else:
        # Run r spans input indices [starts[r], starts[r+1]); lengths come
        # from a prefix sum over kept lens.
        cs_runs = jnp.cumsum(new_run.astype(jnp.int32))
        boundary_q = jnp.arange(1, max_out + 2, dtype=jnp.int32)
        sboth = jnp.searchsorted(
            cs_runs, boundary_q, side="left", method="sort"
        ).astype(jnp.int32)
        starts = sboth[:-1]
        starts_next = sboth[1:]
        ps = jnp.concatenate(
            [jnp.zeros(1, lens.dtype), jnp.cumsum(jnp.where(keep, lens, 0))]
        )
        # One packed lookup serves ps[starts], codes[starts] and ps[starts_next]
        # (contiguous per-index slices: ~14x cheaper than separate gathers).
        table = jnp.stack(
            [ps.astype(jnp.int32),
             jnp.concatenate([codes.astype(jnp.int32), jnp.full(1, PAD, jnp.int32)])],
            axis=1,
        )
        both_idx = jnp.concatenate([starts, starts_next])
        tv = jnp.take_along_axis(table, both_idx[:, None], axis=0)
        out_lens = jnp.where(out_valid, tv[max_out:, 0] - tv[:max_out, 0], 0)
        out_codes = jnp.where(out_valid, tv[:max_out, 1], PAD)
    return out_codes, out_lens, jnp.minimum(n_runs, max_out), overflow


def cleanup_and_compress(codes, lens, max_out: int, mm: bool = False,
                         mm_form: str = "segsum"):
    """clean_up_cigar_edge_indels followed by compress_cigar — the finishing pair
    applied by liftover (liftover_read_alignment.rs:218-222), simplify
    (simplify_alignment_indels.rs:153-155) and the shifters."""
    codes, lens, shift = clean_up_edge_indels(codes, lens)
    out_codes, out_lens, n_out, overflow = compress(codes, lens, max_out, mm, mm_form)
    return out_codes, out_lens, n_out, shift, overflow


def cigar_read_len(codes, lens):
    """Total read length (hard clips included), for the liftover length
    invariant (read_alignment_scanner.rs:204-229)."""
    return jnp.sum(jnp.where(consumes_read(codes), lens, 0))


def cigar_ref_len(codes, lens):
    return jnp.sum(jnp.where(consumes_ref(codes), lens, 0))
