"""Device batch engine: the flagship jitted model of the framework.

Collects phase-2 liftover work items — one per (read segment x contig segment)
pair (reference read_alignment_scanner.rs:430-471) — into fixed-shape bucketed
batches and evaluates them with the JAX kernels:

    [left-shift (reverse-contig items)] -> liftover scan -> indel simplify

as ONE jitted computation per (bucket, orientation) so a batch makes a single
device round trip.  Items that exceed a bucket's static bounds, or whose
windowed sequence passes saturate, are recomputed exactly on host with the
``portello_tpu.ops`` oracle — device results are bit-identical to the oracle
for all non-fallback items (enforced by tests/test_device_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from portello_tpu.kernels.cigar_kernels import INT32_MAX, PAD, cigar_read_len
from portello_tpu.kernels.cigar_kernels import cleanup_and_compress
from portello_tpu.kernels.liftover_parallel import _liftover_parallel_single
from portello_tpu.kernels.shift_kernel import _left_shift_single
from portello_tpu.kernels.simplify_kernel import _simplify_single
from portello_tpu.models.batch import BucketConfig
from portello_tpu.ops import cigar as cg
from portello_tpu.ops.blockmap import NONE
from portello_tpu.ops.seq import rev_comp
from portello_tpu.pipeline.read_scan import (
    finish_lifted_record,
    finish_remapped_alignment_set,
    get_contig_split_segments_from_read_mapping,
    get_liftover_alignment_for_read_and_contig_segment,
)
from portello_tpu.pipeline.split_read import get_seq_order_read_split_segments

DEFAULT_BUCKETS = (
    # Tight HiFi primary bucket (p99 of the 18-24 kb profile; the update-grid
    # rows scale the liftover stage ~linearly), a mid spill bucket, and a
    # wide one; anything beyond is finished on the exact host path.
    # Update-grid height defaults to the PROVEN bound max_ops + max_blocks
    # (176 here, vs 304 worst-case pre-renumbering) — no spill possible.
    BucketConfig(max_ops=128, max_blocks=48, max_seq=24576, max_clusters=96, window=48),
    BucketConfig(max_ops=256, max_blocks=96, max_seq=24576, max_clusters=160, window=48),
    BucketConfig(max_ops=1024, max_blocks=384, max_seq=65536, max_clusters=512, window=48),
)


def _lift_core(ops, lens, n_ops, pos, bk, bv, nb, *, max_out, mm=False,
               max_rows=None):
    e_codes, e_lens, ref2_start, row_ovf = _liftover_parallel_single(
        ops, lens, n_ops, pos, bk, bv, nb, mm, max_rows
    )
    l_codes, l_lens, l_n, shift, overflow = cleanup_and_compress(
        e_codes, e_lens, max_out, mm
    )
    overflow = overflow | row_ovf
    mapped = ref2_start >= 0
    ref2_pos = jnp.where(mapped, ref2_start + shift, -1)
    return l_codes, l_lens, l_n, ref2_pos, mapped, overflow


def _fwd_item(ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq,
              *, max_out, max_clusters, window, mm=False, max_rows=None):
    l_codes, l_lens, l_n, ref2_pos, mapped, overflow = _lift_core(
        ops, lens, n_ops, pos, bk, bv, nb, max_out=max_out, mm=mm,
        max_rows=max_rows
    )
    read_len = cigar_read_len(l_codes, l_lens)
    # simplify consumes the full max_out width of the lifted cigar
    s_codes, s_lens, s_n, s_pos_rel, s_fb = _simplify_single(
        l_codes, l_lens, ref2_pos - ref_base, ref_win, read_seq,
        max_clusters=max_clusters, window=window, max_out=max_out, mm=mm,
    )
    return {
        "codes": s_codes, "lens": s_lens, "n_out": s_n,
        "ref2_pos": s_pos_rel + ref_base, "mapped": mapped,
        "read_len": read_len,
        "fallback": s_fb | overflow,
    }


def _rev_ops_bound(max_ops: int, max_out: int) -> int:
    """Static width of the shifted cigar (stage B's compress width and the
    rev-path liftover input).

    Exactly ``max_ops``: the rev fwd leg is capped there anyway (so it
    shares the fwd graph's shapes); a wider width would widen every op-wide
    tensor of the leg.  A left-shifted cigar has at
    most (input runs + 1) runs (tests/test_shift_run_bound.py), so only
    bucket-edge reads can exceed; they fall back to the exact host path via
    the standard overflow flag."""
    return min(max_out, max_ops)


def _rev_item(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
              ref_win, ref_base, read_seq,
              *, max_out, max_clusters, window, mm=False, max_rows=None):
    # Left-shift indels against the reversed contig before lifting
    # (read_alignment_scanner.rs:159-176, docs/methods.md:37-39).
    bound = _rev_ops_bound(ops.shape[0], max_out)
    # stage B compresses at the proven shifted-run width (<= n_ops+1 runs,
    # tests/test_shift_run_bound.py) instead of the full max_out
    sh_codes, sh_lens, sh_n, sh_pos, sh_fb = _left_shift_single(
        ops, lens, pos - win_base, win_base, contig_win, read_seq,
        max_clusters=max_clusters, window=window, max_out=bound, mm=mm,
    )
    # Stage seam: keep the shift's gather-built outputs from fusing into the
    # liftover's prefix scans.
    sh_codes, sh_lens, sh_n, sh_pos = jax.lax.optimization_barrier(
        (sh_codes, sh_lens, sh_n, sh_pos)
    )
    # Cap the fwd leg at exactly max_ops so the rev leg is SHAPE-IDENTICAL
    # to the fwd graph (one compiled program).  The
    # shifter adds at most one run (tests/test_shift_run_bound.py), so only
    # bucket-edge items (n_ops == max_ops exactly) can exceed; they take the
    # exact host fallback.
    n = ops.shape[0]
    sh_fb = sh_fb | (sh_n > n)
    out = _fwd_item(
        sh_codes[:n], sh_lens[:n], sh_n, sh_pos + win_base, bk, bv, nb,
        ref_win, ref_base, read_seq,
        max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
        max_rows=max_rows,
    )
    out["fallback"] = out["fallback"] | sh_fb
    return out


@partial(
    jax.jit,
    static_argnames=("max_out", "max_clusters", "window", "mm", "max_rows"),
)
def fwd_batch(ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq,
              *, max_out, max_clusters, window, mm=False, max_rows=None):
    if not mm:
        return jax.vmap(
            lambda *a: _fwd_item(
                *a, max_out=max_out, max_clusters=max_clusters, window=window,
                mm=mm, max_rows=max_rows,
            )
        )(ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq)

    # mm path: batch-level so the rare mixed-cluster windows compact across
    # the whole batch (simplify_kernel.simplify_batch_compact), converting
    # only the compacted slots' window tables.
    from portello_tpu.kernels.simplify_kernel import simplify_batch_compact

    l_codes, l_lens, l_n, ref2_pos, mapped, overflow = jax.vmap(
        lambda o, l, n, p, k, v, m: _lift_core(
            o, l, n, p, k, v, m, max_out=max_out, mm=mm, max_rows=max_rows
        )
    )(ops, lens, n_ops, pos, bk, bv, nb)
    read_len = jax.vmap(cigar_read_len)(l_codes, l_lens)
    s_codes, s_lens, s_n, s_pos_rel, s_fb = simplify_batch_compact(
        l_codes, l_lens, ref2_pos - ref_base, ref_win, read_seq,
        max_clusters=max_clusters, window=window, max_out=max_out,
    )
    return {
        "codes": s_codes, "lens": s_lens, "n_out": s_n,
        "ref2_pos": s_pos_rel + ref_base, "mapped": mapped,
        "read_len": read_len,
        "fallback": s_fb | overflow,
    }


@partial(
    jax.jit,
    static_argnames=("max_out", "max_clusters", "window", "max_rows"),
)
def fwd_batch_resident(
    ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base, read_packed,
    ref_words, *, max_out, max_clusters, window, max_rows=None,
):
    """Forward pipeline with the reference device-resident and the read
    sequence packed (mm formulation only; kernels/resident.py).

    Replaces ``fwd_batch``'s two (B, max_seq) uint8 tables: ``ref_words`` is
    the run-global superblock reference table (resident in HBM across
    batches), ``g_sb``/``g_off`` locate each item's window origin
    (= ``ref_base``) inside it, and ``read_packed`` is the (B, max_seq//2)
    BAM-nibble read row.  Outputs are bit-identical to ``fwd_batch`` with
    mm=True on the corresponding unpacked tables (tests/test_resident.py).
    """
    from portello_tpu.kernels.simplify_kernel import (
        simplify_batch_compact_resident,
    )

    l_codes, l_lens, l_n, ref2_pos, mapped, overflow = jax.vmap(
        lambda o, l, n, p, k, v, m: _lift_core(
            o, l, n, p, k, v, m, max_out=max_out, mm=True, max_rows=max_rows
        )
    )(ops, lens, n_ops, pos, bk, bv, nb)
    read_len = jax.vmap(cigar_read_len)(l_codes, l_lens)
    s_codes, s_lens, s_n, s_pos_rel, s_fb = simplify_batch_compact_resident(
        l_codes, l_lens, ref2_pos - ref_base, ref_words, g_sb, g_off,
        read_packed, max_clusters=max_clusters, window=window, max_out=max_out,
    )
    return {
        "codes": s_codes, "lens": s_lens, "n_out": s_n,
        "ref2_pos": s_pos_rel + ref_base, "mapped": mapped,
        "read_len": read_len,
        "fallback": s_fb | overflow,
    }


@partial(
    jax.jit,
    static_argnames=("max_out", "max_clusters", "window", "mm", "max_rows"),
)
def rev_batch_fused(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
                    ref_win, ref_base, read_seq, *, max_out, max_clusters, window,
                    mm=False, max_rows=None):
    """Single-graph reverse pipeline (used by the sharded mesh step)."""
    return jax.vmap(
        lambda *a: _rev_item(
            *a, max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
            max_rows=max_rows,
        )
    )(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb, ref_win, ref_base, read_seq)


@partial(
    jax.jit,
    static_argnames=("max_out", "max_clusters", "window", "mm", "max_rows"),
)
def rev_chain_batch(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
                    ref_win, ref_base, read_seq, *, max_out, max_clusters,
                    window, mm=True, max_rows=None):
    """Whole reverse chain — shift stage A, stage B, capped fwd leg with the
    batch-level (compacted-simplify) forward body — as ONE XLA program.

    The gather path keeps a stage split so gather-built intermediate
    streams cannot fuse into the downstream prefix scans.  On the mm path
    the gathers are gone (one-hot matmuls throughout), so the chain is one
    dispatch per rev batch instead of three.
    """
    from portello_tpu.kernels.shift_kernel import _shift_stage_a, _shift_stage_b

    rel_pos = pos - win_base
    st = jax.vmap(
        lambda c, l, p, wb, rw, rq: _shift_stage_a(
            c, l, p, wb, rw, rq, max_clusters=max_clusters, window=window, mm=mm
        )
    )(ops, lens, rel_pos, win_base, contig_win, read_seq)
    bound = _rev_ops_bound(ops.shape[1], max_out)
    sh_codes, sh_lens, sh_n, sh_pos, sh_fb = jax.vmap(
        lambda c, l, p, s: _shift_stage_b(
            c, l, p, s, window=window, max_out=bound, mm=mm
        )
    )(ops, lens, rel_pos, st)
    n = ops.shape[1]
    sh_fb = sh_fb | (sh_n > n)
    out = fwd_batch(
        sh_codes[:, :n], sh_lens[:, :n], sh_n, sh_pos + win_base,
        bk, bv, nb, ref_win, ref_base, read_seq,
        max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
        max_rows=max_rows,
    )
    out["fallback"] = out["fallback"] | sh_fb
    return out


def rev_batch(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
              ref_win, ref_base, read_seq, *, max_out, max_clusters, window,
              mm=False, max_rows=None):
    """Reverse pipeline: one fused program on the mm path
    (``rev_chain_batch``); a chain of separate device calls — shift stage A,
    stage B, then the forward pipeline — on the gather path.

    The gather path keeps the stage split, so gather-built intermediate
    streams cannot fuse into the downstream prefix scans.  The mm path has
    no gathers and runs as one program (3x fewer dispatches).
    """
    kw = dict(max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
              max_rows=max_rows)
    if mm:
        return rev_chain_batch(
            ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
            ref_win, ref_base, read_seq, **kw,
        )

    from portello_tpu.kernels.shift_kernel import (
        shift_stage_a_batch,
        shift_stage_b_batch,
    )

    rel_pos = pos - win_base
    st = shift_stage_a_batch(
        ops, lens, rel_pos, win_base, contig_win, read_seq,
        max_clusters=max_clusters, window=window, mm=mm,
    )
    # Tight static width for the shifted cigar and the fwd leg (see
    # _rev_ops_bound): stage B compresses at the proven shifted-run width;
    # overflowing reads fall back to the exact host path.
    bound = _rev_ops_bound(ops.shape[1], max_out)
    sh_codes, sh_lens, sh_n, sh_pos, sh_fb = shift_stage_b_batch(
        ops, lens, rel_pos, st, window=window, max_out=bound, mm=mm
    )
    # Cap the fwd leg at exactly max_ops: the rev leg then runs the SAME
    # compiled fwd_batch program as fwd items (no extra 128->256 lane tile on
    # the ops axis; see _rev_item).  sh_n > max_ops (only possible for
    # bucket-edge reads, shift adds <= 1 run) -> exact host fallback.
    n = ops.shape[1]
    sh_fb = sh_fb | (sh_n > n)
    out = fwd_batch(
        sh_codes[:, :n], sh_lens[:, :n], sh_n, sh_pos + win_base,
        bk, bv, nb, ref_win, ref_base, read_seq, **kw,
    )
    out["fallback"] = out["fallback"] | sh_fb
    return out


def _count_update_rows(cigar: np.ndarray, pos: int, keys: np.ndarray) -> int:
    """Host-side liftover update-grid row count, matching the device formula
    (liftover_parallel: per ref-consuming op ``hi - lo + 1`` block visits over
    the windowed keys, 1 per read-only I/S/H op).  Used to bucket items under
    a ``max_rows``-reduced grid; the kernel's row_overflow flag backstops it."""
    if len(cigar) == 0:
        return 0
    codes = cigar[:, 0]
    rc = cg.CONSUMES_REF[codes].astype(bool)
    ro = (codes == cg.I) | (codes == cg.S) | (codes == cg.H)
    rl = np.where(rc, cigar[:, 1], 0)
    s = pos + np.cumsum(rl) - rl
    e = s + rl
    lo_raw = np.searchsorted(keys, s, side="right")
    hi = np.minimum(np.searchsorted(keys, e, side="left"), len(keys))
    pre = lo_raw == 0
    lo = np.clip(lo_raw - 1, 0, hi)
    return int(np.where(rc, hi - lo + pre, np.where(ro, 1, 0)).sum())


@dataclass
class _Item:
    """One (read segment x contig segment) liftover work item."""

    read_key: int
    seg_index: int          # index into the read's ordered splits
    contig_segment_index: int
    need_flip: bool
    is_rev_contig: bool
    host_fallback: bool = False
    skip_unmapped: bool = False
    # device inputs (None when host_fallback/skip)
    dev: dict | None = None
    bucket: int = -1
    # result (filled by flush)
    result: object = None


class DeviceEngine:
    """Batching executor for phase-2 liftover work.

    ``submit(record, emit)`` queues a primary read; batches run when
    ``batch_size`` items accumulate; ``flush(emit)`` drains.  Emission order
    is deterministic per flush (the output contract is unsorted,
    docs/user_guide.md:227-230).
    """

    def __init__(
        self,
        reference,
        contig_list,
        all_contig_mapping_info,
        batch_size: int = 512,
        buckets=DEFAULT_BUCKETS,
        platform: str | None = None,
        is_target_region: bool = False,
        use_mm: bool | None = None,
        host_shift: bool | None = None,
    ):
        self.reference = reference
        self.contig_list = contig_list
        self.info = all_contig_mapping_info
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.is_target_region = is_target_region
        # Rev-item routing: True (default) runs the reverse-contig indel
        # left-shift (reference read_alignment_scanner.rs:159-176) on the
        # host during prep — a few microseconds of byte compares — so rev
        # items dispatch the SAME fwd device graph as fwd items.
        # PTPU_HOST_SHIFT=0 (or host_shift=False) routes them through the
        # device shift chain instead.
        import os as _os

        self.host_shift = (
            host_shift
            if host_shift is not None
            else _os.environ.get("PTPU_HOST_SHIFT", "1") != "0"
        )
        self.stats = {"device_items": 0, "host_items": 0, "fallback_items": 0}
        self._pending: list[tuple] = []  # (record, ordered_splits, [_Item])
        self._n_items = 0
        if platform == "cpu":
            jax.config.update("jax_platforms", "cpu")
        if use_mm is None:
            from portello_tpu.backend import select_dispatch

            use_mm = select_dispatch(
                jax.default_backend(), jax.local_device_count()
            ).mm
        self.use_mm = use_mm

    # -- work item preparation (host side) --------------------------------
    def _pick_bucket(
        self, n_ops: int, n_blocks: int, seq_len: int, ref_span: int, n_rows: int
    ):
        for bi, b in enumerate(self.buckets):
            if (
                n_ops <= b.max_ops
                and n_blocks <= b.max_blocks
                and seq_len <= b.max_seq
                and ref_span <= b.max_seq
                and n_rows <= b.resolved_max_rows()
            ):
                return bi
        return -1

    def _prep_item(self, record, read_segment, ci, seg_info, rev_contig_seq, read_key, seg_index):
        seg = seg_info.seq_order_segment
        contig_is_fwd = seg.is_fwd_strand
        changes_strand = record.is_reverse() == read_segment.is_fwd_strand
        need_flip = (not contig_is_fwd) ^ changes_strand
        item = _Item(
            read_key=read_key,
            seg_index=seg_index,
            contig_segment_index=ci,
            need_flip=need_flip,
            is_rev_contig=not contig_is_fwd,
        )

        bm = seg_info.contig_to_ref_map
        if contig_is_fwd:
            pos = read_segment.pos
            cigar = read_segment.cigar
        else:
            contig_length = self.contig_list.data[read_segment.chrom_index].length
            seg_end = read_segment.pos + cg.get_cigar_ref_offset(read_segment.cigar)
            pos = contig_length - seg_end
            cigar = cg.reverse_cigar(read_segment.cigar)
            if self.host_shift:
                # Host-shift routing (default): run the exact oracle shift
                # here and dispatch the item through the fwd graph.
                from portello_tpu.ops.shift import left_shift_indels

                read_seq = rev_comp(record.seq) if need_flip else record.seq
                pos, cigar = left_shift_indels(
                    pos, cigar, rev_contig_seq, read_seq
                )
                item.is_rev_contig = False  # fwd-graph routing

        if (cigar[:, 0] == cg.P).any():
            # Pad ops: the reference's compress keeps only the first length
            # of an adjacent-Pad run (ops/cigar.py quirk note) while the
            # device compress sums; aligners never emit P, so route the rare
            # padded cigar to the exact host path instead of mirroring the
            # quirk in every kernel formulation.
            item.host_fallback = True
            return item
        if item.is_rev_contig and (cigar[:, 1] == 0).any():
            # Zero-length ops on the DEVICE-SHIFT rev path: a 0-length I/D
            # forms a phantom
            # cluster in the device left-shift (find_clusters is not length-
            # gated) whose homology cap clamps the pending run — silently
            # shifting later real clusters differently from the oracle, which
            # ignores 0-length indels (ops/shift.py).  Legal-but-degenerate
            # BAM; route to the exact host path.  (Fwd-path kernels handle
            # zero-length ops exactly — fuzz-verified.)
            item.host_fallback = True
            return item

        span = cg.get_cigar_ref_offset(cigar)
        lo, hi = bm.range_indices(pos, pos + span)
        keys = np.asarray(bm.keys[lo:hi])
        vals = np.asarray(bm.vals[lo:hi])
        valid = vals != NONE
        if not valid.any():
            # No mapped block overlaps the read span: liftover would only ever
            # see gap blocks -> guaranteed unmapped.  Skip the device.
            item.skip_unmapped = True
            return item

        # ref2 window covering every position the lifted alignment can touch
        nxt = np.concatenate([keys[1:], [pos + span]])
        ref_lo = int(vals[valid].min())
        ref_hi = int((vals + np.minimum(nxt, pos + span) - keys)[valid].max())
        ref_span = ref_hi - ref_lo

        bucket = self._pick_bucket(
            len(cigar), hi - lo, record.seq_len(), ref_span,
            _count_update_rows(cigar, pos, keys),
        )
        if bucket < 0:
            item.host_fallback = True
            return item
        bcfg = self.buckets[bucket]

        read_seq = rev_comp(record.seq) if need_flip else record.seq
        chrom_index = seg.chrom_index
        ref_win = np.zeros(bcfg.max_seq, dtype=np.uint8)
        win = self.reference[chrom_index][ref_lo:ref_hi]
        ref_win[: len(win)] = win

        dev = {
            "cigar": cigar, "pos": pos, "keys": keys, "vals": vals,
            "ref_win": ref_win, "ref_base": ref_lo, "read_seq": read_seq,
        }
        if item.is_rev_contig:
            # reversed-contig window for the DEVICE left shift (host-shift
            # routing never reaches here: the shift already ran on host)
            cwin = np.zeros(bcfg.max_seq, dtype=np.uint8)
            src = rev_contig_seq[pos : pos + span]
            if span > bcfg.max_seq:
                item.host_fallback = True
                return item
            cwin[: len(src)] = src
            dev["contig_win"] = cwin
            dev["win_base"] = pos
        item.dev = dev
        item.bucket = bucket
        return item

    # -- public API --------------------------------------------------------
    def submit(self, record, emit) -> None:
        ordered_splits = get_seq_order_read_split_segments(self.contig_list, record)
        items = []
        for seg_index, read_segment in enumerate(ordered_splits):
            contig_info = self.info[read_segment.chrom_index]
            contig_segments = contig_info.ordered_contig_segment_info
            for ci in get_contig_split_segments_from_read_mapping(
                read_segment, contig_segments
            ):
                items.append(
                    self._prep_item(
                        record, read_segment, ci, contig_segments[ci],
                        contig_info.rev_contig_seq, len(self._pending), seg_index,
                    )
                )
        self._pending.append((record, ordered_splits, items))
        self._n_items += sum(1 for it in items if it.dev is not None)
        if self._n_items >= self.batch_size:
            self.flush(emit)

    def flush(self, emit) -> None:
        if not self._pending:
            return
        self._run_batches()
        for record, ordered_splits, items in self._pending:
            remapped = []
            for item in items:
                rec = self._finish_item(record, ordered_splits, item)
                if rec is not None:
                    remapped.append(rec)
            emit(
                finish_remapped_alignment_set(
                    self._ref_chrom_list_cache(), record, remapped,
                    self.is_target_region,
                )
            )
        self._pending.clear()
        self._n_items = 0

    _ref_chrom_list = None

    def set_ref_chrom_list(self, ref_chrom_list):
        self._ref_chrom_list = ref_chrom_list

    def _ref_chrom_list_cache(self):
        if self._ref_chrom_list is None:
            raise RuntimeError("DeviceEngine.set_ref_chrom_list() not called")
        return self._ref_chrom_list

    # -- batch execution ---------------------------------------------------
    def _run_batches(self) -> None:
        by_group: dict[tuple[int, bool], list[_Item]] = {}
        for _, _, items in self._pending:
            for item in items:
                if item.dev is not None:
                    by_group.setdefault((item.bucket, item.is_rev_contig), []).append(item)
        for (bucket, is_rev), items in by_group.items():
            self._run_group(self.buckets[bucket], is_rev, items)

    def _run_group(self, bcfg: BucketConfig, is_rev: bool, items: list[_Item]) -> None:
        b = len(items)
        max_out = bcfg.resolved_max_out()
        ops = np.full((b, bcfg.max_ops), PAD, np.int32)
        lens = np.zeros((b, bcfg.max_ops), np.int32)
        n_ops = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        bk = np.full((b, bcfg.max_blocks), INT32_MAX, np.int32)
        bv = np.full((b, bcfg.max_blocks), -1, np.int32)
        nb = np.zeros(b, np.int32)
        ref_win = np.zeros((b, bcfg.max_seq), np.uint8)
        ref_base = np.zeros(b, np.int32)
        read_seq = np.zeros((b, bcfg.max_seq), np.uint8)
        if is_rev:
            contig_win = np.zeros((b, bcfg.max_seq), np.uint8)
            win_base = np.zeros(b, np.int32)
        for i, item in enumerate(items):
            d = item.dev
            n = len(d["cigar"])
            ops[i, :n] = d["cigar"][:, 0]
            lens[i, :n] = d["cigar"][:, 1]
            n_ops[i] = n
            pos[i] = d["pos"]
            k = len(d["keys"])
            bk[i, :k] = d["keys"]
            bv[i, :k] = d["vals"]
            nb[i] = k
            ref_win[i] = d["ref_win"]
            ref_base[i] = d["ref_base"]
            read_seq[i, : len(d["read_seq"])] = d["read_seq"]
            if is_rev:
                contig_win[i] = d["contig_win"]
                win_base[i] = d["win_base"]
        kw = dict(
            max_out=max_out, max_clusters=bcfg.max_clusters, window=bcfg.window,
            mm=self.use_mm, max_rows=bcfg.resolved_max_rows(),
        )
        if is_rev:
            out = rev_batch(
                ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
                ref_win, ref_base, read_seq, **kw,
            )
        else:
            out = fwd_batch(
                ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq, **kw
            )
        out = {k: np.asarray(v) for k, v in out.items()}
        self.stats["device_items"] += b
        for i, item in enumerate(items):
            if out["fallback"][i]:
                item.host_fallback = True
                item.dev = None
                self.stats["fallback_items"] += 1
            elif not out["mapped"][i]:
                item.skip_unmapped = True
                item.dev = None
            else:
                n = int(out["n_out"][i])
                cigar = np.empty((n, 2), dtype=np.int64)
                cigar[:, 0] = out["codes"][i, :n]
                cigar[:, 1] = out["lens"][i, :n]
                item.result = (
                    int(out["ref2_pos"][i]), cigar, int(out["read_len"][i])
                )
                item.dev = None

    def _finish_item(self, record, ordered_splits, item: _Item):
        read_segment = ordered_splits[item.seg_index]
        contig_info = self.info[read_segment.chrom_index]
        seg_info = contig_info.ordered_contig_segment_info[item.contig_segment_index]
        if item.skip_unmapped:
            return None
        if item.host_fallback:
            self.stats["host_items"] += 1
            return get_liftover_alignment_for_read_and_contig_segment(
                self.reference,
                self.contig_list,
                record,
                read_segment,
                item.contig_segment_index,
                seg_info,
                contig_info.rev_contig_seq,
            )
        ref2_pos, cigar, lifted_read_len = item.result
        # Read-length invariant (read_alignment_scanner.rs:204-229).
        if lifted_read_len != record.seq_len():
            raise AssertionError(
                f"Failed to remap qname: {record.qname.decode()}: seq len "
                f"{record.seq_len()} != lifted cigar read len {lifted_read_len}"
            )
        return finish_lifted_record(
            record,
            self.contig_list,
            read_segment,
            item.contig_segment_index,
            seg_info,
            seg_info.seq_order_segment.chrom_index,
            ref2_pos,
            cigar,
            item.need_flip,
        )
