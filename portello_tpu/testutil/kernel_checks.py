"""Device graphs against the exact host oracle (``portello_tpu.ops``), item
by item.

One set of checks serves three callers: ``chip_smoke.py`` runs them on the
GPU at the production bucket widths, the tests marked ``gpu`` run the same
widths there, and the CPU tests run them at small widths.  Every compare is
exact: the outputs are integers, and every dot on these paths takes bf16
operands (byte planes <= 255 and {0, 1} masks, both exact in bf16) with a
float32 accumulator, whose sums stay below 2^24 and are therefore exact in
any order.  TF32 never enters, because no float32 operand reaches a dot.
"""

from __future__ import annotations

import numpy as np

from portello_tpu.kernels.cigar_kernels import INT32_MAX, PAD
from portello_tpu.models.batch import BucketConfig
from portello_tpu.ops import cigar as cg
from portello_tpu.ops.blockmap import BlockMap, build_block_map
from portello_tpu.ops.liftover import liftover_read_alignment
from portello_tpu.ops.simplify import simplify_alignment_indels
from portello_tpu.testutil.wgs import edit_sequence, random_bases

#: Item profile per production bucket (pipeline_model.DEFAULT_BUCKETS):
#: (read length, mean bp between read indels, mean bp between contig
#: indels), chosen so the op, block and sequence counts land near each
#: bucket's bounds without crossing them.
PRODUCTION_PROFILES = (
    (18_000, 400, 1_000),
    (22_000, 200, 500),
    (60_000, 250, 500),
)

def make_items(rng, bcfg: BucketConfig, batch: int, read_len: int,
               read_event_bp: int, contig_event_bp: int):
    """One batch of consistent (reference window, contig block map, read)
    work items, in ``fwd_batch``'s positional order.  Cigars longer than
    the bucket are cut to ``max_ops`` (the oracle sees the same cut)."""
    margin = 64
    span = min(read_len + 2 * margin, bcfg.max_seq)
    ops = np.full((batch, bcfg.max_ops), PAD, np.int32)
    lens = np.zeros((batch, bcfg.max_ops), np.int32)
    n_ops = np.zeros(batch, np.int32)
    pos = np.full(batch, margin // 2, np.int32)
    bk = np.full((batch, bcfg.max_blocks), INT32_MAX, np.int32)
    bv = np.full((batch, bcfg.max_blocks), -1, np.int32)
    nb = np.zeros(batch, np.int32)
    ref_win = np.zeros((batch, bcfg.max_seq), np.uint8)
    ref_base = np.zeros(batch, np.int32)
    read_seq = np.zeros((batch, bcfg.max_seq), np.uint8)
    for i in range(batch):
        ref_seg = random_bases(rng, span)
        contig, ccig = edit_sequence(rng, ref_seg, contig_event_bp, 0.001)
        bm = build_block_map(0, ccig, False)
        k = min(len(bm), bcfg.max_blocks)
        bk[i, :k] = bm.keys[:k]
        bv[i, :k] = bm.vals[:k]
        nb[i] = k
        rl = min(read_len, len(contig) - margin)
        rseq, rcig = edit_sequence(
            rng, contig[margin // 2: margin // 2 + rl], read_event_bp, 0.001
        )
        n = min(len(rcig), bcfg.max_ops)
        ops[i, :n] = rcig[:n, 0]
        lens[i, :n] = rcig[:n, 1]
        n_ops[i] = n
        ref_win[i, :span] = ref_seg
        rs = min(len(rseq), bcfg.max_seq)
        read_seq[i, :rs] = rseq[:rs]
    return ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq


def resident_args(table_args):
    """Resident-form arguments whose outputs equal the table form's: each
    item's reference window becomes its own chromosome of the superblock
    table, and read rows are re-encoded through the BAM 16-symbol alphabet
    (in the table form too, so both compare the same bytes).  Returns
    ``(table_args, res_args, words)``."""
    from portello_tpu.kernels.resident import (
        _ENC_LUT,
        SEQ_SYMBOLS,
        build_global_ref,
        pack_seq_rows,
        split_global_base,
    )

    (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq) = [
        np.asarray(a) for a in table_args
    ]
    alpha = np.frombuffer(SEQ_SYMBOLS, np.uint8)
    read_seq = np.where(
        read_seq == 0, np.uint8(0), alpha[_ENC_LUT[read_seq]]
    ).astype(np.uint8)
    words, goff = build_global_ref(list(ref_win))
    g_sb, g_off = split_global_base(goff)
    table = (ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq)
    res = (ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
           pack_seq_rows(read_seq))
    return table, res, words


def oracle_fwd(table_args) -> list:
    """Per item: None (unmapped) or (ref2_pos, lifted+simplified cigar,
    read length), from the exact host ops."""
    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq = [
        np.asarray(a) for a in table_args
    ]
    out = []
    for i in range(len(n_ops)):
        n = int(n_ops[i])
        cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
        k = int(nb[i])
        bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
        lifted = liftover_read_alignment(bm, int(pos[i]), cig)
        if lifted is None:
            out.append(None)
            continue
        p, c = lifted
        read_len = int(c[cg.CONSUMES_READ[c[:, 0]].astype(bool), 1].sum())
        rp, rc = simplify_alignment_indels(
            p - int(ref_base[i]), c, ref_win[i], read_seq[i]
        )
        out.append((int(ref_base[i]) + rp, rc, read_len))
    return out


def compare_fwd(out, oracle: list, name: str) -> dict:
    """Assert every non-fallback item equals the oracle exactly; return
    counts of checked, fallback and unmapped items."""
    out = {k: np.asarray(v) for k, v in out.items()}
    counts = {"items": len(oracle), "checked": 0, "fallback": 0,
              "unmapped": 0}
    for i, want in enumerate(oracle):
        if out["fallback"][i]:
            counts["fallback"] += 1
            continue
        counts["checked"] += 1
        if want is None:
            if out["mapped"][i]:
                raise AssertionError(f"{name}: item {i} mapped, oracle not")
            counts["unmapped"] += 1
            continue
        p, cig, read_len = want
        n = int(out["n_out"][i])
        got = np.stack(
            [out["codes"][i, :n], out["lens"][i, :n]], axis=1
        ).astype(np.int64)
        if not (out["mapped"][i] and int(out["ref2_pos"][i]) == p
                and np.array_equal(got, cig)
                and int(out["read_len"][i]) == read_len):
            raise AssertionError(
                f"{name}: item {i} differs from the oracle: device pos "
                f"{int(out['ref2_pos'][i])} cigar {cg.to_string(got)}, "
                f"oracle pos {p} cigar {cg.to_string(cig)}"
            )
    if counts["checked"] * 2 < counts["items"]:
        raise AssertionError(
            f"{name}: {counts['fallback']} of {counts['items']} items fell "
            "back to the host; the check exercised too little"
        )
    return counts


def _kw(bcfg: BucketConfig) -> dict:
    return dict(
        max_out=bcfg.resolved_max_out(), max_clusters=bcfg.max_clusters,
        window=bcfg.window, max_rows=bcfg.resolved_max_rows(),
    )


def check_fwd_batch(table_args, bcfg: BucketConfig, mm: bool,
                    oracle: list) -> dict:
    from portello_tpu.models.pipeline_model import fwd_batch

    out = fwd_batch(*table_args, mm=mm, **_kw(bcfg))
    return compare_fwd(out, oracle, f"fwd_batch(mm={mm})")


def check_fwd_batch_resident(res_args, words, bcfg: BucketConfig,
                             oracle: list) -> dict:
    """The resident graph has one formulation (matmul window fetch)."""
    import jax

    from portello_tpu.models.pipeline_model import fwd_batch_resident

    out = fwd_batch_resident(*res_args, jax.device_put(words), **_kw(bcfg))
    return compare_fwd(out, oracle, "fwd_batch_resident")


def emission_width(bcfg: BucketConfig) -> int:
    """Width of the lift's emission stream, which cleanup_and_compress
    consumes in the production graph."""
    import jax
    import jax.numpy as jnp

    from portello_tpu.kernels.liftover_parallel import (
        _liftover_parallel_single,
    )

    i32 = jnp.int32
    shapes = [jax.ShapeDtypeStruct((bcfg.max_ops,), i32)] * 2 + [
        jax.ShapeDtypeStruct((), i32)] * 2 + [
        jax.ShapeDtypeStruct((bcfg.max_blocks,), i32)] * 2 + [
        jax.ShapeDtypeStruct((), i32)]
    e_codes = jax.eval_shape(
        lambda *a: _liftover_parallel_single(
            *a, False, bcfg.resolved_max_rows()
        )[0],
        *shapes,
    )
    return e_codes.shape[0]


def check_cleanup_and_compress(rng, width: int, max_out: int, mm: bool,
                               batch: int) -> dict:
    """Random emission-like streams (PAD anywhere, zero-length entries,
    edge indels) through ``cleanup_and_compress`` against
    clean_up_cigar_edge_indels + compress_cigar."""
    import jax
    import jax.numpy as jnp

    from portello_tpu.kernels.cigar_kernels import cleanup_and_compress

    alphabet = np.array([cg.M, cg.I, cg.D, cg.S, cg.EQ, cg.X], np.int32)
    codes = alphabet[rng.integers(0, len(alphabet), size=(batch, width))]
    lens = rng.integers(0, 200, size=(batch, width)).astype(np.int32)
    lens[rng.random((batch, width)) < 0.1] = 0
    # rows from dense to sparse: some compress past max_out (overflow)
    fill = rng.uniform(0.05, 1.0, size=(batch, 1))
    codes[rng.random((batch, width)) > fill] = PAD
    fn = jax.jit(jax.vmap(
        lambda c, ln: cleanup_and_compress(c, ln, max_out, mm)
    ))
    o_codes, o_lens, o_n, o_shift, o_ovf = (
        np.asarray(a) for a in fn(jnp.asarray(codes), jnp.asarray(lens))
    )
    n_overflow = 0
    for i in range(batch):
        keep = codes[i] != PAD
        cig = np.stack([codes[i][keep], lens[i][keep]], axis=1).astype(
            np.int64
        )
        cleaned, shift = cg.clean_up_cigar_edge_indels(cig)
        want = cg.compress_cigar(cleaned)
        overflow = len(want) > max_out
        n_overflow += overflow
        name = f"cleanup_and_compress(mm={mm}) row {i}"
        if bool(o_ovf[i]) != overflow:
            raise AssertionError(f"{name}: overflow flag differs")
        if int(o_shift[i]) != shift:
            raise AssertionError(f"{name}: shift {int(o_shift[i])} != {shift}")
        if overflow:
            continue
        n = int(o_n[i])
        got = np.stack([o_codes[i, :n], o_lens[i, :n]], axis=1)
        if not np.array_equal(got.astype(np.int64), want):
            raise AssertionError(f"{name}: cigar differs from the oracle")
    return {"rows": batch, "width": width, "overflow": n_overflow}


def check_expand(k: int, rows: int, cols: int = 4) -> dict:
    """``expand_sum`` (segment sums) and ``gather_rows`` (one-hot gather)
    at depth ``k`` with byte-plane extremes: every byte 0xFF (-1),
    INT32_MAX, INT32_MIN, and rows that select all ``k`` table rows (the
    largest per-plane sum, 255 * k)."""
    import jax.numpy as jnp

    from portello_tpu.kernels.expand import expand_sum, gather_rows

    rows = max(rows, 3)
    rng = np.random.default_rng(k)
    table = rng.integers(-(2**31), 2**31, size=(k, cols), dtype=np.int64)
    table[: k // 4] = -1
    table[k // 4: k // 2] = np.iinfo(np.int32).max
    table[k // 2: k // 2 + 8] = np.iinfo(np.int32).min
    table = table.astype(np.int32)
    mask = rng.random((rows, k)) < 0.5
    mask[0] = True
    mask[1, : k // 4] = True  # only all-0xFF bytes
    mask[1, k // 4:] = False
    mask[2] = False
    got = np.asarray(expand_sum(jnp.asarray(mask.astype(np.float32)),
                                jnp.asarray(table)))
    want = (mask.astype(np.int64) @ table.astype(np.int64)).astype(np.int32)
    if not np.array_equal(got, want):
        raise AssertionError(f"expand_sum at K={k} is not exact")
    idx = rng.integers(0, k, size=rows).astype(np.int32)
    got = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx), True))
    if not np.array_equal(got, table[idx]):
        raise AssertionError(f"gather_rows(mm) at K={k} is not exact")
    return {"k": k, "rows": rows}
