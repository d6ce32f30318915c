"""Synthetic padded work-item batch generation (for entry point, dry runs and
benchmarks) with HiFi-realistic shape statistics.

HiFi reads map to their *own* sample's assembly, so read-to-contig CIGARs
carry only sequencing error (~0.1-0.5% indel/SNP); contig-to-ref alignments
carry heterozygous + error indels (~1/kb).  These rates drive the op/block
counts the buckets are sized for.
"""

from __future__ import annotations

import numpy as np

from portello_tpu.kernels.cigar_kernels import INT32_MAX, PAD
from portello_tpu.models.batch import BucketConfig
from portello_tpu.ops.blockmap import build_block_map
from portello_tpu.testutil.simulate import apply_edits, rand_seq

#: Production bucket sized for 24 kb HiFi reads (SURVEY.md section 3.3 profile):
#: read-to-contig cigars carry only sequencing error (~0.25%/bp -> ~90-130 ops
#: per 18 kb read, ~45 indel clusters); contig-to-ref blocks within the read
#: span ~1.2/kb (~25).  The bucket is sized to the p99-ish of that profile —
#: the update-grid rows U = 2*max_ops + max_blocks scale the whole liftover
#: stage, so the primary bucket is kept tight.  Items exceeding a bound spill
#: to the wider buckets or
#: the exact host path (DEFAULT_BUCKETS in models/pipeline_model.py).
HIFI_BUCKET = BucketConfig(
    max_ops=128, max_blocks=48, max_seq=24576, max_clusters=96, window=48
)


def make_item_arrays(
    rng: np.random.Generator,
    b: int,
    bcfg: BucketConfig,
    read_len: int = 18000,
    read_error: float = 0.0025,
    contig_var_rate: float = 0.0012,
    rev: bool = False,
):
    """Build one batch of consistent (contig window, block map, read) items.

    Returns arrays in the positional order of
    ``portello_tpu.models.pipeline_model.fwd_batch`` / ``rev_batch``.
    """
    margin = 64
    span = read_len + 2 * margin
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
    if rev:
        contig_win = np.zeros((b, bcfg.max_seq), np.uint8)
        win_base = np.zeros(b, np.int32)

    for i in range(b):
        ref_seg = rand_seq(rng, span)
        contig_seq, contig_cigar = apply_edits(
            ref_seg, rng, contig_var_rate * 0.5, contig_var_rate * 0.5, eqx=True
        )
        bm = build_block_map(0, contig_cigar, False)
        k = min(len(bm), bcfg.max_blocks)
        bk[i, :k] = bm.keys[:k]
        bv[i, :k] = bm.vals[:k]
        nb[i] = k
        rpos = margin // 2
        rl = min(read_len, len(contig_seq) - rpos - 1)
        rseq, rcig = apply_edits(
            contig_seq[rpos : rpos + rl], rng, read_error * 0.5, read_error * 0.5,
            eqx=False,
        )
        n = min(len(rcig), bcfg.max_ops)
        ops[i, :n] = rcig[:n, 0]
        lens[i, :n] = rcig[:n, 1]
        n_ops[i] = n
        pos[i] = rpos
        w = min(span, bcfg.max_seq)
        ref_win[i, :w] = ref_seg[:w]
        ref_base[i] = 0
        rs = min(len(rseq), bcfg.max_seq)
        read_seq[i, :rs] = rseq[:rs]
        if rev:
            cw = min(len(contig_seq), bcfg.max_seq)
            contig_win[i, :cw] = contig_seq[:cw]
            win_base[i] = 0

    if rev:
        return (
            ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
            ref_win, ref_base, read_seq,
        )
    return ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq
