"""Whole-genome-shaped liftover scenario, generated from a seed.

The deployment it stands for: HiFi reads aligned to a diploid de novo
assembly, lifted onto a human-size reference.

- Reference: the 24 GRCh38 primary-assembly chromosomes at their published
  lengths (about 3.1 Gbp; ``chrom_scale`` shrinks them for tests).
- Assembly: two haplotypes of contigs tiling chr20, each derived from the
  reference with SNPs and small indels.  The mix holds forward,
  reverse-mapped, ref-split (a deletion wider than the colinear-join gap) and
  inverted-split contigs, the same four shapes as ``simulate.make_scenario``.
- Reads: primary HiFi reads with log-normal lengths, on both strands, with
  indel and SNP edits against their contig; a share are split reads (primary
  plus a supplementary on another contig, linked by SA tags) and a share are
  unmapped.

Every array is drawn from ``numpy.random.default_rng`` seeded by
``WgsParams.seed``, so the same parameters give byte-identical files.
``build_wgs_scenario`` caches its output in a directory keyed by the
parameters and returns at once when that directory is complete.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from portello_tpu.io.bam import (
    FREVERSE,
    FSUPPLEMENTARY,
    FUNMAP,
    BamHeader,
    BamRecord,
    BamWriter,
)
from portello_tpu.io.index_build import build_bai
from portello_tpu.ops import cigar as cg
from portello_tpu.ops.seq import rev_comp

# GRCh38 primary assembly (GCA_000001405.15), chromosome lengths in bp.
GRCH38_CHROMS = (
    ("chr1", 248_956_422), ("chr2", 242_193_529), ("chr3", 198_295_559),
    ("chr4", 190_214_555), ("chr5", 181_538_259), ("chr6", 170_805_979),
    ("chr7", 159_345_973), ("chr8", 145_138_636), ("chr9", 138_394_717),
    ("chr10", 133_797_422), ("chr11", 135_086_622), ("chr12", 133_275_309),
    ("chr13", 114_364_328), ("chr14", 107_043_718), ("chr15", 101_991_189),
    ("chr16", 90_338_345), ("chr17", 83_257_441), ("chr18", 80_373_285),
    ("chr19", 58_617_616), ("chr20", 64_444_167), ("chr21", 46_709_983),
    ("chr22", 50_818_468), ("chrX", 156_040_895), ("chrY", 57_227_415),
)
ASSEMBLED_CHROM = "chr20"
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[_ACGT] = np.arange(4, dtype=np.uint8)


@dataclass(frozen=True)
class WgsParams:
    """Scenario shape.  The defaults are the full-size deployment."""

    seed: int = 0
    n_reads: int = 20_000
    chrom_scale: float = 1.0
    contig_min: int = 1_000_000
    contig_max: int = 5_000_000
    read_median: int = 17_000
    read_sigma: float = 0.4
    read_min: int = 2_000
    read_max: int = 60_000
    read_event_bp: int = 400       # mean bases between read indels
    read_snp_rate: float = 0.001
    contig_event_bp: int = 5_000   # mean bases between contig indels
    contig_snp_rate: float = 0.001
    split_read_frac: float = 0.02
    unmapped_frac: float = 0.01

    def key(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]


@dataclass
class WgsScenario:
    root: str
    ref_fasta: str
    contig_bam: str
    read_bam: str
    n_primary: int
    n_unmapped: int
    genome_bp: int


def random_bases(rng, n: int) -> np.ndarray:
    return _ACGT[rng.integers(0, 4, size=n, dtype=np.uint8)]


def _write_fasta_record(f, name: str, seq: np.ndarray, width: int = 60) -> None:
    """One FASTA record with ``width``-column lines, written in bulk."""
    f.write(f">{name}\n".encode())
    full = len(seq) // width
    if full:
        lines = np.empty((full, width + 1), np.uint8)
        lines[:, :width] = seq[: full * width].reshape(full, width)
        lines[:, width] = 10
        f.write(lines.tobytes())
    if len(seq) % width:
        f.write(seq[full * width:].tobytes() + b"\n")


def _substitute(rng, seq: np.ndarray, rate: float) -> np.ndarray:
    """SNPs at ``rate``: each hit base becomes one of the other three."""
    seq = seq.copy()
    hits = np.nonzero(rng.random(len(seq)) < rate)[0]
    shift = rng.integers(1, 4, size=len(hits), dtype=np.uint8)
    seq[hits] = _ACGT[(_CODE[seq[hits]] + shift) % 4]
    return seq


def edit_sequence(rng, src: np.ndarray, event_bp: int, snp_rate: float,
                  max_indel: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """Derive a sequence from ``src`` with indel events every ~event_bp
    bases (geometric gaps) and SNPs; return (derived, cigar of derived vs
    src) with M/I/D ops, ``src`` being the reference side."""
    n = len(src)
    k = max(int(n / event_bp * 1.5) + 4, 8)
    gaps = rng.geometric(1.0 / event_bp, size=k)
    kinds = rng.random(k) < 0.5
    lens = rng.integers(1, max_indel + 1, size=k)
    parts = []
    ops = []
    pos = 0
    i = 0
    while pos < n:
        if i == k:  # rare: draw more events
            gaps = rng.geometric(1.0 / event_bp, size=k)
            kinds = rng.random(k) < 0.5
            lens = rng.integers(1, max_indel + 1, size=k)
            i = 0
        run = min(int(gaps[i]), n - pos)
        parts.append(src[pos: pos + run])
        if ops and ops[-1][0] == cg.M:
            ops[-1][1] += run
        else:
            ops.append([cg.M, run])
        pos += run
        if pos >= n:
            break
        ln = int(lens[i])
        if kinds[i]:
            parts.append(random_bases(rng, ln))
            ops.append([cg.I, ln])
        else:
            ln = min(ln, n - pos - 1)
            if ln > 0:
                ops.append([cg.D, ln])
                pos += ln
        i += 1
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return _substitute(rng, seq, snp_rate), np.asarray(ops, np.int64)


def _sa(name: str, pos: int, is_fwd: bool, cigar, mapq: int = 60) -> str:
    strand = "+" if is_fwd else "-"
    return f"{name},{pos + 1},{strand},{cg.to_string(cigar)},{mapq},0;"


def _contig_records(rng, params, chrom, tid):
    """Two haplotypes of contigs tiling ``chrom``.  Returns the contig
    (name, seq) list, in read-BAM header order, and the contig-to-ref
    records."""
    contigs = []
    records = []
    kinds = ("fwd", "rev", "split", "inv")
    n = len(chrom)
    lo_len = max(int(params.contig_min), 1)
    hi_len = max(int(params.contig_max), lo_len + 1)
    for hap in (1, 2):
        pos = int(rng.integers(0, lo_len // 50 + 1))
        k = 0
        while pos < n - lo_len // 2:
            span = min(int(rng.integers(lo_len, hi_len)), n - pos)
            kind = kinds[(k + hap) % 4]
            name = f"h{hap}tg{k + 1:06d}"
            lo, hi = pos, pos + span
            k += 1
            # contigs break between each other: a small uncovered gap
            pos = hi + int(rng.integers(0, lo_len // 100 + 2))
            if kind in ("split", "inv"):
                # the second part starts after a reference gap wider than the
                # 1 kb colinear-join threshold, so the contig stays split
                mid = lo + span // 2
                gap = 2_000 + int(rng.integers(0, 8_000))
                if mid + gap >= hi - 1_000:
                    kind = "fwd"
            if kind in ("fwd", "rev"):
                derived, cig = edit_sequence(
                    rng, chrom[lo:hi], params.contig_event_bp,
                    params.contig_snp_rate,
                )
                is_fwd = kind == "fwd"
                seq = derived if is_fwd else rev_comp(derived)
                contigs.append((name, seq))
                records.append(BamRecord(
                    qname=name.encode(), flag=0 if is_fwd else FREVERSE,
                    tid=tid, pos=lo, mapq=60, cigar=cig, seq=derived,
                    qual=np.full(len(derived), 40, np.uint8),
                ))
                continue
            # two-part contig: part A forward; part B forward (ref-split)
            # or reverse (inversion)
            der_a, cig_a = edit_sequence(
                rng, chrom[lo:mid], params.contig_event_bp,
                params.contig_snp_rate,
            )
            der_b, cig_b = edit_sequence(
                rng, chrom[mid + gap:hi], params.contig_event_bp,
                params.contig_snp_rate,
            )
            b_fwd = kind == "split"
            part_b = der_b if b_fwd else rev_comp(der_b)
            seq = np.concatenate([der_a, part_b])
            contigs.append((name, seq))
            rec_a_cig = np.concatenate([cig_a, cg.cigar((cg.S, len(der_b)))])
            # record B stores the ref-forward strand: for the inversion that
            # is revcomp(contig) = der_b + revcomp(der_a)
            rec_b_cig = (
                np.concatenate([cg.cigar((cg.S, len(der_a))), cig_b])
                if b_fwd
                else np.concatenate([cig_b, cg.cigar((cg.S, len(der_a)))])
            )
            rec_b_seq = seq if b_fwd else rev_comp(seq)
            sa_a = _sa(chrom_name(tid), lo, True, rec_a_cig)
            sa_b = _sa(chrom_name(tid), mid + gap, b_fwd, rec_b_cig)
            ra = BamRecord(
                qname=name.encode(), flag=0, tid=tid, pos=lo, mapq=60,
                cigar=rec_a_cig, seq=seq, qual=np.full(len(seq), 40, np.uint8),
            )
            ra.push_tag(b"SA", b"Z", sa_b)
            rb = BamRecord(
                qname=name.encode(),
                flag=FSUPPLEMENTARY | (0 if b_fwd else FREVERSE),
                tid=tid, pos=mid + gap, mapq=60, cigar=rec_b_cig,
                seq=rec_b_seq, qual=np.full(len(seq), 40, np.uint8),
            )
            rb.push_tag(b"SA", b"Z", sa_a)
            records += [ra, rb]
    records.sort(key=lambda r: (r.tid, r.pos))
    return contigs, records


def chrom_name(tid: int) -> str:
    return GRCH38_CHROMS[tid][0]


def _read_lengths(rng, params, n):
    lens = np.exp(
        rng.normal(np.log(params.read_median), params.read_sigma, size=n)
    )
    return np.clip(lens, params.read_min, params.read_max).astype(np.int64)


def _read_records(rng, params, contigs):
    """Primary reads (+ supplementaries of the split reads), then the
    unmapped reads; returns (records sorted for BAM order, n_primary,
    n_unmapped)."""
    clens = np.array([len(s) for _, s in contigs], np.int64)
    n_unmapped = int(round(params.n_reads * params.unmapped_frac))
    n_mapped = params.n_reads - n_unmapped
    lens = _read_lengths(rng, params, n_mapped)
    tids = rng.choice(len(contigs), size=n_mapped, p=clens / clens.sum())
    is_split = rng.random(n_mapped) < params.split_read_frac
    records = []
    for ri in range(n_mapped):
        ci = int(tids[ri])
        cseq = contigs[ci][1]
        ln = int(min(lens[ri], clens[ci]))
        pos = int(rng.integers(0, clens[ci] - ln + 1))
        qname = f"m84011_{ri:06d}/ccs".encode()
        flag = FREVERSE if rng.random() < 0.5 else 0
        mapq = int(rng.integers(20, 61))
        if is_split[ri] and ln >= 2 * params.read_min:
            # chimeric read: part A on this contig (primary), part B an exact
            # copy of another contig's sequence (supplementary)
            a = ln // 2
            b = ln - a
            cj = int(rng.choice(len(contigs), p=clens / clens.sum()))
            if clens[cj] < b:
                cj = ci
            pb = int(rng.integers(0, clens[cj] - b + 1))
            part_a = cseq[pos: pos + a]
            part_b = contigs[cj][1][pb: pb + b]
            read = np.concatenate([part_a, part_b])
            qual = rng.integers(10, 50, size=ln).astype(np.uint8)
            supp_fwd = bool(rng.random() < 0.5)
            prim_cig = cg.cigar((cg.M, a), (cg.S, b))
            if supp_fwd:
                supp_cig = cg.cigar((cg.S, a), (cg.M, b))
                supp_seq, supp_qual = read, qual
            else:
                # the supplementary stores the reverse complement of the
                # read; its aligned B part comes first there
                supp_cig = cg.cigar((cg.M, b), (cg.S, a))
                supp_seq, supp_qual = rev_comp(read), qual[::-1].copy()
            prim = BamRecord(qname=qname, flag=flag, tid=ci, pos=pos,
                             mapq=mapq, cigar=prim_cig, seq=read, qual=qual)
            prim.push_tag(b"SA", b"Z", _sa(contigs[cj][0], pb, supp_fwd,
                                           supp_cig))
            supp = BamRecord(
                qname=qname,
                flag=FSUPPLEMENTARY | (0 if supp_fwd else FREVERSE),
                tid=cj, pos=pb, mapq=mapq, cigar=supp_cig, seq=supp_seq,
                qual=supp_qual,
            )
            supp.push_tag(b"SA", b"Z", _sa(contigs[ci][0], pos, True,
                                           prim_cig))
            records += [prim, supp]
            continue
        rseq, rcig = edit_sequence(
            rng, cseq[pos: pos + ln], params.read_event_bp,
            params.read_snp_rate,
        )
        rec = BamRecord(
            qname=qname, flag=flag, tid=ci, pos=pos, mapq=mapq, cigar=rcig,
            seq=rseq, qual=rng.integers(10, 50, size=len(rseq)).astype(np.uint8),
        )
        rec.push_tag(b"NM", b"i", 0)
        records.append(rec)
    records.sort(key=lambda r: (r.tid, r.pos))
    for i, ln in enumerate(_read_lengths(rng, params, n_unmapped)):
        records.append(BamRecord(
            qname=f"m84011_u{i:06d}/ccs".encode(), flag=FUNMAP, tid=-1,
            pos=-1, mapq=255, seq=random_bases(rng, int(ln)),
            qual=rng.integers(10, 50, size=int(ln)).astype(np.uint8),
        ))
    return records, n_mapped, n_unmapped


def build_wgs_scenario(cache_root: str, params: WgsParams = WgsParams(),
                       n_threads: int | None = None) -> WgsScenario:
    """Write (or reuse) the scenario under ``cache_root/wgs_<key>/``."""
    root = os.path.join(cache_root, f"wgs_{params.key()}")
    done = os.path.join(root, "scenario.json")
    files = dict(
        ref_fasta=os.path.join(root, "ref.fa"),
        contig_bam=os.path.join(root, "asm_to_ref.bam"),
        read_bam=os.path.join(root, "read_to_asm.bam"),
    )
    if os.path.exists(done):
        with open(done) as f:
            meta = json.load(f)
        return WgsScenario(root=root, **files, **meta["counts"])
    os.makedirs(root, exist_ok=True)
    n_threads = n_threads or os.cpu_count() or 1
    seeds = np.random.SeedSequence(params.seed).spawn(len(GRCH38_CHROMS) + 2)

    chrom_lens = [
        (name, max(int(length * params.chrom_scale), 1))
        for name, length in GRCH38_CHROMS
    ]
    assembled_tid = [n for n, _ in chrom_lens].index(ASSEMBLED_CHROM)
    assembled = None
    with open(files["ref_fasta"] + ".tmp", "wb") as f:
        for tid, (name, length) in enumerate(chrom_lens):
            seq = random_bases(np.random.default_rng(seeds[tid]), length)
            _write_fasta_record(f, name, seq)
            if tid == assembled_tid:
                assembled = seq
            del seq
    os.replace(files["ref_fasta"] + ".tmp", files["ref_fasta"])

    rng = np.random.default_rng(seeds[-2])
    contigs, contig_records = _contig_records(
        rng, params, assembled, assembled_tid
    )
    del assembled
    with BamWriter(files["contig_bam"], BamHeader.from_refs(chrom_lens),
                   n_threads=n_threads) as w:
        for r in contig_records:
            w.write(r)
    del contig_records
    build_bai(files["contig_bam"])

    rng = np.random.default_rng(seeds[-1])
    records, n_primary, n_unmapped = _read_records(rng, params, contigs)
    contig_header = BamHeader.from_refs([(n, len(s)) for n, s in contigs])
    with BamWriter(files["read_bam"], contig_header, n_threads=n_threads) as w:
        for r in records:
            w.write(r)
    del records
    build_bai(files["read_bam"])

    counts = dict(n_primary=n_primary, n_unmapped=n_unmapped,
                  genome_bp=sum(length for _, length in chrom_lens))
    with open(done + ".tmp", "w") as f:
        json.dump({"params": dataclasses.asdict(params), "counts": counts}, f)
    os.replace(done + ".tmp", done)
    return WgsScenario(root=root, **files, **counts)
