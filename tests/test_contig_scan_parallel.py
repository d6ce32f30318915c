"""Threaded phase-1 contig scan conformance.

The reference fans phase 1 over a rayon pool (contig_alignment_scanner/
mod.rs:243-283); our redesign streams raw records off the native BGZF decode
pool and runs per-record compute on a worker pool with in-order commit.  The
scan result — including BTreeMap same-key-overwrite semantics — must be
byte-identical to the sequential scan at every thread count.
"""

import pickle

import numpy as np
import pytest

from portello_tpu.io.bam import BamReader, BamRecord
from portello_tpu.pipeline.contig_scan import (
    save_contig_index,
    scan_contig_bam,
)
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu.utils.chrom_list import ChromList


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p1par")
    return make_scenario(str(tmp)), tmp


def _scan(scn, threads):
    ref_cl = ChromList.from_bam_filename(scn.contig_bam)
    contig_cl = ChromList.from_bam_filename(scn.read_bam)
    return (
        scan_contig_bam(
            scn.contig_bam, ref_cl, contig_cl, None, thread_count=threads
        ),
        ref_cl,
        contig_cl,
    )


def test_threaded_scan_identical(scenario):
    scn, _ = scenario
    blobs = {}
    for threads in (1, 2, 4):
        info, _, _ = _scan(scn, threads)
        blobs[threads] = pickle.dumps(info)
    assert blobs[2] == blobs[1]
    assert blobs[4] == blobs[1]


def test_threaded_contig_index_bytes_identical(scenario, tmp_path):
    scn, _ = scenario
    paths = {}
    for threads in (1, 4):
        info, ref_cl, contig_cl = _scan(scn, threads)
        p = str(tmp_path / f"idx_{threads}.bin")
        save_contig_index(p, info, ref_cl, contig_cl, None, 1000)
        paths[threads] = p
    with open(paths[1], "rb") as a, open(paths[4], "rb") as b:
        assert a.read() == b.read()


def test_lazy_decode_matches_eager(scenario):
    """LazyBamRecord must expose identical seq/qual/seq_len to eager decode."""
    scn, _ = scenario
    n = 0
    with BamReader(scn.read_bam) as r:
        for raw in r.iter_raw():
            eager = BamRecord.decode(raw)
            lazy = BamRecord.decode(raw, lazy=True)
            assert lazy.seq_len() == eager.seq_len()
            assert np.array_equal(lazy.seq, eager.seq)
            assert np.array_equal(lazy.qual, eager.qual)
            assert lazy.qname == eager.qname
            assert lazy.tags == eager.tags
            n += 1
            if n >= 50:
                break
    assert n > 0


def test_lazy_decode_survives_mutation():
    """Mutation clears .raw; deferred seq/qual must still materialize."""
    rec = BamRecord(
        qname=b"r1", flag=0, tid=0, pos=10, mapq=60,
        cigar=np.array([[0, 4]], dtype=np.int64),
        seq=np.frombuffer(b"ACGT", np.uint8).copy(),
        qual=np.full(4, 30, np.uint8),
    )
    raw = rec.encode()
    lazy = BamRecord.decode(raw, lazy=True)
    lazy.set_supplementary()  # clears .raw before seq is ever touched
    assert lazy.raw is None
    assert lazy.seq.tobytes() == b"ACGT"
    assert np.array_equal(lazy.qual, np.full(4, 30, np.uint8))
    # and encode round-trips from the materialized fields
    rt = BamRecord.decode(lazy.encode())
    assert rt.seq.tobytes() == b"ACGT"
    assert rt.is_supplementary()


def test_native_walk_matches_python_oracle(scenario, monkeypatch):
    """The C++ phase-1 walk (ptscan_p1_*) must produce a pickle-identical
    index to the pure-Python oracle walk (PTPU_P1_NATIVE=0)."""
    scn, _ = scenario
    monkeypatch.setenv("PTPU_P1_NATIVE", "0")
    py_info, _, _ = _scan(scn, 1)
    monkeypatch.setenv("PTPU_P1_NATIVE", "1")
    nat_info, _, _ = _scan(scn, 4)
    assert pickle.dumps(nat_info) == pickle.dumps(py_info)


def test_native_walk_error_parity(tmp_path, monkeypatch):
    """Error semantics parity between the native and Python walks: a
    corrupt SA tag raises the same ValueError text; a read name missing
    from the assembly contig list raises KeyError in both."""
    from portello_tpu.io.bam import BamWriter
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.testutil.simulate import make_scenario as _mk

    scn = _mk(str(tmp_path), rng=np.random.default_rng(41))
    ref_cl = ChromList.from_bam_filename(scn.contig_bam)
    contig_cl = ChromList.from_bam_filename(scn.read_bam)

    def scan(path):
        return scan_contig_bam(path, ref_cl, contig_cl, None, thread_count=2)

    def rewrite(mutate, out_name):
        with BamReader(scn.contig_bam) as r:
            recs = list(r)
            header = r.header
        out = str(tmp_path / out_name)
        with BamWriter(out, header) as w:
            for rec in recs:
                w.write(mutate(rec) or rec)
        build_bai(out)
        return out

    # corrupt SA tag on the first record
    def bad_sa(rec):
        if not rec.is_supplementary() and not rec.is_unmapped():
            rec.push_tag(b"SA", b"Z", "chr1,notanint,+,4M,60,0;")
        rec.raw = None  # encode() passes raw bytes through when set
        return rec

    bad1 = rewrite(bad_sa, "bad_sa.bam")
    errs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("PTPU_P1_NATIVE", mode)
        with pytest.raises(ValueError) as ei:
            scan(bad1)
        errs[mode] = str(ei.value)
    assert errs["0"] == errs["1"]

    # read name absent from the contig list
    def bad_name(rec):
        rec.qname = b"not_a_contig"
        rec.raw = None
        return rec

    bad2 = rewrite(bad_name, "bad_name.bam")
    for mode in ("0", "1"):
        monkeypatch.setenv("PTPU_P1_NATIVE", mode)
        with pytest.raises(KeyError, match="not_a_contig"):
            scan(bad2)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_native_walk_fuzz_matches_oracle(tmp_path, monkeypatch, seed):
    """Differential fuzz for the C++ phase-1 walk: randomized contig records
    — split reads across random contigs/strands, hard/soft clip mixes,
    reverse primaries, supplementary records — must produce a
    pickle-identical index to the Python oracle walk."""
    from portello_tpu.io.bam import (
        FREVERSE,
        FSUPPLEMENTARY,
        BamHeader,
        BamRecord,
        BamWriter,
    )
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.ops import cigar as cg
    from portello_tpu.testutil.simulate import rand_seq

    rng = np.random.default_rng(seed)
    n_ref = 3
    ref_names = [f"chr{i}" for i in range(n_ref)]
    ref_lens = [30000] * n_ref
    header = BamHeader.from_refs(list(zip(ref_names, ref_lens)))

    def rand_cigar(read_len, left_clip, right_clip, hard):
        mid = read_len - left_clip - right_clip
        parts = []
        if left_clip:
            parts.append((cg.H if hard else cg.S, left_clip))
        # alternate M/I/D runs inside
        remaining = mid
        while remaining > 0:
            m = int(rng.integers(1, max(remaining, 2)))
            m = min(m, remaining)
            parts.append((cg.M, m))
            remaining -= m
            if remaining > 1 and rng.random() < 0.5:
                if rng.random() < 0.5:
                    i = int(rng.integers(1, min(remaining, 5) + 1))
                    parts.append((cg.I, i))
                    remaining -= i
                else:
                    parts.append((cg.D, int(rng.integers(1, 6))))
        if right_clip:
            parts.append((cg.H if hard else cg.S, right_clip))
        return cg.cigar(*parts)

    recs = []
    contig_names = []
    for ci in range(8):
        qname = f"fz{ci:02d}"
        read_len = int(rng.integers(60, 400))
        n_segs = int(rng.integers(1, 4))
        # partition the read into n_segs aligned windows (sequencing order)
        cuts = sorted(rng.choice(
            np.arange(1, read_len), size=n_segs - 1, replace=False
        ).tolist()) if n_segs > 1 else []
        bounds = [0] + cuts + [read_len]
        segs = []
        for si in range(n_segs):
            lo, hi = bounds[si], bounds[si + 1]
            fwd = bool(rng.random() < 0.7)
            hard = bool(rng.random() < 0.3) and si > 0
            # read-order clip positions -> strand-local clips
            l_clip, r_clip = (lo, read_len - hi) if fwd else (
                read_len - hi, lo
            )
            cigar = rand_cigar(read_len, l_clip, r_clip, hard)
            tid = int(rng.integers(0, n_ref))
            pos = int(rng.integers(0, 20000))
            segs.append((tid, pos, fwd, cigar, hard))
        sa_strs = [
            f"{ref_names[t]},{p + 1},{'+' if f else '-'},"
            f"{cg.to_string(c)},60,0;"
            for t, p, f, c, _ in segs
        ]
        for si, (tid, pos, fwd, cigar, hard) in enumerate(segs):
            flag = 0 if si == 0 else FSUPPLEMENTARY
            if not fwd:
                flag |= FREVERSE
            sa = "".join(s for j, s in enumerate(sa_strs) if j != si)
            seq_len = read_len if not hard else int(
                sum(int(ln) for code, ln in cigar
                    if code in (cg.M, cg.I, cg.S))
            )
            rec = BamRecord(
                qname=qname.encode(), flag=flag, tid=tid, pos=pos, mapq=60,
                cigar=cigar, seq=rand_seq(rng, seq_len),
                qual=np.full(seq_len, 30, np.uint8),
            )
            if sa:
                rec.push_tag(b"SA", b"Z", sa)
            recs.append(rec)
        contig_names.append((qname, read_len))

    recs.sort(key=lambda r: (r.tid, r.pos))
    bam = str(tmp_path / "fuzz_asm.bam")
    with BamWriter(bam, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(bam)

    ref_cl = ChromList.from_pairs(list(zip(ref_names, ref_lens)))
    contig_cl = ChromList.from_pairs(contig_names)

    def scan():
        return scan_contig_bam(bam, ref_cl, contig_cl, None, thread_count=3)

    monkeypatch.setenv("PTPU_P1_NATIVE", "0")
    try:
        py_info = scan()
        py_err = None
    except Exception as e:  # noqa: BLE001 - parity includes errors
        py_info, py_err = None, (type(e).__name__, str(e))
    monkeypatch.setenv("PTPU_P1_NATIVE", "1")
    try:
        nat_info = scan()
        nat_err = None
    except Exception as e:  # noqa: BLE001
        nat_info, nat_err = None, (type(e).__name__, str(e))
    assert py_err == nat_err
    if py_err is None:
        assert pickle.dumps(nat_info) == pickle.dumps(py_info)
