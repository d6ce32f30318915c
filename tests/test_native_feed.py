"""Native C++ feed (ptscan) conformance: CLI output must be record-identical
to the Python engine path (and therefore to the host oracle, which the
engine path is conformance-tested against)."""

import os

import numpy as np
import pytest

from portello_tpu.pipeline import native_feed
from portello_tpu.testutil.simulate import make_scenario

pytestmark = pytest.mark.skipif(
    native_feed.get_lib() is None,
    reason=f"ptscan unavailable: {native_feed.build_error()}",
)


def _run_cli(tmp_path, tag, feed, extra=()):
    from portello_tpu.main import main

    out = tmp_path / f"remapped_{tag}.bam"
    un = tmp_path / f"un_{tag}.bam"
    main([
        "--assembly-to-ref", str(tmp_path / "asm_to_ref.bam"),
        "--read-to-assembly", str(tmp_path / "read_to_asm.bam"),
        "--remapped-read-output", str(out),
        "--unassembled-read-output", str(un),
        "--ref", str(tmp_path / "ref.fa"),
        "--device", "cpu", "--feed", feed, "--batch-size", "32",
        *extra,
    ])
    return out, un


def _records(path):
    from portello_tpu.io.bam import BamReader

    with BamReader(str(path)) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def test_native_feed_matches_python_engine(tmp_path):
    rng = np.random.default_rng(11)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=60, read_len=400)
    out_n, un_n = _run_cli(tmp_path, "native", "native")
    out_p, un_p = _run_cli(tmp_path, "python", "python")
    assert _records(out_n) == _records(out_p)
    assert _records(un_n) == _records(un_p)
    assert len(_records(out_n)) > 0


def test_native_feed_target_region(tmp_path):
    rng = np.random.default_rng(12)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=40, read_len=300)
    extra = ("--target-region", "chr1:1-20000")
    out_n, _ = _run_cli(tmp_path, "native_t", "native", extra)
    out_p, _ = _run_cli(tmp_path, "python_t", "python", extra)
    assert _records(out_n) == _records(out_p)


def test_native_feed_small_batch_flush(tmp_path):
    """Partial final batches (count < batch_size) must resolve exactly."""
    rng = np.random.default_rng(13)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=5, read_len=300)
    out_n, _ = _run_cli(tmp_path, "native_s", "native")
    out_p, _ = _run_cli(tmp_path, "python_s", "python")
    assert _records(out_n) == _records(out_p)


def test_native_feed_two_host_shards(tmp_path):
    """Native feed honors the multi-host contig ownership plan: merged
    2-host shards equal the single run (unsorted-content contract,
    docs/user_guide.md:227-230)."""
    from portello_tpu.main import main
    from portello_tpu.testutil.simulate import make_scenario
    from portello_tpu.tools.merge import merge_bams

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(17))

    def run(tag, extra):
        r = str(tmp_path / f"r_{tag}.bam")
        u = str(tmp_path / f"u_{tag}.bam")
        main([
            "--assembly-to-ref", scn.contig_bam,
            "--read-to-assembly", scn.read_bam,
            "--remapped-read-output", r,
            "--unassembled-read-output", u,
            "--ref", scn.ref_fasta,
            "--device", "cpu", "--feed", "native", "--batch-size", "32",
            *extra,
        ])
        return r, u

    r_single, u_single = run("single", [])
    shards_r, shards_u = [], []
    for host in range(2):
        run(f"h{host}", ["--num-hosts", "2", "--host-id", str(host)])
        shards_r.append(str(tmp_path / f"r_h{host}.shard{host:02d}of02.bam"))
        shards_u.append(str(tmp_path / f"u_h{host}.shard{host:02d}of02.bam"))
    merged_r = str(tmp_path / "m_r.bam")
    merged_u = str(tmp_path / "m_u.bam")
    merge_bams(merged_r, shards_r)
    merge_bams(merged_u, shards_u)
    assert _records(merged_r) == _records(r_single)
    assert _records(merged_u) == _records(u_single)


def test_native_feed_forced_fallbacks(tmp_path):
    """Tiny buckets/windows force bucket-overflow and window-saturation
    fallbacks, driving ptscan's native exact compute (host_lift_item incl.
    the C++ left-shift/homology port) — outputs must still equal the Python
    engine configured with the same buckets."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from portello_tpu.models.batch import BucketConfig
    from portello_tpu.models.pipeline_model import DeviceEngine
    from portello_tpu.pipeline.native_feed import scan_and_remap_reads_native
    from portello_tpu.pipeline.read_scan import scan_and_remap_reads
    from portello_tpu.testutil.simulate import make_scenario
    from portello_tpu.io.fasta import get_genome_ref_from_fasta
    from portello_tpu.utils.chrom_list import ChromList
    from portello_tpu.pipeline.contig_scan import scan_contig_bam

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(23))
    ref_cl = ChromList.from_bam_filename(scn.contig_bam)
    asm_cl = ChromList.from_bam_filename(scn.read_bam)
    genome = get_genome_ref_from_fasta(scn.ref_fasta)
    reference = [genome.chroms[c.label] for c in ref_cl.data]
    info = scan_contig_bam(scn.contig_bam, ref_cl, asm_cl, None)

    # window=4 saturates most indel clusters; small max_ops forces bucket
    # spills and host fallbacks for anything nontrivial
    buckets = [
        BucketConfig(max_ops=24, max_blocks=12, max_seq=1024,
                     max_clusters=8, window=4),
    ]

    stats = scan_and_remap_reads_native(
        scn.read_bam, str(tmp_path / "r_native.bam"),
        str(tmp_path / "u_native.bam"), reference, ref_cl, info, False,
        batch_size=16, buckets=buckets, thread_count=3, use_mm=False,
    )
    # the point of this test: the native fallback paths actually fire
    assert stats["host_items"] > 0

    engine = DeviceEngine(
        reference, asm_cl, info, batch_size=16, buckets=buckets,
        platform="cpu", use_mm=False,
    )
    scan_and_remap_reads(
        scn.read_bam, str(tmp_path / "r_py.bam"),
        str(tmp_path / "u_py.bam"), reference, ref_cl, info, False,
        engine=engine,
    )
    assert _records(tmp_path / "r_native.bam") == _records(tmp_path / "r_py.bam")
    assert _records(tmp_path / "u_native.bam") == _records(tmp_path / "u_py.bam")


def test_native_feed_unmapped_only_input(tmp_path):
    """An input with no mapped primaries exercises the empty-batch EOF path;
    unplaced records still pass through."""
    from portello_tpu.io.bam import BamReader, BamWriter
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.main import main
    from portello_tpu.testutil.simulate import make_scenario

    make_scenario(str(tmp_path), rng=np.random.default_rng(29))
    src = str(tmp_path / "read_to_asm.bam")
    only_un = str(tmp_path / "only_unmapped.bam")
    with BamReader(src) as r:
        header = r.header
        recs = [rec for rec in r if rec.is_unmapped()]
    with BamWriter(only_un, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(only_un)
    main([
        "--assembly-to-ref", str(tmp_path / "asm_to_ref.bam"),
        "--read-to-assembly", only_un,
        "--remapped-read-output", str(tmp_path / "r_u.bam"),
        "--unassembled-read-output", str(tmp_path / "u_u.bam"),
        "--ref", str(tmp_path / "ref.fa"),
        "--device", "cpu", "--feed", "native",
    ])
    assert len(_records(tmp_path / "u_u.bam")) == len(recs)
    assert _records(tmp_path / "r_u.bam") == []


def test_native_feed_multi_bucket_spill(tmp_path):
    """Items exceeding the tiny first bucket spill to the second instead of
    falling back to host; outputs equal the Python engine on the same
    bucket ladder."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from portello_tpu.models.batch import BucketConfig
    from portello_tpu.models.pipeline_model import DeviceEngine
    from portello_tpu.pipeline.native_feed import scan_and_remap_reads_native
    from portello_tpu.pipeline.read_scan import scan_and_remap_reads
    from portello_tpu.testutil.simulate import make_scenario
    from portello_tpu.io.fasta import get_genome_ref_from_fasta
    from portello_tpu.utils.chrom_list import ChromList
    from portello_tpu.pipeline.contig_scan import scan_contig_bam

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(41))
    ref_cl = ChromList.from_bam_filename(scn.contig_bam)
    asm_cl = ChromList.from_bam_filename(scn.read_bam)
    genome = get_genome_ref_from_fasta(scn.ref_fasta)
    reference = [genome.chroms[c.label] for c in ref_cl.data]
    info = scan_contig_bam(scn.contig_bam, ref_cl, asm_cl, None)

    buckets = [
        BucketConfig(max_ops=4, max_blocks=4, max_seq=256,
                     max_clusters=8, window=16),  # almost nothing fits
        BucketConfig(max_ops=96, max_blocks=48, max_seq=4096,
                     max_clusters=64, window=16),
    ]
    stats = scan_and_remap_reads_native(
        scn.read_bam, str(tmp_path / "r_n.bam"), str(tmp_path / "u_n.bam"),
        reference, ref_cl, info, False, batch_size=16, buckets=buckets,
        thread_count=2, use_mm=False,
    )
    assert stats["device_items"] > 0

    engine = DeviceEngine(
        reference, asm_cl, info, batch_size=16, buckets=buckets,
        platform="cpu", use_mm=False,
    )
    scan_and_remap_reads(
        scn.read_bam, str(tmp_path / "r_p.bam"), str(tmp_path / "u_p.bam"),
        reference, ref_cl, info, False, engine=engine,
    )
    assert _records(tmp_path / "r_n.bam") == _records(tmp_path / "r_p.bam")


def test_native_feed_long_cigar_cg(tmp_path):
    """A read with >65535 cigar ops exercises the CG-tag long-cigar decode
    (input) and spill (output) in both the native scanner and the Python
    path (SAM spec 4.2.2; io/bam.py decode/encode)."""
    from portello_tpu.io.bam import BamHeader, BamRecord, BamWriter
    from portello_tpu.io.fasta import write_fasta
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.main import main
    from portello_tpu.ops import cigar as cg

    rng = np.random.default_rng(47)
    n_pairs = 40_000  # 80k ops > 0xFFFF
    read_len = 2 * n_pairs
    contig_span = n_pairs
    contig_len = contig_span + 200
    chrom_len = contig_len + 200

    chrom = rng.integers(65, 69, size=chrom_len, dtype=np.uint8)
    contig_seq = chrom[100 : 100 + contig_len].copy()
    ref_fa = str(tmp_path / "ref.fa")
    write_fasta(ref_fa, [("chr1", bytes(chrom))])

    ref_header = BamHeader.from_refs([("chr1", chrom_len)])
    asm_bam = str(tmp_path / "asm.bam")
    with BamWriter(asm_bam, ref_header) as w:
        w.write(BamRecord(
            qname=b"ctg1", flag=0, tid=0, pos=100, mapq=60,
            cigar=cg.cigar((cg.EQ, contig_len)),
            seq=contig_seq, qual=np.full(contig_len, 40, np.uint8),
        ))
    build_bai(asm_bam)

    # read: alternating 1M1I over the contig -> 80k-op cigar
    cigar = np.tile(np.array([[cg.M, 1], [cg.I, 1]], np.int64), (n_pairs, 1))
    seq = np.empty(read_len, np.uint8)
    seq[0::2] = contig_seq[50 : 50 + n_pairs]   # M bases match the contig
    seq[1::2] = ord("A")                        # inserted bases
    read_header = BamHeader.from_refs([("ctg1", contig_len)])
    read_bam = str(tmp_path / "reads.bam")
    with BamWriter(read_bam, read_header) as w:
        w.write(BamRecord(
            qname=b"longread", flag=0, tid=0, pos=50, mapq=50,
            cigar=cigar, seq=seq, qual=np.full(read_len, 30, np.uint8),
        ))
    build_bai(read_bam)

    outs = {}
    for feed, dev in (("native", "cpu"), ("python", "host")):
        r = str(tmp_path / f"out_{feed}.bam")
        main([
            "--assembly-to-ref", asm_bam, "--read-to-assembly", read_bam,
            "--remapped-read-output", r,
            "--unassembled-read-output", str(tmp_path / f"un_{feed}.bam"),
            "--ref", ref_fa, "--device", dev, "--feed", feed,
        ])
        outs[feed] = _records(r)
    assert outs["native"] == outs["python"]
    assert len(outs["native"]) == 1
    # the lifted record must round-trip its >65535-op cigar through CG
    assert "40000I" not in outs["native"][0]  # sanity: ops not merged away


def test_native_feed_malformed_sa_error_contract(tmp_path):
    """A malformed SA tag must fail the scan on the native feed exactly as on
    the Python feed (reference sa_tag_parser.rs:27-31 assert)."""
    from portello_tpu.io.bam import BamReader, BamWriter
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.main import main
    from portello_tpu.testutil.simulate import make_scenario

    make_scenario(str(tmp_path), rng=np.random.default_rng(31))
    src = str(tmp_path / "read_to_asm.bam")
    bad = str(tmp_path / "read_to_asm_bad.bam")
    with BamReader(src) as r:
        recs = list(r)
        header = r.header
    # corrupt the first primary mapped record with a 4-field SA segment
    for rec in recs:
        if not rec.is_unmapped() and not rec.is_supplementary():
            rec.remove_tag(b"SA")
            rec.push_tag(b"SA", b"Z", b"contig0,100,+,10M;")
            break
    with BamWriter(bad, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(bad)

    for feed, device in (("python", "host"), ("native", "cpu")):
        with pytest.raises(SystemExit):
            main([
                "--assembly-to-ref", str(tmp_path / "asm_to_ref.bam"),
                "--read-to-assembly", bad,
                "--remapped-read-output", str(tmp_path / f"re_{feed}.bam"),
                "--unassembled-read-output", str(tmp_path / f"ue_{feed}.bam"),
                "--ref", str(tmp_path / "ref.fa"),
                "--device", device, "--feed", feed,
            ])


def test_native_feed_sharded_multidevice(tmp_path, monkeypatch):
    """Multi-device data-parallel dispatch (PTPU_SHARD=1 on the virtual
    8-device CPU mesh; auto on multi-GPU hosts) must produce output
    record-identical to the single-device paths — for both kernel
    formulations, including the fused mm rev chain."""
    rng = np.random.default_rng(53)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=50, read_len=400)
    out_p, un_p = _run_cli(tmp_path, "ref_python", "python")

    monkeypatch.setenv("PTPU_SHARD", "1")
    out_s, un_s = _run_cli(tmp_path, "shard_gather", "native")
    assert _records(out_s) == _records(out_p)
    assert _records(un_s) == _records(un_p)

    monkeypatch.setenv("PTPU_MM", "1")
    out_m, un_m = _run_cli(tmp_path, "shard_mm", "native")
    assert _records(out_m) == _records(out_p)
    assert _records(un_m) == _records(un_p)
    assert len(_records(out_p)) > 0


def test_zero_length_indel_rev_path_routes_to_host(tmp_path):
    """A zero-length I op on a reverse-contig read forms a phantom cluster
    in the device left-shift (silently divergent from the oracle, which
    ignores 0-length indels); both feeds must route such items to the exact
    host path.  Output equality vs the pure-host run is the contract; the
    stats prove the routing fired."""
    import jax

    jax.config.update("jax_platforms", "cpu")

    from portello_tpu.io.bam import BamReader, BamWriter
    from portello_tpu.io.fasta import get_genome_ref_from_fasta
    from portello_tpu.io.index_build import build_bai
    from portello_tpu.ops import cigar as cg
    from portello_tpu.pipeline.contig_scan import scan_contig_bam
    from portello_tpu.pipeline.native_feed import scan_and_remap_reads_native
    from portello_tpu.pipeline.read_scan import scan_and_remap_reads
    from portello_tpu.utils.chrom_list import ChromList

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(37))
    ref_cl = ChromList.from_bam_filename(scn.contig_bam)
    asm_cl = ChromList.from_bam_filename(scn.read_bam)
    genome = get_genome_ref_from_fasta(scn.ref_fasta)
    reference = [genome.chroms[c.label] for c in ref_cl.data]
    info = scan_contig_bam(scn.contig_bam, ref_cl, asm_cl, None)

    # contigs whose EVERY split segment maps reverse: any read item on them
    # takes the rev (left-shift) device path
    rev_tids = [
        ci for ci in range(len(asm_cl.data))
        if info[ci].ordered_contig_segment_info
        and all(
            not s.seq_order_segment.is_fwd_strand
            for s in info[ci].ordered_contig_segment_info
        )
    ]
    assert rev_tids, "scenario must contain an all-reverse contig"

    injected = 0
    with BamReader(scn.read_bam) as r:
        recs = list(r)
        header = r.header
    for rec in recs:
        if (rec.tid in rev_tids and not rec.is_unmapped()
                and not rec.is_supplementary()
                and rec.get_string_tag(b"SA") is None):
            c = rec.cigar
            for k in range(len(c)):
                if c[k, 0] == cg.M and c[k, 1] >= 2:
                    parts = [c[:k], [[cg.M, 1], [cg.I, 0], [cg.M, c[k, 1] - 1]],
                             c[k + 1:]]
                    rec.cigar = np.concatenate(
                        [np.asarray(p, np.int64).reshape(-1, 2) for p in parts]
                    )
                    rec.raw = None  # invalidate the encode cache
                    injected += 1
                    break
    assert injected > 0, "no eligible rev-contig read to inject into"
    bad = str(tmp_path / "read_to_asm_zl.bam")
    with BamWriter(bad, header) as w:
        for rec in recs:
            w.write(rec)
    build_bai(bad)

    # device-shift routing: zero-length rev ops must route to the exact host
    # path there (host-shift routing runs the shift on host and is immune)
    os.environ["PTPU_HOST_SHIFT"] = "0"
    try:
        stats = scan_and_remap_reads_native(
            bad, str(tmp_path / "zl_native.bam"), str(tmp_path / "zl_un_n.bam"),
            reference, ref_cl, info, False, batch_size=32, thread_count=2,
            use_mm=False,
        )
    finally:
        del os.environ["PTPU_HOST_SHIFT"]
    assert stats["host_items"] >= injected

    scan_and_remap_reads(
        bad, str(tmp_path / "zl_py.bam"), str(tmp_path / "zl_un_p.bam"),
        reference, ref_cl, info, False,
    )
    assert _records(tmp_path / "zl_native.bam") == _records(tmp_path / "zl_py.bam")
    assert _records(tmp_path / "zl_un_n.bam") == _records(tmp_path / "zl_un_p.bam")


def test_native_feed_all_host_routing(tmp_path):
    """PTPU_ALL_HOST=1 (the no-chip offload-A/B leg) routes every item
    through the exact host path with zero device dispatches; output must be
    record-identical to the device-routed run."""
    rng = np.random.default_rng(17)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=50, read_len=400)
    out_d, un_d = _run_cli(tmp_path, "dev_ah", "native")
    os.environ["PTPU_ALL_HOST"] = "1"
    try:
        out_h, un_h = _run_cli(tmp_path, "allhost", "native", ("--threads", "4"))
    finally:
        del os.environ["PTPU_ALL_HOST"]
    assert _records(out_h) == _records(out_d)
    assert _records(un_h) == _records(un_d)
    from portello_tpu.pipeline.native_feed import _last_stats

    assert _last_stats["device_items"] == 0
    assert _last_stats["host_items"] > 0


def test_native_feed_resident_mode(tmp_path, monkeypatch):
    """Resident slot mode (PTPU_RESIDENT=1): the
    C++ fill emits packed nibble rows + ref chrom indices, the device
    fetches reference windows from the device-resident superblock table
    (kernels/resident.py), and output must be record-identical to the
    table-slot run — including reverse-contig reads (host-shifted, flip
    re-packed rows) and odd-length reads (nibble parity)."""
    rng = np.random.default_rng(61)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=50, read_len=401)
    out_t, un_t = _run_cli(tmp_path, "res_table", "native")
    monkeypatch.setenv("PTPU_RESIDENT", "1")
    out_r, un_r = _run_cli(tmp_path, "res_resident", "native")
    assert _records(out_r) == _records(out_t)
    assert _records(un_r) == _records(un_t)
    assert len(_records(out_t)) > 0
    from portello_tpu.pipeline.native_feed import _last_stats

    assert _last_stats["device_items"] > 0  # the resident graph really ran


def test_native_feed_resident_sharded(tmp_path, monkeypatch):
    """Resident mode under multi-device batch sharding: the superblock
    table is replicated over the mesh, batches shard on dim 0
    (mesh.make_sharded_fwd_resident_step); output must match the
    single-device table run."""
    rng = np.random.default_rng(62)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=40, read_len=400)
    out_t, un_t = _run_cli(tmp_path, "ress_table", "native")
    monkeypatch.setenv("PTPU_RESIDENT", "1")
    monkeypatch.setenv("PTPU_SHARD", "1")
    out_r, un_r = _run_cli(tmp_path, "ress_shard", "native")
    assert _records(out_r) == _records(out_t)
    assert _records(un_r) == _records(un_t)


def test_native_feed_resident_requires_host_shift(tmp_path, monkeypatch):
    """PTPU_RESIDENT=1 + PTPU_HOST_SHIFT=0 is contradictory (the
    device-shift rev graph consumes the ASCII tables); both the C++ gate
    and the feed must fall back to table slots, output unchanged."""
    rng = np.random.default_rng(63)
    make_scenario(str(tmp_path), rng=rng, n_reads_per_contig=30, read_len=300)
    out_t, _ = _run_cli(tmp_path, "reshs_table", "native")
    monkeypatch.setenv("PTPU_RESIDENT", "1")
    monkeypatch.setenv("PTPU_HOST_SHIFT", "0")
    out_r, _ = _run_cli(tmp_path, "reshs_devshift", "native")
    assert _records(out_r) == _records(out_t)


def test_pool_epoch_stress():
    """WorkPool epoch-handoff regression (round 5): a worker that slept
    through an epoch must never wake into a COMPLETED epoch, read the dead
    closure pointer, and claim a ticket of the next epoch once ``next`` is
    reset — that stale invocation of a destroyed std::function was the
    wandering RA>=2 suite corruption (ASAN stack-use-after-scope at
    pool_worker's ``(*fn)(i)``).  ptscan_dbg_pool_stress
    alternates two distinct epoch bodies over rapid tiny epochs and returns
    nonzero if any item ran the wrong epoch's body; under ASAN the stale
    call itself aborts.  Pre-fix this tripped within ~one 200k-epoch trial
    at 6 threads."""
    import ctypes

    lib = native_feed.get_lib()
    lib.ptscan_dbg_pool_stress.restype = ctypes.c_int
    lib.ptscan_dbg_pool_stress.argtypes = [ctypes.c_int, ctypes.c_longlong]
    assert lib.ptscan_dbg_pool_stress(6, 200_000) == 0
