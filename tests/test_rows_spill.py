"""Update-grid row bound and bucket-spill machinery.

Under the renumbered visit scheme every rc op needs inside_keys + 1 rows, so
``total_rows <= n_ops + n_blocks`` — the proven default bound in
``BucketConfig.resolved_max_rows`` (no spill possible with default buckets).
This fuzzes that proof and exercises the spill path with an artificially
tight custom bucket (items route to the wider bucket on the host row count,
run on device there, and match the oracle with zero host fallbacks)."""

import numpy as np
import pytest

from portello_tpu.io.bam import BamReader
from portello_tpu.models.batch import BucketConfig
from portello_tpu.ops.blockmap import build_block_map
from portello_tpu.ops import cigar as cg

jax = pytest.importorskip("jax")

from test_liftover_kernel import random_cigar  # noqa: E402


def test_pick_bucket_rows_dimension():
    from portello_tpu.models.pipeline_model import DeviceEngine

    eng = DeviceEngine.__new__(DeviceEngine)
    eng.buckets = [
        BucketConfig(max_ops=128, max_blocks=48, max_seq=1024, max_rows=40),
        BucketConfig(max_ops=256, max_blocks=96, max_seq=1024),
    ]
    assert eng._pick_bucket(100, 10, 500, 500, n_rows=40) == 0
    assert eng._pick_bucket(100, 10, 500, 500, n_rows=41) == 1
    assert eng._pick_bucket(100, 10, 500, 500, n_rows=700) == -1


def test_rows_never_exceed_ops_plus_blocks():
    """The proof behind resolved_max_rows(): rows <= n_ops + n_blocks."""
    from portello_tpu.models.pipeline_model import _count_update_rows

    rng = np.random.default_rng(23)
    checked = 0
    for _ in range(300):
        map_cigar = random_cigar(rng, 24)
        map_pos = int(rng.integers(0, 4000))
        bm = build_block_map(map_pos, map_cigar, False)
        read_cigar = random_cigar(rng, 48)
        read_pos = int(rng.integers(0, 3000))
        # window the keys exactly like _prep_item does
        span = cg.get_cigar_ref_offset(read_cigar)
        lo, hi = bm.range_indices(read_pos, read_pos + span)
        keys = np.asarray(bm.keys[lo:hi])
        rows = _count_update_rows(read_cigar, read_pos, keys)
        assert rows <= len(read_cigar) + len(keys), (
            f"rows {rows} > {len(read_cigar)} + {len(keys)}"
        )
        checked += 1
    assert checked == 300


def content(path):
    with BamReader(path) as r:
        return sorted(rec.encode() for rec in r)


def test_custom_tight_bucket_spills_not_falls_back(tmp_path):
    from portello_tpu.io.fasta import get_genome_ref_from_fasta
    from portello_tpu.models.pipeline_model import DEFAULT_BUCKETS, DeviceEngine
    from portello_tpu.pipeline.contig_scan import scan_contig_bam
    from portello_tpu.pipeline.read_scan import scan_and_remap_reads
    from portello_tpu.utils.chrom_list import ChromList
    from test_engine_fallbacks import build_inputs

    contig_bam, read_bam, fasta = build_inputs(tmp_path)
    ref_chrom_list = ChromList.from_bam_filename(contig_bam)
    contig_list = ChromList.from_bam_filename(read_bam)
    genome = get_genome_ref_from_fasta(fasta)
    reference = [genome.chroms[c.label] for c in ref_chrom_list.data]
    info = scan_contig_bam(contig_bam, ref_chrom_list, contig_list, None)

    b0 = DEFAULT_BUCKETS[0]
    tight = (
        # max_rows=8 forces every normal item over the row bound
        BucketConfig(
            max_ops=b0.max_ops, max_blocks=b0.max_blocks, max_seq=b0.max_seq,
            max_clusters=b0.max_clusters, window=b0.window, max_rows=8,
        ),
    ) + tuple(DEFAULT_BUCKETS[1:])

    def run(tag, buckets):
        engine = DeviceEngine(
            reference, contig_list, info, batch_size=16, buckets=buckets
        )
        scan_and_remap_reads(
            read_bam, str(tmp_path / f"r_{tag}.bam"),
            str(tmp_path / f"u_{tag}.bam"),
            reference, ref_chrom_list, info, False, engine=engine,
        )
        return engine

    e_tight = run("tight", list(tight))
    e_def = run("def", list(DEFAULT_BUCKETS))
    # identical output either way; the tight run must not have gained
    # host fallbacks (items spilled to bucket 1 on the row count instead)
    assert content(str(tmp_path / "r_tight.bam")) == content(
        str(tmp_path / "r_def.bam")
    )
    assert e_tight.stats["host_items"] == e_def.stats["host_items"]
    assert e_tight.stats["device_items"] == e_def.stats["device_items"]
