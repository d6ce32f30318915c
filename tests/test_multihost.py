"""Multi-host semantics: per-host contig-sharded runs + merge must reproduce
the single-host output exactly (as sorted record sets)."""

import numpy as np
import pytest

from portello_tpu.io.bam import BamReader
from portello_tpu.main import main
from portello_tpu.parallel.distributed import plan_host_shards, shard_output_path
from portello_tpu.testutil.simulate import make_scenario
from portello_tpu.tools.merge import merge_bams


def content(path):
    with BamReader(path) as r:
        return sorted(rec.encode() for rec in r)


def test_plan_host_shards():
    lengths = [100, 900, 500, 300, 200]
    plans = [plan_host_shards(lengths, 2, h) for h in range(2)]
    owned = sorted(i for p in plans for i in p.contig_indices)
    assert owned == list(range(5))
    loads = [sum(lengths[i] for i in p.contig_indices) for p in plans]
    assert max(loads) - min(loads) <= 900  # greedy balance


def test_shard_output_path():
    assert shard_output_path("out.bam", 1, 4) == "out.shard01of04.bam"
    assert shard_output_path("out", 0, 2) == "out.shard00of02"
    assert shard_output_path("-", 0, 2) == "-"
    assert shard_output_path("x/y.bam", 3, 8) == "x/y.shard03of08.bam"


def test_two_host_run_matches_single(tmp_path):
    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(11))

    def run(tag, extra):
        r = str(tmp_path / f"r_{tag}.bam")
        u = str(tmp_path / f"u_{tag}.bam")
        main(
            [
                "--assembly-to-ref", scn.contig_bam,
                "--read-to-assembly", scn.read_bam,
                "--remapped-read-output", r,
                "--unassembled-read-output", u,
                "--ref", scn.ref_fasta,
                "--device", "host",
                *extra,
            ]
        )
        return r, u

    r_single, u_single = run("single", [])
    shards_r = []
    shards_u = []
    for host in range(2):
        run(f"h{host}", ["--num-hosts", "2", "--host-id", str(host)])
        shards_r.append(str(tmp_path / f"r_h{host}.shard{host:02d}of02.bam"))
        shards_u.append(str(tmp_path / f"u_h{host}.shard{host:02d}of02.bam"))

    merged_r = str(tmp_path / "merged_r.bam")
    merged_u = str(tmp_path / "merged_u.bam")
    merge_bams(merged_r, shards_r)
    merge_bams(merged_u, shards_u)

    assert content(merged_r) == content(r_single)
    assert content(merged_u) == content(u_single)


def test_local_workers_matches_single(tmp_path):
    """--local-workers N fans phase 2 across worker processes and merges
    shards; output equals the single-process run."""
    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(19))

    def run(tag, extra):
        r = str(tmp_path / f"lw_r_{tag}.bam")
        u = str(tmp_path / f"lw_u_{tag}.bam")
        main([
            "--assembly-to-ref", scn.contig_bam,
            "--read-to-assembly", scn.read_bam,
            "--remapped-read-output", r,
            "--unassembled-read-output", u,
            "--ref", scn.ref_fasta,
            "--device", "host",
            *extra,
        ])
        return r, u

    r1, u1 = run("single", [])
    r2, u2 = run("workers", ["--local-workers", "2"])
    assert content(r2) == content(r1)
    assert content(u2) == content(u1)


def test_dcn_coordinator_handshake_two_processes(tmp_path):
    """Real DCN init: two worker processes rendezvous through
    ``jax.distributed.initialize`` (--coordinator, CPU backend), each runs
    its contig shard, and the merged output equals the single-host run.

    This exercises the actual coordinator service handshake — not just the
    shard-plan arithmetic (SURVEY.md section 2d; the one previously
    untrodden shipped codepath)."""
    import socket
    import subprocess
    import sys

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(23))

    r_single = str(tmp_path / "dcn_r_single.bam")
    u_single = str(tmp_path / "dcn_u_single.bam")
    main([
        "--assembly-to-ref", scn.contig_bam,
        "--read-to-assembly", scn.read_bam,
        "--remapped-read-output", r_single,
        "--unassembled-read-output", u_single,
        "--ref", scn.ref_fasta,
        "--device", "cpu", "--batch-size", "32",
    ])

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = []
    for host in range(2):
        cmd = [
            sys.executable, "-m", "portello_tpu.main",
            "--assembly-to-ref", scn.contig_bam,
            "--read-to-assembly", scn.read_bam,
            "--remapped-read-output", str(tmp_path / f"dcn_r_h{host}.bam"),
            "--unassembled-read-output", str(tmp_path / f"dcn_u_h{host}.bam"),
            "--ref", scn.ref_fasta,
            "--device", "cpu", "--batch-size", "32",
            "--num-hosts", "2", "--host-id", str(host),
            "--coordinator", f"127.0.0.1:{port}",
        ]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("DCN worker timed out (coordinator handshake hung?)")
        outs.append(out)
    for host, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {host} failed:\n{out[-3000:]}"
        # the handshake line proves jax.distributed really initialized
        # (global device count = 2 processes x N local virtual devices)
        assert f"JAX distributed initialized: process {host}/2" in out, (
            out[-3000:]
        )

    shards_r = [
        str(tmp_path / f"dcn_r_h{h}.shard{h:02d}of02.bam") for h in range(2)
    ]
    shards_u = [
        str(tmp_path / f"dcn_u_h{h}.shard{h:02d}of02.bam") for h in range(2)
    ]
    merged_r = str(tmp_path / "dcn_merged_r.bam")
    merged_u = str(tmp_path / "dcn_merged_u.bam")
    merge_bams(merged_r, shards_r)
    merge_bams(merged_u, shards_u)
    assert content(merged_r) == content(r_single)
    assert content(merged_u) == content(u_single)


def test_local_workers_cram_no_transcode(tmp_path, monkeypatch):
    """--local-workers on CRAM input runs WITHOUT the temp-BAM transcode:
    each worker's feed serves its contig shard by .crai slice seek;
    outputs equal the single-process CRAM run and no ptpu_cram_* temp file
    is ever created."""
    from portello_tpu.io import cram

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(29))
    crm = str(tmp_path / "read_to_asm.cram")
    with BamReader(scn.read_bam) as r:
        recs = list(r)
        header = r.header
    with cram.CramWriter(crm, header) as w:
        for rec in recs:
            w.write(rec)

    # any temp files (parent or worker subprocesses) land here
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmpdir))
    import tempfile

    tempfile.tempdir = None  # drop the cached default so TMPDIR applies
    try:
        def run(tag, extra):
            r = str(tmp_path / f"lwc_r_{tag}.bam")
            u = str(tmp_path / f"lwc_u_{tag}.bam")
            main([
                "--assembly-to-ref", scn.contig_bam,
                "--read-to-assembly", crm,
                "--remapped-read-output", r,
                "--unassembled-read-output", u,
                "--ref", scn.ref_fasta,
                "--device", "host",
                *extra,
            ])
            return r, u

        r1, u1 = run("single", [])
        r2, u2 = run("workers", ["--local-workers", "2"])
    finally:
        tempfile.tempdir = None  # don't leak the patched dir to other tests

    assert content(r2) == content(r1)
    assert content(u2) == content(u1)
    leftovers = list(tmpdir.glob("ptpu_cram_*"))
    assert leftovers == [], leftovers


def test_two_host_cram_native_feed_matches_single(tmp_path):
    """Contig-sharded native-feed runs on CRAM input (per-shard .crai fetch
    plan through the push feeder) merge to the single-host CRAM output."""
    from portello_tpu.io import cram
    from portello_tpu.pipeline import native_feed

    if native_feed.get_lib() is None:
        pytest.skip(f"ptscan unavailable: {native_feed.build_error()}")

    scn = make_scenario(str(tmp_path), rng=np.random.default_rng(31))
    crm = str(tmp_path / "read_to_asm.cram")
    with BamReader(scn.read_bam) as r:
        recs = list(r)
        header = r.header
    with cram.CramWriter(crm, header) as w:
        for rec in recs:
            w.write(rec)

    def run(tag, extra):
        r = str(tmp_path / f"cn_r_{tag}.bam")
        u = str(tmp_path / f"cn_u_{tag}.bam")
        main([
            "--assembly-to-ref", scn.contig_bam,
            "--read-to-assembly", crm,
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
        shards_r.append(str(tmp_path / f"cn_r_h{host}.shard{host:02d}of02.bam"))
        shards_u.append(str(tmp_path / f"cn_u_h{host}.shard{host:02d}of02.bam"))
    merged_r = str(tmp_path / "cn_merged_r.bam")
    merged_u = str(tmp_path / "cn_merged_u.bam")
    merge_bams(merged_r, shards_r)
    merge_bams(merged_u, shards_u)
    assert content(merged_r) == content(r_single)
    assert content(merged_u) == content(u_single)
