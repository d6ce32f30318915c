"""WGS-shaped stress soak with memory accounting.

Builds a >=100k-read scenario with MIXED 2-60 kb reads (a wide log-normal,
so the mass spans all three device buckets) and indel rates high enough that long
reads exceed the primary bucket's op budget (spill to the mid/wide buckets,
the widest reads to the exact host path), then drives:

  1. the end-to-end CLI (native feed, cpu device),
  2. --local-workers 2 (fork fan-out + shard merge),
  3. tools/sort over both outputs, tools/merge over the sorted pair,

recording wall clock, peak RSS (self + children, so forked workers count),
and the device/host/fallback routing counts, and asserting
order-insensitive record equality between the two CLI legs.  A half-size
run is recorded alongside so nonlinear memory growth is visible: the
pipeline's design RSS is input-size-independent (bounded slot arenas +
bounded queues) plus the reference/contig index.

Usage: python scripts/soak_scale.py [n_reads] [--skip-half]
Writes its scenario under .bench_cache/ (testutil/wgs.py, reused when
present) and prints one JSON summary line at the end.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def soak_params(n_reads, seed):
    """A WGS-shaped scenario (testutil/wgs.py) at 5% genome scale with a
    wide read-length spread (2-60 kb) and an indel every ~150 bp, so a long
    read carries ~400 ops: past the 128/256-op buckets into the wide one,
    the longest past even that (host fallback)."""
    from portello_tpu.testutil.wgs import WgsParams

    return WgsParams(
        seed=seed, n_reads=n_reads, chrom_scale=0.05, contig_min=300_000,
        contig_max=1_000_000, read_median=11_000, read_sigma=0.9,
        read_event_bp=150,
    )


_WRAP = r"""
import resource, sys
from portello_tpu.main import main
try:
    main(sys.argv[1:])
finally:
    r = resource.getrusage(resource.RUSAGE_SELF)
    c = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"PEAK_RSS_KB {max(r.ru_maxrss, c.ru_maxrss)}", file=sys.stderr)
"""


def run_cli(args):
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", _WRAP, *args], capture_output=True, text=True
    )
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-4000:])
        raise SystemExit(f"CLI leg failed rc={p.returncode}")
    rss = None
    m = re.search(r"PEAK_RSS_KB (\d+)", p.stderr)
    if m:
        rss = int(m.group(1)) // 1024
    counts = {}
    m = re.search(
        r"Lifted (\d+) primary reads: (\d+) device work items, (\d+) host "
        r"items \((\d+) window/bucket fallbacks\)", p.stderr
    )
    if m:
        counts = dict(zip(
            ("n_primary", "device_items", "host_items", "fallbacks"),
            map(int, m.groups()),
        ))
    return wall, rss, counts


def digest_bam(path):
    """Order-insensitive record digest + count (sum of per-record hashes)."""
    from portello_tpu.io.bam import BamReader

    total = 0
    n = 0
    with BamReader(path) as r:
        for rec in r:
            h = hashlib.sha1(rec.to_sam(r.header).encode()).digest()[:8]
            total = (total + int.from_bytes(h, "little")) & (2**64 - 1)
            n += 1
    return total, n


def run_scale(n_reads, rng_seed):
    from portello_tpu.testutil.wgs import build_wgs_scenario

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    scn = build_wgs_scenario(
        os.path.join(here, "..", ".bench_cache"),
        soak_params(n_reads, rng_seed),
    )
    sys.stderr.write(
        f"[soak_scale] scenario ready in {time.perf_counter() - t0:.0f}s\n"
    )
    out = tempfile.mkdtemp(prefix="soakscale_")
    base = [
        "--assembly-to-ref", scn.contig_bam,
        "--read-to-assembly", scn.read_bam,
        "--ref", scn.ref_fasta,
        "--device", "cpu", "--feed", "native",
    ]
    rec = {"n_reads": n_reads}

    r1 = os.path.join(out, "r1.bam")
    wall, rss, counts = run_cli(base + [
        "--remapped-read-output", r1,
        "--unassembled-read-output", os.path.join(out, "u1.bam"),
        "--threads", "4",
    ])
    rec["e2e"] = {"wall_s": round(wall, 1), "peak_rss_mb": rss, **counts}
    sys.stderr.write(f"[soak_scale n={n_reads}] e2e {rec['e2e']}\n")

    r2 = os.path.join(out, "r2.bam")
    wall, rss, counts = run_cli(base + [
        "--remapped-read-output", r2,
        "--unassembled-read-output", os.path.join(out, "u2.bam"),
        "--threads", "2", "--local-workers", "2",
    ])
    rec["workers2"] = {"wall_s": round(wall, 1), "peak_rss_mb": rss, **counts}
    sys.stderr.write(f"[soak_scale n={n_reads}] workers {rec['workers2']}\n")

    d1, n1 = digest_bam(r1)
    d2, n2 = digest_bam(r2)
    if (d1, n1) != (d2, n2):
        raise SystemExit(
            f"EQUALITY FAILED: e2e ({n1} recs, {d1:x}) != workers "
            f"({n2} recs, {d2:x})"
        )
    rec["equality"] = f"{n1} records identical (order-insensitive)"

    # tools/sort both outputs, tools/merge the sorted pair
    from portello_tpu.tools.merge import merge_bams
    from portello_tpu.tools.sort import sort_bam

    s1, s2 = os.path.join(out, "s1.bam"), os.path.join(out, "s2.bam")
    t0 = time.perf_counter()
    sort_bam(r1, s1, n_threads=4)
    sort_bam(r2, s2, n_threads=4)
    rec["sort_wall_s"] = round(time.perf_counter() - t0, 1)
    merged = os.path.join(out, "merged.bam")
    t0 = time.perf_counter()
    merge_bams(merged, [s1, s2], n_threads=4)
    rec["merge_wall_s"] = round(time.perf_counter() - t0, 1)
    _, nm = digest_bam(merged)
    if nm != 2 * n1:
        raise SystemExit(f"merge record count {nm} != {2 * n1}")
    rec["out_bam_mb"] = os.path.getsize(r1) // 2**20

    import shutil

    shutil.rmtree(out, ignore_errors=True)
    return rec


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    skip_half = "--skip-half" in sys.argv
    summary = {"full": run_scale(n, rng_seed=2026)}
    if not skip_half:
        summary["half"] = run_scale(n // 2, rng_seed=2027)
        f, h = summary["full"], summary["half"]
        if f["e2e"]["peak_rss_mb"] and h["e2e"]["peak_rss_mb"]:
            summary["rss_full_over_half"] = round(
                f["e2e"]["peak_rss_mb"] / h["e2e"]["peak_rss_mb"], 2
            )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
