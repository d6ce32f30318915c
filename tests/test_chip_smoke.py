"""chip_smoke.py's helpers at tiny scale: the seeded whole-genome scenario
generator, the sorted-record comparison, and the result line's format.  The
GPU run itself is made on a GPU host (``python chip_smoke.py``)."""

import json
import os
import sys

import numpy as np
import pytest

from portello_tpu.io.bam import BamReader
from portello_tpu.testutil.wgs import GRCH38_CHROMS, WgsParams, build_wgs_scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(n_reads=120, chrom_scale=0.001, contig_min=12_000,
            contig_max=30_000, read_median=3_000, read_min=1_000,
            read_max=8_000)


def _bytes(scn):
    out = []
    for path in (scn.ref_fasta, scn.contig_bam, scn.read_bam):
        with open(path, "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("wgs")
    return build_wgs_scenario(str(root), WgsParams(seed=7, **TINY))


def test_scenario_is_determined_by_seed(tiny, tmp_path):
    again = build_wgs_scenario(str(tmp_path / "a"), WgsParams(seed=7, **TINY))
    other = build_wgs_scenario(str(tmp_path / "b"), WgsParams(seed=8, **TINY))
    assert _bytes(again) == _bytes(tiny)
    assert _bytes(other)[2] != _bytes(tiny)[2]


def test_scenario_cache_is_keyed_by_params(tiny, tmp_path):
    root = os.path.dirname(tiny.root)
    same = build_wgs_scenario(root, WgsParams(seed=7, **TINY))
    assert same.root == tiny.root
    assert WgsParams(seed=7, **TINY).key() != WgsParams(seed=8, **TINY).key()


def test_scenario_shape(tiny):
    with BamReader(tiny.contig_bam) as r:
        names = [n for n, _ in r.header.refs]
        contigs = list(r)
    assert names == [n for n, _ in GRCH38_CHROMS]
    assert all(c.tid == names.index("chr20") for c in contigs)
    # forward, reverse, ref-split and inverted-split contigs
    assert any(c.is_reverse() and not c.is_supplementary() for c in contigs)
    supp = [c for c in contigs if c.is_supplementary()]
    assert any(c.is_reverse() for c in supp)
    assert any(not c.is_reverse() for c in supp)
    assert all(c.get_string_tag(b"SA") for c in supp)
    with BamReader(tiny.read_bam) as r:
        reads = list(r)
    unmapped = [x for x in reads if x.is_unmapped()]
    primary = [x for x in reads
               if not x.is_unmapped() and not x.is_supplementary()]
    assert len(unmapped) == tiny.n_unmapped >= 1
    assert len(primary) == tiny.n_primary
    assert {x.is_reverse() for x in primary} == {True, False}
    lens = np.array([len(x.seq) for x in primary])
    assert lens.min() >= TINY["read_min"] - 10
    assert lens.max() <= TINY["read_max"] + 200


def test_scenario_split_reads_carry_sa(tmp_path):
    scn = build_wgs_scenario(
        str(tmp_path), WgsParams(seed=3, **{**TINY, "n_reads": 300})
    )
    with BamReader(scn.read_bam) as r:
        reads = list(r)
    supp = [x for x in reads if x.is_supplementary()]
    assert supp
    qnames = {x.qname for x in supp}
    prim = [x for x in reads if x.qname in qnames
            and not x.is_supplementary()]
    assert len(prim) == len(supp)
    assert all(x.get_string_tag(b"SA") for x in prim + supp)


def test_compare_records():
    chip_smoke.compare_records("same", ["a", "b"], ["a", "b"])
    with pytest.raises(AssertionError, match="sorted record 1 differs"):
        chip_smoke.compare_records("x", ["a", "c"], ["a", "b"])
    with pytest.raises(AssertionError, match="1 records, the oracle has 2"):
        chip_smoke.compare_records("x", ["a"], ["a", "b"])


def test_sorted_records_and_oracle_run(tiny, tmp_path):
    runner = chip_smoke.Runner(tiny, str(tmp_path / "out"))
    wall, stats, records = runner.run("oracle", "--device", "host")
    assert stats is None and wall > 0
    assert records[0] == sorted(records[0]) and records[0]
    assert len(records[1]) == tiny.n_unmapped
    runner.oracle = records
    runner.check("self", records)
    _, stats, native = runner.run(
        "native", "--device", "cpu", "--feed", "native", "--batch-size", "32"
    )
    runner.check("native", native)
    assert stats["device_items"] > 0


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


def test_chip_smoke_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
