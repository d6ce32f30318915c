#!/usr/bin/env python3
"""Smoke test of the liftover pipeline on an NVIDIA GPU, through the CLI.

    python chip_smoke.py [--seed N] [--reads N]     # one GPU
    python chip_smoke.py --four-gpus [--reads N]    # the multi-card paths only

Default phases, run one after another in this one process:

  a. scenario  a whole-genome-shaped input set made from ``--seed``
               (testutil/wgs.py: the 24 GRCh38 chromosomes, about 3.1 Gbp;
               two haplotypes of 1-5 Mbp contigs tiling chr20; 20,000 HiFi
               reads), cached under .bench_cache/
  b. oracle    ``--device host`` over the scenario; its sorted records
  c. GPU legs  ``--device gpu --feed native`` once per formulation (table
               slots with gathers, table slots with matmuls, resident
               reference with matmuls), cold and warm; every run's sorted
               records must equal the oracle's
  d. kernels   fwd_batch (both formulations), fwd_batch_resident and
               cleanup_and_compress against the exact host ops, item by
               item, at the production bucket widths with batch 512;
               expand_sum and the one-hot gather at K=1024
  e. card      ``nvidia-smi`` name and power limit

``--four-gpus`` runs only the multi-card phase: ``--local-workers 4`` (one
card per worker process) and the batch-sharded dispatch over four local
cards, each against the oracle.

Every result goes to stdout as a JSON line; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU the script exits non-zero
before any work and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache")

# (leg name, PTPU_MM, PTPU_RESIDENT)
LEGS = (
    ("table-gather", "0", "0"),
    ("table-mm", "1", "0"),
    ("resident-mm", "1", "1"),
)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_identity() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def result_line(devices) -> str:
    first = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": first.platform, "kind": first.device_kind,
        "count": len(devices),
    }})


def sorted_records(path: str) -> list[str]:
    """The records of a BAM as sorted SAM lines (the output contract is
    unsorted, so runs are compared as sorted record lists)."""
    from portello_tpu.io.bam import BamReader

    with BamReader(path) as r:
        return sorted(rec.to_sam(r.header) for rec in r)


def compare_records(name: str, got: list[str], want: list[str]) -> None:
    if got == want:
        return
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            raise AssertionError(
                f"{name}: sorted record {i} differs from the oracle:\n"
                f"  got  {g[:300]}\n  want {w[:300]}"
            )
    raise AssertionError(
        f"{name}: {len(got)} records, the oracle has {len(want)}"
    )


class Runner:
    """Runs the CLI in this process over one scenario and compares each
    run's outputs with the oracle's."""

    def __init__(self, scenario, out_root: str):
        self.scn = scenario
        self.out_root = out_root
        self.oracle = None
        os.makedirs(out_root, exist_ok=True)

    def run(self, tag: str, *extra: str):
        from portello_tpu.main import main as cli_main

        out = os.path.join(self.out_root, tag)
        os.makedirs(out, exist_ok=True)
        remapped = os.path.join(out, "remapped.bam")
        unassembled = os.path.join(out, "unassembled.bam")
        argv = [
            "--assembly-to-ref", self.scn.contig_bam,
            "--read-to-assembly", self.scn.read_bam,
            "--ref", self.scn.ref_fasta,
            "--remapped-read-output", remapped,
            "--unassembled-read-output", unassembled,
            *extra,
        ]
        t0 = time.perf_counter()
        try:
            stats = cli_main(argv)
        except SystemExit as e:
            raise RuntimeError(f"CLI run {tag} exited with {e.code}") from None
        wall = time.perf_counter() - t0
        records = (sorted_records(remapped), sorted_records(unassembled))
        shutil.rmtree(out)
        return wall, stats, records

    def check(self, tag: str, records) -> None:
        compare_records(f"{tag} remapped", records[0], self.oracle[0])
        compare_records(f"{tag} unassembled", records[1], self.oracle[1])


def phase_scenario(args):
    from portello_tpu.testutil.wgs import WgsParams, build_wgs_scenario

    t0 = time.perf_counter()
    params = WgsParams(seed=args.seed, n_reads=args.reads)
    scn = build_wgs_scenario(CACHE, params)
    emit(phase="scenario", seconds=time.perf_counter() - t0,
         genome_bp=scn.genome_bp, n_primary=scn.n_primary,
         n_unmapped=scn.n_unmapped, dir=os.path.relpath(scn.root, HERE))
    return scn


def phase_oracle(runner: Runner) -> None:
    wall, _, records = runner.run("oracle", "--device", "host")
    runner.oracle = records
    emit(phase="oracle", seconds=wall, remapped_records=len(records[0]),
         unassembled_records=len(records[1]))
    if not records[0]:
        raise AssertionError("the oracle lifted no records")


def _leg_fields(stats: dict) -> dict:
    """The feed's timing split and routing counts of one run."""
    fields = {
        "device_s": stats["t_dev"],
        "prep_wait_s": stats["t_prep"],
        "finish_s": stats["t_post"],
        "n_primary": stats["n_primary"],
        "device_items": stats["device_items"],
        "host_items": stats["host_items"],
        "host_fallbacks": stats["fallback_items"],
        "bytes_in_use": stats["device_bytes_in_use"],
    }
    fields.update({k: v for k, v in stats.items() if k.startswith("t_native_")})
    return fields


def phase_gpu_legs(runner: Runner) -> None:
    saved = {k: os.environ.get(k)
             for k in ("PTPU_MM", "PTPU_RESIDENT", "PTPU_FEED_TIMING")}
    os.environ["PTPU_FEED_TIMING"] = "1"
    try:
        for name, mm, resident in LEGS:
            os.environ["PTPU_MM"] = mm
            os.environ["PTPU_RESIDENT"] = resident
            cold, _, records = runner.run(
                f"{name}-cold", "--device", "gpu", "--feed", "native"
            )
            runner.check(f"{name} cold", records)
            warm, stats, records = runner.run(
                f"{name}-warm", "--device", "gpu", "--feed", "native"
            )
            runner.check(f"{name} warm", records)
            emit(phase="gpu_leg", leg=name, wall_cold_s=cold,
                 wall_warm_s=warm,
                 reads_per_s_warm=stats["n_primary"] / warm,
                 **_leg_fields(stats), equals_oracle=True)
            in_use = stats["device_bytes_in_use"]
            if resident == "1" and in_use < runner.scn.genome_bp:
                raise AssertionError(
                    "resident leg: the genome table is not on the card "
                    f"({in_use} bytes in use)"
                )
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_kernels(batch: int, seed: int) -> None:
    import numpy as np

    from portello_tpu.models.pipeline_model import DEFAULT_BUCKETS
    from portello_tpu.testutil import kernel_checks as kc

    rng = np.random.default_rng(seed)
    for bi, bcfg in enumerate(DEFAULT_BUCKETS):
        t0 = time.perf_counter()
        items = kc.make_items(rng, bcfg, batch, *kc.PRODUCTION_PROFILES[bi])
        table, res, words = kc.resident_args(items)
        oracle = kc.oracle_fwd(table)
        for mm in (False, True):
            counts = kc.check_fwd_batch(table, bcfg, mm, oracle)
            emit(phase="kernel", graph="fwd_batch", mm=mm, bucket=bi,
                 max_ops=bcfg.max_ops, max_seq=bcfg.max_seq, **counts)
        counts = kc.check_fwd_batch_resident(res, words, bcfg, oracle)
        emit(phase="kernel", graph="fwd_batch_resident", mm=True, bucket=bi,
             max_ops=bcfg.max_ops, max_seq=bcfg.max_seq, **counts)
        width = kc.emission_width(bcfg)
        for mm in (False, True):
            counts = kc.check_cleanup_and_compress(
                rng, width, bcfg.resolved_max_out(), mm, batch
            )
            emit(phase="kernel", graph="cleanup_and_compress", mm=mm,
                 bucket=bi, **counts)
        emit(phase="kernel_bucket", bucket=bi,
             seconds=time.perf_counter() - t0)
    emit(phase="kernel", graph="expand_sum+gather_rows",
         **kc.check_expand(1024, batch))


def gpu_devices():
    """The GPU devices JAX sees; exits non-zero when there are none."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: JAX found no accelerator: {e}")
    if devices[0].platform != "gpu":
        sys.exit(
            f"chip_smoke: JAX found no GPU (platform {devices[0].platform})"
        )
    return devices


def main_one_gpu(args) -> None:
    devices = gpu_devices()
    runner = None
    try:
        scn = phase_scenario(args)
        runner = Runner(scn, os.path.join(CACHE, "chip_smoke_out"))
        phase_oracle(runner)
        phase_gpu_legs(runner)
        t0 = time.perf_counter()
        phase_kernels(512, args.seed)
        emit(phase="kernels", seconds=time.perf_counter() - t0)
    finally:
        if runner is not None:
            shutil.rmtree(runner.out_root, ignore_errors=True)
    for line in card_identity():
        print(line)
    print(result_line(devices))


def main_four_gpus(args) -> None:
    from portello_tpu.backend import visible_gpus

    # the local-workers leg runs before this process starts a backend, so
    # the four cards are checked without JAX first
    if len(visible_gpus()) < 4:
        sys.exit("chip_smoke --four-gpus: needs four visible GPUs")
    runner = None
    try:
        scn = phase_scenario(args)
        runner = Runner(scn, os.path.join(CACHE, "chip_smoke_out"))
        phase_oracle(runner)
        wall, _, records = runner.run(
            "workers4", "--device", "gpu", "--feed", "native",
            "--local-workers", "4",
        )
        runner.check("local-workers 4", records)
        emit(phase="four_gpus", leg="local-workers-4", wall_s=wall,
             equals_oracle=True)
        devices = gpu_devices()
        if len(devices) != 4:
            sys.exit(f"chip_smoke --four-gpus: JAX sees {len(devices)} GPUs")
        cold, _, records = runner.run(
            "sharded-cold", "--device", "gpu", "--feed", "native"
        )
        runner.check("sharded cold", records)
        warm, stats, records = runner.run(
            "sharded-warm", "--device", "gpu", "--feed", "native"
        )
        runner.check("sharded warm", records)
        emit(phase="four_gpus", leg="sharded-4", wall_cold_s=cold,
             wall_warm_s=warm, **_leg_fields(stats), equals_oracle=True)
    finally:
        if runner is not None:
            shutil.rmtree(runner.out_root, ignore_errors=True)
    for line in card_identity():
        print(line)
    print(result_line(devices))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reads", type=int, default=20_000,
                   help="reads in the scenario (default 20000)")
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-card phase")
    args = p.parse_args(argv)
    if args.four_gpus:
        main_four_gpus(args)
    else:
        main_one_gpu(args)


if __name__ == "__main__":
    main()
