"""Pipeline driver (reference src/main.rs:24-122 parity).

Loads both BAM headers as chrom lists, loads and validates the reference
FASTA, runs phase 1 (contig scan) then phase 2 (read remap), logging total
runtime.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from portello_tpu._version import PROGRAM_NAME, PROGRAM_VERSION
from portello_tpu.cli import (
    EX_DATAERR,
    Settings,
    parse_settings,
    validate_and_fix_settings,
    validate_settings_data,
)
from portello_tpu.io.fasta import get_genome_ref_from_fasta
from portello_tpu.logger import setup_logger
from portello_tpu.pipeline.contig_scan import scan_contig_bam
from portello_tpu.pipeline.read_scan import scan_and_remap_reads
from portello_tpu.utils.chrom_list import ChromList
from portello_tpu.utils.genome_segment import GenomeSegment


def get_chrom_array(ref_filename: str, ref_chrom_list: ChromList, logger) -> list[np.ndarray]:
    """Reference FASTA as an array ordered by ref chrom index, with name/length
    consistency checks (main.rs:24-62; exit DATAERR on mismatch)."""
    genome = get_genome_ref_from_fasta(ref_filename)
    out = []
    error = False
    for info in ref_chrom_list.data:
        seq = genome.chroms.pop(info.label, None)
        if seq is None:
            logger.error(
                f'Chromosome "{info.label}" specified in the assembly-to-ref '
                "alignment file, but not in the reference fasta"
            )
            error = True
        elif len(seq) != info.length:
            logger.error(
                f'Chromosome "{info.label}" specified with inconsistent length: '
                f"{info.length} in the assembly-to-ref alignment file, and "
                f"{len(seq)} in the reference fasta"
            )
            error = True
        else:
            out.append(seq)
    if error:
        logger.error("Exiting due to one or more reference consistency issues")
        sys.exit(EX_DATAERR)
    return out


def make_engine(settings: Settings, reference, contig_list, all_contig_mapping_info):
    """Select the compute path: device batch engine or host oracle (None).

    A device engine that cannot start fails the run; it is never swapped
    for the host path behind the user's back."""
    if settings.device == "host":
        return None
    from portello_tpu.backend import check_platform, configure_compile_cache

    check_platform(settings.device)
    configure_compile_cache()
    from portello_tpu.models.pipeline_model import DeviceEngine

    return DeviceEngine(
        reference,
        contig_list,
        all_contig_mapping_info,
        batch_size=settings.batch_size,
    )


def run(settings: Settings, preloaded_reference=None) -> dict | None:
    """One pipeline run; returns the native feed's stats (None on the
    Python feed or the host path)."""
    logger = setup_logger()
    cmdline = " ".join(sys.argv)
    logger.info(f"Starting {PROGRAM_NAME} {PROGRAM_VERSION}")
    logger.info(f"cmdline: {cmdline}")
    logger.info(f"Running on {settings.thread_count} threads")
    start = time.monotonic()

    if settings.device != "host":
        # the platform choice is pinned before anything starts a backend
        from portello_tpu.backend import set_platform

        set_platform(settings.device)
    if settings.num_hosts > 1 and settings.coordinator:
        # jax.distributed.initialize must precede ANY backend touch (even
        # jax.devices), so the DCN handshake happens before phase 1 / the
        # engine build
        from portello_tpu.parallel.distributed import init_distributed

        init_distributed(
            settings.coordinator, settings.num_hosts, settings.host_id
        )

    ref_chrom_list = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
    assembly_contig_list = ChromList.from_bam_filename(settings.read_to_assembly_bam)

    target_region = None
    if settings.target_region is not None:
        target_region = GenomeSegment.from_region_str(
            ref_chrom_list, settings.target_region
        )

    # forked workers inherit the parent's parsed FASTA copy-on-write
    reference = (
        preloaded_reference
        if preloaded_reference is not None
        else get_chrom_array(settings.ref_filename, ref_chrom_list, logger)
    )

    from portello_tpu.pipeline.contig_scan import (
        load_contig_index,
        save_contig_index,
    )

    if settings.contig_index and os.path.exists(settings.contig_index):
        all_contig_mapping_info = load_contig_index(
            settings.contig_index, ref_chrom_list, assembly_contig_list,
            target_region, settings.max_join_gap,
        )
        logger.info(f"Loaded contig mapping index from {settings.contig_index}")
    else:
        all_contig_mapping_info = scan_contig_bam(
            settings.assembly_to_ref_bam,
            ref_chrom_list,
            assembly_contig_list,
            target_region,
            max_join_gap=settings.max_join_gap,
            reference_seqs=reference,
            thread_count=settings.thread_count,
        )
        if settings.contig_index:
            save_contig_index(
                settings.contig_index, all_contig_mapping_info,
                ref_chrom_list, assembly_contig_list, target_region,
                settings.max_join_gap,
            )
            logger.info(f"Saved contig mapping index to {settings.contig_index}")

    engine = make_engine(
        settings, reference, assembly_contig_list, all_contig_mapping_info
    )

    shard_plan = None
    remapped_out = settings.remapped_read_output
    unassembled_out = settings.unassembled_read_output
    if settings.num_hosts > 1:
        from portello_tpu.parallel.distributed import (
            plan_host_shards,
            shard_output_path,
        )

        shard_plan = plan_host_shards(
            [c.length for c in assembly_contig_list.data],
            settings.num_hosts,
            settings.host_id,
        )
        remapped_out = shard_output_path(
            remapped_out, settings.host_id, settings.num_hosts
        )
        unassembled_out = shard_output_path(
            unassembled_out, settings.host_id, settings.num_hosts
        )
        logger.info(
            f"Host {settings.host_id}/{settings.num_hosts} owns "
            f"{len(shard_plan.contig_indices)} contigs; output shard: "
            f"{remapped_out}"
        )

    from portello_tpu.io.aln_input import is_cram_file

    use_native_feed = False
    if engine is not None and settings.feed in ("auto", "native"):
        from portello_tpu.pipeline.native_feed import get_lib as _feed_lib

        if _feed_lib() is not None:
            use_native_feed = True
        elif settings.feed == "native":
            raise SystemExit("--feed native requested but ptscan unavailable")

    # CRAM input streams directly into the native scanner: a feeder thread
    # decodes records and pushes uncompressed BAM bytes through a bounded
    # in-memory queue (no temp-BAM transcode; the reference streams CRAM
    # through htslib, cli.rs:25,32 / read_alignment_scanner.rs:382-394).
    # The reference dict is keyed by NAME (CramReader validates name+length;
    # a read-to-assembly CRAM's tids are assembly contigs, so RR=1 slices
    # error clearly instead of decoding the wrong sequence).
    scan_input = settings.read_to_assembly_bam
    cram_reference = None
    if use_native_feed and is_cram_file(scan_input):
        cram_reference = {
            c.label: seq for c, seq in zip(ref_chrom_list.data, reference)
        }

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if settings.profile:
        # Structured device tracing for phase 2 (SURVEY.md section 5: the
        # reference has only ad-hoc eprintln probes; here: a real profiler).
        import jax

        os.makedirs(settings.profile, exist_ok=True)
        os.environ["PTPU_FEED_TIMING"] = "1"
        profile_ctx = contextlib.ExitStack()
        try:
            jax.profiler.start_trace(settings.profile)
            profile_ctx.callback(jax.profiler.stop_trace)
            logger.info(f"Writing device profile trace to {settings.profile}")
        except Exception as e:  # profiling is best-effort
            logger.warning(f"profiler unavailable: {e}")

    stats = None
    with profile_ctx:
        if use_native_feed:
            from portello_tpu.pipeline.native_feed import (
                scan_and_remap_reads_native,
            )

            stats = scan_and_remap_reads_native(
                scan_input,
                remapped_out,
                unassembled_out,
                reference,
                ref_chrom_list,
                all_contig_mapping_info,
                target_region is not None,
                cmdline=cmdline,
                batch_size=settings.batch_size,
                thread_count=settings.thread_count,
                shard_plan=shard_plan,
                cram_reference=cram_reference,
            )
        else:
            scan_and_remap_reads(
                settings.read_to_assembly_bam,
                remapped_out,
                unassembled_out,
                reference,
                ref_chrom_list,
                all_contig_mapping_info,
                target_region is not None,
                cmdline=cmdline,
                engine=engine,
                thread_count=settings.thread_count,
                shard_plan=shard_plan,
            )

    elapsed = time.monotonic() - start
    hh = int(elapsed // 3600)
    mm = int(elapsed % 3600 // 60)
    ss = elapsed % 60
    logger.info(
        f"{PROGRAM_NAME} completed. Total Runtime: {hh:02d}:{mm:02d}:{ss:06.3f}"
    )
    return stats


def _fork_workers(
    settings: Settings, n: int, logger, cards: list[str] | None
) -> list[int] | None:
    """Fork-based phase-2 fan-out: the parent preloads the heavyweight
    shared state ONCE — the package imports (jax included: importing
    starts no backend; each child initializes its own after the fork), the
    native libraries and the parsed reference FASTA — then forks, so every
    worker inherits it copy-on-write instead of replaying ~3-4 s of fixed
    startup cost.  ``cards``: the CUDA device each worker is pinned to (one
    card per worker process), or None off the GPU.
    PTPU_FORK_WORKERS=0 restores subprocess workers.  Returns the failed
    worker ids, or None when forking is unsafe (a live XLA backend in this
    process would not survive the fork — the caller falls back to
    subprocess workers)."""
    import dataclasses
    import traceback

    # warm the modules the workers need; no backend/device touch before the
    # fork (XLA runtime threads would not survive it)
    import jax  # noqa: F401

    if settings.device != "host":
        try:  # internal, so best-effort: treat lookup failure as "live"
            from jax._src import xla_bridge as _xb

            backend_live = bool(getattr(_xb, "_backends", True))
        except Exception:  # pragma: no cover - jax internals moved
            backend_live = True
        if backend_live:
            logger.info(
                "XLA backend already initialized in this process; using "
                "subprocess workers"
            )
            return None

    import portello_tpu.models.pipeline_model  # noqa: F401
    from portello_tpu.io import native_codec
    from portello_tpu.ops import native_core
    from portello_tpu.pipeline import native_feed

    # build the native libraries here, not in N racing children
    for lib in (native_feed, native_codec, native_core):
        lib.get_lib()

    ref_cl = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
    reference = get_chrom_array(settings.ref_filename, ref_cl, logger)

    pids = []
    for w in range(n):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                if cards is not None:
                    os.environ["CUDA_VISIBLE_DEVICES"] = cards[w]
                child = dataclasses.replace(
                    settings, local_workers=1, num_hosts=n, host_id=w
                )
                run(child, preloaded_reference=reference)
                code = 0
            except SystemExit as e:
                if isinstance(e.code, int):
                    code = e.code
                elif e.code:
                    print(e.code, file=sys.stderr)
            except BaseException:
                traceback.print_exc()
            finally:
                os._exit(code)
        pids.append(pid)
    failed = []
    for w, pid in enumerate(pids):
        _, status = os.waitpid(pid, 0)
        if os.waitstatus_to_exitcode(status) != 0:
            failed.append(w)
    return failed


def _worker_cards(device: str, n: int) -> list[str] | None:
    """The CUDA device of each worker when the workers run on GPUs (always
    for --device gpu; for auto when this host has GPUs), else None."""
    if device not in ("gpu", "auto"):
        return None
    from portello_tpu.backend import assign_worker_gpus, visible_gpus

    gpus = visible_gpus()
    if device == "auto" and not gpus:
        return None
    return assign_worker_gpus(n, gpus)


def run_local_workers(settings: Settings, argv: list[str]) -> None:
    """Fan phase 2 out over N worker processes on this machine.

    Each worker is a full pipeline run over a contig shard (the process-level
    analogue of the reference's rayon fan-out, SURVEY.md section 2d); shards
    are merged into the final outputs afterwards.
    """
    import subprocess

    from portello_tpu.parallel.distributed import shard_output_path
    from portello_tpu.tools.merge import merge_bams

    logger = setup_logger()
    n = settings.local_workers
    if settings.remapped_read_output == "-":
        raise SystemExit("--local-workers does not support stdout output")
    base_args = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--local-workers":
            skip = True
            continue
        if a.startswith("--local-workers="):
            continue
        base_args.append(a)

    # Do the shared one-time work ONCE in the parent instead of N times in
    # the workers: the phase-1 contig scan (measured fan-out overhead) and,
    # for CRAM read input, the temp-BAM transcode.  Temps live until the
    # single try/finally below releases them.
    import tempfile

    from portello_tpu.io.aln_input import is_cram_file
    from portello_tpu.utils.genome_segment import GenomeSegment

    temps: list[str] = []
    try:
        prescan = settings.contig_index is None or not os.path.exists(
            settings.contig_index
        )
        if prescan:
            from portello_tpu.pipeline.contig_scan import save_contig_index

            ref_cl = ChromList.from_bam_filename(settings.assembly_to_ref_bam)
            asm_cl = ChromList.from_bam_filename(settings.read_to_assembly_bam)
            region = (
                None if settings.target_region is None
                else GenomeSegment.from_region_str(ref_cl, settings.target_region)
            )
            # phase 1 needs sequences only to decode a CRAM contig input
            ref_seqs = (
                get_chrom_array(settings.ref_filename, ref_cl, logger)
                if is_cram_file(settings.assembly_to_ref_bam)
                else None
            )
            info = scan_contig_bam(
                settings.assembly_to_ref_bam, ref_cl, asm_cl, region,
                max_join_gap=settings.max_join_gap, reference_seqs=ref_seqs,
                thread_count=settings.thread_count,
            )
            if settings.contig_index is not None:
                # user asked for the cache at this path: build it here so the
                # workers all LOAD it (never racing to write it)
                index_path = settings.contig_index
            else:
                fd, index_path = tempfile.mkstemp(
                    suffix=".ptidx", prefix="ptpu_cidx_"
                )
                os.close(fd)
                temps.append(index_path)
                base_args += ["--contig-index", index_path]
                import dataclasses

                settings = dataclasses.replace(
                    settings, contig_index=index_path
                )
            save_contig_index(
                index_path, info, ref_cl, asm_cl, region, settings.max_join_gap
            )
            logger.info("Scanned contig alignments once; index cached for workers")

        # CRAM read input needs NO transcode: each worker's feed serves only
        # its owned contig shard by .crai slice seek (push-mode CRAM feeder /
        # python-feed fetch plan), so the workers collectively decode each
        # container at most once — the reference streams reads through
        # htslib region fetches regardless of container format
        # (read_alignment_scanner.rs:382-394)
        logger.info(f"Running phase 2 across {n} local worker processes")
        cards = _worker_cards(settings.device, n)
        if cards is not None:
            logger.info(f"Worker GPUs (CUDA_VISIBLE_DEVICES): {cards}")
        use_fork = hasattr(os, "fork") and (
            os.environ.get("PTPU_FORK_WORKERS", "1") != "0"
        )
        failed = (
            _fork_workers(settings, n, logger, cards) if use_fork else None
        )
        if failed is None:
            procs = []
            for w in range(n):
                cmd = [
                    sys.executable, "-m", "portello_tpu.main", *base_args,
                    "--num-hosts", str(n), "--host-id", str(w),
                ]
                env = None
                if cards is not None:
                    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards[w])
                procs.append(subprocess.Popen(cmd, env=env))
            failed = [w for w, p in enumerate(procs) if p.wait() != 0]
        if failed:
            raise SystemExit(f"worker processes failed: {failed}")

        for output in (
            settings.remapped_read_output, settings.unassembled_read_output
        ):
            shards = [shard_output_path(output, w, n) for w in range(n)]
            merge_bams(
                output, shards, n_threads=max(1, settings.thread_count // 2)
            )
            for s in shards:
                os.remove(s)
        logger.info(f"Merged {n} worker shards")
    finally:
        for t in temps:
            if os.path.exists(t):
                os.remove(t)


def main(argv=None) -> dict | None:
    """The CLI.  Returns the native feed's stats of a single-process run."""
    settings = parse_settings(argv)
    settings = validate_and_fix_settings(settings)
    setup_logger()
    try:
        validate_settings_data(settings)
        if settings.local_workers > 1:
            run_local_workers(settings, list(argv if argv is not None else sys.argv[1:]))
            return None
        return run(settings)
    except Exception as err:
        print(err, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
