"""Native phase-2 feed: the C++ read scanner (ptscan.cc) driving the JAX
device engine.

The reference devotes all CPU cores to record decode + split parsing + record
re-encode (reference src/read_alignment_scanner.rs:495-535); round 1 ran this
path in Python at ~1k reads/s, starving the chip.  Here the whole per-record
runtime — BGZF decode, field/SA parsing, work-item prep, result finishing,
primary selection, SA regeneration, BAM encode + write — runs natively, and
Python only moves padded batches through the jitted kernels:

    while ptscan_next_batch(h, desc):    # C++ scans + preps one full batch
        out = fwd_batch/rev_batch(desc)  # device round trip (fixed shapes)
        ptscan_post_results(h, out)      # C++ finishes + writes ready reads

The C++ side runs the whole scan loop on a dedicated producer thread and
publishes dispatch-ready slots (fixed ``batch_size``-row arenas, EOF
partials pre-padded), so ``ptscan_next_batch`` just pops a ready batch:
host prep overlaps device compute with no Python-side copies — the feed
wraps each slot zero-copy and the slot stays frozen until its results are
posted.  Each bucket compiles exactly two programs (fwd/rev) for the whole
run.  Output is record-identical to the Python engine path
(tests/test_native_feed.py compares CLI outputs byte-for-byte after
sorting).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

from portello_tpu.pipeline.read_scan import get_alignment_file_header

logger = logging.getLogger("portello-tpu")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "io", "native", "ptscan.cc")
_SO = os.path.join(_HERE, "..", "io", "native", "_build", "ptscan.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None
_last_stats: dict = {}


class _BatchDesc(ctypes.Structure):
    _fields_ = [
        ("bucket", ctypes.c_longlong),
        ("is_rev", ctypes.c_longlong),
        ("count", ctypes.c_longlong),
        ("ops", ctypes.POINTER(ctypes.c_int32)),
        ("lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_ops", ctypes.POINTER(ctypes.c_int32)),
        ("pos", ctypes.POINTER(ctypes.c_int32)),
        ("bk", ctypes.POINTER(ctypes.c_int32)),
        ("bv", ctypes.POINTER(ctypes.c_int32)),
        ("nb", ctypes.POINTER(ctypes.c_int32)),
        ("ref_win", ctypes.POINTER(ctypes.c_uint8)),
        ("ref_base", ctypes.POINTER(ctypes.c_int32)),
        ("read_seq", ctypes.POINTER(ctypes.c_uint8)),
        ("contig_win", ctypes.POINTER(ctypes.c_uint8)),
        ("win_base", ctypes.POINTER(ctypes.c_int32)),
        # resident slot mode only (null otherwise)
        ("read_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("ref_chrom", ctypes.POINTER(ctypes.c_int32)),
    ]


class _P1Out(ctypes.Structure):
    """Flattened phase-1 walk results (ptscan.cc PtscanP1Out)."""

    _fields_ = [
        ("n_rec", ctypes.c_longlong),
        ("rec", ctypes.POINTER(ctypes.c_int64)),
        ("n_seg", ctypes.c_longlong),
        ("seg", ctypes.POINTER(ctypes.c_int64)),
        ("cig", ctypes.POINTER(ctypes.c_int64)),
        ("n_cig", ctypes.c_longlong),
        ("bmk", ctypes.POINTER(ctypes.c_int64)),
        ("bmv", ctypes.POINTER(ctypes.c_int64)),
        ("n_bm", ctypes.c_longlong),
        ("rev", ctypes.POINTER(ctypes.c_uint8)),
        ("n_rev", ctypes.c_longlong),
        ("qname", ctypes.POINTER(ctypes.c_uint8)),
        ("n_qname", ctypes.c_longlong),
    ]


def i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _build() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # compile into a per-pid temp and publish atomically: concurrent
    # processes racing on a stale .so must never dlopen a half-written
    # library (os.replace is atomic on POSIX)
    tmp_so = f"{_SO}.tmp{os.getpid()}"
    base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp_so]
    # libdeflate (the codec htslib links for BGZF) when present; zlib-only
    # fallback otherwise
    proc = subprocess.run(
        base + ["-lz", "-ldeflate", "-lpthread"], capture_output=True, text=True
    )
    if proc.returncode != 0:
        proc = subprocess.run(
            base + ["-DPTIO_NO_LIBDEFLATE", "-lz", "-lpthread"],
            capture_output=True, text=True,
        )
    if proc.returncode != 0:
        if os.path.exists(tmp_so):
            os.remove(tmp_so)
        return proc.stderr[-2000:]
    os.replace(tmp_so, _SO)
    return None


def bind_lib(so_path: str):
    """Load a prebuilt ptscan shared object and set its prototypes (no
    rebuild — e.g. a sanitizer-instrumented build; scripts/tsan_native.py)."""
    lib = ctypes.CDLL(so_path)
    lib.ptscan_create.restype = ctypes.c_void_p
    lib.ptscan_next_batch.restype = ctypes.c_int
    lib.ptscan_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BatchDesc)]
    lib.ptscan_post_results.restype = ctypes.c_int
    lib.ptscan_error.restype = ctypes.c_char_p
    lib.ptscan_error.argtypes = [ctypes.c_void_p]
    lib.ptscan_finish.restype = ctypes.c_int
    lib.ptscan_finish.argtypes = [ctypes.c_void_p]
    lib.ptscan_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.ptscan_destroy.argtypes = [ctypes.c_void_p]
    # push-mode reader (direct CRAM streaming)
    lib.ptio_reader_open_push.restype = ctypes.c_void_p
    lib.ptio_reader_open_push.argtypes = [ctypes.c_longlong]
    lib.ptio_reader_push.restype = ctypes.c_int
    lib.ptio_reader_push.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong
    ]
    lib.ptio_reader_push_eof.argtypes = [ctypes.c_void_p]
    lib.ptio_reader_push_close.argtypes = [ctypes.c_void_p]
    lib.ptio_reader_close.argtypes = [ctypes.c_void_p]
    # phase-1 per-record walk (contig_scan native path)
    lib.ptscan_p1_create.restype = ctypes.c_void_p
    lib.ptscan_p1_create.argtypes = [
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.ptscan_p1_process.restype = ctypes.c_int
    lib.ptscan_p1_process.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
    ]
    lib.ptscan_p1_results.argtypes = [ctypes.c_void_p, ctypes.POINTER(_P1Out)]
    lib.ptscan_p1_error.restype = ctypes.c_char_p
    lib.ptscan_p1_error.argtypes = [ctypes.c_void_p]
    lib.ptscan_p1_destroy.argtypes = [ctypes.c_void_p]
    # seq nibble codec debug surface (tests/test_simd_codecs.py)
    lib.ptscan_dbg_seqcodec.restype = None
    lib.ptscan_dbg_seqcodec.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
        np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS"),
    ]
    return lib


def get_lib():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        # sanitizer runs: bind a prebuilt instrumented library for the WHOLE
        # process (incl. pytest), bypassing the staleness rebuild that would
        # silently swap in an uninstrumented build
        override = os.environ.get("PTPU_PTSCAN_SO")
        if override:
            _lib = bind_lib(override)
            return _lib
        deps = [_SRC,
                os.path.join(os.path.dirname(_SRC), "ptio.cc"),
                os.path.join(os.path.dirname(_SRC), "ptcore.cc")]
        if not os.path.exists(_SO) or any(
            os.path.getmtime(d) > os.path.getmtime(_SO) for d in deps
        ):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        _lib = bind_lib(_SO)
        return _lib


def build_error() -> str | None:
    return _build_error


def _flat_index(contig_list, all_info):
    """Flatten the phase-1 contig index into the ptscan struct-of-arrays."""
    n = len(contig_list.data)
    contig_len = np.array([c.length for c in contig_list.data], np.int64)
    names = [c.label for c in contig_list.data]
    name_cat = "".join(names).encode()
    name_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in names], out=name_off[1:])

    seg_off = np.zeros(n + 1, np.int64)
    seg_chrom, seg_pos, seg_fwd, seg_mapq = [], [], [], []
    so_start, so_end = [], []
    bm_lens = []
    bm_keys_parts, bm_vals_parts = [], []
    rc_off = np.zeros(n + 1, np.int64)
    rc_parts = []
    for ci in range(n):
        info = all_info[ci]
        segs = info.ordered_contig_segment_info
        seg_off[ci + 1] = seg_off[ci] + len(segs)
        for si in segs:
            seg = si.seq_order_segment
            seg_chrom.append(seg.chrom_index)
            seg_pos.append(seg.pos)
            seg_fwd.append(1 if seg.is_fwd_strand else 0)
            seg_mapq.append(seg.mapq)
            so_start.append(seg.seq_order_read_start)
            so_end.append(seg.seq_order_read_end)
            bm = si.contig_to_ref_map
            bm_lens.append(len(bm))
            bm_keys_parts.append(np.asarray(bm.keys, np.int64))
            bm_vals_parts.append(np.asarray(bm.vals, np.int64))
        rc = info.rev_contig_seq
        rc_parts.append(
            np.asarray(rc, np.uint8) if rc is not None else np.zeros(0, np.uint8)
        )
        rc_off[ci + 1] = rc_off[ci] + len(rc_parts[-1])

    s_total = int(seg_off[-1])
    bm_off = np.zeros(s_total + 1, np.int64)
    np.cumsum(bm_lens, out=bm_off[1:])
    return {
        "n": n,
        "contig_len": contig_len,
        "name_cat": name_cat,
        "name_off": name_off,
        "seg_off": seg_off,
        "seg_chrom": np.array(seg_chrom, np.int32),
        "seg_pos": np.array(seg_pos, np.int64),
        "seg_fwd": np.array(seg_fwd, np.uint8),
        "seg_mapq": np.array(seg_mapq, np.int32),
        "so_start": np.array(so_start, np.int64),
        "so_end": np.array(so_end, np.int64),
        "bm_off": bm_off,
        "bm_keys": (
            np.concatenate(bm_keys_parts) if bm_keys_parts else np.zeros(0, np.int64)
        ),
        "bm_vals": (
            np.concatenate(bm_vals_parts) if bm_vals_parts else np.zeros(0, np.int64)
        ),
        "rc_off": rc_off,
        "rc_bytes": (
            np.concatenate(rc_parts) if rc_parts else np.zeros(0, np.uint8)
        ),
    }


def create_scanner(
    lib,
    read_bam: str,
    remapped_out: str,
    unassembled_out: str,
    header: bytes,
    reference,
    ref_chrom_list,
    contig_list,
    all_contig_mapping_info,
    buckets,
    batch_size: int,
    is_target_region: bool,
    shard_plan,
    thread_count: int,
    push_reader=None,
    resident: bool = False,
):
    """Marshal the phase-1 index + config and call ``ptscan_create``.

    The single owner of the 36-positional-argument ABI (also used by the
    jax-free TSAN harness, scripts/tsan_native.py).  Returns ``(handle,
    keepalive)`` — the C++ scanner keeps RAW POINTERS into the index and
    reference arrays, so the caller must hold ``keepalive`` (and the
    ``reference`` list) alive until ``ptscan_destroy``.

    ``resident``: emit resident-mode slots (packed read rows + ref chrom
    index; no ref_win/read_seq tables) — kernels/resident.py.  The C++ side
    additionally requires host-shift routing and silently falls back to
    table slots under PTPU_HOST_SHIFT=0; the feed mirrors that condition.
    """
    idx = _flat_index(contig_list, all_contig_mapping_info)

    ref_names = [c.label for c in ref_chrom_list.data]
    ref_name_cat = "".join(ref_names).encode()
    ref_name_off = np.zeros(len(ref_names) + 1, np.int64)
    np.cumsum([len(x) for x in ref_names], out=ref_name_off[1:])
    ref_arrays = [np.ascontiguousarray(r, dtype=np.uint8) for r in reference]
    ref_ptrs = (ctypes.c_void_p * len(ref_arrays))(
        *[r.ctypes.data_as(ctypes.c_void_p).value for r in ref_arrays]
    )
    ref_lens = np.array([len(r) for r in ref_arrays], np.int64)

    bucket_dims = np.array(
        [
            [b.max_ops, b.max_blocks, b.max_seq, b.resolved_max_rows()]
            for b in buckets
        ],
        np.int64,
    ).ravel()

    owned = None
    owned_ptr = None
    emit_unmapped = 1
    if shard_plan is not None:
        owned = np.array(
            [1 if shard_plan.owns(t) else 0 for t in range(len(contig_list.data))],
            np.uint8,
        )
        owned_ptr = owned.ctypes.data_as(ctypes.c_void_p)
        emit_unmapped = 1 if shard_plan.host_id == 0 else 0

    # Deflate is the dominant host cost at long read lengths (round-3
    # profile: ~2/3 of host feed time), so the BGZF pool gets the full
    # thread budget — the pool threads park when idle, and prep/fill are
    # bursty.  (The reference gives htslib threads/2; this is a deliberate
    # rebalance, not parity.)
    writer_threads = max(1, thread_count)
    level = 0 if remapped_out == "-" else 6


    lib.ptscan_create.argtypes = []  # bypass strict typing; pass explicit ctypes
    h = lib.ptscan_create(
        read_bam.encode(), remapped_out.encode(),
        unassembled_out.encode(),
        ctypes.cast(ctypes.c_char_p(header), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_longlong(len(header)),
        ctypes.c_int(level), ctypes.c_int(writer_threads),
        ctypes.c_longlong(idx["n"]), i64p(idx["contig_len"]),
        ctypes.c_char_p(idx["name_cat"]), i64p(idx["name_off"]),
        ctypes.c_longlong(len(ref_names)), ctypes.c_char_p(ref_name_cat),
        i64p(ref_name_off), ref_ptrs, i64p(ref_lens),
        i64p(idx["seg_off"]), i32p(idx["seg_chrom"]), i64p(idx["seg_pos"]),
        u8p(idx["seg_fwd"]), i32p(idx["seg_mapq"]), i64p(idx["so_start"]),
        i64p(idx["so_end"]), i64p(idx["bm_off"]), i64p(idx["bm_keys"]),
        i64p(idx["bm_vals"]), i64p(idx["rc_off"]), u8p(idx["rc_bytes"]),
        ctypes.c_longlong(len(buckets)), i64p(bucket_dims),
        ctypes.c_longlong(batch_size), ctypes.c_int(1 if is_target_region else 0),
        owned_ptr if owned_ptr is not None else ctypes.c_void_p(None),
        ctypes.c_int(emit_unmapped), ctypes.c_int(max(1, thread_count)),
        push_reader if push_reader is not None else ctypes.c_void_p(None),
        ctypes.c_int(1 if resident else 0),
    )
    h = ctypes.c_void_p(h)
    if not h:
        raise RuntimeError("ptscan_create failed")
    keepalive = (idx, header, ref_name_cat, ref_name_off, ref_arrays,
                 ref_ptrs, ref_lens, bucket_dims, owned)
    return h, keepalive


def _as_np(ptr, shape, dtype):
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
        shape=(int(np.prod(shape)) * np.dtype(dtype).itemsize,),
    ).view(dtype).reshape(shape)


class _FeederAborted(RuntimeError):
    """The consumer closed the push stream under the producer (the scanner
    hit its own error first; that error is the one to surface)."""


def _cram_feeder(lib, push_handle, cram_path, reference, state,
                 chunk_bytes=1 << 20, fetch_plan=None,
                 include_unmapped=True):
    """Producer thread: decode CRAM records and push uncompressed BAM bytes
    into the native scanner (direct streaming — replaces the temp-BAM
    transcode; the reference streams CRAM through htslib,
    read_alignment_scanner.rs:382-394).

    ``fetch_plan``: optional list of (tid, end) contig ranges — used for
    contig-shard (multi-process) runs, where this process lifts only reads
    whose primary alignment is on an owned contig: the feeder then serves
    those contigs by .crai slice seek (plus, when ``include_unmapped``, the
    unmapped section), touching only the indexed containers and decoding
    each shared multi-reference container at most once (fetch_many)."""
    import struct as _struct

    from portello_tpu.io.cram import CramReader

    try:
        buf = bytearray()

        def flush():
            if not buf:
                return
            data = bytes(buf)
            if lib.ptio_reader_push(push_handle, data, len(data)) != 0:
                raise _FeederAborted("push stream closed by consumer")
            buf.clear()

        with CramReader(cram_path, reference=reference) as r:
            buf += r.header.encode()
            if fetch_plan is not None:
                def _records():
                    yield from r.fetch_many(fetch_plan)
                    if include_unmapped:
                        yield from r.fetch_unmapped()

                source = _records()
            else:
                source = r
            for rec in source:
                blob = rec.encode()
                buf += _struct.pack("<i", len(blob)) + blob
                if len(buf) >= chunk_bytes:
                    flush()
            flush()
        lib.ptio_reader_push_eof(push_handle)
    except BaseException as e:  # noqa: BLE001 — surfaced by the main thread
        state["exc"] = e
        # no EOF: a clean EOF at a record boundary would silently truncate;
        # close instead so the scanner stops and the main thread re-raises
        lib.ptio_reader_push_close(push_handle)


def scan_and_remap_reads_native(
    read_to_assembly_bam: str,
    remapped_read_output: str,
    unassembled_read_output: str,
    reference,
    ref_chrom_list,
    all_contig_mapping_info,
    is_target_region: bool,
    cmdline: str = "",
    batch_size: int = 512,
    buckets=None,
    thread_count: int = 1,
    shard_plan=None,
    use_mm: bool | None = None,
    cram_reference=None,
) -> dict:
    """Native-feed phase 2; returns the stats dict.  Raises RuntimeError when
    the native library can't build.

    CRAM input streams directly: a producer thread decodes records and
    pushes uncompressed BAM bytes through a bounded in-memory queue into
    the scanner (no temp-BAM transcode).  ``cram_reference`` is the
    name-keyed reference dict for reference-based slices."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"ptscan unavailable: {build_error()}")

    import jax

    from portello_tpu.models.pipeline_model import (
        DEFAULT_BUCKETS,
        fwd_batch,
        rev_batch,
    )
    from portello_tpu.utils.chrom_list import ChromList
    from portello_tpu.utils.progress import ProgressReporter

    logger.info(
        f"Processing read-to-contig alignment file '{read_to_assembly_bam}' "
        "(native feed)"
    )
    contig_list = ChromList.from_bam_filename(read_to_assembly_bam)
    buckets = list(buckets if buckets is not None else DEFAULT_BUCKETS)
    from portello_tpu.backend import select_dispatch

    n_dev = jax.local_device_count()
    plan = select_dispatch(jax.default_backend(), n_dev)
    mm = plan.mm if use_mm is None else use_mm
    # Multi-device data parallelism: dispatch each fixed-shape batch through
    # the sharded mesh steps (1-D data mesh over the LOCAL devices).
    use_shard = plan.shard
    if use_shard and batch_size % n_dev != 0:
        if os.environ.get("PTPU_SHARD") == "1":
            raise SystemExit(
                f"PTPU_SHARD=1 requires --batch-size divisible by the "
                f"{n_dev} local devices (got {batch_size})"
            )
        logger.warning(
            f"batch size {batch_size} not divisible by {n_dev} devices; "
            "falling back to single-device dispatch"
        )
        use_shard = False
    sharded_fns: dict = {}
    mesh = None
    if use_shard:
        from portello_tpu.parallel.mesh import (
            make_mesh,
            make_sharded_fwd_step,
            make_sharded_rev_step,
        )

        # LOCAL devices only: each host feeds its own batch stream (its own
        # shard_plan contigs), so the mesh must never span processes — a
        # global mesh would make every dispatch a multi-host collective
        # program over host-local data.
        mesh = make_mesh(devices=jax.local_devices())
        logger.info(f"Sharding batches over {n_dev} local devices")

        def get_sharded(bi: int, kind: str, kw: dict):
            key = (bi, kind)
            if key not in sharded_fns:
                if kind == "rev":
                    mk = make_sharded_rev_step
                elif kind == "res":
                    from portello_tpu.parallel.mesh import (
                        make_sharded_fwd_resident_step as mk,
                    )
                else:
                    mk = make_sharded_fwd_step
                sharded_fns[key] = mk(mesh, **kw)
            return sharded_fns[key]

    # Resident slot mode (kernels/resident.py): the genome stays in device
    # memory as a superblock table and read rows transfer PACKED — the
    # fill's per-item reference memcpy + nibble decode and 3/4 of the
    # per-batch H2D disappear.  Requires host-shift routing (the selector
    # turns it off under PTPU_HOST_SHIFT=0, as the C++ gate does).
    use_resident = plan.resident
    res_words = res_goff = None
    split_global_base = None
    if use_resident:
        from portello_tpu.kernels.resident import (
            build_global_ref,
            split_global_base,
        )
        from portello_tpu.models.pipeline_model import fwd_batch_resident

        words_np, res_goff = build_global_ref(reference)
        if use_shard:
            from portello_tpu.parallel.mesh import replicated_sharding

            res_words = jax.device_put(words_np, replicated_sharding(mesh))
        else:
            res_words = jax.device_put(words_np)
        logger.info(
            f"Resident reference table: {words_np.nbytes / 2**20:.1f} MiB in "
            "device memory; packed read rows"
        )
        del words_np

    header = get_alignment_file_header(ref_chrom_list, cmdline).encode()

    from portello_tpu.io.aln_input import is_cram_file

    push_handle = None
    feeder = None
    feeder_state: dict = {}
    if is_cram_file(read_to_assembly_bam):
        import threading

        logger.info("Streaming CRAM input directly into the native scanner")
        fetch_plan = None
        include_unmapped = shard_plan is None or shard_plan.host_id == 0
        if shard_plan is not None:
            # Shard narrowing only: ownership is keyed on the PRIMARY
            # record's tid (the same test the scanner applies), so fetching
            # just the owned contigs is sound.  --target-region narrowing is
            # deliberately NOT done: a primary on a filtered-out contig can
            # carry an SA split onto a surviving one, and skipping its
            # contig would silently drop that split's lifted records (the
            # reference scans every contig, read_alignment_scanner.rs:638).
            from portello_tpu.io.crai import CraiIndex

            try:
                CraiIndex.load(read_to_assembly_bam)
            except FileNotFoundError:
                pass  # no index: feeder full-scans (CLI normally enforces)
            else:
                fetch_plan = [
                    (ci, contig_list.data[ci].length)
                    for ci in range(len(all_contig_mapping_info))
                    if shard_plan.owns(ci)
                ]
                logger.info(
                    "Serving this shard's CRAM reads by .crai slice seek "
                    f"over {len(fetch_plan)} owned contigs"
                )
        push_handle = ctypes.c_void_p(lib.ptio_reader_open_push(0))
        feeder = threading.Thread(
            target=_cram_feeder,
            args=(lib, push_handle, read_to_assembly_bam, cram_reference,
                  feeder_state),
            kwargs={"fetch_plan": fetch_plan,
                    "include_unmapped": include_unmapped},
            name="cram-feeder",
            daemon=True,
        )
        feeder.start()

    try:
        h, _keepalive = create_scanner(
            lib, read_to_assembly_bam, remapped_read_output,
            unassembled_read_output, header, reference, ref_chrom_list,
            contig_list, all_contig_mapping_info, buckets, batch_size,
            is_target_region, shard_plan, thread_count,
            push_reader=push_handle, resident=use_resident,
        )
    except BaseException:
        # create failed: the scanner did NOT take reader ownership.  The
        # unbounded join is deliberate: after push_close the feeder's next
        # push returns -1, so it can only be finishing bounded decode work —
        # and closing the reader under a live producer would be a
        # use-after-free (ptio.cc push-mode contract).
        if push_handle is not None:
            lib.ptio_reader_push_close(push_handle)
            feeder.join()
            lib.ptio_reader_close(push_handle)
            exc = feeder_state.get("exc")
            if exc is not None and not isinstance(exc, _FeederAborted):
                # the producer's own error (e.g. a CRAM decode failure that
                # truncated the header mid-push) explains the create failure
                raise exc from None
        raise

    genome_kb = sum(ci.length for ci in contig_list.data) // 1000
    cum_len = np.zeros(len(contig_list.data) + 1, np.int64)
    np.cumsum([ci.length for ci in contig_list.data], out=cum_len[1:])
    progress = ProgressReporter(
        genome_kb, "Remapped read alignments from", "assembly contig kb"
    )
    stats_buf = (ctypes.c_longlong * 6)()

    desc = _BatchDesc()
    import collections
    import time as _time

    t_prep = t_dev = t_post = 0.0
    n_batches = 0
    # Pipeline: keep up to 2 dispatched batches outstanding so the device
    # computes batch N while the C++ scanner preps batch N+1 (jax dispatch is
    # async until the outputs are materialized).  post_results resolves
    # batches in emission order (the C++ side queues them FIFO).
    in_flight: collections.deque = collections.deque()

    def dispatch(d):
        b = int(d.bucket)
        bcfg = buckets[b]
        is_rev = bool(d.is_rev)
        bs = batch_size  # fixed compiled shape; slots are always bs rows

        # ZERO-COPY views into the C++ slot arena (jax aliases aligned numpy
        # arrays on CPU).  Safe because a slot stays frozen from emit until
        # its post_results call, which runs only after this dispatch's
        # outputs are materialized (computation complete, inputs dead); pad
        # rows of EOF-partial slots are pre-padded by the C++ side.
        def grab2(ptr, cols, dtype=np.int32):
            return _as_np(ptr, (bs, cols), dtype)

        def grab1(ptr, dtype=np.int32):
            return _as_np(ptr, (bs,), dtype)

        ops = grab2(d.ops, bcfg.max_ops)
        lens = grab2(d.lens, bcfg.max_ops)
        n_ops = grab1(d.n_ops)
        pos = grab1(d.pos)
        bk = grab2(d.bk, bcfg.max_blocks)
        bv = grab2(d.bv, bcfg.max_blocks)
        nb = grab1(d.nb)
        ref_base = grab1(d.ref_base)
        kw = dict(
            max_out=bcfg.resolved_max_out(),
            max_clusters=bcfg.max_clusters,
            window=bcfg.window,
            mm=mm,
            max_rows=bcfg.resolved_max_rows(),
        )
        if use_resident and not is_rev:
            # resident slots carry packed rows + the ref chrom index; map
            # (chrom, ref_base) -> global superblock coordinates here (the
            # fancy-index makes fresh arrays — nothing aliases the slot
            # after dispatch returns)
            read_packed = grab2(
                d.read_packed, (bcfg.max_seq + 1) // 2, np.uint8
            )
            ref_chrom = grab1(d.ref_chrom)
            g_sb, g_off = split_global_base(
                res_goff[ref_chrom] + ref_base.astype(np.int64)
            )
            res_args = (
                ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
                read_packed,
            )
            rkw = {k: v for k, v in kw.items() if k != "mm"}
            if use_shard:
                return get_sharded(b, "res", rkw)(*res_args, res_words)
            return fwd_batch_resident(*res_args, res_words, **rkw)
        if use_resident:  # pragma: no cover - guarded by the C++ gate
            raise RuntimeError(
                "resident slot mode emitted a device-shift rev batch"
            )
        ref_win = grab2(d.ref_win, bcfg.max_seq, np.uint8)
        read_seq = grab2(d.read_seq, bcfg.max_seq, np.uint8)
        if is_rev:
            contig_win = grab2(d.contig_win, bcfg.max_seq, np.uint8)
            win_base = grab1(d.win_base)
            rev_args = (
                ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
                ref_win, ref_base, read_seq,
            )
            if use_shard:
                return get_sharded(b, "rev", kw)(*rev_args)
            return rev_batch(*rev_args, **kw)
        fwd_args = (
            ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq
        )
        if use_shard:
            return get_sharded(b, "fwd", kw)(*fwd_args)
        return fwd_batch(*fwd_args, **kw)

    def post(out):
        nonlocal t_dev, t_post
        _t0 = _time.perf_counter()
        codes = np.ascontiguousarray(np.asarray(out["codes"], np.int32))
        olens = np.ascontiguousarray(np.asarray(out["lens"], np.int32))
        n_out = np.ascontiguousarray(np.asarray(out["n_out"], np.int32))
        opos = np.ascontiguousarray(np.asarray(out["ref2_pos"], np.int32))
        mapped = np.ascontiguousarray(
            np.asarray(out["mapped"], bool).astype(np.uint8)
        )
        fallback = np.ascontiguousarray(
            np.asarray(out["fallback"], bool).astype(np.uint8)
        )
        read_len = np.ascontiguousarray(np.asarray(out["read_len"], np.int64))
        t_dev += _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        rc2 = lib.ptscan_post_results(
            h, i32p(codes), i32p(olens), i32p(n_out), i32p(opos),
            u8p(mapped), u8p(fallback), i64p(read_len),
            ctypes.c_longlong(codes.shape[1]),
        )
        if rc2 < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())
        t_post += _time.perf_counter() - _t0

    try:
        while True:
            _t0 = _time.perf_counter()
            rc = lib.ptscan_next_batch(h, ctypes.byref(desc))
            t_prep += _time.perf_counter() - _t0
            if rc < 0:
                raise RuntimeError(lib.ptscan_error(h).decode())
            if rc == 0:
                break
            if rc == 2:  # EOF with results outstanding: drain one, retry
                post(in_flight.popleft())
                continue
            n_batches += 1
            _t0 = _time.perf_counter()
            in_flight.append(dispatch(desc))
            t_dev += _time.perf_counter() - _t0
            if len(in_flight) >= 2:
                post(in_flight.popleft())
            lib.ptscan_stats(h, stats_buf)
            tid = int(stats_buf[5])
            if tid > 0:
                done = int(cum_len[tid]) // 1000
                progress.inc(max(done - progress.count, 0))
        while in_flight:
            post(in_flight.popleft())

        if feeder is not None:
            feeder.join()
            if feeder_state.get("exc") is not None:
                # a feeder failure can look like a clean EOF at a record
                # boundary — always prefer the producer's own error
                raise feeder_state["exc"]

        if lib.ptscan_finish(h) < 0:
            raise RuntimeError(lib.ptscan_error(h).decode())
        lib.ptscan_stats(h, stats_buf)
        timing_buf = (ctypes.c_longlong * 9)()
        lib.ptscan_timing.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
        ]
        lib.ptscan_timing(h, timing_buf)
    except BaseException:
        if feeder is not None and feeder.is_alive():
            lib.ptio_reader_push_close(push_handle)
            feeder.join()
        exc = feeder_state.get("exc")
        if exc is not None and not isinstance(exc, _FeederAborted):
            raise exc from None
        raise
    finally:
        progress.clear()
        lib.ptscan_destroy(h)

    stats = {
        "n_primary": int(stats_buf[0]),
        "device_items": int(stats_buf[1]),
        "host_items": int(stats_buf[2]),
        "fallback_items": int(stats_buf[3]),
        "n_unassembled": int(stats_buf[4]),
    }
    logger.info(
        f"Lifted {stats['n_primary']} primary reads: "
        f"{stats['device_items']} device work items, "
        f"{stats['host_items']} host items "
        f"({stats['fallback_items']} window/bucket fallbacks)"
    )
    if os.environ.get("PTPU_FEED_TIMING"):
        logger.info(
            f"feed timing: prep {t_prep:.2f}s, device {t_dev:.2f}s, "
            f"finish {t_post:.2f}s over {n_batches} batches"
        )
        names = ("read", "prepare", "fill", "drain", "post", "shift",
                 "finish_enc", "fin_encode", "fin_write")
        logger.info(
            "native phase split: "
            + ", ".join(f"{n} {v / 1e9:.3f}s" for n, v in zip(names, timing_buf))
        )
        for i, n in enumerate(names):
            stats[f"t_native_{n}"] = timing_buf[i] / 1e9
    stats["t_prep"] = t_prep
    stats["t_dev"] = t_dev
    stats["t_post"] = t_post
    # device memory while this run's arrays (the resident table included)
    # are still alive; None on backends without memory stats
    mem = jax.local_devices()[0].memory_stats() or {}
    stats["device_bytes_in_use"] = mem.get("bytes_in_use")
    global _last_stats
    _last_stats = stats
    return stats
