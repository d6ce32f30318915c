"""Device-resident reference windows + packed read-sequence rows.

A reformulation of the simplify window path.  The table forward graph
consumes two (B, max_seq) uint8 tables — a per-item reference window and
the decoded read sequence — whose only use is the G-slot compacted window
compare (simplify_kernel.simplify_batch_compact).  Filling, transferring
and bf16-converting those tables costs on both sides of the host-device
link:

- host fill: a 24 KB reference memcpy + an 18 KB nibble decode per item;
- H2D: ~25 MB per 512-batch;
- on the device: two (B, max_seq) uint8->bf16 table conversions per batch
  feeding the slot-row one-hot dots.

This module replaces both tables:

- **Reference**: the whole genome stays resident in device memory as a
  64-byte superblock table (built once per run).  Each slot's two 48-byte
  windows are fetched with a tiny 2-row gather (2*2*G rows of 16 words —
  thousands of elements) + the standard barrel realign.
  The per-item ``ref_win`` array, its host fill, and its H2D vanish.
- **Read sequence**: transferred PACKED (B, max_seq/2) in the BAM 4-bit
  code domain (a straight memcpy of the raw record bytes on the host —
  the AVX2 nibble decode disappears from the fill).  The slot-row one-hot
  dot runs on the packed table (half the traffic); only the G fetched
  windows (~25 packed bytes each) are widened back to ASCII on device.
  The unpack sits BEHIND the compaction instead of in front of the whole
  batch, so no (512, 24576) relayout happens; the widening touches
  (G, ~50) elements.

Exactness: window bytes compare in the ASCII domain on both sides —
reference bytes are the genome's raw bytes, read bytes decode through the
same 16-symbol map ("=ACMGRSVTWYHKDBN", the BAM spec table that
ptscan.cc/ops use) — so every in-range compare is bit-identical to the
per-item table path.  Out-of-range window positions (beyond the lifted
span / read end) see REAL neighbouring reference bytes here instead of
zero padding, but those positions provably never influence the output:
the raw runs are consumed only through ``min(raw, m)`` and
``sat = (raw >= window) & (m > window)``, and every position ``t < min(m,
window)`` lies inside the cluster's own ref/read extent (tests assert
output equality under adversarial span-edge fuzz, tests/test_resident.py).

Reference semantics matched: src/simplify_alignment_indels.rs:54-92 (the
sequence window compare being fetched).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

SB = 64  # superblock bytes in the global reference table
SEQ_SYMBOLS = b"=ACMGRSVTWYHKDBN"  # BAM 4-bit code -> ASCII (ptscan kSeqChars)
_REF_PAD = ord("N")

# host-side ASCII -> BAM nibble code (total on the 16-symbol alphabet; read
# sequences are always inside it: BAM decode emits exactly these chars and
# ops.seq.rev_comp maps everything else to 'N')
_ENC_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(SEQ_SYMBOLS):
    _ENC_LUT[_c] = _i
    _ENC_LUT[ord(chr(_c).lower())] = _i


def build_global_ref(reference) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate the per-chrom reference arrays into the device-resident
    superblock table.

    Returns ``(words, goff)``: ``words`` is (NSB, SB/4) uint32 (the uint8
    table viewed as little-endian words — the layout the device fetch
    bitcasts back), ``goff`` is the int64 global BYTE offset of each chrom.
    Every chrom starts 64-aligned; one front pad superblock keeps index
    clamping trivially safe and two tail superblocks keep the +1 row of the
    last window in-table.
    """
    parts = [np.full(SB, _REF_PAD, np.uint8)]
    goff = np.zeros(len(reference), np.int64)
    off = SB
    for i, r in enumerate(reference):
        a = np.ascontiguousarray(r, dtype=np.uint8)
        goff[i] = off
        parts.append(a)
        pad = (-len(a)) % SB
        if pad:
            parts.append(np.full(pad, _REF_PAD, np.uint8))
        off += len(a) + pad
    parts.append(np.full(2 * SB, _REF_PAD, np.uint8))
    cat = np.concatenate(parts)
    return cat.reshape(-1, SB).view(np.uint32).copy(), goff


def split_global_base(gbyte) -> tuple[np.ndarray, np.ndarray]:
    """int64 global byte offset(s) -> (superblock index int32, residue int32).

    The device never reconstructs the raw byte offset (which can exceed
    int32 for >2.1 GB genomes); all window arithmetic runs in the split
    (superblock, residue) domain.
    """
    gbyte = np.asarray(gbyte, np.int64)
    return (gbyte >> 6).astype(np.int32), (gbyte & 63).astype(np.int32)


def pack_seq_rows(rows: np.ndarray) -> np.ndarray:
    """(B, L) ASCII uint8 rows -> (B, ceil(L/2)) packed BAM nibble rows
    (high nibble = first base; zero-padded rows pack to 0x00 = '==')."""
    rows = np.ascontiguousarray(rows, np.uint8)
    b, length = rows.shape
    if length % 2:
        rows = np.concatenate([rows, np.zeros((b, 1), np.uint8)], axis=1)
    nib = _ENC_LUT[rows]
    # '=' is code 0, so zero padding encodes to 0 and round-trips to '='
    nib[rows == 0] = 0
    return ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)


def _nib_to_ascii(nib):
    """BAM nibble codes -> ASCII via 16 elementwise selects (a 16-element
    device gather would serialize; this is pure VPU)."""
    acc = jnp.zeros_like(nib)
    for i, ch in enumerate(SEQ_SYMBOLS):
        acc = acc | jnp.where(nib == i, jnp.uint8(ch), jnp.uint8(0))
    return acc


def _barrel_bytes(span_t, o, window: int):
    """(128, C) byte span columns + per-column residue o in [0, 64) ->
    (window, C): the 6-stage byte-granularity barrel shifter
    (cluster_utils._window_bytes_mm_t's realign)."""
    w = span_t
    for bit in (32, 16, 8, 4, 2, 1):
        need = window + bit - 1
        w = jnp.where(((o & bit) != 0)[None, :], w[bit : bit + need], w[:need])
    return w[:window]


def fetch_ref_windows_global(words, g_sb, g_off, starts_rel, window: int):
    """Fetch (window, C) reference bytes from the resident superblock table.

    ``words``: (NSB, SB/4) uint32 global table (build_global_ref).
    ``g_sb``/``g_off``: (C,) int32 per-window global base (split domain).
    ``starts_rel``: (C,) int32 window starts relative to that base
    (>= -window by the cluster-coordinate contract).

    Each window needs its 2 covering superblocks: ONE take of 2C rows
    (2C * SB/4 words — thousands of elements at C ~ 128, far below the
    gather wall) followed by the barrel realign.  No fill sentinel: edge
    positions read real neighbouring genome bytes, which provably never
    influence the simplify output (module docstring).
    """
    nsb = words.shape[0]
    q = g_off + starts_rel
    p_sb = jnp.clip(g_sb + (q >> 6), 0, nsb - 2)
    o = q & 63
    rows = jnp.take(words, jnp.concatenate([p_sb, p_sb + 1]), axis=0)
    c = p_sb.shape[0]
    span_words = jnp.concatenate([rows[:c], rows[c:]], axis=1)  # (C, 2*SB/4)
    span = jax.lax.bitcast_convert_type(span_words, jnp.uint8).reshape(c, 2 * SB)
    return _barrel_bytes(span.T, o, window)


def fetch_read_windows_packed(rows_packed, starts, window: int):
    """(G, Lp) packed nibble rows + (G, W) base-coordinate starts ->
    (G, window, W) ASCII bytes.

    Fetches window//2+1 PACKED bytes per window through the standard
    superblock machinery, then widens just those bytes to ASCII and drops
    the leading nibble when the start is odd.  Out-of-range packed fill
    (0xFD) widens to real symbols ('D','N') — harmless for the same
    reason as the reference-edge bytes (module docstring).
    """
    from portello_tpu.kernels.cluster_utils import _window_bytes_mm_t

    assert window % 2 == 0, "packed fetch assumes an even window"
    pw = window // 2 + 1
    pstarts = starts >> 1          # floor for negatives (arithmetic shift)
    parity = (starts & 1)[:, None, :]
    wp = jax.vmap(
        lambda row, st: _window_bytes_mm_t(row, st, pw, 0xFD)
    )(rows_packed, pstarts)        # (G, pw, W)
    hi = wp >> 4
    lo = wp & 0xF
    bases = jnp.stack([hi, lo], axis=2).reshape(
        wp.shape[0], 2 * pw, wp.shape[2]
    )                              # (G, 2*pw, W): hi nibble = first base
    chars = _nib_to_ascii(bases)
    return jnp.where(
        parity == 1, chars[:, 1 : window + 1, :], chars[:, :window, :]
    )
