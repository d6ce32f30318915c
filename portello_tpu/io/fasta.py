"""FASTA loading (reference genome_ref.rs:9-80 equivalent).

Loads chromosome sequences as uint8 arrays, uppercased (whole file — the
pipeline holds the entire reference in RAM like the reference tool does).
Also provides a writer for fixtures.
"""

from __future__ import annotations

import numpy as np

_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] -= 32
_UPPER_TABLE = _UPPER.tobytes()


class GenomeRef:
    """Map chrom name -> uint8 sequence array (genome_ref.rs:9-37)."""

    def __init__(self, chroms: dict[str, np.ndarray] | None = None):
        self.chroms: dict[str, np.ndarray] = chroms or {}

    def convert_disallowed_characters(self, allowed: bytes, unknown: int) -> None:
        lut = np.full(256, unknown, dtype=np.uint8)
        idx = np.frombuffer(allowed, dtype=np.uint8)
        lut[idx] = idx
        for name, seq in self.chroms.items():
            self.chroms[name] = lut[seq]

    def simplify_ambiguous_dna_bases(self) -> None:
        self.convert_disallowed_characters(b"ACGTN", ord("N"))


def get_genome_ref_from_fasta(path: str) -> GenomeRef:
    """Parse a whole FASTA file, uppercasing sequences (genome_ref.rs:43-80)."""
    with open(path, "rb") as f:
        raw = f.read()
    genome = GenomeRef()
    pos = raw.find(b">")
    while pos >= 0:
        hdr_end = raw.find(b"\n", pos)
        if hdr_end < 0:
            # final header with no trailing newline: an empty-sequence
            # record (rust-bio reader behavior), not a silent drop
            hdr_end = len(raw)
        header = raw[pos + 1 : hdr_end]
        name = header.split()[0].decode() if header.split() else ""
        nxt = raw.find(b">", hdr_end)
        seq_block = raw[hdr_end + 1 : nxt if nxt >= 0 else len(raw)]
        # one C pass: uppercase and strip line breaks (whole-genome inputs
        # are ~3 GB, where the numpy mask-and-index form took 3x longer)
        genome.chroms[name] = np.frombuffer(
            seq_block.translate(_UPPER_TABLE, b"\r\n"), dtype=np.uint8
        )
        pos = nxt
    return genome


def write_fasta(path: str, chroms: list[tuple[str, bytes]], width: int = 60) -> None:
    with open(path, "wb") as f:
        for name, seq in chroms:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
