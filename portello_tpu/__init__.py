"""portello-tpu: batched JAX liftover of HiFi read alignments.

A brand-new framework with the capabilities of PacificBiosciences/portello
(reference v0.6.1): it transfers ("lifts over") read-to-assembly
alignments onto a standard reference genome using the assembly-to-reference
alignments, producing a remapped read BAM and an "unassembled" read BAM.

Architecture (a redesign for batched devices, not a port):

- ``portello_tpu.ops``       pure host-side (numpy) alignment algebra: CIGAR ops as
  dense ``(code, len)`` tensors, block maps, liftover, indel simplification and
  shifting.  This layer is the exact conformance oracle; its behavior matches the
  reference implementation function-for-function.
- ``portello_tpu.kernels``   JAX/XLA device kernels: batched, padded,
  fixed-shape formulations of the same algebra (`lax.scan` two-pointer merge for
  liftover, windowed vector compare for indel normalization), vmapped over reads.
- ``portello_tpu.models``    the "flagship model": the jitted end-to-end batch
  liftover step combining the kernels.
- ``portello_tpu.parallel``  `jax.sharding` mesh utilities; sharded batch step
  for multi-device / multi-host data parallelism.
- ``portello_tpu.io``        host I/O: C++ BGZF/BAM codec (htslib replacement) with
  ctypes bindings, FASTA loader.
- ``portello_tpu.pipeline``  the two-phase driver: contig alignment scan (phase 1)
  and read scan + remap (phase 2).
"""

from portello_tpu._version import PROGRAM_NAME, PROGRAM_VERSION

__all__ = ["PROGRAM_NAME", "PROGRAM_VERSION"]
__version__ = PROGRAM_VERSION
