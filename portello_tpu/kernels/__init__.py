"""JAX/XLA device kernels: fixed-shape, batched formulations of the
alignment algebra in ``portello_tpu.ops``.

Design notes:

- CIGARs are padded ``int32`` code/length vectors (PAD code 9); batches are
  bucketed by maximum op count so every kernel compiles once per bucket shape.
- The liftover inner loop — in the reference a nested walk over CIGAR ops and
  map-block entries (reference src/liftover_read_alignment.rs:137-223) — becomes a
  fixed-length two-pointer ``lax.scan`` (one "update call" per step, bounded by
  ``2*max_ops + max_blocks`` steps), vmapped across the read batch so every scan
  step is a wide vector op.
- Run-length compression and edge-indel cleanup are data-parallel scatter/
  segment-sum passes, not sequential walks.
- Sequence-dependent passes (indel simplification / shifting) compare bases over
  bounded windows; reads whose clusters exceed the static window report a
  fallback flag and are finished exactly on host by the ``portello_tpu.ops``
  oracle.
"""
