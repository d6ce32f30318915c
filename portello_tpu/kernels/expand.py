"""Backend-adaptive expansion primitives: index gathers and sorted search.

Any gather whose index domain is a small static ``K`` can be computed as a
one-hot ``(R, K)`` mask matmul against the table split into byte planes,
which replaces a general gather with a dense matrix product:

- the mask is {0, 1} and byte-plane values are <= 255, both exact in
  bfloat16, so each product is exact in its f32 accumulator;
- each output row sums exactly one nonzero product, so no rounding can
  occur regardless of accumulation order.

The result is bit-exact for arbitrary int32 input (including negatives and
INT32_MAX pads, via uint32 byte slicing) — enforced against
``take_along_axis`` by tests/test_expand.py.

``searchsorted`` over small key sets is replaced by compare-and-count
reductions (elementwise compares and a sum).

Every kernel threads a static ``mm`` flag, chosen per backend by
``portello_tpu.backend.select_dispatch`` (native gathers on the CPU, where
XLA gathers are cheap and small matmuls are not).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def count_le(keys, queries):
    """#(keys <= q) per query == searchsorted(keys, q, side="right").

    ``keys`` (K,) need not be sorted for the count itself, but equivalence
    with searchsorted of course requires sorted keys (all call sites).
    """
    return jnp.sum(
        queries[:, None] >= keys[None, :], axis=1, dtype=jnp.int32
    )


def count_lt(keys, queries):
    """#(keys < q) per query == searchsorted(keys, q, side="left")."""
    return jnp.sum(
        queries[:, None] > keys[None, :], axis=1, dtype=jnp.int32
    )


def _split_bytes(table):
    """int32 (K, C) -> bfloat16 (K, 4C) byte planes.

    bf16 is exact for integers <= 256, so byte planes and {0,1} masks lose
    nothing, while halving the HBM traffic of the materialized mask (the
    dominant cost of an expansion at these shapes).
    """
    u = table.astype(jnp.uint32)
    return jnp.concatenate(
        [((u >> (8 * i)) & 0xFF).astype(jnp.bfloat16) for i in range(4)], axis=1
    )


def _join_bytes(f, c):
    """float32 (R, 4C) byte planes -> int32 (R, C)."""
    u = f.astype(jnp.uint32)
    out = u[:, :c]
    for i in range(1, 4):
        out = out | (u[:, i * c : (i + 1) * c] << (8 * i))
    return out.astype(jnp.int32)


def expand_mask(mask, table):
    """(R, K) one-hot/zero-row float mask @ (K, C) int32 table -> (R, C) int32.

    Rows of ``mask`` with no set bit yield 0.  Bit-exact (see module doc).
    """
    c = table.shape[1]
    planes = _split_bytes(table)
    out = jax.lax.dot(
        mask.astype(jnp.bfloat16), planes,
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    return _join_bytes(out, c)


def expand_bytes(mask, table_u8):
    """(R, K) one-hot float mask @ (K, C) uint8 table -> (R, C) uint8.

    Single-plane variant of :func:`expand_mask` for byte tables (values
    <= 255 are exact in bf16 products; one nonzero per output).
    """
    out = jax.lax.dot(
        mask.astype(jnp.bfloat16), table_u8.astype(jnp.bfloat16),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    return out.astype(jnp.uint8)


def onehot_eq(idx, k: int):
    """(R,) int32 indices -> (R, k) one-hot float mask (out-of-range -> zero row)."""
    j = jnp.arange(k, dtype=jnp.int32)[None, :]
    return (idx[:, None] == j).astype(jnp.bfloat16)


def onehot_interval(off, visits, r: int):
    """(K,) interval starts/lengths -> (r, K) mask: mask[x, i] = off_i <= x < off_i+visits_i.

    For non-overlapping intervals this is one-hot per covered row and a zero
    row outside all intervals.
    """
    x = jnp.arange(r, dtype=jnp.int32)[:, None]
    return ((x >= off[None, :]) & (x < (off + visits)[None, :])).astype(jnp.bfloat16)


def expand_sum(mask, table):
    """(R, K) {0,1} float mask @ (K, C) int32 table -> (R, C) int32 SUMS.

    Segment-sum variant of :func:`expand_mask`: mask rows may select MANY
    table rows and the result is their exact sum.  Byte planes are recombined
    ARITHMETICALLY (p0 + (p1<<8) + ...) instead of bit-or, so per-plane sums
    compose exactly as long as each per-row selected count stays <= 65793
    (255*count < 2^24, the f32 exact-integer bound) and the true int32 sum
    does not overflow.  Used for one-matmul segment reductions (compress run
    lengths/codes, cluster stats) replacing boundary searches + prefix-sum
    difference lookups.
    """
    c = table.shape[1]
    planes = _split_bytes(table)
    out = jax.lax.dot(
        mask.astype(jnp.bfloat16), planes,
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )
    v = out.astype(jnp.int32)
    res = v[:, :c]
    for i in range(1, 4):
        res = res + (v[:, i * c : (i + 1) * c] << (8 * i))
    return res


def gather_rows(table, idx, mm: bool):
    """Row gather ``table[idx]`` for 2-D int32 tables, by either formulation.

    With ``mm`` False this is ``take_along_axis`` (out-of-range behavior
    follows the caller's clipping); with ``mm`` True, out-of-range indices
    produce zero rows — callers must clip or mask identically on both paths.
    """
    if mm:
        return expand_mask(onehot_eq(idx, table.shape[0]), table)
    return jnp.take_along_axis(table, idx[:, None], axis=0)
