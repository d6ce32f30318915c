"""Exactness of the one-hot-matmul expansion primitives (kernels/expand.py)
and bit-equality of the mm kernel formulation against the gather formulation
across the full device pipeline.

The gather formulation is conformance-tested against the exact host oracle
(tests/test_device_engine.py), so mm == gather here extends that bit-equality
chain to the matmul formulation.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from portello_tpu.kernels.expand import (
    count_le,
    count_lt,
    expand_mask,
    gather_rows,
    onehot_eq,
    onehot_interval,
)


def test_expand_mask_exact_full_int32_range():
    rng = np.random.default_rng(0)
    table = rng.integers(-(2**63), 2**63 - 1, size=(96, 8)).astype(np.int32)
    table[0] = np.iinfo(np.int32).max
    table[1] = np.iinfo(np.int32).min
    table[2] = -1
    idx = rng.integers(0, 96, size=608).astype(np.int32)
    out = np.asarray(expand_mask(onehot_eq(jnp.asarray(idx), 96), jnp.asarray(table)))
    assert np.array_equal(out, table[idx])


def test_expand_zero_rows_out_of_range():
    table = np.arange(12, dtype=np.int32).reshape(4, 3) - 5
    idx = np.array([0, 4, -1, 3], dtype=np.int32)  # 4 and -1 out of range
    out = np.asarray(expand_mask(onehot_eq(jnp.asarray(idx), 4), jnp.asarray(table)))
    assert np.array_equal(out[0], table[0])
    assert np.array_equal(out[3], table[3])
    assert (out[1] == 0).all() and (out[2] == 0).all()


def test_gather_rows_matches_take_along_axis():
    rng = np.random.default_rng(1)
    table = rng.integers(-(2**31), 2**31 - 1, size=(50, 4)).astype(np.int32)
    idx = rng.integers(0, 50, size=200).astype(np.int32)
    a = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx), True))
    b = np.asarray(gather_rows(jnp.asarray(table), jnp.asarray(idx), False))
    assert np.array_equal(a, b)


def test_onehot_interval_matches_searchsorted_expansion():
    rng = np.random.default_rng(2)
    visits = rng.integers(0, 4, size=64).astype(np.int32)
    off = np.cumsum(visits) - visits
    total = visits.sum()
    r_dim = 160
    mask = np.asarray(onehot_interval(jnp.asarray(off), jnp.asarray(visits), r_dim))
    op_of = np.searchsorted(off + visits, np.arange(r_dim), side="right")
    for r in range(r_dim):
        if r < total:
            expect = np.zeros(64)
            expect[op_of[r]] = 1.0
            assert np.array_equal(mask[r], expect), r
        else:
            assert (mask[r] == 0).all()


def test_counts_match_searchsorted():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(-100, 100, size=37)).astype(np.int32)
    q = rng.integers(-120, 120, size=91).astype(np.int32)
    le = np.asarray(count_le(jnp.asarray(keys), jnp.asarray(q)))
    lt = np.asarray(count_lt(jnp.asarray(keys), jnp.asarray(q)))
    assert np.array_equal(le, np.searchsorted(keys, q, side="right"))
    assert np.array_equal(lt, np.searchsorted(keys, q, side="left"))


def test_window_bytes_mm_matches_gather():
    from portello_tpu.kernels.cluster_utils import _window_bytes, _window_bytes_mm

    rng = np.random.default_rng(4)
    for L in (256, 4096, 4100):  # incl. non-64-multiple
        seq = rng.integers(0, 256, size=L, dtype=np.uint8)
        window = 48
        # contract range: -window <= start <= L, incl. boundary straddles
        start = np.concatenate(
            [
                np.arange(-window, window),
                rng.integers(-window, L + 1, size=200),
                np.arange(L - window - 2, L + 1),
            ]
        ).astype(np.int32)
        a = np.asarray(_window_bytes(jnp.asarray(seq), jnp.asarray(start), window, 0xFE))
        b = np.asarray(_window_bytes_mm(jnp.asarray(seq), jnp.asarray(start), window, 0xFE))
        assert np.array_equal(a, b), L


@pytest.mark.parametrize("rev", [False, True])
def test_pipeline_mm_equals_gather(rev):
    """Full fwd/rev batch pipeline: mm formulation is bit-identical."""
    from portello_tpu.models.pipeline_model import fwd_batch, rev_batch_fused
    from portello_tpu.testutil.batchgen import make_item_arrays
    from portello_tpu.models.batch import BucketConfig

    bcfg = BucketConfig(
        max_ops=96, max_blocks=48, max_seq=4096, max_clusters=64, window=16
    )
    rng = np.random.default_rng(42)
    args = make_item_arrays(
        rng, 8, bcfg, read_len=2000, read_error=0.01, contig_var_rate=0.004,
        rev=rev,
    )
    kw = dict(
        max_out=bcfg.resolved_max_out(),
        max_clusters=bcfg.max_clusters,
        window=bcfg.window,
    )
    fn = rev_batch_fused if rev else fwd_batch
    out_g = fn(*args, **kw, mm=False)
    out_m = fn(*args, **kw, mm=True)
    assert set(out_g) == set(out_m)
    for k in out_g:
        assert np.array_equal(np.asarray(out_g[k]), np.asarray(out_m[k])), k


def test_shift_stages_mm_equals_gather():
    from portello_tpu.kernels.shift_kernel import (
        shift_stage_a_batch,
        shift_stage_b_batch,
    )
    from portello_tpu.testutil.batchgen import make_item_arrays
    from portello_tpu.models.batch import BucketConfig

    bcfg = BucketConfig(
        max_ops=96, max_blocks=48, max_seq=4096, max_clusters=64, window=16
    )
    rng = np.random.default_rng(43)
    (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
     ref_win, ref_base, read_seq) = make_item_arrays(
        rng, 8, bcfg, read_len=2000, read_error=0.01, contig_var_rate=0.004,
        rev=True,
    )
    rel = pos - win_base
    outs = {}
    for mm in (False, True):
        st = shift_stage_a_batch(
            ops, lens, rel, win_base, contig_win, read_seq,
            max_clusters=bcfg.max_clusters, window=bcfg.window, mm=mm,
        )
        outs[mm] = shift_stage_b_batch(
            ops, lens, rel, st, window=bcfg.window,
            max_out=bcfg.resolved_max_out(), mm=mm,
        )
    for a, b in zip(outs[False], outs[True]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_expand_sum_segment_sums_exact():
    """expand_sum: arithmetic byte-plane recombination gives exact int32
    segment sums, including negative table values (two's complement wrap)."""
    from portello_tpu.kernels.expand import expand_sum

    rng = np.random.default_rng(7)
    k, c, r = 464, 4, 232
    table = rng.integers(-(2**28), 2**28, size=(k, c)).astype(np.int32)
    table[0] = [2**28, -(2**28), -1, 0]
    seg = np.sort(rng.integers(0, r, size=k)).astype(np.int32)
    mask = (seg[None, :] == np.arange(r, dtype=np.int32)[:, None])
    out = np.asarray(
        expand_sum(jnp.asarray(mask.astype(np.float32)), jnp.asarray(table))
    )
    expect = np.zeros((r, c), np.int64)
    np.add.at(expect, seg, table.astype(np.int64))
    assert np.array_equal(out, expect.astype(np.int32))


def test_expand_sum_empty_segments_zero():
    from portello_tpu.kernels.expand import expand_sum

    table = np.array([[5, -3], [7, 9]], np.int32)
    mask = np.zeros((4, 2), np.float32)
    mask[1] = [1, 1]
    out = np.asarray(expand_sum(jnp.asarray(mask), jnp.asarray(table)))
    assert np.array_equal(out, [[0, 0], [12, 6], [0, 0], [0, 0]])


def test_window_bytes_mm_t_matches_row_major():
    """Transposed (lane-major) window fetch is bit-identical to the
    row-major fetch across the full supported start range."""
    from portello_tpu.kernels.cluster_utils import (
        _window_bytes,
        _window_bytes_mm_t,
    )

    rng = np.random.default_rng(8)
    for L in (256, 4096, 4100):
        seq = rng.integers(0, 256, size=L, dtype=np.uint8)
        window = 48
        start = np.concatenate(
            [
                np.arange(-window, window),
                rng.integers(-window, L + 1, size=200),
                np.arange(L - window - 2, L + 1),
            ]
        ).astype(np.int32)
        a = np.asarray(
            _window_bytes(jnp.asarray(seq), jnp.asarray(start), window, 0xFE)
        )
        b = np.asarray(
            _window_bytes_mm_t(jnp.asarray(seq), jnp.asarray(start), window, 0xFE)
        )
        assert np.array_equal(a, b.T), L


def test_compress_mm_forms_bit_identical():
    """Both mm compress formulations (segsum / search) equal the gather form."""
    from portello_tpu.kernels.cigar_kernels import PAD, compress

    rng = np.random.default_rng(9)
    n, max_out = 464, 160
    for trial in range(3):
        codes = rng.integers(0, 3, size=n).astype(np.int32)
        lens = rng.integers(0, 5, size=n).astype(np.int32)
        codes[lens == 0] = PAD
        codes[: n - 300] = PAD
        lens[: n - 300] = 0
        ref = compress(jnp.asarray(codes), jnp.asarray(lens), max_out, False)
        for form in ("segsum", "search"):
            got = compress(
                jnp.asarray(codes), jnp.asarray(lens), max_out, True, form
            )
            for a, b in zip(ref, got):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (trial, form)
