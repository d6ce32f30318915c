"""Device-vs-oracle conformance AT THE PRODUCTION BUCKET SHAPES.

The small-shape suites prove formulation correctness, but several kernel
invariants are shape-dependent (the packed prev_end2 cummax needs
ref_span <= 2^16, the proven update-grid bound max_ops + max_blocks, the
max_ops lane cap on the rev leg) — this exercises the real HiFi bucket
(128/48/24576/96/48) with 18 kb items on CPU so those bounds are hit by a
conformance test, not only by the benchmark.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from portello_tpu.models.pipeline_model import fwd_batch, rev_batch  # noqa: E402
from portello_tpu.ops.blockmap import BlockMap  # noqa: E402
from portello_tpu.ops.liftover import liftover_read_alignment  # noqa: E402
from portello_tpu.ops.shift import left_shift_indels  # noqa: E402
from portello_tpu.ops.simplify import simplify_alignment_indels  # noqa: E402
from portello_tpu.testutil.batchgen import HIFI_BUCKET, make_item_arrays  # noqa: E402

B = 4
KW = dict(
    max_out=HIFI_BUCKET.resolved_max_out(),
    max_clusters=HIFI_BUCKET.max_clusters,
    window=HIFI_BUCKET.window,
    max_rows=HIFI_BUCKET.resolved_max_rows(),
    mm=True,
)


def _check(out, i, expect):
    if expect is None:
        assert not bool(np.asarray(out["mapped"])[i])
        return
    p, cig = expect
    n = int(np.asarray(out["n_out"])[i])
    got = np.stack(
        [np.asarray(out["codes"])[i, :n], np.asarray(out["lens"])[i, :n]],
        axis=1,
    ).astype(np.int64)
    assert int(np.asarray(out["ref2_pos"])[i]) == p
    assert np.array_equal(got, cig)


# (read_error, contig_var_rate): the HiFi profile the bucket is sized for,
# plus a near-cap density (~109 ops / ~41 blocks / ~150 grid rows of the
# 128/48/176 budgets) so the cap-adjacent arithmetic is exercised too
RATES = [(0.0025, 0.0012), (0.003, 0.0022)]


@pytest.mark.parametrize("read_error,contig_rate", RATES)
def test_fwd_production_shapes_match_oracle(read_error, contig_rate):
    rng = np.random.default_rng(20260817)
    args = make_item_arrays(
        rng, B, HIFI_BUCKET, read_len=18000, rev=False,
        read_error=read_error, contig_var_rate=contig_rate,
    )
    ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq = args
    out = fwd_batch(*args, **KW)
    fb = np.asarray(out["fallback"])
    assert not fb.all(), "all items fell back; test exercises nothing"
    for i in range(B):
        if fb[i]:
            continue
        n = int(n_ops[i])
        cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
        k = int(nb[i])
        bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
        lifted = liftover_read_alignment(bm, int(pos[i]), cig)
        if lifted is None:
            _check(out, i, None)
            continue
        p, c = lifted
        rp, rc = simplify_alignment_indels(
            p - int(ref_base[i]), c, ref_win[i], read_seq[i]
        )
        _check(out, i, (int(ref_base[i]) + rp, rc))


@pytest.mark.parametrize("read_error,contig_rate", RATES)
def test_rev_production_shapes_match_oracle(read_error, contig_rate):
    rng = np.random.default_rng(20260818)
    args = make_item_arrays(
        rng, B, HIFI_BUCKET, read_len=18000, rev=True,
        read_error=read_error, contig_var_rate=contig_rate,
    )
    (ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
     ref_win, ref_base, read_seq) = args
    out = rev_batch(*args, **KW)
    fb = np.asarray(out["fallback"])
    assert not fb.all(), "all items fell back; test exercises nothing"
    for i in range(B):
        if fb[i]:
            continue
        n = int(n_ops[i])
        cig = np.stack([ops[i, :n], lens[i, :n]], axis=1).astype(np.int64)
        p1, sh = left_shift_indels(int(pos[i]), cig, contig_win[i], read_seq[i])
        k = int(nb[i])
        bm = BlockMap(bk[i, :k].astype(np.int64), bv[i, :k].astype(np.int64))
        lifted = liftover_read_alignment(bm, p1, sh)
        if lifted is None:
            _check(out, i, None)
            continue
        p, c = lifted
        rp, rc = simplify_alignment_indels(
            p - int(ref_base[i]), c, ref_win[i], read_seq[i]
        )
        _check(out, i, (int(ref_base[i]) + rp, rc))
