"""Host update-grid row counter must agree exactly with the device kernel.

``_count_update_rows`` (and its C++ mirror in ptscan.cc) buckets items under
a reduced ``max_rows`` grid; the kernel independently computes the row total
and flags overflow.  For each random item, the kernel must NOT overflow at
``max_rows == host_rows`` and MUST overflow at ``host_rows - 1`` — together
these prove the two counts are identical.
"""

import numpy as np
import pytest

from portello_tpu.models.batch import BucketConfig, build_liftover_batch
from portello_tpu.ops.blockmap import build_block_map

jax = pytest.importorskip("jax")

from portello_tpu.models.pipeline_model import (  # noqa: E402
    _count_update_rows,
    _lift_core,
)
from test_liftover_kernel import random_cigar  # noqa: E402

CFG = BucketConfig(max_ops=48, max_blocks=24, max_seq=1024)


@pytest.mark.parametrize("mm", [False, True])
def test_device_rows_match_host_count(mm):
    rng = np.random.default_rng(7)
    items = []
    for _ in range(60):
        map_cigar = random_cigar(rng, 16)
        map_pos = int(rng.integers(0, 3000))
        bm = build_block_map(map_pos, map_cigar, False)
        if len(bm) > CFG.max_blocks:
            continue
        read_cigar = random_cigar(rng, 32)
        read_pos = int(rng.integers(0, 2000))
        items.append((read_cigar, read_pos, bm))
    assert len(items) > 40

    arrs = [np.asarray(a) for a in build_liftover_batch(items, CFG)]
    max_out = CFG.resolved_max_out()

    def overflow_at(max_rows):
        fn = jax.jit(
            jax.vmap(
                lambda o, l, n, p, k, v, m: _lift_core(
                    o, l, n, p, k, v, m, max_out=max_out, mm=mm,
                    max_rows=max_rows,
                )
            ),
            static_argnames=(),
        )
        return np.asarray(fn(*arrs)[5])

    rows = np.array(
        [
            _count_update_rows(cig, pos, np.asarray(bm.keys))
            for cig, pos, bm in items
        ]
    )
    assert rows.max() > rows.min()  # varied inputs

    # At the batch max every item fits (no row overflow; compress overflow
    # impossible at these shapes).
    assert not overflow_at(int(rows.max())).any()
    # One row below the max, exactly the max-row items overflow.
    ovf = overflow_at(int(rows.max()) - 1)
    assert np.array_equal(ovf, rows == rows.max())
    # And at the per-batch median bound, overflow == (rows > bound).
    med = int(np.median(rows))
    assert np.array_equal(overflow_at(med), rows > med)
