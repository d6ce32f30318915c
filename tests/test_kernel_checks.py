"""The device-vs-oracle checks of portello_tpu/testutil/kernel_checks.py.

The CPU cases run the checks at small widths.  The ``gpu`` cases run the
same checks at the production bucket widths with batch 512, as
``chip_smoke.py`` does; they skip without a GPU.

Every compare is exact, with no tolerance: the outputs are integers, and
every dot on the main path (kernels/expand.py, cluster_utils.py) takes
bf16 operands with a float32 accumulator.  Byte planes (<= 255) and {0, 1}
masks are exact in bf16, each product is exact in float32, and every
segment sum stays below 2^24, so the sums are exact in any order — also on
Hopper's tensor cores.  TF32 never enters: no float32 operand reaches a
dot.
"""

import numpy as np
import pytest

from portello_tpu.models.batch import BucketConfig
from portello_tpu.models.pipeline_model import DEFAULT_BUCKETS
from portello_tpu.testutil import kernel_checks as kc

SMALL = BucketConfig(max_ops=64, max_blocks=16, max_seq=2048,
                     max_clusters=24, window=16)


@pytest.fixture(scope="module")
def small_items():
    rng = np.random.default_rng(0)
    items = kc.make_items(rng, SMALL, 8, 1500, 150, 300)
    table, res, words = kc.resident_args(items)
    return table, res, words, kc.oracle_fwd(table)


@pytest.mark.parametrize("mm", [False, True])
def test_fwd_batch_matches_oracle_small(small_items, mm):
    table, _, _, oracle = small_items
    counts = kc.check_fwd_batch(table, SMALL, mm, oracle)
    assert counts["checked"] == counts["items"] == 8


def test_fwd_batch_resident_matches_oracle_small(small_items):
    _, res, words, oracle = small_items
    counts = kc.check_fwd_batch_resident(res, words, SMALL, oracle)
    assert counts["checked"] == 8


def test_compare_fwd_rejects_a_wrong_item(small_items):
    table, _, _, oracle = small_items
    from portello_tpu.models.pipeline_model import fwd_batch

    out = {k: np.array(v) for k, v in fwd_batch(
        *table, mm=False, max_out=SMALL.resolved_max_out(),
        max_clusters=SMALL.max_clusters, window=SMALL.window,
        max_rows=SMALL.resolved_max_rows(),
    ).items()}
    out["ref2_pos"][3] += 1
    with pytest.raises(AssertionError, match="item 3 differs"):
        kc.compare_fwd(out, oracle, "tampered")


@pytest.mark.parametrize("mm", [False, True])
def test_cleanup_and_compress_matches_oracle_small(mm):
    width = kc.emission_width(SMALL)
    counts = kc.check_cleanup_and_compress(
        np.random.default_rng(1), width, SMALL.resolved_max_out(), mm, 32
    )
    assert counts["width"] == width


@pytest.mark.parametrize("k", [16, 1024])
def test_expand_sum_and_gather_exact(k):
    """Byte-plane extremes (0xFF bytes, INT32_MAX/MIN, all-K selections)
    at the widest K the production buckets use."""
    assert kc.check_expand(k, 64) == {"k": k, "rows": 64}


def test_emission_width_per_bucket():
    widths = [kc.emission_width(b) for b in DEFAULT_BUCKETS]
    assert widths == sorted(widths)
    assert all(w >= b.max_ops for w, b in zip(widths, DEFAULT_BUCKETS))


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [0, 1, 2])
def test_production_widths_on_gpu(gpu_device, bucket):
    bcfg = DEFAULT_BUCKETS[bucket]
    rng = np.random.default_rng(bucket)
    items = kc.make_items(rng, bcfg, 512, *kc.PRODUCTION_PROFILES[bucket])
    table, res, words = kc.resident_args(items)
    oracle = kc.oracle_fwd(table)
    for mm in (False, True):
        kc.check_fwd_batch(table, bcfg, mm, oracle)
        kc.check_cleanup_and_compress(
            rng, kc.emission_width(bcfg), bcfg.resolved_max_out(), mm, 512
        )
    kc.check_fwd_batch_resident(res, words, bcfg, oracle)


@pytest.mark.gpu
def test_expand_exact_on_gpu(gpu_device):
    kc.check_expand(1024, 512)
