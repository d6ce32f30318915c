"""The sharded production graphs (8-device CPU mesh via conftest) must be
bit-identical to the single-device stage-split chain the engine runs —
the dryrun must validate the graph production uses."""

import numpy as np
import pytest

import jax

from portello_tpu.models.batch import BucketConfig
from portello_tpu.models.pipeline_model import fwd_batch, rev_batch
from portello_tpu.parallel.mesh import (
    make_mesh,
    make_sharded_fwd_step,
    make_sharded_rev_step,
    shard_batch_arrays,
)
from portello_tpu.testutil.batchgen import make_item_arrays

BCFG = BucketConfig(
    max_ops=64, max_blocks=16, max_seq=512, max_clusters=24, window=16
)
KW = dict(
    max_out=BCFG.resolved_max_out(),
    max_clusters=BCFG.max_clusters,
    window=BCFG.window,
)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mm", [False, True])
def test_sharded_rev_chain_matches_single_device(mm):
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    items = make_item_arrays(rng, 16, BCFG, read_len=300, rev=True)
    rev = make_sharded_rev_step(mesh, **KW, mm=mm)
    sharded = rev(*shard_batch_arrays(mesh, items))
    single = rev_batch(*[np.asarray(a) for a in items], **KW, mm=mm)
    assert set(sharded) == set(single)
    for k in single:
        assert np.array_equal(np.asarray(sharded[k]), np.asarray(single[k])), k


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_fwd_matches_single_device():
    mesh = make_mesh(8)
    rng = np.random.default_rng(4)
    items = make_item_arrays(rng, 16, BCFG, read_len=300)
    fwd = make_sharded_fwd_step(mesh, **KW)
    sharded = fwd(*shard_batch_arrays(mesh, items))
    single = fwd_batch(*[np.asarray(a) for a in items], **KW)
    for k in single:
        assert np.array_equal(np.asarray(sharded[k]), np.asarray(single[k])), k
