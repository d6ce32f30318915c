"""Multi-device / multi-host parallelism.

The reference's concurrency model is single-process rayon threading over 20 Mb
genome windows (SURVEY.md section 2d).  The device equivalent implemented
here: a 1-D ``data`` device mesh; read work-item batches sharded along the
batch axis; the contig index and reference windows travel with their batch
rows (fully data-parallel, no cross-item communication is required by the
algorithm — each read lifts independently).  Multi-host runs shard BAM decode
by genome region per host and concatenate per-host unsorted outputs, which the
output contract explicitly permits (docs/user_guide.md:63-77, :227-230).
"""

from portello_tpu.parallel.mesh import make_mesh, shard_batch_arrays  # noqa: F401
