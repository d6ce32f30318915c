"""Device mesh construction and batch sharding for the liftover kernels.

The liftover workload is embarrassingly parallel across reads, so the natural
mesh is 1-D over a ``data`` axis with every batch tensor sharded on dim 0 and
all outputs likewise; XLA inserts no collectives on the hot path, so the
device interconnect's topology does not matter.  The same entry points serve
single-host multi-device (one mesh over local devices) and multi-host
(jax.distributed + the same named sharding over the global mesh).

The reverse-contig pipeline ships in two forms: the production **fused
chain** on the mm path (one program: shift A + B + capped fwd leg;
models/pipeline_model.rev_chain_batch) and the **stage-split chain** on the
gather path (separate dispatches with device-resident sharded intermediates,
so gathers cannot fuse into the prefix scans).
``make_sharded_rev_step`` shards whichever form ``mm`` selects — the same
graph the engine runs.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def shard_batch_arrays(mesh: Mesh, arrays: tuple) -> tuple:
    """Place every batch tensor with dim-0 sharded over the data axis."""
    sh = batch_sharding(mesh)
    return tuple(jax.device_put(np.asarray(a), sh) for a in arrays)


def make_sharded_fwd_step(
    mesh: Mesh, *, max_out: int, max_clusters: int, window: int, mm: bool = False,
    max_rows: int | None = None,
):
    """Sharded forward liftover step over the mesh: the PRODUCTION
    ``fwd_batch`` graph per shard via ``shard_map``.

    Batch dim must be divisible by the mesh size; everything shards on dim 0
    and the per-shard graph is exactly the single-device one (the mm path's
    batch-level mixed-cluster compaction happens independently per shard —
    no collectives on the hot path; per-item outputs are identical, only
    the rare global-budget spill FLAG is computed per shard).
    """
    from jax import shard_map

    from portello_tpu.models.pipeline_model import fwd_batch

    spec = P("data")

    def local(ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq):
        return fwd_batch(
            ops, lens, n_ops, pos, bk, bv, nb, ref_win, ref_base, read_seq,
            max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
            max_rows=max_rows,
        )

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=(spec,) * 10, out_specs=spec)
    )


def make_sharded_fwd_resident_step(
    mesh: Mesh, *, max_out: int, max_clusters: int, window: int,
    max_rows: int | None = None,
):
    """Sharded resident-mode forward step (``fwd_batch_resident``): batch
    tensors shard on dim 0; the global superblock reference table is
    REPLICATED (every chip holds the genome — the per-window fetch must see
    the whole table, and replication keeps the hot path collective-free).

    The caller should place ``ref_words`` once with
    ``replicated_sharding(mesh)`` so the table isn't re-transferred per
    dispatch.
    """
    from jax import shard_map

    from portello_tpu.models.pipeline_model import fwd_batch_resident

    spec = P("data")

    def local(ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
              read_packed, ref_words):
        return fwd_batch_resident(
            ops, lens, n_ops, pos, bk, bv, nb, g_sb, g_off, ref_base,
            read_packed, ref_words,
            max_out=max_out, max_clusters=max_clusters, window=window,
            max_rows=max_rows,
        )

    return jax.jit(
        shard_map(
            local, mesh=mesh,
            in_specs=(spec,) * 11 + (P(None, None),),
            out_specs=spec,
        )
    )


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Every-device replication (the resident reference table's placement)."""
    return NamedSharding(mesh, P())


def make_sharded_rev_step(
    mesh: Mesh, *, max_out: int, max_clusters: int, window: int, mm: bool = False,
    max_rows: int | None = None,
):
    """Sharded reverse-contig step: the PRODUCTION chain.

    mm path: ONE sharded dispatch of the fused chain (``rev_chain_batch``,
    the graph the engine runs).  Gather path: three sharded dispatches —
    shift stage A, stage B, forward pipeline — with device-resident sharded
    intermediates (the stage split the gather formulation still requires;
    ``pipeline_model.rev_batch``).  Returns a callable over the 12 rev batch
    arrays.
    """
    from jax import shard_map as _shard_map

    from portello_tpu.kernels.shift_kernel import _shift_stage_a, _shift_stage_b

    if mm:
        from portello_tpu.models.pipeline_model import rev_chain_batch

        def chain_local(*a):
            return rev_chain_batch(
                *a, max_out=max_out, max_clusters=max_clusters, window=window,
                mm=mm, max_rows=max_rows,
            )

        return jax.jit(
            _shard_map(
                chain_local, mesh=mesh, in_specs=(P("data"),) * 12,
                out_specs=P("data"),
            )
        )

    sh = batch_sharding(mesh)

    stage_a = jax.jit(
        jax.vmap(
            lambda c, l, p, wb, rw, rq: _shift_stage_a(
                c, l, p, wb, rw, rq,
                max_clusters=max_clusters, window=window, mm=mm,
            )
        ),
        in_shardings=(sh,) * 6,
        out_shardings=sh,
    )
    from portello_tpu.models.pipeline_model import _rev_ops_bound

    # stage B's static width (the proven shifted-run bound) depends on the
    # batch's max_ops, known only at call time; cache one jitted program per
    # distinct width (pipeline_model.rev_batch semantics).
    stage_b_cache: dict = {}

    def get_stage_b(bound: int):
        if bound not in stage_b_cache:
            stage_b_cache[bound] = jax.jit(
                jax.vmap(
                    lambda c, l, p, s: _shift_stage_b(
                        c, l, p, s, window=window, max_out=bound, mm=mm
                    )
                ),
                in_shardings=(sh, sh, sh, sh),
                out_shardings=sh,
            )
        return stage_b_cache[bound]

    from jax import shard_map

    from portello_tpu.models.pipeline_model import fwd_batch

    def fwd_local(*a):
        return fwd_batch(
            *a, max_out=max_out, max_clusters=max_clusters, window=window,
            mm=mm, max_rows=max_rows,
        )

    fwd = jax.jit(
        shard_map(fwd_local, mesh=mesh, in_specs=(P("data"),) * 10,
                  out_specs=P("data"))
    )

    def run(ops, lens, n_ops, pos, win_base, contig_win, bk, bv, nb,
            ref_win, ref_base, read_seq):
        rel_pos = pos - win_base
        bound = _rev_ops_bound(ops.shape[1], max_out)
        st = stage_a(ops, lens, rel_pos, win_base, contig_win, read_seq)
        sh_codes, sh_lens, sh_n, sh_pos, sh_fb = get_stage_b(bound)(
            ops, lens, rel_pos, st
        )
        # max_ops-capped fwd leg (pipeline_model.rev_batch semantics): the
        # rev leg shares the fwd graph's shapes; spilling reads -> host
        n = ops.shape[1]
        sh_fb = sh_fb | (sh_n > n)
        out = fwd(
            sh_codes[:, :n], sh_lens[:, :n], sh_n, sh_pos + win_base,
            bk, bv, nb, ref_win, ref_base, read_seq,
        )
        out["fallback"] = out["fallback"] | sh_fb
        return out

    return run


def make_sharded_rev_step_fused(
    mesh: Mesh, *, max_out: int, max_clusters: int, window: int, mm: bool = False,
    max_rows: int | None = None,
):
    """Fused single-graph reverse step (compile-validation / single-dispatch)."""
    from portello_tpu.models.pipeline_model import _rev_item

    fn = jax.vmap(
        lambda *a: _rev_item(
            *a, max_out=max_out, max_clusters=max_clusters, window=window, mm=mm,
            max_rows=max_rows,
        )
    )
    sh = batch_sharding(mesh)
    in_sh = (sh,) * 12
    return jax.jit(fn, in_shardings=in_sh, out_shardings=sh)
