"""Multi-device batch-campaign streaming: shard_map('batch') x per-device
scan_pipeline.

The reference's real workload is SEQUENCES of image pairs
(ref: benchmark_of_methods.py:111-175, examples/*.py run one calibrated
config over a campaign of frames); this module spreads such a campaign
over several devices.  Each device runs the production single-device
streaming construct — ``compile.scan_pipeline``, one dispatch, single-pair
working set — on its own (K/N, H, W) slice of the campaign, with ZERO
collectives: the batch axis is embarrassingly parallel, so unlike the
spatial decompositions there is no halo to exchange and per-device numerics
are bit-identical to the single-device stream.

    mesh = make_mesh(8, batch=8)              # ('batch', 'y', 'x') = (8,1,1)
    fn = batch_sharded_scan("PyHSchunck_Fs3_4", mesh)
    us, vs = fn(im1_stack, im2_stack)         # (K, H, W), K % 8 == 0

``FlowBatchRunner(..., mesh=mesh)`` drives whole campaigns through this
construct with prefetch/checkpoint/failure isolation (harness/batch_runner).
"""

from __future__ import annotations

from functools import lru_cache

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def batch_spec() -> P:
    """Partition spec of a (K, H, W) campaign stack: leading axis over the
    mesh 'batch' axis, images whole per device."""
    return P("batch", None, None)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """NamedSharding for campaign stacks on ``mesh`` (use for device_put so
    the H2D upload lands pre-sharded, no gather/scatter at dispatch)."""
    return NamedSharding(mesh, batch_spec())


@lru_cache(maxsize=None)
def batch_sharded_scan(name: str, mesh: Mesh):
    """Jitted (im1s, im2s) -> (us, vs) over (K, H, W) stacks, K sharded over
    the mesh 'batch' axis; each device scans the full pipeline over its
    local slice.  K must be a multiple of the batch axis size (pad the
    ragged tail; the runner does).

    A 1-way batch axis short-circuits to the plain ``scan_pipeline`` — the
    decomposition is the identity there."""
    from opticalflow_ri.compile import pipeline_fn, scan_pipeline

    if mesh.shape["batch"] == 1:
        return scan_pipeline(name)

    fn = pipeline_fn(name)
    spec = batch_spec()

    def local_scan(im1s, im2s):
        def step(carry, pair):
            u, v = fn(pair[0], pair[1])
            return carry, (u, v)

        _, (us, vs) = jax.lax.scan(step, None, (im1s, im2s))
        return us, vs

    f = shard_map(local_scan, mesh=mesh, in_specs=(spec, spec),
                  out_specs=(spec, spec), check_vma=False)
    return jax.jit(f)
