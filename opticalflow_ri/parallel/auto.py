"""Auto-sharded execution of whole pipelines over a device mesh (GSPMD).

Any calibrated configuration is traced as usual and annotated with a
('y', 'x') spatial sharding (optionally 'batch'); XLA's SPMD partitioner
inserts the halo exchanges and collectives: stencil shift-sums become
neighbour ppermutes, resize matmuls become collective matmuls, reductions
become all-reduces.

    mesh = make_mesh(4)
    fn = auto_sharded_pipeline("PyHSchunck_Fs3_4", mesh)
    U, V = fn(im1, im2)          # executes across all 4 devices

Numerical parity with the single-device run is asserted in tests.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opticalflow_ri.compile import pipeline_fn


def auto_sharded_pipeline(name: str, mesh: Mesh, batch: bool = False):
    """Jitted (im1, im2) -> (U, V) running SPMD over ``mesh``.

    ``batch=True`` expects (B, H, W) inputs and additionally shards the
    leading axis over the mesh's 'batch' axis.

    A single-device mesh short-circuits to the plain compiled pipeline —
    there is nothing to decompose.
    """
    if mesh.size == 1:
        from opticalflow_ri.compile import compiled_pipeline, scan_pipeline

        # scan_pipeline has the same (B, H, W)-stack contract as the batched
        # route
        return scan_pipeline(name) if batch else compiled_pipeline(name)

    spec = P("batch", "y", "x") if batch else P("y", "x")
    sharding = NamedSharding(mesh, spec)
    fn = pipeline_fn(name)
    if batch:
        import warnings

        warnings.warn(
            "auto_sharded_pipeline(batch=True) vmaps the whole pipeline and "
            "partitions it with GSPMD; for campaign streaming use "
            "parallel.batch_sharded_scan, which runs the single-device scan "
            "on every device with no collectives",
            stacklevel=2,
        )
        fn = jax.vmap(fn)

    def wrapped(im1, im2):
        im1 = jax.lax.with_sharding_constraint(im1, sharding)
        im2 = jax.lax.with_sharding_constraint(im2, sharding)
        u, v = fn(im1, im2)
        return (
            jax.lax.with_sharding_constraint(u, sharding),
            jax.lax.with_sharding_constraint(v, sharding),
        )

    return jax.jit(wrapped, in_shardings=(sharding, sharding))
