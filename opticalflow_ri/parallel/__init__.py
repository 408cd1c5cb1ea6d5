"""Multi-device execution: device meshes, halo exchange, sharded solvers.

The reference is strictly single-process/single-device (SURVEY.md section 2.3)
— this package is the new first-class scaling layer:

  * spatial domain decomposition: a 2-D (y, x) mesh over image tiles with
    ``lax.ppermute`` neighbour halo exchange per stencil iteration — the
    stencil analog of tensor/sequence/context parallelism;
  * batch data parallelism over image pairs (the ``batch`` mesh axis);
  * global reductions (error norms, image maxima) as ``psum``/``pmax``
    collectives;
  * multi-host entry points via ``jax.distributed``.
"""

from opticalflow_ri.parallel.mesh import make_mesh, mesh_shape_for
from opticalflow_ri.parallel.halo import exchange_halo
from opticalflow_ri.parallel.sharded import (
    hs_solve_sharded,
    liu_shen_solve_sharded,
    batched_hs_pipeline,
)
from opticalflow_ri.parallel.batch_stream import (
    batch_sharded_scan,
    batch_sharding,
)

__all__ = [
    "make_mesh", "mesh_shape_for", "exchange_halo",
    "hs_solve_sharded", "liu_shen_solve_sharded", "batched_hs_pipeline",
    "batch_sharded_scan", "batch_sharding",
]
