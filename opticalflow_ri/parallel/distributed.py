"""Multi-host execution helpers.

The reference is single-process (SURVEY.md section 2.4); this module is the
multi-host entry point: initialise ``jax.distributed``, build a global ('batch', 'y', 'x') mesh spanning every
chip, and construct globally-sharded arrays from per-host image shards.

Typical multi-host launch (same program on every host):

    from opticalflow_ri.parallel import distributed as dist
    dist.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = dist.global_mesh(batch=jax.process_count())
    pairs = dist.shard_batch_global(mesh, local_im1, local_im2)
    u, v, err = batched_hs_pipeline(mesh, *pairs)
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opticalflow_ri.parallel.mesh import mesh_shape_for


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialise jax.distributed.  With no arguments, relies on JAX's
    cluster auto-detection (e.g. a SLURM or Open MPI launch); on a machine
    that no scheduler describes, pass the coordinator address, process
    count and process id explicitly."""
    # NB: must not touch the backend before jax.distributed.initialize();
    # jax.process_count()/jax.devices() would initialise XLA and make
    # initialization fail.  is_initialized() is backend-free.
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(batch: int = 1) -> Mesh:
    """('batch', 'y', 'x') mesh over every device of every host."""
    devices = jax.devices()
    shape = mesh_shape_for(len(devices), batch=batch)
    return Mesh(np.array(devices).reshape(shape), ("batch", "y", "x"))


def shard_batch_global(mesh: Mesh, *host_local_arrays, global_shape=None):
    """Assemble per-host (B_local, H, W) arrays into globally-sharded arrays
    on the ('batch', 'y', 'x') mesh via make_array_from_process_local_data.

    ``global_shape``: pass explicitly when the host-local block is a SPATIAL
    slice (the y/x mesh axes span processes) rather than a batch slice —
    the default inference assumes only the leading axis differs per host."""
    sharding = NamedSharding(mesh, P("batch", "y", "x"))
    out = []
    for arr in host_local_arrays:
        arr = np.asarray(arr, np.float32)
        out.append(jax.make_array_from_process_local_data(
            sharding, arr, global_shape))
    return tuple(out)
