"""Multi-host glue (parallel/distributed.py) exercised for real.

jax.distributed supports a single-process cluster (coordinator on
localhost), which drives the exact code path a multi-host launch uses:
distributed service init -> global mesh -> make_array_from_process_local_data
-> sharded pipeline.  Runs in a subprocess because jax.distributed must be
initialised before ANY backend use, and the test session's backend is already
live.
"""

import os
import subprocess
import sys

import numpy as np

_CHILD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
import numpy as np
from opticalflow_ri.parallel import distributed as dist

# must work BEFORE any backend-initialising call (regression: the old guard
# called jax.process_count() first, which broke every real launch)
dist.initialize(coordinator_address="localhost:12421", num_processes=1,
                process_id=0)
assert jax.distributed.is_initialized()
assert jax.process_count() == 1

# second call is a no-op, not an error
dist.initialize()

mesh = dist.global_mesh(batch=2)
assert mesh.shape == {"batch": 2, "y": 2, "x": 2}, mesh.shape

rng = np.random.default_rng(0)
b1 = rng.uniform(0, 255, (4, 32, 32)).astype(np.float32)
b2 = rng.uniform(0, 255, (4, 32, 32)).astype(np.float32)
g1, g2 = dist.shard_batch_global(mesh, b1, b2)
assert g1.shape == (4, 32, 32)

from opticalflow_ri.parallel.sharded import batched_hs_pipeline
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.ops.gaussian import gaussian_filter_px
import jax.numpy as jnp

u, v, err = batched_hs_pipeline(mesh, g1, g2, niter=5)
assert np.isfinite(np.asarray(err)).all()

# parity vs the unsharded pipeline on the same host-local data
def one(a, b):
    f1 = gaussian_filter_px(a, 3.4, 3)
    f2 = gaussian_filter_px(b, 3.4, 3)
    z = jnp.zeros_like(f1)
    return hs_solve(f1, f2, 21.0, 5, z, z)[:2]

ur, vr = jax.jit(jax.vmap(one))(jnp.asarray(b1), jnp.asarray(b2))
aee = float(np.mean(np.hypot(np.asarray(u) - np.asarray(ur),
                             np.asarray(v) - np.asarray(vr))))
assert aee < 1e-5, aee
print("DIST_OK", aee)
"""


def test_distributed_single_process_cluster():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=env, capture_output=True,
        text=True, timeout=240, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert "DIST_OK" in out.stdout, f"stdout={out.stdout}\nstderr={out.stderr}"


_CHILD2 = r"""
import sys
pid = int(sys.argv[1])
port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
import numpy as np
from opticalflow_ri.parallel import distributed as dist

dist.initialize(coordinator_address=f"localhost:{port}", num_processes=2,
                process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

# batch=1 -> ('batch','y','x') = (1, 2, 4): the 'y' axis SPANS the two
# processes, so every Jacobi halo exchange crosses the process boundary —
# the DCN code path, where process-local arrays actually differ.
mesh = dist.global_mesh(batch=1)
assert mesh.shape == {"batch": 1, "y": 2, "x": 4}, mesh.shape

rng = np.random.default_rng(0)  # same seed on both hosts: full ref on host
b1 = rng.uniform(0, 255, (1, 64, 64)).astype(np.float32)
b2 = rng.uniform(0, 255, (1, 64, 64)).astype(np.float32)

# this process holds only its y-half; assembly must produce the global array
lo, hi = pid * 32, (pid + 1) * 32
g1, g2 = dist.shard_batch_global(mesh, b1[:, lo:hi, :], b2[:, lo:hi, :],
                                 global_shape=(1, 64, 64))
assert g1.shape == (1, 64, 64)

from opticalflow_ri.parallel.sharded import batched_hs_pipeline

u, v, err = batched_hs_pipeline(mesh, g1, g2, niter=5)
assert np.isfinite(np.asarray(err)).all()

# parity per addressable shard vs the single-process reference (no process
# can address the full output; each checks exactly its local tiles)
import jax.numpy as jnp
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.ops.gaussian import gaussian_filter_px

a = gaussian_filter_px(jnp.asarray(b1[0]), 3.4, 3)
b = gaussian_filter_px(jnp.asarray(b2[0]), 3.4, 3)
z = jnp.zeros_like(a)
ur, vr, _ = hs_solve(a, b, 21.0, 5, z, z)
ur = np.asarray(ur)[None]
vr = np.asarray(vr)[None]

checked = 0
for arr, ref in ((u, ur), (v, vr)):
    for sh in arr.addressable_shards:
        diff = float(np.max(np.abs(np.asarray(sh.data) - ref[sh.index])))
        assert diff < 1e-5, (sh.index, diff)
        checked += 1
assert checked == 8, checked  # 4 local devices x (u, v)
print("DIST2_OK", pid, checked)
"""


def test_distributed_two_process_cluster():
    """A REAL 2-process CPU cluster (4 devices each): spatial sharding spans
    the process boundary, so halo ppermutes ride the cross-process path and
    per-host shard assembly is exercised where local arrays actually differ
    (round-4 verdict #7)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    port = str(12500 + os.getpid() % 1000)
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD2, str(pid), port], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=cwd,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0 and "DIST2_OK" in out, f"rc={rc}\nstdout={out}\nstderr={err}"
