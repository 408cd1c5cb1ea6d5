"""The XLA multi-device paths against one device, on 8 virtual CPU devices:
the shard_map solvers with ppermute halos (per-iteration and
temporal-blocked) on 2-D, rows-only and batch-carrying meshes, and GSPMD
auto-sharded LK and Farneback pipelines on a rows-only mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from opticalflow_ri.compile import compiled_pipeline
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.models.liu_shen import liu_shen_solve
from opticalflow_ri.parallel.auto import auto_sharded_pipeline
from opticalflow_ri.parallel.sharded import (
    hs_solve_sharded, hs_solve_sharded_tblocked, liu_shen_solve_sharded,
)
from conftest import aee

MESHES = [(1, 2, 4), (1, 8, 1), (2, 2, 2)]


def _mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("batch", "y", "x"))


def _fields(shape, seed, lo=0.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 255, shape).astype(np.float32)
    b = rng.uniform(lo, 255, shape).astype(np.float32)
    u0 = rng.uniform(-1, 1, shape).astype(np.float32)
    v0 = rng.uniform(-1, 1, shape).astype(np.float32)
    return [jnp.asarray(x) for x in (a, b, u0, v0)]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_hs_sharded_nonzero_init(mesh_shape):
    a, b, u0, v0 = _fields((64, 128), 4)
    us, vs, es = hs_solve_sharded(_mesh(mesh_shape), a, b, 10.0, 25, u0, v0)
    ur, vr, er = hs_solve(a, b, 10.0, 25, u0, v0)
    assert aee(us, vs, np.asarray(ur), np.asarray(vr)) < 1e-5
    np.testing.assert_allclose(float(es), float(er), rtol=1e-4)


@pytest.mark.parametrize("mesh_shape,t_block", [((1, 2, 4), 8),
                                                ((1, 8, 1), 4)], ids=str)
def test_hs_sharded_tblocked_nonzero_init(mesh_shape, t_block):
    """T iterations per halo exchange, with a partial tail block."""
    a, b, u0, v0 = _fields((64, 128), 5)
    us, vs, es = hs_solve_sharded_tblocked(_mesh(mesh_shape), a, b, 15.0, 25,
                                           u0, v0, t_block=t_block)
    ur, vr, er = hs_solve(a, b, 15.0, 25, u0, v0)
    assert aee(us, vs, np.asarray(ur), np.asarray(vr)) < 1e-5
    np.testing.assert_allclose(float(es), float(er), rtol=1e-4)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_liu_shen_sharded_nonzero_init(mesh_shape):
    a, b, u0, v0 = _fields((128, 128), 7, lo=1.0)
    us, vs, es = liu_shen_solve_sharded(_mesh(mesh_shape), a, b, 10.0,
                                        u0 * 0.5, v0 * 0.5, max_iter=10)
    ur, vr, er = liu_shen_solve(a, b, 10.0, u0 * 0.5, v0 * 0.5, max_iter=10)
    np.testing.assert_allclose(np.asarray(us), np.asarray(ur), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(vr), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(es), float(er), rtol=1e-3)


@pytest.mark.parametrize("name", ["denseLK_Fs2_0", "Farneback_Fs0_0",
                                  "HS_Fs3_4"])
def test_auto_sharded_rows_only(name, piv_pair_medium):
    """GSPMD over a rows-only (1, 8, 1) mesh: (160, 128) frames split into
    20-row tiles, thinner than the LK window and the FB blur."""
    im1, im2, _, _ = piv_pair_medium
    u1, v1 = compiled_pipeline(name)(jnp.asarray(im1), jnp.asarray(im2))
    u8, v8 = auto_sharded_pipeline(name, _mesh((1, 8, 1)))(
        jnp.asarray(im1), jnp.asarray(im2))
    du = np.abs(np.asarray(u8) - np.asarray(u1))
    dv = np.abs(np.asarray(v8) - np.asarray(v1))
    if name == "denseLK_Fs2_0":
        assert ((du < 1e-3) & (dv < 1e-3)).mean() > 0.99
    assert float(np.mean(np.hypot(du, dv))) < 1e-4
