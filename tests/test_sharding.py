"""Sharded execution correctness: N-way spatial sharding must reproduce the
single-device solver (halo-exchange oracle, SURVEY.md section 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from opticalflow_ri.parallel import (
    make_mesh, mesh_shape_for, hs_solve_sharded, liu_shen_solve_sharded,
    batched_hs_pipeline,
)
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.models.liu_shen import liu_shen_solve


needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_mesh_shape_factoring():
    assert mesh_shape_for(8) == (1, 2, 4)
    assert mesh_shape_for(8, batch=2) == (2, 2, 2)
    assert mesh_shape_for(4) == (1, 2, 2)
    assert mesh_shape_for(1) == (1, 1, 1)


@needs_devices
def test_hs_sharded_matches_single_device(piv_pair_medium):
    im1, im2, _, _ = piv_pair_medium
    z = np.zeros_like(im1)
    mesh = make_mesh(8)  # (1, 2, 4) spatial decomposition

    u1, v1, e1 = hs_solve(jnp.asarray(im1), jnp.asarray(im2), 21.0, 50, jnp.asarray(z), jnp.asarray(z))
    u8, v8, e8 = hs_solve_sharded(mesh, jnp.asarray(im1), jnp.asarray(im2), 21.0, 50, jnp.asarray(z), jnp.asarray(z))

    np.testing.assert_allclose(np.asarray(u8), np.asarray(u1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(e8), float(e1), rtol=1e-4, atol=1e-7)


@needs_devices
def test_hs_sharded_tblocked_matches_single_device(piv_pair_medium):
    """Temporal-blocked halo exchange (T iterations per ppermute round, T-deep
    mirror ring at global borders) == per-iteration exchange == unsharded,
    incl. a remainder outer step (50 % 8 != 0)."""
    from opticalflow_ri.parallel.sharded import hs_solve_sharded_tblocked

    im1, im2, _, _ = piv_pair_medium
    z = jnp.zeros(im1.shape, jnp.float32)
    mesh = make_mesh(8)

    u1, v1, e1 = hs_solve(jnp.asarray(im1), jnp.asarray(im2), 21.0, 50, z, z)
    ut, vt, et = hs_solve_sharded_tblocked(
        mesh, jnp.asarray(im1), jnp.asarray(im2), 21.0, 50, z, z, t_block=8)

    np.testing.assert_allclose(np.asarray(ut), np.asarray(u1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vt), np.asarray(v1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(et), float(e1), rtol=1e-4, atol=1e-7)


def test_liu_shen_sharded_matches_single_device(piv_pair_medium):
    im1, im2, _, _ = piv_pair_medium
    z = np.zeros_like(im1)
    mesh = make_mesh(8)

    u1, v1, e1 = liu_shen_solve(jnp.asarray(im1), jnp.asarray(im2), 1000.0, jnp.asarray(z), jnp.asarray(z))
    u8, v8, e8 = liu_shen_solve_sharded(mesh, jnp.asarray(im1), jnp.asarray(im2), 1000.0, jnp.asarray(z), jnp.asarray(z))

    np.testing.assert_allclose(np.asarray(u8), np.asarray(u1), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), rtol=1e-4, atol=1e-5)


@needs_devices
def test_batched_pipeline_dp_plus_spatial(piv_pair_medium):
    from opticalflow_ri.ops.gaussian import gaussian_filter_px

    im1, im2, _, _ = piv_pair_medium
    batch1 = np.stack([im1, im1 * 0.5])
    batch2 = np.stack([im2, im2 * 0.5])
    mesh = make_mesh(8, batch=2)  # dp=2 x (2,2) spatial

    u, v, err = batched_hs_pipeline(mesh, jnp.asarray(batch1), jnp.asarray(batch2), niter=20)
    assert np.asarray(u).shape == batch1.shape
    assert np.asarray(err).shape == (2,)

    # must equal the unsharded pipeline per batch element
    f1 = gaussian_filter_px(jnp.asarray(im1), 3.4, 3)
    f2 = gaussian_filter_px(jnp.asarray(im2), 3.4, 3)
    z = jnp.zeros_like(f1)
    u_ref, v_ref, e_ref = hs_solve(f1, f2, 21.0, 20, z, z)
    np.testing.assert_allclose(np.asarray(u)[0], np.asarray(u_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(np.asarray(err)[0]), float(e_ref), rtol=1e-4, atol=1e-7)


@needs_devices
def test_halo_exchange_boundary_rules():
    """exchange_halo under all 4 border modes == whole-array padding."""
    from opticalflow_ri.parallel.halo import exchange_halo
    from opticalflow_ri.ops.padding import pad2d
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from functools import partial

    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    mesh = make_mesh(8)

    for mode in ("mirror", "symmetric", "nearest", "constant"):
        f = shard_map(
            partial(exchange_halo, halo=2, mode=mode),
            mesh=mesh, in_specs=P("y", "x"), out_specs=P("y", "x"),
            check_vma=False,
        )
        got = jax.jit(f)(jnp.asarray(x))
        # sharded padded tiles concatenate into... the interior halos overlap,
        # so instead compare against slicing the globally padded array
        want = np.asarray(pad2d(jnp.asarray(x), 2, mode))
        got = np.asarray(got)
        # reconstruct: tile (i,j) of got is (16/2+4) x (64/4+4); check tile (0,0)
        assert got.shape == (2 * (16 + 4), 4 * (16 + 4))
        t00 = got[:20, :20]
        np.testing.assert_allclose(t00, want[:20, :20], atol=1e-6)
        t_last = got[-20:, -20:]
        np.testing.assert_allclose(t_last, want[-20:, -20:], atol=1e-6)
