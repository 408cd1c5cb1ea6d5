"""Multi-device batch-campaign streaming: shard_map('batch') x per-device
scan_pipeline must match the single-device stream exactly (the decomposition
is embarrassingly parallel — zero collectives, bit-identical numerics)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _batch_mesh(n):
    devs = np.array(jax.devices()[:n]).reshape(n, 1, 1)
    return Mesh(devs, ("batch", "y", "x"))


def _stack(n, shape=(48, 64)):
    from opticalflow_ri.utils.synthetic import particle_image_pair

    im1s, im2s = [], []
    for i in range(n):
        a, b, _, _ = particle_image_pair(shape=shape, seed=i)
        im1s.append(a)
        im2s.append(b)
    return (jnp.asarray(np.stack(im1s), jnp.float32),
            jnp.asarray(np.stack(im2s), jnp.float32))


@needs_devices
def test_batch_sharded_scan_matches_single_device_stream():
    from opticalflow_ri.parallel.batch_stream import (
        batch_sharded_scan, batch_sharding,
    )
    from opticalflow_ri.compile import scan_pipeline

    mesh = _batch_mesh(8)
    im1s, im2s = _stack(8)
    sh = batch_sharding(mesh)
    us, vs = batch_sharded_scan("HS_Fs0_0", mesh)(
        jax.device_put(im1s, sh), jax.device_put(im2s, sh))
    ur, vr = scan_pipeline("HS_Fs0_0")(im1s, im2s)
    np.testing.assert_array_equal(np.asarray(us), np.asarray(ur))
    np.testing.assert_array_equal(np.asarray(vs), np.asarray(vr))


@needs_devices
def test_batch_sharded_scan_one_way_shortcut():
    """A 1-way batch axis short-circuits to the plain scan_pipeline (nothing
    to decompose; the single-device construct is the A/B baseline)."""
    from opticalflow_ri.parallel.batch_stream import batch_sharded_scan
    from opticalflow_ri.compile import scan_pipeline

    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                 ("batch", "y", "x"))
    assert batch_sharded_scan("HS_Fs0_0", mesh1) is scan_pipeline("HS_Fs0_0")


@needs_devices
def test_batch_runner_with_mesh(tmp_path):
    """FlowBatchRunner drives a campaign across the mesh batch axis and
    produces the same flows as the single-device runner."""
    from PIL import Image
    from opticalflow_ri.harness.batch_runner import FlowBatchRunner
    from opticalflow_ri.utils.synthetic import particle_image_pair

    pairs = []
    for i in range(6):
        a, b, _, _ = particle_image_pair(shape=(48, 48), seed=i)
        p1 = str(tmp_path / f"f{i}_0.tif")
        p2 = str(tmp_path / f"f{i}_1.tif")
        Image.fromarray(a.astype(np.uint8)).save(p1)
        Image.fromarray(b.astype(np.uint8)).save(p2)
        pairs.append((f"pair{i}", p1, p2))

    mesh = _batch_mesh(4)
    out_m = str(tmp_path / "out_mesh")
    out_s = str(tmp_path / "out_single")
    st_m = FlowBatchRunner("HS_Fs0_0", batch_size=4, output_dir=out_m,
                           mesh=mesh).run(pairs)
    st_s = FlowBatchRunner("HS_Fs0_0", batch_size=4,
                           output_dir=out_s).run(pairs)
    assert sorted(st_m["done"]) == sorted(st_s["done"])
    assert st_m["failed"] == []

    import scipy.io

    for name, _, _ in pairs:
        mm = scipy.io.loadmat(os.path.join(out_m, f"{name}.mat"))
        ms = scipy.io.loadmat(os.path.join(out_s, f"{name}.mat"))
        np.testing.assert_array_equal(mm["velocities"]["u"][0, 0],
                                      ms["velocities"]["u"][0, 0])
        np.testing.assert_array_equal(mm["velocities"]["v"][0, 0],
                                      ms["velocities"]["v"][0, 0])


@needs_devices
def test_batch_runner_mesh_validation():
    from opticalflow_ri.harness.batch_runner import FlowBatchRunner

    mesh = _batch_mesh(4)
    with pytest.raises(ValueError):
        FlowBatchRunner("HS_Fs0_0", batch_size=3, mesh=mesh,
                        output_dir="/tmp/_ofri_nope")
    with pytest.raises(ValueError):
        FlowBatchRunner("HS_Fs0_0", batch_size=4, mesh=mesh,
                        pipeline="batched", output_dir="/tmp/_ofri_nope")


@needs_devices
def test_batched_gspmd_route_warns():
    """The vmapped GSPMD batch route (no kernels) now announces its cliff."""
    from opticalflow_ri.parallel.auto import auto_sharded_pipeline
    from opticalflow_ri.parallel.mesh import make_mesh

    with pytest.warns(UserWarning, match="batch_sharded_scan"):
        auto_sharded_pipeline("HS_Fs0_0", make_mesh(8), batch=True)
