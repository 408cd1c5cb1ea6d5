"""Native IO runtime: C++ TIFF decode and MAT-5 writer vs the Python stack."""

import os

import numpy as np
import pytest

from opticalflow_ri.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native IO lib unavailable (no g++?)"
)


def _write_tiff(path, arr, bits=8):
    from PIL import Image

    if bits == 8:
        Image.fromarray(arr.astype(np.uint8)).save(path, compression=None)
    else:
        Image.fromarray(arr.astype(np.uint16)).save(path, compression=None)


def test_tiff_read_8bit(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 255, (37, 53)).astype(np.uint8)
    p = str(tmp_path / "a.tif")
    _write_tiff(p, arr)
    got = native.tiff_read(p)
    assert got is not None
    np.testing.assert_array_equal(got, arr.astype(np.float32))


def test_tiff_read_16bit(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 65535, (24, 31)).astype(np.uint16)
    p = str(tmp_path / "b.tif")
    _write_tiff(p, arr, bits=16)
    got = native.tiff_read(p)
    assert got is not None
    np.testing.assert_array_equal(got, arr.astype(np.float32))


def test_tiff_read_reference_image():
    p = "/root/reference/examples/testImages/Bits08/Ni06/parabolic01_0.tif"
    if not os.path.exists(p):
        pytest.skip("reference image unavailable")
    from opticalflow_ri.utils.io import load_image

    got = native.tiff_read(p)
    if got is None:
        pytest.skip("reference TIFF uses an unsupported layout")
    np.testing.assert_array_equal(got, load_image(p))


def test_batch_read(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    arrs = []
    for i in range(6):
        a = rng.integers(0, 255, (16, 20)).astype(np.uint8)
        p = str(tmp_path / f"{i}.tif")
        _write_tiff(p, a)
        paths.append(p)
        arrs.append(a)
    got = native.tiff_read_batch(paths)
    assert got is not None
    np.testing.assert_array_equal(got, np.stack(arrs).astype(np.float32))


def test_save_flow_roundtrip(tmp_path):
    import scipy.io

    rng = np.random.default_rng(3)
    u = rng.normal(size=(15, 22)).astype(np.float32)
    v = rng.normal(size=(15, 22)).astype(np.float32)
    p = str(tmp_path / "flow.mat")
    assert native.save_flow(p, u, v)
    m = scipy.io.loadmat(p)
    vel = m["velocities"]
    np.testing.assert_allclose(vel["u"][0, 0], u, rtol=1e-6)
    np.testing.assert_allclose(vel["v"][0, 0], v, rtol=1e-6)
    assert float(np.squeeze(vel["iaWidth"][0, 0])) == 1
    assert float(np.squeeze(m["parameters"]["imageHeight"][0, 0])) == 15
    assert float(np.squeeze(vel["margins"][0, 0]["top"][0, 0])) == 0
