"""Resampler parity: PIL bicubic/bilinear and RectBivariateSpline equivalents."""

import numpy as np
import jax.numpy as jnp
import PIL
from PIL import Image

from opticalflow_ri.ops.resize import pil_resize, spline_upsample


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _pil(im, out_hw, method):
    m = PIL.Image.BICUBIC if method == "bicubic" else PIL.Image.BILINEAR
    return np.array(Image.fromarray(im).resize((out_hw[1], out_hw[0]), m))


def test_bicubic_downscale_matches_pil():
    im = _rand((64, 96))
    for out in ((32, 48), (21, 33), (64, 96)):
        got = np.asarray(pil_resize(jnp.asarray(im), out, "bicubic"))
        want = _pil(im, out, "bicubic")
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_bicubic_upscale_matches_pil():
    im = _rand((24, 36), 5)
    got = np.asarray(pil_resize(jnp.asarray(im), (48, 72), "bicubic"))
    want = _pil(im, (48, 72), "bicubic")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_bilinear_matches_pil():
    im = _rand((40, 56), 2)
    for out in ((20, 28), (13, 17), (80, 112)):
        got = np.asarray(pil_resize(jnp.asarray(im), out, "bilinear"))
        want = _pil(im, out, "bilinear")
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_spline_upsample_matches_scipy():
    from scipy.interpolate import RectBivariateSpline

    f = np.cumsum(_rand((24, 20), 3), axis=0) / 10.0
    out_h, out_w = 48, 40
    got = np.asarray(spline_upsample(jnp.asarray(f), (out_h, out_w)))

    ys_in = np.arange(24) / np.float32(24)
    xs_in = np.arange(20) / np.float32(20)
    ys_out = np.arange(out_h) / np.float32(out_h)
    xs_out = np.arange(out_w) / np.float32(out_w)
    want = np.float32(RectBivariateSpline(ys_in, xs_in, f)(ys_out, xs_out))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)
