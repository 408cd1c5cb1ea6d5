"""Warping parity against the oracle implementation."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.ops.warp import bilinear_warp_rounded, symmetric_warp_pair
from opticalflow_ri.oracle.pyramid import bilinear_warp_rounded as oracle_warp


def test_rounded_bilinear_warp_matches_oracle():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (32, 40)).astype(np.float32)
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    # fractional displacements incl. exact halves (round-half-even sensitive)
    dy = rng.uniform(-3, 3, img.shape).astype(np.float32)
    dx = rng.uniform(-3, 3, img.shape).astype(np.float32)
    dy[::4, ::4] = 0.5
    dx[::5, ::5] = -1.5

    got = np.asarray(bilinear_warp_rounded(jnp.asarray(img), jnp.asarray(ys + dy), jnp.asarray(xs + dx)))
    want = oracle_warp(img, ys + dy, xs + dx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_symmetric_pair_warp():
    rng = np.random.default_rng(1)
    im1 = rng.uniform(0, 255, (24, 24)).astype(np.float32)
    im2 = rng.uniform(0, 255, (24, 24)).astype(np.float32)
    u = rng.uniform(-2, 2, im1.shape).astype(np.float32)
    v = rng.uniform(-2, 2, im1.shape).astype(np.float32)

    w1, w2 = symmetric_warp_pair(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u), jnp.asarray(v))

    h, wd = im1.shape
    ys, xs = np.mgrid[0:h, 0:wd].astype(np.float32)
    ow1 = oracle_warp(im1, ys - v / 2.0, xs - u / 2.0)
    ow2 = oracle_warp(im2, ys + v / 2.0, xs + u / 2.0)
    np.testing.assert_allclose(np.asarray(w1), ow1, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(w2), ow2, rtol=1e-5, atol=1e-3)
