"""Farneback parity: the single-program XLA pipeline vs the oracle port."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.models.farneback import (
    farneback_solve, poly_expansion, update_matrices, update_flow,
    gaussian_blur, FarnebackAdapter,
)
from opticalflow_ri.oracle import farneback as ofb
from conftest import aee


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def test_poly_expansion_matches_oracle():
    img = _rand((48, 64))
    for n, sigma in ((7, 1.5), (5, 1.1)):
        got = np.asarray(poly_expansion(jnp.asarray(img), n, sigma))
        want = ofb.poly_expansion(img, n, sigma)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gaussian_blur_matches_oracle():
    img = _rand((40, 52), 1)
    got = np.asarray(gaussian_blur(jnp.asarray(img), 7, 0.8))
    want = ofb.gaussian_blur(img, 7, 0.8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_update_matrices_and_flow_match_oracle():
    rng = np.random.default_rng(2)
    h, w = 36, 44
    r0 = rng.normal(size=(5, h, w)).astype(np.float32)
    r1 = rng.normal(size=(5, h, w)).astype(np.float32)
    fx = rng.uniform(-3, 3, (h, w)).astype(np.float32)
    fy = rng.uniform(-3, 3, (h, w)).astype(np.float32)

    got_m = np.asarray(update_matrices(jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(r0), jnp.asarray(r1)))
    want_m = ofb.update_matrices(fx, fy, r0, r1)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-4, atol=1e-4)

    gfx, gfy = update_flow(jnp.asarray(want_m))
    wfx, wfy = ofb.update_flow(want_m)
    np.testing.assert_allclose(np.asarray(gfx), wfx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gfy), wfy, rtol=1e-4, atol=1e-5)


def test_farneback_single_level_matches_oracle(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v = farneback_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z))
    ou, ov = ofb.farneback_compute(im1, im2, z, z)
    assert aee(u, v, ou, ov) < 1e-3


def test_farneback_internal_pyramid_matches_oracle(piv_pair_medium):
    im1, im2, _, _ = piv_pair_medium
    z = np.zeros_like(im1)
    u, v = farneback_solve(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z), pyr_levels=2
    )
    ou, ov = ofb.farneback_compute(im1, im2, z, z, pyr_levels=2)
    assert aee(u, v, ou, ov) < 2e-3


def test_farneback_recovers_flow(piv_pair_medium):
    im1, im2, u_true, v_true = piv_pair_medium
    z = np.zeros_like(im1)
    u, v = farneback_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z))
    c = 16
    err = aee(np.asarray(u)[c:-c, c:-c], np.asarray(v)[c:-c, c:-c],
              u_true[c:-c, c:-c], v_true[c:-c, c:-c])
    assert err < 0.7, err


def test_adapter_protocol(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    ad = FarnebackAdapter(windowSize=33, Niters=2, polyN=7, polySigma=1.5)
    z = np.zeros_like(im1)
    u, v, err = ad.compute(im1, im2, z, z)
    assert err == "Unknown"  # reference returns the literal string (:602)
    assert ad.getGenericPyramidalDefaults() == {"warping": False, "scaling": True}
    try:
        FarnebackAdapter(windowSize=32)
        assert False, "even windowSize must raise"
    except ValueError:
        pass


def test_farneback_box_filter_path(piv_pair_small):
    """useGaussian=False exercises boxFilter5 (ref: optical_flow_farneback.cl:350-406)."""
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v = farneback_solve(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z),
        use_gaussian=False,
    )
    ou, ov = ofb.farneback_compute(im1, im2, z, z, use_gaussian=False)
    assert aee(u, v, ou, ov) < 1e-3


def test_farneback_nonhalf_pyr_scale(piv_pair_medium):
    """pyrScale=0.8 exercises the level-size rounding and blur-kernel sizing."""
    im1, im2, _, _ = piv_pair_medium
    z = np.zeros_like(im1)
    u, v = farneback_solve(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z),
        pyr_scale=0.8, pyr_levels=3,
    )
    ou, ov = ofb.farneback_compute(im1, im2, z, z, pyr_scale=0.8, pyr_levels=3)
    assert aee(u, v, ou, ov) < 2e-3


def test_farneback_poly5(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v = farneback_solve(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z),
        poly_n=5, poly_sigma=1.1,
    )
    ou, ov = ofb.farneback_compute(im1, im2, z, z, poly_n=5, poly_sigma=1.1)
    assert aee(u, v, ou, ov) < 1e-3


def test_farneback_odd_shapes():
    from opticalflow_ri.utils.synthetic import particle_image_pair

    im1, im2, _, _ = particle_image_pair(shape=(47, 61), seed=6, max_disp=1.5)
    z = np.zeros_like(im1)
    u, v = farneback_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z))
    ou, ov = ofb.farneback_compute(im1, im2, z, z)
    assert aee(u, v, ou, ov) < 1e-3
