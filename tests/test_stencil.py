"""Stencil primitives vs scipy.ndimage semantics."""

import numpy as np
import jax.numpy as jnp
from scipy.ndimage import convolve as filter2

from opticalflow_ri.ops.stencil import (
    correlate3x3,
    hs_derivatives,
    separable_correlate,
)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_correlate3x3_matches_ndimage_modes():
    x = _rand((17, 23))
    k = _rand((3, 3), 1)
    for ours, scipy_mode in (("mirror", "mirror"), ("nearest", "nearest"), ("constant", "constant")):
        got = np.asarray(correlate3x3(jnp.asarray(x), k, ours))
        # ndimage.convolve flips the kernel; flip ours to compare correlation.
        want = filter2(x, k[::-1, ::-1], mode=scipy_mode)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hs_derivatives_match_reference_formulas():
    from opticalflow_ri.oracle.horn_schunck import derivatives

    f0 = _rand((21, 19), 2)
    f1 = _rand((21, 19), 3)
    fx, fy, ft = hs_derivatives(jnp.asarray(f0), jnp.asarray(f1))
    ofx, ofy, oft = derivatives(f0, f1)
    np.testing.assert_allclose(np.asarray(fx), ofx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(fy), ofy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ft), oft, rtol=1e-5, atol=1e-6)


def test_separable_correlate_symmetric_border():
    from scipy.ndimage import correlate1d

    x = _rand((15, 12), 4)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    got = np.asarray(separable_correlate(jnp.asarray(x), k, "symmetric"))
    want = correlate1d(correlate1d(x, k, axis=1, mode="reflect"), k, axis=0, mode="reflect")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
