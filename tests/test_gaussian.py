"""Calibrated Gaussian filter parity: kernel weights and full filter."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.ops.gaussian import prepare_gaussian_kernel, gaussian_filter_px
from opticalflow_ri.oracle.gaussian import gaussian_filter_px as oracle_filter


def test_kernel_weights_truncated_sigma():
    # The driver's calibrated quirk: sigma=3.4 with a 3-px kernel.
    k = prepare_gaussian_kernel(3.4, 3)
    assert k.dtype == np.float32
    assert k.shape == (3,)
    np.testing.assert_allclose(k.sum(), 1.0, rtol=1e-6)
    assert k[0] == k[2]  # symmetric taps
    assert k[1] > k[0]


def test_kernel_weights_match_reference_formula():
    for sigma, n in ((3.4, 3), (2.0, 3), (0.48, 5)):
        xs = np.arange(-n / 2, n / 2, 1, dtype=int)
        ref = np.empty(n, np.float32)
        ref[:] = 1.0 / np.sqrt(2 * np.pi * sigma**2) * np.exp(-(xs**2) / (2 * sigma**2))
        ref /= ref.sum()
        np.testing.assert_array_equal(prepare_gaussian_kernel(sigma, n), ref)


def test_filter_matches_oracle():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 48)).astype(np.float32)
    got = np.asarray(gaussian_filter_px(jnp.asarray(img), 3.4, 3))
    want = oracle_filter(img, 3.4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_bit_exact_kernels():
    from opticalflow_ri.ops.kernels_bitexact import get_gaussian_kernel_bit_exact

    # binomial fast paths
    _, k3 = get_gaussian_kernel_bit_exact(3, 0.0)
    np.testing.assert_array_equal(k3, [0.25, 0.5, 0.25])
    _, k5 = get_gaussian_kernel_bit_exact(5, 0.0)
    np.testing.assert_array_equal(k5, [0.0625, 0.25, 0.375, 0.25, 0.0625])

    # positive sigma is ignored: kernel depends only on n
    _, a = get_gaussian_kernel_bit_exact(33, 4.95)
    _, b = get_gaussian_kernel_bit_exact(33, 1.0)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(), 1.0, atol=1e-12)
    assert a.shape == (33,)
    # negative sigma is honoured
    _, c = get_gaussian_kernel_bit_exact(33, -4.95)
    assert not np.array_equal(a, c)
