"""Simple Gaussian kernel generator (ref: src/SimpleGaussianKernel.py)."""

import numpy as np

from opticalflow_ri.ops.kernels_simple import (
    simple_gaussian_kernel, simple_gaussian_kernel_decimal,
)


def test_float_kernel_normalised_and_gaussian():
    s, k = simple_gaussian_kernel(7, 1.5)
    assert abs(k.sum() - 1.0) < 1e-15 and abs(float(s) - 1.0) < 1e-15
    # weight at integer offset j from centre is exp(-j^2 / (2 sigma^2))
    expected = np.exp(-np.arange(-3, 4) ** 2 / (2 * 1.5**2))
    np.testing.assert_allclose(k, expected / expected.sum(), rtol=1e-12)
    assert np.array_equal(k, k[::-1])


def test_binomial_fast_paths():
    for n, ref in [(3, [0.25, 0.5, 0.25]),
                   (5, [0.0625, 0.25, 0.375, 0.25, 0.0625]),
                   (9, np.array([4, 13, 30, 51, 60, 51, 30, 13, 4]) / 256.0)]:
        _, k = simple_gaussian_kernel_decimal(n, -1.0)
        np.testing.assert_array_equal(k, np.asarray(ref, np.float64))


def test_decimal_matches_float_path():
    _, kf = simple_gaussian_kernel(9, 2.0)
    _, kd = simple_gaussian_kernel_decimal(9, 2.0)
    np.testing.assert_allclose(kf, np.array([float(x) for x in kd]), rtol=1e-14)
