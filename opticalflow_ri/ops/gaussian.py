"""Calibrated separable Gaussian pre-filter (ref: src/gaussian_filter.py).

The reference's filter is deliberately self-contained so results stay
calibrated: a float32 sampled-Gaussian kernel, renormalised, applied as a
separable direct convolution with a *symmetric* border (edge pixel repeated).
The driver calls it with deliberately truncated kernels (sigma=3.4 with a
3-px kernel — ref: src/GenericPyramidalOpticalFlow.py:374), which is a
calibration quirk we reproduce bit-for-bit in the kernel weights.

This implementation applies the same weights as a shift-and-accumulate
separable stencil (one fused pass per axis) instead of the reference's
per-row Numba loops (ref: src/gaussian_filter.py:24-45).  Unlike the
reference, nothing is mutated in place — functions are pure.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from opticalflow_ri.ops.stencil import separable_correlate


def prepare_gaussian_kernel(sigma: float, kernel_size_px: int) -> np.ndarray:
    """Float32 sampled-Gaussian kernel, exactly as the reference computes it
    (ref: src/gaussian_filter.py:47-52): taps at arange(-n/2, n/2) cast to int,
    float32 Gaussian formula, renormalised to unit sum in float32."""
    xs = np.arange(-kernel_size_px / 2, kernel_size_px / 2, 1, dtype=int)
    kernel = np.empty(kernel_size_px, dtype=np.float32)
    kernel[:] = (
        1.0 / np.sqrt(2.0 * np.pi * sigma**2) * np.exp(-(xs**2) / (2.0 * sigma**2))
    )
    kernel /= np.sum(kernel)
    return kernel


def gaussian_filter_px(image: jnp.ndarray, sigma: float, kernel_size_px: int) -> jnp.ndarray:
    """Separable Gaussian with an explicit kernel size in pixels
    (ref: src/gaussian_filter.py:92-94).  Pure — does not overwrite its input."""
    kernel = prepare_gaussian_kernel(sigma, kernel_size_px)
    return separable_correlate(image, kernel, "symmetric")


def gaussian_filter(image: jnp.ndarray, sigma: float, truncate: float) -> jnp.ndarray:
    """Separable Gaussian with scipy-style truncation radius
    (ref: src/gaussian_filter.py:87-90)."""
    kernel_size_px = 2 * int(truncate * sigma + 0.5) + 1
    return gaussian_filter_px(image, sigma, kernel_size_px)
