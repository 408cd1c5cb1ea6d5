"""Oracle for the calibrated separable Gaussian filter
(semantics of ref: src/gaussian_filter.py — float32 sampled kernel,
symmetric border, rows filtered before columns)."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

from opticalflow_ri.ops.gaussian import prepare_gaussian_kernel


def gaussian_filter_px(image: np.ndarray, sigma: float, kernel_size_px: int) -> np.ndarray:
    kernel = prepare_gaussian_kernel(sigma, kernel_size_px)
    # scipy 'reflect' == symmetric border (edge repeated), matching the
    # reference's explicit edge-repeating pad loops.
    out = correlate1d(image.astype(np.float32), kernel, axis=1, mode="reflect")
    out = correlate1d(out, kernel, axis=0, mode="reflect")
    return out.astype(np.float32)


def gaussian_filter(image: np.ndarray, sigma: float, truncate: float) -> np.ndarray:
    kernel_size_px = 2 * int(truncate * sigma + 0.5) + 1
    return gaussian_filter_px(image, sigma, kernel_size_px)
