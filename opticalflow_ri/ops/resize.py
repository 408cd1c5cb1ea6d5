"""Resampling with exact reference parity, as precomputed matmuls.

The reference uses three distinct resamplers, each with its own semantics
(SURVEY.md "hard parts" #1):

  * PIL BICUBIC  — pyramid image downsizing (ref: src/GenericPyramidalOpticalFlow.py:67-68)
  * PIL BILINEAR — Farneback internal pyramid image/flow resizing
                   (ref: src/Farneback_PyCL.py:62-63)
  * scipy RectBivariateSpline — inter-level flow upsampling
                   (ref: src/GenericPyramidalOpticalFlow.py:152-162)

All three are *linear* operators, and separable (tensor-product) per axis.  We
therefore precompute, on host and once per (in_size, out_size) pair, the exact
per-axis coefficient matrices — reproducing Pillow's ``precompute_coeffs``
arithmetic in float64 for the PIL modes, and extracting the FITPACK spline
operator for the spline mode — and apply them on device as two matmuls:

    out = R_v @ (img @ R_h^T)

This is bit-faithful in the weights (identical support windows, identical
normalisation) and turns the awkward gather-style resampling into dense
matmuls.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Pillow filter kernels (float64, same polynomials as Pillow's Resample.c)
# ---------------------------------------------------------------------------

def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


_PIL_FILTERS = {
    "bilinear": (_bilinear_filter, 1.0),
    "bicubic": (_bicubic_filter, 2.0),
}


@lru_cache(maxsize=None)
def pil_resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 coefficient matrix replicating Pillow's
    ``precompute_coeffs`` (antialias support widening on downscale, half-pixel
    centres, per-output-pixel renormalisation)."""
    filt, support0 = _PIL_FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = int(center - support + 0.5)
        if xmin < 0:
            xmin = 0
        xmax = int(center + support + 0.5)
        if xmax > in_size:
            xmax = in_size
        w = np.array(
            [filt((x - center + 0.5) * ss) for x in range(xmin, xmax)],
            dtype=np.float64,
        )
        total = w.sum()
        if total != 0.0:
            w /= total
        mat[o, xmin:xmax] = w
    return mat.astype(np.float32)


def pil_resize(img: jnp.ndarray, out_hw: tuple, method: str) -> jnp.ndarray:
    """PIL-equivalent resize of the trailing 2 dims to ``(out_h, out_w)``.

    Mirrors ``Image.resize((w, h), PIL.Image.BICUBIC/BILINEAR)`` on mode-F
    images as used by the reference's ``imresize`` helpers."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return img
    rv = jnp.asarray(pil_resize_matrix(in_h, out_h, method))
    rh = jnp.asarray(pil_resize_matrix(in_w, out_w, method))
    # Pillow resamples horizontally first, then vertically.  HIGHEST precision:
    # these matmuls define calibrated resampling weights, so they must run at
    # full float32 accuracy, never in bf16 or TF32.
    tmp = jnp.einsum("...hw,Ww->...hW", img, rh, precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("...hW,Hh->...HW", tmp, rv, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# RectBivariateSpline-equivalent flow upsampling
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def spline_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) operator of the interpolating cubic FITPACK spline
    on the reference's normalised grids ``arange(n)/float32(n)``
    (ref: src/GenericPyramidalOpticalFlow.py:155-162).

    Extracted by fitting the spline to the identity matrix: an interpolating
    tensor-product spline evaluated at its own nodes along one axis reduces to
    the 1-D evaluation operator along the other axis.
    """
    from scipy.interpolate import RectBivariateSpline

    pos_in = np.arange(in_size) / np.float32(in_size)
    pos_out = np.arange(out_size) / np.float32(out_size)
    sp = RectBivariateSpline(pos_in, pos_in, np.eye(in_size))
    return np.float32(sp(pos_out, pos_in))


def spline_upsample(field: jnp.ndarray, out_hw: tuple) -> jnp.ndarray:
    """Upsample a flow field exactly as the reference's spline interpolation,
    as two device matmuls."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = field.shape[-2], field.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return field
    rv = jnp.asarray(spline_resize_matrix(in_h, out_h))
    rh = jnp.asarray(spline_resize_matrix(in_w, out_w))
    tmp = jnp.einsum("Hh,...hw->...Hw", rv, field, precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("...Hw,Ww->...HW", tmp, rh, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
