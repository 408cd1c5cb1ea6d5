"""Oracle Farneback polynomial-expansion optical flow
(semantics of ref: src/Farneback_PyCL.py + src/optical_flow_farneback.cl).

NumPy reimplementation written from the kernels' math:
  * polynomial expansion = separable correlations with the g/xg/xxg bases
    (replicate border), combined through the 6x6 Gram-inverse constants;
  * gaussianBlur / gaussianBlur5 use reflect-101 borders, boxFilter5 replicate;
  * updateMatrices bilinear-samples R1 at the flow-displaced position, blends
    with R0, applies the border attenuation ramp, and assembles the 5-plane
    normal-equation field M;
  * updateFlow solves the regularised (+1e-3) per-pixel 2x2 system;
  * the solver owns an internal pyramid (pyrScale 0.5, min level size 32)
    with PIL-BILINEAR flow/image resizing, independent of the generic driver.

Plane layout here is (5, H, W), mirroring the reference's 5-stacked-row-blocks.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d

import PIL
from PIL import Image

from opticalflow_ri.ops.kernels_bitexact import get_gaussian_kernel_bit_exact

BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0], np.float32)


def prepare_poly_gaussian(n: int, sigma: float):
    """Basis vectors g, xg, xxg and the four Gram-inverse constants
    (ref: src/Farneback_PyCL.py:124-172)."""
    if sigma < 1.19209289550781250000000000000000000e-7:
        sigma = n * 0.3

    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)

    G = np.zeros((6, 6), np.float64)
    gy = g.astype(np.float64)
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            w = gy[yy + n] * gy[xx + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[3, 3] += w * xx**4
            G[5, 5] += w * xx * xx * yy * yy
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (
        np.float32(inv[1, 1]), np.float32(inv[0, 3]),
        np.float32(inv[3, 3]), np.float32(inv[5, 5]),
    )


def poly_expansion(src: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """5-plane polynomial expansion (ref: optical_flow_farneback.cl:72-133)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = prepare_poly_gaussian(n, sigma)
    xg_odd = xg  # antisymmetric already (x*g)
    src = np.asarray(src, np.float32)

    ve = correlate1d(src, g, axis=0, mode="nearest")
    vo = correlate1d(src, xg_odd, axis=0, mode="nearest")
    vx2 = correlate1d(src, xxg, axis=0, mode="nearest")

    b1 = correlate1d(ve, g, axis=1, mode="nearest")
    b2 = correlate1d(ve, xg_odd, axis=1, mode="nearest")
    b4 = correlate1d(ve, xxg, axis=1, mode="nearest")
    b3 = correlate1d(vo, g, axis=1, mode="nearest")
    b6 = correlate1d(vo, xg_odd, axis=1, mode="nearest")
    b5 = correlate1d(vx2, g, axis=1, mode="nearest")

    return np.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ]).astype(np.float32)


def _full_kernel(n: int, sigma: float) -> np.ndarray:
    _, k = get_gaussian_kernel_bit_exact(n, sigma)
    return np.float32(k)


def gaussian_blur(src, smooth_size, sigma):
    k = _full_kernel(smooth_size, sigma)
    out = correlate1d(np.asarray(src, np.float32), k, axis=0, mode="mirror")
    return correlate1d(out, k, axis=1, mode="mirror")


def gaussian_blur5(m, smooth_size, sigma):
    k = _full_kernel(smooth_size, sigma)
    half = smooth_size // 2
    k = k[smooth_size // 2 - half : smooth_size // 2 + half + 1]
    out = correlate1d(np.asarray(m, np.float32), k, axis=1, mode="mirror")
    return correlate1d(out, k, axis=2, mode="mirror")


def box_filter5(m, ksize_half):
    k = np.ones(2 * ksize_half + 1, np.float32)
    out = correlate1d(np.asarray(m, np.float32), k, axis=1, mode="nearest")
    out = correlate1d(out, k, axis=2, mode="nearest")
    return out / np.float32((2 * ksize_half + 1) ** 2)


def update_matrices(flowx, flowy, r0, r1):
    """(ref: optical_flow_farneback.cl:256-348)."""
    _, rows, cols = r0.shape
    ys, xs = np.mgrid[0:rows, 0:cols]
    fx = xs + flowx
    fy = ys + flowy
    x1 = np.floor(fx).astype(np.int64)
    y1 = np.floor(fy).astype(np.int64)
    fx = (fx - x1).astype(np.float32)
    fy = (fy - y1).astype(np.float32)

    inside = (x1 >= 0) & (y1 >= 0) & (x1 < cols - 1) & (y1 < rows - 1)
    x1c = np.clip(x1, 0, cols - 2)
    y1c = np.clip(y1, 0, rows - 2)

    a00 = (1 - fx) * (1 - fy)
    a01 = fx * (1 - fy)
    a10 = (1 - fx) * fy
    a11 = fx * fy

    def samp(plane):
        return (
            a00 * plane[y1c, x1c] + a01 * plane[y1c, x1c + 1]
            + a10 * plane[y1c + 1, x1c] + a11 * plane[y1c + 1, x1c + 1]
        ).astype(np.float32)

    r2 = np.where(inside, samp(r1[0]), 0.0).astype(np.float32)
    r3 = np.where(inside, samp(r1[1]), 0.0).astype(np.float32)
    r4 = np.where(inside, (r0[2] + samp(r1[2])) * 0.5, r0[2]).astype(np.float32)
    r5 = np.where(inside, (r0[3] + samp(r1[3])) * 0.5, r0[3]).astype(np.float32)
    r6 = np.where(inside, (r0[4] + samp(r1[4])) * 0.25, r0[4] * 0.5).astype(np.float32)

    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + r4 * flowy + r6 * flowx
    r3 = r3 + r6 * flowy + r5 * flowx

    ramp = BORDER_RAMP
    scale = (
        ramp[np.minimum(xs, 5)] * ramp[np.minimum(ys, 5)]
        * ramp[np.minimum(cols - xs - 1, 5)] * ramp[np.minimum(rows - ys - 1, 5)]
    ).astype(np.float32)
    r2 *= scale
    r3 *= scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return np.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ]).astype(np.float32)


def update_flow(m):
    """(ref: optical_flow_farneback.cl:408-429)."""
    g11, g12, g22, h1, h2 = m
    det_inv = np.float32(1.0) / (g11 * g22 - g12 * g12 + np.float32(1e-3))
    flowx = (g11 * h2 - g12 * h1) * det_inv
    flowy = (g22 * h1 - g12 * h2) * det_inv
    return flowx.astype(np.float32), flowy.astype(np.float32)


def _imresize_bilinear(im, wh):
    return np.array(Image.fromarray(im).resize(wh, PIL.Image.BILINEAR))


def farneback_compute(im1, im2, u0, v0, window_size=33, n_iters=5, poly_n=7,
                      poly_sigma=1.5, use_gaussian=True, pyr_scale=0.5,
                      pyr_levels=1):
    """Full Farneback solve with its internal pyramid
    (ref: src/Farneback_PyCL.py:462-604).  ``pyr_levels`` counts levels as the
    adapter's constructor does (1 == single level)."""
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    rows, cols = im1.shape
    levels = pyr_levels - 1

    min_size = 32
    scale = 1.0
    final_levels = 0
    while final_levels < levels:
        scale *= pyr_scale
        if cols * scale < min_size or rows * scale < min_size:
            break
        final_levels += 1

    prev_fx = prev_fy = None
    cur_fx = cur_fy = None
    for k in range(final_levels, -1, -1):
        scale = pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_size = int(round(sigma * 5)) | 1
        smooth_size = max(smooth_size, 3)

        width = int(round(cols * scale))
        height = int(round(rows * scale))

        if prev_fx is None:
            cur_fx = _imresize_bilinear(np.asarray(u0, np.float32), (width, height)) * np.float32(scale)
            cur_fy = _imresize_bilinear(np.asarray(v0, np.float32), (width, height)) * np.float32(scale)
        else:
            cur_fx = _imresize_bilinear(prev_fx, (width, height)) * np.float32(1.0 / pyr_scale)
            cur_fy = _imresize_bilinear(prev_fy, (width, height)) * np.float32(1.0 / pyr_scale)

        blur_sigma = sigma
        ra = poly_expansion(
            _imresize_bilinear(gaussian_blur(im1, smooth_size, blur_sigma), (width, height)),
            poly_n, poly_sigma,
        )
        rb = poly_expansion(
            _imresize_bilinear(gaussian_blur(im2, smooth_size, blur_sigma), (width, height)),
            poly_n, poly_sigma,
        )

        m = update_matrices(cur_fx, cur_fy, ra, rb)
        for i in range(n_iters):
            if use_gaussian:
                m = gaussian_blur5(m, window_size, window_size / 2 * 0.3)
            else:
                m = box_filter5(m, window_size // 2)
            cur_fx, cur_fy = update_flow(m)
            if i < n_iters - 1:
                m = update_matrices(cur_fx, cur_fy, ra, rb)

        prev_fx, prev_fy = cur_fx, cur_fy

    return cur_fx, cur_fy


class OracleFarnebackAdapter:
    def __init__(self, windowSize=33, Niters=5, polyN=7, polySigma=1.5,
                 useGaussian=True, pyrScale=0.5, pyramidalLevels=1):
        self.args = dict(window_size=windowSize, n_iters=Niters, poly_n=polyN,
                         poly_sigma=polySigma, use_gaussian=useGaussian,
                         pyr_scale=pyrScale, pyr_levels=pyramidalLevels)

    def compute(self, im1, im2, U, V):
        u, v = farneback_compute(im1, im2, U, V, **self.args)
        return u, v, "Unknown"

    def getAlgoName(self):
        return "Oracle Farneback"

    def hasGenericPyramidalDefaults(self):
        return True

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "scaling": True}
