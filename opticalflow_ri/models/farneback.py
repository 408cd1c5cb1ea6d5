"""Farneback polynomial-expansion optical flow.

Re-design of the reference's OpenCL port (ref: src/Farneback_PyCL.py +
src/optical_flow_farneback.cl) as ONE jitted XLA program per
(image shape, config): the reference round-trips every buffer host<->device on
every sub-step (ref: src/Farneback_PyCL.py:226-235 and friends, ~20
full-image copies per iteration); here the entire internal pyramid — blurs,
polynomial expansions, matrix updates, flow solves — is traced once and fused
by XLA, with data resident in device memory throughout.

Mapping of the five device kernels (SURVEY.md section 2.2):
  * polynomialExpansion -> separable g/xg/xxg correlations (replicate border)
    + Gram-inverse combination (kernels :72-133);
  * gaussianBlur / gaussianBlur5 -> separable correlations, reflect-101
    border (:135-253); boxFilter5 -> separable box sums, replicate (:350-406);
  * updateMatrices -> 4-tap bilinear gather of R1 at the flow-displaced
    position + border-ramp attenuation (:254-348);
  * updateFlow -> fused elementwise 2x2 solve with +1e-3 regulariser
    (:408-429).

Plane layout is (5, H, W): leading channel dim keeps the W axis minor and
contiguous (the reference stacks 5 row-blocks in one matrix, an OpenCL-ism).

The host-side pyramid logic (level sizing, PIL-BILINEAR flow rescaling, the
bit-exact blur kernels, smoothSize = max(round(5*sigma)|1, 3)) matches
ref: src/Farneback_PyCL.py:462-604; `fastPyramids` stays unimplemented there
and is intentionally not reproduced.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from opticalflow_ri.ops import resolve_impl
from opticalflow_ri.ops.stencil import correlate1d
from opticalflow_ri.ops.resize import pil_resize
from opticalflow_ri.ops.kernels_bitexact import get_gaussian_kernel_bit_exact

BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472, 1.0], np.float32)


@lru_cache(maxsize=None)
def prepare_poly_gaussian(n: int, sigma: float):
    """g/xg/xxg bases + Gram-inverse constants
    (ref: src/Farneback_PyCL.py:124-172), host-side, cached."""
    if sigma < 1.19209289550781250000000000000000000e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    xg = (x * g).astype(np.float32)
    xxg = (x * x * g).astype(np.float32)

    G = np.zeros((6, 6), np.float64)
    gd = g.astype(np.float64)
    for yy in range(-n, n + 1):
        for xx in range(-n, n + 1):
            w = gd[yy + n] * gd[xx + n]
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


def poly_expansion(src: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """(H, W) -> (5, H, W) polynomial-expansion field: separable
    correlations with the g/xg/xxg bases (replicate border)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = prepare_poly_gaussian(n, float(sigma))

    ve = correlate1d(src, g, axis=-2, mode="nearest")
    vo = correlate1d(src, xg, axis=-2, mode="nearest")
    vx2 = correlate1d(src, xxg, axis=-2, mode="nearest")

    b1 = correlate1d(ve, g, axis=-1, mode="nearest")
    b2 = correlate1d(ve, xg, axis=-1, mode="nearest")
    b4 = correlate1d(ve, xxg, axis=-1, mode="nearest")
    b3 = correlate1d(vo, g, axis=-1, mode="nearest")
    b6 = correlate1d(vo, xg, axis=-1, mode="nearest")
    b5 = correlate1d(vx2, g, axis=-1, mode="nearest")

    return jnp.stack([
        b3 * ig11,
        b2 * ig11,
        b1 * ig03 + b5 * ig33,
        b1 * ig03 + b4 * ig33,
        b6 * ig55,
    ])


def _blur_kernel(n: int, sigma: float) -> np.ndarray:
    _, k = get_gaussian_kernel_bit_exact(n, sigma)
    return np.float32(k)


def gaussian_blur(src, smooth_size: int, sigma: float):
    k = _blur_kernel(smooth_size, float(sigma))
    out = correlate1d(src, k, axis=-2, mode="mirror")
    return correlate1d(out, k, axis=-1, mode="mirror")


def gaussian_blur5(m, smooth_size: int, sigma: float):
    k = _blur_kernel(smooth_size, float(sigma))
    out = correlate1d(m, k, axis=-2, mode="mirror")
    return correlate1d(out, k, axis=-1, mode="mirror")


def box_filter5(m, ksize_half: int):
    k = np.ones(2 * ksize_half + 1, np.float32)
    out = correlate1d(m, k, axis=-2, mode="nearest")
    out = correlate1d(out, k, axis=-1, mode="nearest")
    return out * jnp.float32(1.0 / (2 * ksize_half + 1) ** 2)


def update_matrices(flowx, flowy, r0, r1, sample_max_shift: int | None = 5):
    """Assemble the 5-plane normal-equation field M
    (ref: optical_flow_farneback.cl:256-348).

    The bilinear sample of R1 at the flow-displaced position runs, by default,
    as a dense tent-weight contraction over static shifts in
    [-sample_max_shift, sample_max_shift]^2 — one fused multiply-reduce with
    no gathers.  Flows beyond that range (outside this library's
    <=4 px calibrated regime) would sample clamped; pass
    ``sample_max_shift=None`` for the exact gather path.

    Default R=5 since round 4 (was 6): flows <= 4.99 px still sample exactly
    (the tent needs shifts floor(d) and floor(d)+1), transient clamps moved
    the bundled-pair solve by <= 4.5e-5 px vs the exact R=12 sampler, and the
    contraction shrinks 169 -> 121 shifts (-28%).  Pass 6 to restore the old
    envelope.
    """
    _, rows, cols = r0.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (rows, cols), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (rows, cols), 1)
    fx = xs + flowx
    fy = ys + flowy
    x1i = jnp.floor(fx).astype(jnp.int32)
    y1i = jnp.floor(fy).astype(jnp.int32)

    inside = (x1i >= 0) & (y1i >= 0) & (x1i < cols - 1) & (y1i < rows - 1)

    if sample_max_shift is not None:
        R = int(sample_max_shift)
        dxc = jnp.clip(flowx, -R, R - 1e-3)
        dyc = jnp.clip(flowy, -R, R - 1e-3)
        rp = jnp.pad(r1, ((0, 0), (R, R + 1), (R, R + 1)), mode="edge")
        s = jnp.zeros_like(r1)
        for sy in range(-R, R + 1):
            wy = jnp.maximum(0.0, 1.0 - jnp.abs(dyc - sy))
            for sx in range(-R, R + 1):
                w = wy * jnp.maximum(0.0, 1.0 - jnp.abs(dxc - sx))
                s = s + w[None] * rp[:, R + sy : R + sy + rows, R + sx : R + sx + cols]
    else:
        fxf = fx - jnp.floor(fx)
        fyf = fy - jnp.floor(fy)
        x1c = jnp.clip(x1i, 0, cols - 2)
        y1c = jnp.clip(y1i, 0, rows - 2)
        a00 = (1 - fxf) * (1 - fyf)
        a01 = fxf * (1 - fyf)
        a10 = (1 - fxf) * fyf
        a11 = fxf * fyf
        flat = r1.reshape(5, rows * cols)
        i00 = (y1c * cols + x1c).reshape(-1)
        t00 = jnp.take(flat, i00, axis=1).reshape(5, rows, cols)
        t01 = jnp.take(flat, i00 + 1, axis=1).reshape(5, rows, cols)
        t10 = jnp.take(flat, i00 + cols, axis=1).reshape(5, rows, cols)
        t11 = jnp.take(flat, i00 + cols + 1, axis=1).reshape(5, rows, cols)
        s = a00 * t00 + a01 * t01 + a10 * t10 + a11 * t11

    return assemble_m(s, r0, flowx, flowy, inside)


def assemble_m(s, r0, flowx, flowy, inside):
    """The non-sampling tail of updateMatrices: difference blend, border
    attenuation ramp and normal-equation products
    (ref: optical_flow_farneback.cl:310-346)."""
    rows, cols = flowx.shape
    r2 = jnp.where(inside, s[0], 0.0)
    r3 = jnp.where(inside, s[1], 0.0)
    r4 = jnp.where(inside, (r0[2] + s[2]) * 0.5, r0[2])
    r5 = jnp.where(inside, (r0[3] + s[3]) * 0.5, r0[3])
    r6 = jnp.where(inside, (r0[4] + s[4]) * 0.25, r0[4] * 0.5)

    r2 = (r0[0] - r2) * 0.5
    r3 = (r0[1] - r3) * 0.5
    r2 = r2 + r4 * flowy + r6 * flowx
    r3 = r3 + r6 * flowy + r5 * flowx

    ramp = jnp.asarray(BORDER_RAMP)
    xi = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    yi = jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    scale = (
        ramp[jnp.minimum(xi, 5)] * ramp[jnp.minimum(yi, 5)]
        * ramp[jnp.minimum(cols - xi - 1, 5)]
        * ramp[jnp.minimum(rows - yi - 1, 5)]
    )
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return jnp.stack([
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    ])


def blur_update_flow(m, window_size: int, use_gaussian: bool):
    """Window-blur M (gaussianBlur5 or boxFilter5), then solve for the flow
    (updateFlow)."""
    if use_gaussian:
        m = gaussian_blur5(m, window_size, window_size / 2 * 0.3)
    else:
        m = box_filter5(m, window_size // 2)
    return update_flow(m)


def update_flow(m):
    """Regularised per-pixel 2x2 solve (ref: optical_flow_farneback.cl:408-429)."""
    g11, g12, g22, h1, h2 = m[0], m[1], m[2], m[3], m[4]
    det_inv = 1.0 / (g11 * g22 - g12 * g12 + jnp.float32(1e-3))
    return (g11 * h2 - g12 * h1) * det_inv, (g22 * h1 - g12 * h2) * det_inv


def _level_plan(rows, cols, pyr_scale, levels):
    """Static per-level geometry, cropped at min size 32
    (ref: src/Farneback_PyCL.py:468-487, :508-515)."""
    min_size = 32
    scale = 1.0
    final_levels = 0
    while final_levels < levels:
        scale *= pyr_scale
        if cols * scale < min_size or rows * scale < min_size:
            break
        final_levels += 1
    plan = []
    for k in range(final_levels, -1, -1):
        s = pyr_scale**k
        sigma = (1.0 / s - 1.0) * 0.5
        smooth = max(int(round(sigma * 5)) | 1, 3)
        plan.append(
            dict(scale=s, sigma=sigma, smooth=smooth,
                 width=int(round(cols * s)), height=int(round(rows * s)))
        )
    return plan


@partial(
    jax.jit,
    static_argnames=("window_size", "n_iters", "poly_n", "poly_sigma",
                     "use_gaussian", "pyr_scale", "pyr_levels", "impl"),
)
def farneback_solve(im1, im2, u0, v0, window_size=33, n_iters=5, poly_n=7,
                    poly_sigma=1.5, use_gaussian=True, pyr_scale=0.5,
                    pyr_levels=1, impl: str = "auto"):
    """Whole Farneback pipeline as one XLA program.  ``impl``: "xla";
    "auto" resolves to it."""
    resolve_impl(impl)
    im1 = im1.astype(jnp.float32)
    im2 = im2.astype(jnp.float32)
    u0 = u0.astype(jnp.float32)
    v0 = v0.astype(jnp.float32)
    rows, cols = im1.shape
    plan = _level_plan(rows, cols, pyr_scale, pyr_levels - 1)

    prev = None
    for lvl in plan:
        h, w = lvl["height"], lvl["width"]
        if prev is None:
            fx = pil_resize(u0, (h, w), "bilinear") * jnp.float32(lvl["scale"])
            fy = pil_resize(v0, (h, w), "bilinear") * jnp.float32(lvl["scale"])
        else:
            fx = pil_resize(prev[0], (h, w), "bilinear") * jnp.float32(1.0 / pyr_scale)
            fy = pil_resize(prev[1], (h, w), "bilinear") * jnp.float32(1.0 / pyr_scale)

        ra = poly_expansion(
            pil_resize(gaussian_blur(im1, lvl["smooth"], lvl["sigma"]), (h, w), "bilinear"),
            poly_n, poly_sigma,
        )
        rb = poly_expansion(
            pil_resize(gaussian_blur(im2, lvl["smooth"], lvl["sigma"]), (h, w), "bilinear"),
            poly_n, poly_sigma,
        )

        m = update_matrices(fx, fy, ra, rb)
        for i in range(n_iters):
            fx, fy = blur_update_flow(m, window_size, use_gaussian)
            if i < n_iters - 1:
                m = update_matrices(fx, fy, ra, rb)
        prev = (fx, fy)

    return prev


class FarnebackAdapter:
    """Driver adapter with the reference constructor surface
    (ref: src/Farneback_PyCL.py:65-122)."""

    def __init__(self, windowSize: int = 33, Niters: int = 5, polyN: int = 7,
                 polySigma: float = 1.5, useGaussian: bool = True,
                 pyrScale: float = 0.5, pyramidalLevels: int = 1,
                 provideGenericPyramidalDefaults: bool = True):
        assert pyramidalLevels >= 1, "Pyramidal levels must be >= 1"
        if windowSize % 2 == 0:
            raise ValueError("windowSize must be an odd value")
        assert polyN in (5, 7)
        self.windowSize = windowSize
        self.numIters = Niters
        self.polyN = int(polyN)
        self.polySigma = polySigma
        self.useGaussianFilter = useGaussian
        self.pyrScale = pyrScale
        self.pyramidalLevels = pyramidalLevels
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults

    def compute(self, im1, im2, U, V):
        fx, fy = farneback_solve(
            jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(U), jnp.asarray(V),
            window_size=self.windowSize, n_iters=self.numIters,
            poly_n=self.polyN, poly_sigma=float(self.polySigma),
            use_gaussian=self.useGaussianFilter, pyr_scale=float(self.pyrScale),
            pyr_levels=self.pyramidalLevels,
        )
        # the reference reports no numeric error from this solver (:602)
        return fx, fy, "Unknown"

    def getAlgoName(self):
        return "Farneback"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "scaling": True}
