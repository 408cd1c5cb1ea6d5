"""Generic coarse-to-fine pyramidal optical-flow driver.

Functional re-design of the reference's pyramidal orchestrator
(ref: src/GenericPyramidalOpticalFlow.py:238-416) and its OO wrapper
(ref: src/GenericPyramidalOpticalFlowWrapper.py).  Control flow, level
ordering, scaling flags, FILTER/FILTER_OPT semantics (3-px vs 5-px kernels,
ref: :374,:382) and the adapter-defaults override mechanism (ref: :304-327)
are reproduced exactly; all image math runs on device as jitted JAX ops:

  * image downsizing       -> PIL-BICUBIC-equivalent matmul resize (ops.resize)
  * flow upsampling        -> RectBivariateSpline-equivalent matmuls
  * symmetric sub-pixel warping -> ops.warp (both BiLinear and Liu-Shen modes)
  * pre-filtering          -> calibrated separable Gaussian (ops.gaussian)

Adapters follow the reference protocol: ``compute(im1, im2, U, V) ->
(U, V, error)``, ``getAlgoName()``, ``hasGenericPyramidalDefaults()``,
``getGenericPyramidalDefaults()`` (ref: :256-289).
"""

from __future__ import annotations

import logging

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.ops.gaussian import gaussian_filter_px
from opticalflow_ri.ops.resize import pil_resize, spline_upsample
from opticalflow_ri.ops.warp import symmetric_warp_pair, liu_shen_warp

log = logging.getLogger("opticalflow_ri")


def _imresize_bicubic(im, scale):
    """PIL-convention size rounding (ref: src/GenericPyramidalOpticalFlow.py:336-343)."""
    out_w = int(np.round(im.shape[1] * scale))
    out_h = int(np.round(im.shape[0] * scale))
    return pil_resize(im, (out_h, out_w), "bicubic")


def update_next_pyramidal_level(
    im1_next, prev_shape, im2_next, u_accum, v_accum, u, v,
    warping=True, bi_linear=True, scale=False,
):
    """Carry accumulated flow (and optionally warp the image pair) into a new
    pyramid level (ref: src/GenericPyramidalOpticalFlow.py:118-235).

    Returns (im1, im2, u_accum, v_accum, u_init, v_init).
    """
    y_dim, x_dim = im1_next.shape[-2], im1_next.shape[-1]
    y_prev, x_prev = prev_shape

    if (x_prev, y_prev) != (x_dim, y_dim):
        us_new = spline_upsample(u_accum, (y_dim, x_dim))
        vs_new = spline_upsample(v_accum, (y_dim, x_dim))
    else:
        us_new = u_accum
        vs_new = v_accum

    if scale:
        us_new = us_new * jnp.float32(np.float32(x_dim) / np.float32(x_prev))
        vs_new = vs_new * jnp.float32(np.float32(y_dim) / np.float32(y_prev))

    zeros = jnp.zeros((y_dim, x_dim), jnp.float32)
    if warping:
        if bi_linear:
            im1_next, im2_next = symmetric_warp_pair(im1_next, im2_next, us_new, vs_new)
        else:
            im1_next = liu_shen_warp(im1_next, us_new, vs_new)
        return im1_next, im2_next, us_new, vs_new, zeros, zeros
    return im1_next, im2_next, zeros, zeros, us_new, vs_new


def generic_pyramidal_optical_flow(
    im1, im2, FILTER, mainOFlowAlgoAdapter, pyramidalLevels=1, kLevels=1,
    FILTER_OPT=None, optionalOFlowAlgoAdapter=None, warping=True, biLinear=True,
    pyramidalIntermediateScaling=True, pyramidalScaling=False,
):
    """Coarse-to-fine pyramidal processing of a main (and optional refinement)
    optical-flow adapter; see module docstring for the parity contract."""
    im1 = jnp.asarray(im1, jnp.float32)
    im2 = jnp.asarray(im2, jnp.float32)

    if mainOFlowAlgoAdapter.hasGenericPyramidalDefaults():
        defaults = mainOFlowAlgoAdapter.getGenericPyramidalDefaults()
        if defaults is not None:
            for key, setter in (
                ("warping", "warping"),
                ("biLinear", "biLinear"),
                ("intermediateScaling", "pyramidalIntermediateScaling"),
                ("scaling", "pyramidalScaling"),
            ):
                val = defaults.get(key)
                if val is not None:
                    log.info(
                        "Using algorithm %s default for %s: %s",
                        mainOFlowAlgoAdapter.getAlgoName(), key, val,
                    )
                    if setter == "warping":
                        warping = val
                    elif setter == "biLinear":
                        biLinear = val
                    elif setter == "pyramidalIntermediateScaling":
                        pyramidalIntermediateScaling = val
                    else:
                        pyramidalScaling = val

    scale = 1.0 / (2.0 ** (pyramidalLevels - 1))
    u = v = u_accum = v_accum = None
    prev_shape = None

    for level in range(1, pyramidalLevels + 1):
        local_scaling = pyramidalIntermediateScaling
        if level == pyramidalLevels:
            local_scaling = pyramidalScaling

        if scale < 1.0 and level != pyramidalLevels:
            im1_new = _imresize_bicubic(im1, scale)
            im2_new = _imresize_bicubic(im2, scale)
        elif scale > 1.0:
            raise ValueError(f"Invalid scale level: {scale}")
        else:
            im1_new = im1
            im2_new = im2

        if level > 1:
            im1_warp, im2_warp, u_accum, v_accum, u, v = update_next_pyramidal_level(
                im1_new, prev_shape, im2_new, u_accum, v_accum, u, v,
                warping, biLinear, local_scaling,
            )
        else:
            im1_warp, im2_warp = im1_new, im2_new
            zeros = jnp.zeros(im1_new.shape, jnp.float32)
            u = v = u_accum = v_accum = zeros

        if FILTER > 1e-3:
            im1_work = gaussian_filter_px(im1_warp, FILTER, 3)
            im2_work = gaussian_filter_px(im2_warp, FILTER, 3)
        else:
            im1_work, im2_work = im1_warp, im2_warp

        if optionalOFlowAlgoAdapter is not None and FILTER_OPT > 1e-3:
            im1_opt = gaussian_filter_px(im1_new, FILTER_OPT, 5)
            im2_opt = gaussian_filter_px(im2_new, FILTER_OPT, 5)
        elif optionalOFlowAlgoAdapter is not None:
            im1_opt, im2_opt = im1_new, im2_new

        for k in range(kLevels):
            log.info("Level=%d kIter=%d", level, k)
            if k > 0:
                if warping:
                    im1_warp, im2_warp, u_accum, v_accum, u, v = update_next_pyramidal_level(
                        im1_new, im1_new.shape[-2:], im2_new, u_accum, v_accum, u, v,
                        warping, biLinear, False,
                    )
                    if FILTER > 1:
                        im1_work = gaussian_filter_px(im1_warp, FILTER, 3)
                        im2_work = gaussian_filter_px(im2_warp, FILTER, 3)
                    else:
                        im1_work, im2_work = im1_warp, im2_warp
                else:
                    im1_work, im2_work, u_accum, v_accum, u, v = update_next_pyramidal_level(
                        im1_work, im1_work.shape[-2:], im2_work, u_accum, v_accum, u, v,
                        warping, biLinear, False,
                    )

            u, v, error = mainOFlowAlgoAdapter.compute(im1_work, im2_work, u, v)
            log.info(
                "%s estimated error for image registration: %s",
                mainOFlowAlgoAdapter.getAlgoName(), error,
            )

            if optionalOFlowAlgoAdapter is not None:
                u, v, error_opt = optionalOFlowAlgoAdapter.compute(im1_opt, im2_opt, u, v)
                log.info(
                    "%s estimated error for image registration: %s",
                    optionalOFlowAlgoAdapter.getAlgoName(), error_opt,
                )

            u = jnp.asarray(u, jnp.float32)
            v = jnp.asarray(v, jnp.float32)
            u_accum = u_accum + u
            v_accum = v_accum + v

        prev_shape = im1_work.shape[-2:]
        scale *= 2

    return u_accum, v_accum


class GenericPyramidalOpticalFlowWrapper:
    """OO wrapper holding driver parameters
    (ref: src/GenericPyramidalOpticalFlowWrapper.py:8-64)."""

    def __init__(
        self, algo_adapter, filter_sigma=0.0, pyr_levels=1, k_levels=1,
        filter_opt=None, optional_algo_adapter=None, warping=True, bi_linear=True,
        pyramidal_intermediate_scaling=True, pyramidal_scaling=False,
    ):
        self.algo_adapter = algo_adapter
        self.filter_sigma = filter_sigma
        self.pyr_levels = pyr_levels
        self.k_levels = k_levels
        self.filter_opt = filter_opt
        self.optional_algo_adapter = optional_algo_adapter
        self.warping = warping
        self.bi_linear = bi_linear
        self.pyramidal_intermediate_scaling = pyramidal_intermediate_scaling
        self.pyramidal_scaling = pyramidal_scaling

    def calculateFlow(self, im1, im2):
        return generic_pyramidal_optical_flow(
            im1, im2, self.filter_sigma, self.algo_adapter,
            pyramidalLevels=self.pyr_levels, kLevels=self.k_levels,
            FILTER_OPT=self.filter_opt,
            optionalOFlowAlgoAdapter=self.optional_algo_adapter,
            warping=self.warping, biLinear=self.bi_linear,
            pyramidalIntermediateScaling=self.pyramidal_intermediate_scaling,
            pyramidalScaling=self.pyramidal_scaling,
        )
