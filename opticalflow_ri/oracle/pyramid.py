"""Oracle pyramidal driver (semantics of ref: src/GenericPyramidalOpticalFlow.py).

Uses PIL and scipy directly (the reference's own resampling backends) so the
engine driver's matmul-based resamplers can be validated end to end against it."""

from __future__ import annotations

import numpy as np
import PIL
from PIL import Image
from scipy.interpolate import RectBivariateSpline

from opticalflow_ri.oracle.gaussian import gaussian_filter_px


def imresize_bicubic(im, scale):
    res = (
        int(np.round(im.shape[1] * scale)),
        int(np.round(im.shape[0] * scale)),
    )
    return np.array(Image.fromarray(im).resize(res, PIL.Image.BICUBIC))


def spline_upsample(field, out_hw):
    in_h, in_w = field.shape
    out_h, out_w = out_hw
    ys_in = np.arange(in_h) / np.float32(in_h)
    xs_in = np.arange(in_w) / np.float32(in_w)
    ys_out = np.arange(out_h) / np.float32(out_h)
    xs_out = np.arange(out_w) / np.float32(out_w)
    return np.float32(RectBivariateSpline(ys_in, xs_in, field)(ys_out, xs_out))


def bilinear_warp_rounded(img, coords_y, coords_x):
    h, w = img.shape
    iy = np.int32(np.round(coords_y))
    ix = np.int32(np.round(coords_x))
    dy = coords_y - iy
    dx = coords_x - ix
    iyn = np.where(dy < 0, iy - 1, iy + 1)
    ixn = np.where(dx < 0, ix - 1, ix + 1)
    dy = np.abs(dy)
    dx = np.abs(dx)
    iy = np.clip(iy, 0, h - 1)
    iyn = np.clip(iyn, 0, h - 1)
    ix = np.clip(ix, 0, w - 1)
    ixn = np.clip(ixn, 0, w - 1)
    out = (
        (1 - dy) * (1 - dx) * img[iy, ix]
        + (1 - dy) * dx * img[iy, ixn]
        + dy * (1 - dx) * img[iyn, ix]
        + dy * dx * img[iyn, ixn]
    )
    return out.astype(np.float32)


def _update_level(im1_next, prev_shape, im2_next, u_acc, v_acc, warping, scale):
    y_dim, x_dim = im1_next.shape
    y_prev, x_prev = prev_shape
    if (y_prev, x_prev) != (y_dim, x_dim):
        us = spline_upsample(u_acc, (y_dim, x_dim))
        vs = spline_upsample(v_acc, (y_dim, x_dim))
    else:
        us, vs = u_acc, v_acc
    if scale:
        us = us * np.float32(np.float32(x_dim) / np.float32(x_prev))
        vs = vs * np.float32(np.float32(y_dim) / np.float32(y_prev))
    zeros = np.zeros((y_dim, x_dim), np.float32)
    if warping:
        ys, xs = np.mgrid[0:y_dim, 0:x_dim].astype(np.float32)
        w1 = bilinear_warp_rounded(im1_next, ys - vs / 2.0, xs - us / 2.0)
        w2 = bilinear_warp_rounded(im2_next, ys + vs / 2.0, xs + us / 2.0)
        return w1, w2, us, vs, zeros, zeros
    return im1_next, im2_next, zeros, zeros, us, vs


def pyramidal_optical_flow(
    im1, im2, FILTER, main_adapter, pyramidal_levels=1, k_levels=1,
    FILTER_OPT=None, optional_adapter=None, warping=True, bi_linear=True,
    intermediate_scaling=True, scaling=False,
):
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)

    if main_adapter.hasGenericPyramidalDefaults():
        d = main_adapter.getGenericPyramidalDefaults() or {}
        warping = d.get("warping", warping)
        bi_linear = d.get("biLinear", bi_linear)
        intermediate_scaling = d.get("intermediateScaling", intermediate_scaling)
        scaling = d.get("scaling", scaling)

    scale = 1.0 / (2.0 ** (pyramidal_levels - 1))
    u = v = u_acc = v_acc = None
    prev_shape = None

    for level in range(1, pyramidal_levels + 1):
        local_scaling = scaling if level == pyramidal_levels else intermediate_scaling

        if scale < 1.0 and level != pyramidal_levels:
            im1_new = imresize_bicubic(im1, scale)
            im2_new = imresize_bicubic(im2, scale)
        else:
            im1_new, im2_new = im1, im2

        if level > 1:
            im1_warp, im2_warp, u_acc, v_acc, u, v = _update_level(
                im1_new, prev_shape, im2_new, u_acc, v_acc, warping, local_scaling
            )
        else:
            im1_warp, im2_warp = im1_new, im2_new
            zeros = np.zeros(im1_new.shape, np.float32)
            u = v = u_acc = v_acc = zeros

        if FILTER > 1e-3:
            im1_work = gaussian_filter_px(im1_warp, FILTER, 3)
            im2_work = gaussian_filter_px(im2_warp, FILTER, 3)
        else:
            im1_work, im2_work = im1_warp, im2_warp

        if optional_adapter is not None and FILTER_OPT > 1e-3:
            im1_opt = gaussian_filter_px(im1_new, FILTER_OPT, 5)
            im2_opt = gaussian_filter_px(im2_new, FILTER_OPT, 5)
        elif optional_adapter is not None:
            im1_opt, im2_opt = im1_new, im2_new

        for k in range(k_levels):
            if k > 0:
                if warping:
                    im1_warp, im2_warp, u_acc, v_acc, u, v = _update_level(
                        im1_new, im1_new.shape, im2_new, u_acc, v_acc, warping, False
                    )
                    if FILTER > 1:
                        im1_work = gaussian_filter_px(im1_warp, FILTER, 3)
                        im2_work = gaussian_filter_px(im2_warp, FILTER, 3)
                    else:
                        im1_work, im2_work = im1_warp, im2_warp
                else:
                    im1_work, im2_work, u_acc, v_acc, u, v = _update_level(
                        im1_work, im1_work.shape, im2_work, u_acc, v_acc, warping, False
                    )

            u, v, _ = main_adapter.compute(im1_work, im2_work, u, v)
            if optional_adapter is not None:
                u, v, _ = optional_adapter.compute(im1_opt.copy(), im2_opt.copy(), u, v)
            u = np.asarray(u, np.float32)
            v = np.asarray(v, np.float32)
            u_acc = u_acc + u
            v_acc = v_acc + v

        prev_shape = im1_work.shape
        scale *= 2

    return u_acc, v_acc
