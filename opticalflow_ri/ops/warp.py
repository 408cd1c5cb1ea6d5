"""Sub-pixel image warping for the pyramidal driver.

Replicates the reference's two warp modes
(ref: src/GenericPyramidalOpticalFlow.py:70-116, :198-221):

  * ``bilinear_warp_rounded`` — the driver's default "BiLinear" warp.  NOTE the
    reference does NOT use conventional floor-based bilinear sampling: it
    rounds the coordinate to the nearest integer (numpy round-half-even),
    picks the second tap on the side of the fractional remainder's sign, and
    blends with |frac| weights, clamping all taps to the image.  We reproduce
    that exactly (jnp.round is also half-even).
  * ``liu_shen_warp`` — the alternative optical-flow-equation warp: integer
    scatter shift plus a first-order intensity correction from the smoothed
    sub-pixel residual flow.  NumPy fancy assignment resolves duplicate
    destinations last-write-wins in row-major source order; JAX's plain
    ``.at[].set`` leaves that unspecified, so the scatter here is expressed
    as a deterministic scatter-MAX of source linear indices (max source
    index == numpy's last writer) followed by a gather.

Gathers here run once per pyramid level (not in the iteration hot loop), so
XLA's native gather is used; the hot solver loops never gather.
"""

from __future__ import annotations

import jax.numpy as jnp

from opticalflow_ri.ops.gaussian import gaussian_filter


def _gather2d(img: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray) -> jnp.ndarray:
    return img[iy, ix]


def bilinear_warp_rounded(img: jnp.ndarray, coords_y: jnp.ndarray, coords_x: jnp.ndarray) -> jnp.ndarray:
    """Warp ``img`` sampling at (coords_y, coords_x) with the reference's
    round-to-nearest + signed-neighbour bilinear scheme
    (ref: src/GenericPyramidalOpticalFlow.py:70-116)."""
    h, w = img.shape[-2], img.shape[-1]

    iy = jnp.round(coords_y).astype(jnp.int32)
    ix = jnp.round(coords_x).astype(jnp.int32)
    dy = coords_y - iy
    dx = coords_x - ix

    iyn = jnp.where(dy < 0, iy - 1, iy + 1)
    ixn = jnp.where(dx < 0, ix - 1, ix + 1)
    dy = jnp.abs(dy)
    dx = jnp.abs(dx)

    iy = jnp.clip(iy, 0, h - 1)
    iyn = jnp.clip(iyn, 0, h - 1)
    ix = jnp.clip(ix, 0, w - 1)
    ixn = jnp.clip(ixn, 0, w - 1)

    p00 = _gather2d(img, iy, ix)
    p01 = _gather2d(img, iy, ixn)
    p10 = _gather2d(img, iyn, ix)
    p11 = _gather2d(img, iyn, ixn)

    return (
        (1 - dy) * (1 - dx) * p00
        + (1 - dy) * dx * p01
        + dy * (1 - dx) * p10
        + dy * dx * p11
    ).astype(jnp.float32)


def displacement_warp_tent(img: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray,
                           max_shift: int = 8) -> jnp.ndarray:
    """Bilinear warp by a per-pixel displacement field, as a dense tent-weight
    contraction over static integer shifts (no gathers).

    The reference's round-to-nearest + signed-neighbour scheme is numerically
    identical to standard bilinear interpolation (both are the piecewise-linear
    interpolant; per-tap index clamping == edge padding), so weight(s) =
    max(0, 1-|d-s|) per axis reproduces it exactly for |d| <= max_shift.
    Displacements beyond that (outside the <=4 px calibrated regime) sample
    clamped; use ``bilinear_warp_rounded`` for the unbounded gather path.
    """
    h, w = img.shape[-2], img.shape[-1]
    R = int(max_shift)
    dyc = jnp.clip(dy, -R, R - 1e-3)
    dxc = jnp.clip(dx, -R, R - 1e-3)
    pad_w = [(0, 0)] * (img.ndim - 2) + [(R, R + 1), (R, R + 1)]
    p = jnp.pad(img, pad_w, mode="edge")
    out = jnp.zeros_like(img)
    for sy in range(-R, R + 1):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(dyc - sy))
        for sx in range(-R, R + 1):
            wt = wy * jnp.maximum(0.0, 1.0 - jnp.abs(dxc - sx))
            out = out + wt * p[..., R + sy : R + sy + h, R + sx : R + sx + w]
    return out


def symmetric_warp_pair(im1: jnp.ndarray, im2: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                        max_shift: int | None = 8):
    """Symmetric half-displacement warp of an image pair: im1 backwards by
    (u/2, v/2), im2 forwards — the driver's warping step
    (ref: src/GenericPyramidalOpticalFlow.py:198-201)."""
    if max_shift is not None:
        w1 = displacement_warp_tent(im1, -v / 2.0, -u / 2.0, max_shift)
        w2 = displacement_warp_tent(im2, v / 2.0, u / 2.0, max_shift)
        return w1, w2
    h, w = im1.shape[-2], im1.shape[-1]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None] * jnp.ones((1, w), jnp.float32)
    xs = jnp.arange(w, dtype=jnp.float32)[None, :] * jnp.ones((h, 1), jnp.float32)
    w1 = bilinear_warp_rounded(im1, ys - v / 2.0, xs - u / 2.0)
    w2 = bilinear_warp_rounded(im2, ys + v / 2.0, xs + u / 2.0)
    return w1, w2


def liu_shen_warp(im1: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Optical-flow-equation warp of im1 by (u, v)
    (ref: src/GenericPyramidalOpticalFlow.py:204-221)."""
    h, w = im1.shape[-2], im1.shape[-1]
    ys = jnp.arange(h, dtype=jnp.int32)[:, None] + jnp.zeros((1, w), jnp.int32)
    xs = jnp.arange(w, dtype=jnp.int32)[None, :] + jnp.zeros((h, 1), jnp.int32)

    ui = jnp.floor(u + 0.5)
    vi = jnp.floor(v + 0.5)
    xdst = (xs + ui.astype(jnp.int32))
    ydst = (ys + vi.astype(jnp.int32))
    # numpy semantics: negative indices wrap; we additionally clip the high end
    # (where the reference would fault).
    xdst = jnp.clip(jnp.where(xdst < 0, xdst + w, xdst), 0, w - 1)
    ydst = jnp.clip(jnp.where(ydst < 0, ydst + h, ydst), 0, h - 1)
    # Deterministic last-write-wins: for each destination, the winning source
    # is the one with the LARGEST row-major linear index (numpy iterates the
    # index meshes row-major, so the last writer has the max index).
    # scatter-max is order-independent, unlike scatter-set.
    dst = (ydst * w + xdst).reshape(-1)
    src_idx = jnp.arange(h * w, dtype=jnp.int32)
    winner = jnp.full((h * w,), -1, jnp.int32).at[dst].max(src_idx)
    im_flat = im1.reshape(-1)
    shifted = jnp.where(winner >= 0,
                        im_flat[jnp.maximum(winner, 0)], im_flat).reshape(h, w)

    du = gaussian_filter(u - ui.astype(u.dtype), 0.6 * 3, 4.0 / 0.6 * 3)
    dv = gaussian_filter(v - vi.astype(v.dtype), 0.6 * 3, 4.0 / 0.6 * 3)

    t_dx = shifted[:-1, 1:] * du[:-1, 1:] - shifted[:-1, :-1] * du[:-1, :-1]
    t_dy = shifted[1:, :-1] * dv[1:, :-1] - shifted[:-1, :-1] * dv[:-1, :-1]
    corrected = shifted.at[:-1, :-1].add(-(t_dx + t_dy))
    return corrected
