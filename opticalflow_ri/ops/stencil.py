"""Small-kernel stencil correlation as shift-and-accumulate passes.

The reference funnels every solver through ``scipy.ndimage.convolve`` with
3x3 (and 2x2) kernels.  The idiomatic XLA lowering of such tiny stencils is
NOT a convolution HLO but a weighted sum of statically-shifted slices of a
padded array: XLA fuses the whole stencil into a single elementwise loop, so
each stencil costs one read and one write of the image per call.

Semantics notes (validated against scipy.ndimage in tests/test_stencil.py):
  * ``correlate3x3(x, k)`` computes out(y,x) = sum_ij k[i,j] * in[y+i-1, x+j-1],
    i.e. plain correlation with the kernel centred.  The reference calls
    ``scipy.ndimage.convolve`` (true convolution, kernel flipped); callers here
    pass the pre-flipped kernel where the reference relies on that flip
    (ref: src/PhysicsBasedOpticalFlowLiuShen.py:116-121 flips its MATLAB
    kernels so that convolve == correlate with the MATLAB kernel).
  * 2x2 kernels follow ndimage's even-kernel origin: out(y,x) covers
    in[y..y+1, x..x+1] with the flipped kernel (verified empirically; see
    tests).  Used only by the Horn-Schunck derivative stencils
    (ref: src/HornSchunck.py:107-127).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.ops.padding import pad2d


def correlate3x3(x: jnp.ndarray, k: np.ndarray, mode: str) -> jnp.ndarray:
    """Correlate the trailing 2 dims of ``x`` with a static 3x3 kernel ``k``."""
    k = np.asarray(k)
    assert k.shape == (3, 3)
    xp = pad2d(x, 1, mode)
    H = x.shape[-2]
    W = x.shape[-1]
    out = None
    for i in range(3):
        for j in range(3):
            w = float(k[i, j])
            if w == 0.0:
                continue
            term = xp[..., i : i + H, j : j + W] * jnp.float32(w)
            out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(x)
    return out


def hs_avg3x3(x: jnp.ndarray, mode: str = "mirror") -> jnp.ndarray:
    """Horn-Schunck neighbour average 1/12·[[1,2,1],[2,0,2],[1,2,1]] (ref:
    src/HornSchunck.py:87-89) in separable form.

    The kernel decomposes as ([1,2,1]⊗[1,2,1] − 4·δ)/12, so the 8-tap
    correlation becomes two 3-tap passes plus a centre correction — ~9
    arithmetic ops instead of 15 and one-third the minor-axis shifts in the
    Jacobi hot loop.  Exactly equal to
    ``correlate3x3(x, HS_AVG_KERNEL, mode)`` in real arithmetic; f32
    results differ only in round-off association.
    """
    xp = pad2d(x, 1, mode)
    two = jnp.float32(2.0)
    p = xp[..., :, :-2] + two * xp[..., :, 1:-1] + xp[..., :, 2:]
    q = p[..., :-2, :] + two * p[..., 1:-1, :] + p[..., 2:, :]
    return (q - jnp.float32(4.0) * x) * jnp.float32(1.0 / 12.0)


def hs_avg3x3_padded(xp: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """``hs_avg3x3`` on an already 1-px-padded array (halo supplied by a
    neighbour exchange rather than a border rule)."""
    two = jnp.float32(2.0)
    p = xp[..., :, : out_w] + two * xp[..., :, 1 : out_w + 1] + xp[..., :, 2 : out_w + 2]
    q = p[..., : out_h, :] + two * p[..., 1 : out_h + 1, :] + p[..., 2 : out_h + 2, :]
    centre = xp[..., 1 : out_h + 1, 1 : out_w + 1]
    return (q - jnp.float32(4.0) * centre) * jnp.float32(1.0 / 12.0)


def correlate3x3_padded(xp: jnp.ndarray, k: np.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Correlate an already 1-px-padded array ``xp`` with a 3x3 kernel.

    Used by the sharded/fused paths where the halo (padding) is supplied by a
    neighbour-exchange rather than a border rule.
    """
    k = np.asarray(k)
    out = None
    for i in range(3):
        for j in range(3):
            w = float(k[i, j])
            if w == 0.0:
                continue
            term = xp[..., i : i + out_h, j : j + out_w] * jnp.float32(w)
            out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(xp[..., :out_h, :out_w])
    return out


def hs_derivatives(im1: jnp.ndarray, im2: jnp.ndarray):
    """Horn-Schunck 2x2 derivative stencils (ref: src/HornSchunck.py:107-127).

    Replicates ``filter2(im, kX, mode='mirror')`` for the even 2x2 kernels with
    ndimage's origin convention: out(y,x) combines in[y..y+1, x..x+1] with the
    flipped kernel, mirror boundary at the bottom/right edge.

    Matches the reference's effective computation inside ``HS`` after the
    argument swap quirk (ref: src/HornSchunck.py:37 vs :73): callers pass
    (im1=frame_t0, im2=frame_t1) and receive ft = avg(frame_t0) - avg(frame_t1).
    """

    def quads(im):
        p = pad2d(im, ((0, 1), (0, 1)), "mirror")
        a = p[..., :-1, :-1]  # in[y,   x]
        b = p[..., :-1, 1:]   # in[y,   x+1]
        c = p[..., 1:, :-1]   # in[y+1, x]
        d = p[..., 1:, 1:]    # in[y+1, x+1]
        return a, b, c, d

    a1, b1, c1, d1 = quads(im1)
    a2, b2, c2, d2 = quads(im2)

    quarter = jnp.float32(0.25)
    # kX = [[-1,1],[-1,1]]*0.25 under ndimage convolve => (a - b + c - d)/4
    fx = (a1 - b1 + c1 - d1 + a2 - b2 + c2 - d2) * quarter
    # kY = [[-1,-1],[1,1]]*0.25 => (a + b - c - d)/4
    fy = (a1 + b1 - c1 - d1 + a2 + b2 - c2 - d2) * quarter
    # ft = avg2x2(im1) - avg2x2(im2)   (frame-role swap already folded in)
    ft = (a1 + b1 + c1 + d1 - a2 - b2 - c2 - d2) * quarter
    return fx, fy, ft


def correlate1d(x: jnp.ndarray, kernel: np.ndarray, axis: int, mode: str) -> jnp.ndarray:
    """1-D correlation along ``axis`` (one of the trailing two dims) with a
    static kernel, as a shift-and-accumulate pass.  Matches
    ``scipy.ndimage.correlate1d`` semantics (kernel centred at len//2)."""
    kernel = np.asarray(kernel, dtype=np.float32)
    n = kernel.shape[0]
    centre = n // 2
    axis = axis % x.ndim
    assert axis >= x.ndim - 2
    size = x.shape[axis]
    if axis == x.ndim - 1:
        pw = ((0, 0), (centre, n - 1 - centre))
    else:
        pw = ((centre, n - 1 - centre), (0, 0))
    xp = pad2d(x, pw, mode)
    out = None
    for j in range(n):
        w = float(kernel[j])
        if w == 0.0:
            continue
        if axis == x.ndim - 1:
            term = xp[..., :, j : j + size] * jnp.float32(w)
        else:
            term = xp[..., j : j + size, :] * jnp.float32(w)
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(x)
    return out


def separable_correlate(x: jnp.ndarray, kernel: np.ndarray, mode: str) -> jnp.ndarray:
    """Separable 1-D correlation along rows then columns of the trailing 2 dims.

    The kernel is symmetric in every reference use, so correlation equals
    convolution.  Border handling per ``mode`` on both passes, matching the
    reference's per-axis padding (ref: src/gaussian_filter.py:54-85).
    """
    kernel = np.asarray(kernel, dtype=np.float32)
    n = kernel.shape[0]
    half = n // 2
    H, W = x.shape[-2], x.shape[-1]

    xp = pad2d(x, ((0, 0), (half, half)), mode)
    out = None
    for j in range(n):
        w = float(kernel[j])
        term = xp[..., :, j : j + W] * jnp.float32(w)
        out = term if out is None else out + term

    xp = pad2d(out, ((half, half), (0, 0)), mode)
    out2 = None
    for i in range(n):
        w = float(kernel[i])
        term = xp[..., i : i + H, :] * jnp.float32(w)
        out2 = term if out2 is None else out2 + term
    return out2
