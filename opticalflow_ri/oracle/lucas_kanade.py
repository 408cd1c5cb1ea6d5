"""Oracle dense windowed Lucas-Kanade (semantics of ref: src/pyrlkDenseLargeW.cl
+ src/denseLucasKanade_PyCL.py), vectorised NumPy.

Per output pixel (i, j) the OpenCL kernel runs a Gauss-Newton iteration over a
32x32 sample grid masked down to the (2*halfWindow+1)^2 window:

  * patch of I and Scharr-style gradients (weights 3/10/3) read through the
    hardware sampler at integer offsets -> exact pixels of the replicate-padded
    image (CLAMP_TO_EDGE); the -0.5 sampler offset cancels for integer coords;
  * structure tensor A = [sum gx^2, sum gx gy; ., sum gy^2] over the weighted
    window; singular bail-out D < 1.192092896e-7 keeps the INPUT flow and
    clears status;
  * up to Niter steps: sample J with the bilinear sampler at the flow-shifted
    window, b = sum w (J - I) grad, delta = -A^{-1} b * 32, stop when both
    |delta| < 0.01 or the window origin leaves [-halfWin, cols);
  * window weights follow the kernel's tile rules (tiles of 8 columns; the
    asymmetric-window config can zero column 8 and trailing columns).

This oracle exists to pin those semantics down for the engine's
tests; it is vectorised over pixels but otherwise kept literal.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

_GRID = 32
_D_EPS = np.float32(1.192092896e-07)
_STEP_EPS = 0.01


def window_mask(win: int, asym_near: int, asym_far: int) -> np.ndarray:
    """Per-column weights over the 32-sample grid, replicating the kernel's
    tile weight rules (ref: src/pyrlkDenseLargeW.cl:321-374).  ``win`` is the
    full window size (2*halfWindow+1); near/far are the asymmetric-window
    flags (left/top, right/bottom)."""
    m = np.zeros(_GRID, np.float32)
    large = win >= 16  # the -DWSX=1 / -DWSY=1 compile path
    for c in range(_GRID):
        tile, lid = divmod(c, 8)
        if large:
            if tile == 0:
                w = 1.0
            elif tile == 1:
                w = (1.0 - asym_near) if lid == 0 else 1.0
            else:
                w = 1.0 if (c < win - asym_far) else 0.0
        else:
            if tile == 0:
                w = 1.0
            elif tile == 1:
                w = 1.0 if (c < win - asym_far) else 0.0
                if lid == 0:
                    w = 1.0 - asym_near
            else:
                w = 0.0
        m[c] = w
    return m


def _cl_bilinear_windows(jpad, ay, ax, pad):
    """For each pixel, gather a 33x33 window of the padded J starting at the
    per-pixel integer base (ay, ax); returns (H, W, 33, 33)."""
    sw = sliding_window_view(jpad, (_GRID + 1, _GRID + 1))
    ay = np.clip(ay + pad, 0, sw.shape[0] - 1)
    ax = np.clip(ax + pad, 0, sw.shape[1] - 1)
    return sw[ay, ax]


def lk_dense(im1, im2, u0, v0, half_window=13, n_iter=5, asym=(0, 0, 0, 0),
             level=0, calc_err=True):
    """Returns (u, v, status, err).  ``asym`` is (left, right, top, bottom)."""
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    h, w = im1.shape
    win = 2 * half_window + 1
    hw = half_window

    wx = window_mask(win, asym[0], asym[1])
    wy = window_mask(win, asym[2], asym[3])
    wgt = wy[:, None] * wx[None, :]  # (32, 32)

    # padded images: wide enough for window extent + max plausible shift
    maxd = int(np.ceil(max(np.abs(u0).max(), np.abs(v0).max(), 1.0)))
    pad = hw + _GRID + maxd + 8 * n_iter  # generous; replicate border == CLAMP_TO_EDGE
    ipad = np.pad(im1, pad, mode="edge")
    jpad = np.pad(im2, pad, mode="edge")

    # local 34x34 patches of I around each pixel: L[p, y, x] = ipad[i-hw-1+y, ...]
    swi = sliding_window_view(ipad, (_GRID + 2, _GRID + 2))
    base = pad - hw - 1
    li = swi[base : base + h, base : base + w]  # (H, W, 34, 34)

    pch = li[:, :, 1:-1, 1:-1]  # I at window positions (H, W, 32, 32)
    gx = (
        3.0 * (li[:, :, :-2, 2:] + li[:, :, 2:, 2:] - li[:, :, :-2, :-2] - li[:, :, 2:, :-2])
        + 10.0 * (li[:, :, 1:-1, 2:] - li[:, :, 1:-1, :-2])
    ) * wgt
    gy = (
        3.0 * (li[:, :, 2:, :-2] + li[:, :, 2:, 2:] - li[:, :, :-2, :-2] - li[:, :, :-2, 2:])
        + 10.0 * (li[:, :, 2:, 1:-1] - li[:, :, :-2, 1:-1])
    ) * wgt

    a11 = np.einsum("hwrc,hwrc->hw", gx, gx, dtype=np.float32)
    a12 = np.einsum("hwrc,hwrc->hw", gx, gy, dtype=np.float32)
    a22 = np.einsum("hwrc,hwrc->hw", gy, gy, dtype=np.float32)
    det = a11 * a22 - a12 * a12
    ok = det >= _D_EPS
    det_safe = np.where(ok, det, 1.0)
    ia11 = a11 / det_safe
    ia12 = a12 / det_safe
    ia22 = a22 / det_safe

    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    prevx = jj + np.asarray(u0, np.float32) - hw
    prevy = ii + np.asarray(v0, np.float32) - hw

    status = np.ones((h, w), np.float32)
    active = ok.copy()

    for _ in range(n_iter):
        oob = (prevx < -hw) | (prevx >= w) | (prevy < -hw) | (prevy >= h)
        if level == 0:
            status[active & oob] = 0.0
        active = active & ~oob
        if not active.any():
            break

        x0 = np.floor(prevx).astype(np.int64)
        y0 = np.floor(prevy).astype(np.int64)
        fx = (prevx - x0)[:, :, None, None].astype(np.float32)
        fy = (prevy - y0)[:, :, None, None].astype(np.float32)
        jwin = _cl_bilinear_windows(jpad, y0, x0, pad)
        js = (
            (1 - fy) * (1 - fx) * jwin[:, :, :-1, :-1]
            + (1 - fy) * fx * jwin[:, :, :-1, 1:]
            + fy * (1 - fx) * jwin[:, :, 1:, :-1]
            + fy * fx * jwin[:, :, 1:, 1:]
        ).astype(np.float32)

        diff = (js - pch) * wgt
        b1 = np.einsum("hwrc,hwrc->hw", diff, gx, dtype=np.float32)
        b2 = np.einsum("hwrc,hwrc->hw", diff, gy, dtype=np.float32)

        dx = (ia12 * b2 - ia22 * b1) * 32.0
        dy = (ia12 * b1 - ia11 * b2) * 32.0

        prevx = np.where(active, prevx + dx, prevx)
        prevy = np.where(active, prevy + dy, prevy)
        small = (np.abs(dx) < _STEP_EPS) & (np.abs(dy) < _STEP_EPS)
        active = active & ~small

    u = np.where(ok, prevx + hw - jj, np.asarray(u0, np.float32))
    v = np.where(ok, prevy + hw - ii, np.asarray(v0, np.float32))
    status = np.where(ok, status, 0.0)

    err = None
    if calc_err:
        x0 = np.floor(prevx).astype(np.int64)
        y0 = np.floor(prevy).astype(np.int64)
        fx = (prevx - x0)[:, :, None, None].astype(np.float32)
        fy = (prevy - y0)[:, :, None, None].astype(np.float32)
        jwin = _cl_bilinear_windows(jpad, y0, x0, pad)
        js = (
            (1 - fy) * (1 - fx) * jwin[:, :, :-1, :-1]
            + (1 - fy) * fx * jwin[:, :, :-1, 1:]
            + fy * (1 - fx) * jwin[:, :, 1:, :-1]
            + fy * fx * jwin[:, :, 1:, 1:]
        ).astype(np.float32)
        quant = lambda p: ((p * 16384.0) + 256.0) / 512.0
        emask = (window_mask(win, 0, 0)[None, :] * window_mask(win, 0, 0)[:, None]) * wgt
        sad = np.einsum("hwrc,rc->hw", np.abs(quant(js) - quant(pch)), emask, dtype=np.float32)
        err = np.where(ok, sad / np.float32(32 * win * win), 0.0)

    return u, v, status, err


class OracleDenseLKAdapter:
    def __init__(self, Niter=5, halfWindow=13):
        self.Niter = Niter
        self.halfWindow = halfWindow

    def compute(self, im1, im2, U, V):
        u, v, _, _ = lk_dense(im1, im2, U, V, self.halfWindow, self.Niter, calc_err=False)
        return u, v, True

    def getAlgoName(self):
        return "Oracle Dense LK"

    def hasGenericPyramidalDefaults(self):
        return True

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "intermediateScaling": True, "scaling": False}
