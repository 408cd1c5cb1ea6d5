"""Masked separable window sums as factor ladders of box sums.

The LK window weights are 0/1 masks over the 32-sample grid
(ref: src/pyrlkDenseLargeW.cl:321-374); a masked window sum decomposes into
maximal runs of ones, and each run of length L into a ladder of small box
sums over a 2/3/5-smooth factorisation of L (6 adds per element for the
width-27 window, against 26 for the plain slice sum).  Used by the LK
structure tensor and shift-plane build (models/lucas_kanade.py).
"""

from __future__ import annotations

import numpy as np
from jax import lax


def runs_from_mask(mask: np.ndarray):
    """Decompose a static 0/1 weight vector into maximal runs of ones."""
    runs = []
    start = None
    for idx, m in enumerate(mask.tolist() + [0.0]):
        if m != 0.0 and start is None:
            start = idx
        elif m == 0.0 and start is not None:
            runs.append((start, idx - 1))
            start = None
    return tuple(runs)


def _smooth_factorization(L: int):
    """Min-cost 2/3/5-smooth decomposition: the smooth L' <= L (returned as
    its factor list, plus the remainder L - L') minimising total sliding-sum
    adds = sum(f - 1 for f in factors) + (L - L').  Note this is NOT simply
    the largest smooth L' <= L — e.g. L=26 picks 24 (cost 6+2) over 25
    (cost 8+1)."""
    best = (L - 1, [], L)  # (adds, factors, remainder) — all-direct fallback
    for lp in range(L, 0, -1):
        m, factors = lp, []
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
                factors.append(f)
        if m != 1:
            continue
        adds = sum(f - 1 for f in factors) + (L - lp)
        if adds < best[0]:
            best = (adds, sorted(factors), L - lp)
    return best[1], best[2]


def _ladder_run(x, lo, L, axis, out_len):
    """Width-L sliding sum starting at offset ``lo`` via a factor ladder:
    S_1 = x;  S_{m*f}(c) = sum_{j<f} S_m(c + j*m)."""
    factors, rem = _smooth_factorization(L)
    s, m = x, 1
    for f in factors:
        n = s.shape[axis]
        nxt = None
        for j in range(f):
            t = lax.slice_in_dim(s, j * m, n - (f - 1) * m + j * m, axis=axis)
            nxt = t if nxt is None else nxt + t
        s, m = nxt, m * f
    term = lax.slice_in_dim(s, lo, lo + out_len, axis=axis)
    for k in range(lo + m, lo + L):
        term = term + lax.slice_in_dim(x, k, k + out_len, axis=axis)
    return term


def windowed_sum_axis(x, runs, axis, out_len):
    """sum_k mask[k] * x[p + k - half_window] along ``axis``, one factor
    ladder per run of ones.  ``x`` covers positions
    [-hw, out_len-1+GRID-1-hw] relative to the output origin."""
    out = None
    for lo, hi in runs:
        term = _ladder_run(x, lo, hi - lo + 1, axis, out_len)
        out = term if out is None else out + term
    return out


def wsum2d(x, runs_y, runs_x, out_h, out_w):
    """Separable masked window sum of ``x`` (covering the padded off-domain)
    down to the (out_h, out_w) pixel grid (x-axis pass first)."""
    t = windowed_sum_axis(x, runs_x, x.ndim - 1, out_w)
    return windowed_sum_axis(t, runs_y, x.ndim - 2, out_h)
