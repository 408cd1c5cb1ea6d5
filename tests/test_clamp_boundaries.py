"""Pin the documented clamp envelopes of the tent-contraction sampling paths.

Both hot-path samplers trade per-pixel gathers for dense tent-weight
contractions over static integer shifts, clamped to [-R, R-1e-3] (R=6 by
default):

  * LK Gauss-Newton warp sampling (models/lucas_kanade.py, ``max_shift``),
    vs the same solver with ``max_shift=12`` (exact for |flow| <= 12; the
    planes cover every sampled corner, no clamping occurs);
  * Farneback ``update_matrices`` (models/farneback.py,
    ``sample_max_shift``), vs its exact gather path
    (``sample_max_shift=None``, ref: optical_flow_farneback.cl:256-348).

The calibrated regime is |flow| <= 4 px (ref README.md:3); these tests
demonstrate the actual safe envelope: parity at 5.5 px, graceful sub-0.05 px
error AT the 6 px boundary (the clip to R-1e-3 blends 99.9% of the correct
tap), and real divergence at 8 px.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from opticalflow_ri.models.farneback import poly_expansion, update_matrices
from opticalflow_ri.models.lucas_kanade import lk_dense_solve


def _band_limited(shape, shift=(0.0, 0.0), seed=0):
    """Smooth analytic image translated EXACTLY by (dy, dx) — evaluated at
    shifted coordinates, so any displacement is representable."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    ys = ys - shift[0]
    xs = xs - shift[1]
    img = np.zeros(shape)
    for _ in range(8):
        fy, fx = rng.uniform(0.01, 0.04, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.5, 1.0)
        img += amp * np.sin(2 * np.pi * (fy * ys + fx * xs) + ph)
    return (127.5 + 50.0 * img).astype(np.float32)


# ---------------------------------------------------------------------------
# LK: max_shift=6 vs the exact max_shift=12 solver
# ---------------------------------------------------------------------------

def _lk_both(d):
    im1 = _band_limited((64, 64))
    im2 = _band_limited((64, 64), shift=(0.0, d))
    u0 = jnp.full(im1.shape, float(d), jnp.float32)
    v0 = jnp.zeros(im1.shape, jnp.float32)
    out = {}
    for R in (6, 12):
        u, v, _ = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), u0, v0,
                                 half_window=13, n_iter=5, max_shift=R,
                                 impl="xla")
        out[R] = (np.asarray(u), np.asarray(v))
    return out


def _interior(a, m=20):
    return a[m:-m, m:-m]


def test_lk_parity_inside_envelope():
    """|flow| = 5.5 < R: clamp never engages; bit-level agreement."""
    out = _lk_both(5.5)
    np.testing.assert_allclose(_interior(out[6][0]), _interior(out[12][0]),
                               atol=1e-4)
    assert abs(float(np.mean(_interior(out[12][0]))) - 5.5) < 0.05


def test_lk_boundary_at_r():
    """|flow| = 6 = R: the clip to R-1e-3 costs < 0.05 px."""
    out = _lk_both(6.0)
    diff = np.abs(_interior(out[6][0]) - _interior(out[12][0]))
    assert float(diff.max()) < 0.05
    assert abs(float(np.mean(_interior(out[6][0]))) - 6.0) < 0.05


def test_lk_divergence_beyond_r():
    """|flow| = 8 > R: the clamped solver measurably diverges from the
    exact one (this is the documented envelope edge, 2x the calibrated
    regime)."""
    out = _lk_both(8.0)
    # exact solver stays locked on the true 8 px displacement
    assert abs(float(np.mean(_interior(out[12][0]))) - 8.0) < 0.05
    diff = np.abs(_interior(out[6][0]) - _interior(out[12][0]))
    assert float(diff.max()) > 0.5


# ---------------------------------------------------------------------------
# Farneback update_matrices: tent contraction vs exact gather
# ---------------------------------------------------------------------------

def _um_both(d):
    im1 = _band_limited((64, 64), seed=1)
    im2 = _band_limited((64, 64), shift=(0.0, d), seed=1)
    r0 = poly_expansion(jnp.asarray(im1), 7, 1.5)
    r1 = poly_expansion(jnp.asarray(im2), 7, 1.5)
    fx = jnp.full(im1.shape, float(d), jnp.float32)
    fy = jnp.zeros(im1.shape, jnp.float32)
    tent = np.asarray(update_matrices(fx, fy, r0, r1, sample_max_shift=6))
    exact = np.asarray(update_matrices(fx, fy, r0, r1, sample_max_shift=None))
    return tent, exact


def test_update_matrices_parity_inside_envelope():
    tent, exact = _um_both(5.5)
    np.testing.assert_allclose(tent, exact, atol=1e-3)


def test_update_matrices_boundary_at_r():
    """flow = 6: the 1e-3 clip blends 99.9% of the correct tap; relative
    error stays under 1%."""
    tent, exact = _um_both(6.0)
    scale = np.abs(exact).max()
    assert float(np.abs(tent - exact).max()) < 0.01 * scale


def test_update_matrices_divergence_beyond_r():
    tent, exact = _um_both(8.0)
    scale = np.abs(exact).max()
    assert float(np.abs(tent - exact).max()) > 0.05 * scale
