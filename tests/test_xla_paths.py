"""The XLA solver bodies against the NumPy/SciPy oracles, at the shapes and
options that stress them: shapes off any tile grid, nonzero flow init,
asymmetric LK windows, a Liu-Shen tolerance met mid-run, wild and calibrated
Farneback flows, both window blurs, and the driver warp."""

import numpy as np
import jax.numpy as jnp
import pytest

from opticalflow_ri.models.farneback import (
    blur_update_flow, box_filter5, gaussian_blur5, poly_expansion,
    update_flow, update_matrices,
)
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.models.liu_shen import (
    liu_shen_iteration, liu_shen_precompute, liu_shen_solve,
)
from opticalflow_ri.models.lucas_kanade import lk_dense_solve
from opticalflow_ri.ops.warp import symmetric_warp_pair
from opticalflow_ri.oracle import farneback as ofb
from opticalflow_ri.oracle import horn_schunck as ohs
from opticalflow_ri.oracle import liu_shen as ols
from opticalflow_ri.oracle.lucas_kanade import lk_dense
from opticalflow_ri.oracle.pyramid import bilinear_warp_rounded
from conftest import aee

SHAPES = [(64, 128), (60, 130), (44, 150), (128, 256)]


def _images(shape, seed, lo=0.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 255, shape).astype(np.float32)
    b = rng.uniform(lo, 255, shape).astype(np.float32)
    return a, b, rng


def _init(shape, init, rng, scale=1.0):
    if init == "zero":
        z = np.zeros(shape, np.float32)
        return z, z
    return (rng.uniform(-scale, scale, shape).astype(np.float32),
            rng.uniform(-scale, scale, shape).astype(np.float32))


@pytest.mark.parametrize("init", ["zero", "random"])
@pytest.mark.parametrize("shape", SHAPES)
def test_hs_xla_matches_oracle(shape, init):
    a, b, rng = _images(shape, 1)
    u0, v0 = _init(shape, init, rng)
    u, v, err = hs_solve(jnp.asarray(a), jnp.asarray(b), 21.0, 45,
                         jnp.asarray(u0), jnp.asarray(v0))
    ou, ov, oerr = ohs.hs_solve(a, b, 21.0, 45, u0, v0)
    assert aee(u, v, ou, ov) < 1e-5
    np.testing.assert_allclose(float(err), oerr, rtol=1e-3)


@pytest.mark.parametrize("init", ["zero", "random"])
@pytest.mark.parametrize("shape", [(32, 128), (96, 128), (60, 130),
                                   (128, 256)])
def test_liu_shen_xla_matches_oracle(shape, init):
    a, b, rng = _images(shape, 5, lo=1.0)
    u0, v0 = _init(shape, init, rng, scale=0.5)
    u, v, err = liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 10.0,
                               jnp.asarray(u0), jnp.asarray(v0),
                               max_iter=30, tol=0.0)
    ou, ov, oerr = ols.liu_shen_solve(a, b, 10.0, u0, v0, max_iter=30,
                                      tol=0.0)
    scale = max(float(np.abs(ou).max()), float(np.abs(ov).max()))
    np.testing.assert_allclose(np.asarray(u), ou, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(v), ov, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(float(err), oerr, rtol=1e-3)


@pytest.mark.parametrize("k", [5, 11])
def test_liu_shen_tolerance_met_mid_run(k):
    """A tolerance between the errors of iterations k-1 and k stops the
    while_loop after exactly k iterations, like the reference's
    per-iteration check (ref: src/PhysicsBasedOpticalFlowLiuShen.py:88-89,
    :141)."""
    h, w = 64, 128
    a, b, _ = _images((h, w), 11, lo=1.0)
    z = jnp.zeros((h, w), jnp.float32)
    fields = liu_shen_precompute(jnp.asarray(a) / a.max(),
                                 jnp.asarray(b) / b.max(), 10.0)
    u, v, errs = z, z, []
    for _ in range(k + 1):
        un, vn = liu_shen_iteration(u, v, fields, 10.0)
        errs.append(float((jnp.linalg.norm(un - u)
                           + jnp.linalg.norm(vn - v)) / (h * w)))
        u, v = un, vn
    tol = (errs[k - 1] + errs[k - 2]) / 2.0
    assert errs[k - 1] <= tol < errs[k - 2]

    ut, vt, et = liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 10.0, z, z,
                                max_iter=40, tol=tol)
    uk, vk, ek = liu_shen_solve(jnp.asarray(a), jnp.asarray(b), 10.0, z, z,
                                max_iter=k, tol=0.0)
    np.testing.assert_array_equal(np.asarray(ut), np.asarray(uk))
    np.testing.assert_array_equal(np.asarray(vt), np.asarray(vk))
    assert float(et) == float(ek) <= tol
    ou, ov, oerr = ols.liu_shen_solve(a, b, 10.0, np.zeros((h, w)),
                                      np.zeros((h, w)), max_iter=40, tol=tol)
    np.testing.assert_allclose(float(et), oerr, rtol=1e-3)
    scale = float(np.abs(ou).max())
    np.testing.assert_allclose(np.asarray(ut), ou, rtol=1e-4,
                               atol=1e-5 * scale)


def _flows(kind, shape, rng):
    h, w = shape
    if kind == "wild":  # per-pixel random, inside the R=5 sampling envelope
        return (rng.uniform(-4.9, 4.9, shape).astype(np.float32),
                rng.uniform(-4.9, 4.9, shape).astype(np.float32))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)  # calibrated: smooth <=4
    return (3.5 * (1 - (2 * ys / h - 1) ** 2) - 0.5,
            1.5 * np.sin(xs / 20.0).astype(np.float32))


@pytest.mark.parametrize("kind", ["wild", "calibrated"])
@pytest.mark.parametrize("shape", [(64, 128), (44, 150)])
def test_update_matrices_r5_matches_oracle(shape, kind):
    a, b, rng = _images(shape, 2)
    r0 = poly_expansion(jnp.asarray(a), 7, 1.5)
    r1 = poly_expansion(jnp.asarray(b), 7, 1.5)
    fx, fy = _flows(kind, shape, rng)
    got = update_matrices(jnp.asarray(fx), jnp.asarray(fy), r0, r1, 5)
    want = ofb.update_matrices(fx, fy, np.asarray(r0), np.asarray(r1))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=2e-6 * scale)


def _psd_m(shape, seed):
    """A well-conditioned 5-plane M field (products of smooth factors), so
    the 2x2 flow solve does not amplify round-off."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    b = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return np.stack([a * a + c * c, (a + b) * c, b * b + c * c, a * d, c * d])


@pytest.mark.parametrize("use_gaussian", [True, False])
@pytest.mark.parametrize("shape", [(64, 128), (44, 150)])
def test_window_blur_and_update_flow_match_oracle(shape, use_gaussian):
    m = _psd_m(shape, 17)
    if use_gaussian:
        blurred = gaussian_blur5(jnp.asarray(m), 33, 33 / 2 * 0.3)
        want = ofb.gaussian_blur5(m, 33, 33 / 2 * 0.3)
    else:
        blurred = box_filter5(jnp.asarray(m), 16)
        want = ofb.box_filter5(m, 16)
    np.testing.assert_allclose(np.asarray(blurred), want, rtol=1e-5,
                               atol=1e-6)
    fx, fy = blur_update_flow(jnp.asarray(m), 33, use_gaussian)
    wfx, wfy = ofb.update_flow(want)
    np.testing.assert_allclose(np.asarray(fx), wfx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fy), wfy, rtol=1e-4, atol=1e-5)
    gfx, gfy = update_flow(blurred)
    np.testing.assert_array_equal(np.asarray(gfx), np.asarray(fx))
    np.testing.assert_array_equal(np.asarray(gfy), np.asarray(fy))


def _lk_pair(shape, seed, shift):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.roll(a, shift, axis=(0, 1)) + rng.normal(0, 2, shape).astype(
        np.float32)
    return a, b.astype(np.float32)


LK_CASES = [
    # (shape, asym, flow init, roll shift)
    ((64, 128), (0, 0, 0, 0), (0.0, 0.0), (1, 2)),
    ((32, 128), (0, 1, 0, 1), (0.5, -0.25), (0, 1)),
    ((32, 128), (1, 0, 0, 1), (0.5, -0.25), (0, 1)),
    ((60, 130), (0, 0, 0, 0), (0.0, 0.0), (1, 1)),
    ((96, 128), (0, 0, 0, 0), (0.25, -0.5), (1, 2)),
]


@pytest.mark.parametrize("shape,asym,init,shift", LK_CASES)
def test_lk_xla_matches_oracle(shape, asym, init, shift):
    a, b = _lk_pair(shape, 3, shift)
    u0 = np.full(shape, init[0], np.float32)
    v0 = np.full(shape, init[1], np.float32)
    u, v, st = lk_dense_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(u0),
                              jnp.asarray(v0), asym=asym)
    ou, ov, ost, _ = lk_dense(a, b, u0, v0, asym=asym, calc_err=False)
    du = np.abs(np.asarray(u) - ou)
    dv = np.abs(np.asarray(v) - ov)
    # LK's 0.01-px early exit amplifies summation-order noise on borderline
    # pixels: hold the bulk, the mean and the status map
    assert ((du < 1e-3) & (dv < 1e-3)).mean() > 0.99
    assert float(np.mean(np.hypot(du, dv))) < 1e-3
    assert (np.asarray(st) != ost).mean() < 1e-3


@pytest.mark.parametrize("asym", [(0, 0, 0, 0), (0, 1, 0, 1)])
def test_lk_error_map_matches_oracle(asym):
    """The GetError SAD map: its window contraction runs at HIGHEST
    precision, so no backend may take it to TF32."""
    shape = (48, 64)
    a, b = _lk_pair(shape, 9, (1, 1))
    z = np.zeros(shape, np.float32)
    out = lk_dense_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(z),
                         jnp.asarray(z), asym=asym, calc_err=True)
    _, _, _, oerr = lk_dense(a, b, z, z, asym=asym, calc_err=True)
    err = np.asarray(out[3])
    assert err.shape == shape and np.isfinite(err).all()
    close = np.abs(err - oerr) <= 1e-4 * np.abs(oerr).max()
    assert close.mean() > 0.99


@pytest.mark.parametrize("shape", [(24, 24), (37, 53), (48, 136),
                                   (64, 128)])
def test_symmetric_warp_matches_oracle(shape):
    rng = np.random.default_rng(29)
    im1 = rng.uniform(0, 255, shape).astype(np.float32)
    im2 = rng.uniform(0, 255, shape).astype(np.float32)
    u = rng.uniform(-6, 6, shape).astype(np.float32)
    v = rng.uniform(-6, 6, shape).astype(np.float32)
    w1, w2 = symmetric_warp_pair(jnp.asarray(im1), jnp.asarray(im2),
                                 jnp.asarray(u), jnp.asarray(v))
    ys, xs = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(w1), bilinear_warp_rounded(im1, ys - v / 2, xs - u / 2),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(w2), bilinear_warp_rounded(im2, ys + v / 2, xs + u / 2),
        rtol=1e-5, atol=1e-3)
