"""Liu-Shen (optical-flow-equation) warp mode parity
(ref: GenericPyramidalOpticalFlow.py:204-221, the biLinear=False path)."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.ops.warp import liu_shen_warp
from opticalflow_ri.oracle.gaussian import gaussian_filter as oracle_gauss


def _oracle_ls_warp(im1, u, v):
    im1 = im1.copy()
    h, w = im1.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    us = np.int32(xs + np.floor(u + 0.5))
    vs = np.int32(ys + np.floor(v + 0.5))
    du = u - np.floor(u + np.float32(0.5))
    dv = v - np.floor(v + np.float32(0.5))
    # numpy fancy assignment wraps negative indices; the library clips the
    # high end where the reference would fault (documented divergence)
    us = np.clip(np.where(us < 0, us + w, us), 0, w - 1)
    vs = np.clip(np.where(vs < 0, vs + h, vs), 0, h - 1)
    im1[vs, us] = im1[ys, xs]
    du = oracle_gauss(du, 0.6 * 3, 4.0 / 0.6 * 3)
    dv = oracle_gauss(dv, 0.6 * 3, 4.0 / 0.6 * 3)
    tdx = (im1[:-1, 1:] * du[:-1, 1:] - im1[:-1, :-1] * du[:-1, :-1])
    tdy = (im1[1:, :-1] * dv[1:, :-1] - im1[:-1, :-1] * dv[:-1, :-1])
    im1[:-1, :-1] = im1[:-1, :-1] - (tdx + tdy)
    return im1


def test_ls_warp_subpixel_flow():
    """Sub-0.5px flows: the integer scatter is the identity, isolating the
    intensity-correction math."""
    rng = np.random.default_rng(0)
    im = rng.uniform(0, 255, (40, 48)).astype(np.float32)
    u = (rng.uniform(-0.4, 0.4, im.shape)).astype(np.float32)
    v = (rng.uniform(-0.4, 0.4, im.shape)).astype(np.float32)

    got = np.asarray(liu_shen_warp(jnp.asarray(im), jnp.asarray(u), jnp.asarray(v)))
    want = _oracle_ls_warp(im, u, v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_ls_warp_duplicate_destinations_last_write_wins():
    """Colliding integer shifts must resolve exactly like numpy fancy
    assignment (last writer in row-major source order wins)."""
    rng = np.random.default_rng(7)
    im = rng.uniform(0, 255, (32, 40)).astype(np.float32)
    # large random integer-ish flows -> many duplicate destinations
    u = rng.integers(-5, 6, im.shape).astype(np.float32)
    v = rng.integers(-5, 6, im.shape).astype(np.float32)

    # verify the test actually exercises collisions
    h, w = im.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    dst = (np.clip(ys + v.astype(np.int64), 0, h - 1) * w
           + np.clip(xs + u.astype(np.int64), 0, w - 1))
    assert len(np.unique(dst)) < dst.size

    got = np.asarray(liu_shen_warp(jnp.asarray(im), jnp.asarray(u), jnp.asarray(v)))
    want = _oracle_ls_warp(im, u, v)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_driver_accepts_ls_warp_mode(piv_pair_small):
    """biLinear=False end-to-end through the pyramid driver."""
    from opticalflow_ri.pyramid import generic_pyramidal_optical_flow
    from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter

    im1, im2, _, _ = piv_pair_small
    ad = HSOpticalFlowAlgoAdapter([21.0, 45.0], 20, provideGenericPyramidalDefaults=False)
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 2.0, ad, 2, 1, warping=True, biLinear=False,
    )
    assert np.isfinite(np.asarray(u)).all()
