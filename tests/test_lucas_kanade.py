"""Dense LK parity: the shift-plane implementation vs the CL-faithful oracle."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.models.lucas_kanade import lk_dense_solve, DenseLucasKanadeAdapter
from opticalflow_ri.oracle.lucas_kanade import lk_dense, window_mask


def _compare(u, v, ou, ov, frac=0.99, tol=1e-2):
    """LK lets near-singular pixels take wild steps; compare the well-behaved
    bulk (pixels where the oracle flow stays in the calibrated regime)."""
    m = (np.abs(ou) < 5) & (np.abs(ov) < 5)
    du = np.abs(np.asarray(u) - ou)[m]
    dv = np.abs(np.asarray(v) - ov)[m]
    assert m.mean() > 0.9
    good = ((du < tol) & (dv < tol)).mean()
    assert good > frac, f"only {good:.3f} of pixels within {tol}"


def test_window_mask_default():
    m = window_mask(27, 0, 0)
    assert m[:27].sum() == 27 and m[27:].sum() == 0


def test_window_mask_asym():
    m = window_mask(27, 1, 0)
    assert m[8] == 0 and m[0] == 1 and m[26] == 1
    m = window_mask(27, 0, 1)
    assert m[26] == 0 and m[25] == 1


def test_lk_zero_flow_on_identical_images(piv_pair_small):
    im1, _, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, status = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im1), jnp.asarray(z), jnp.asarray(z))
    # identical images: residual is zero, flow stays ~0 where A is invertible
    m = np.asarray(status) > 0
    assert m.mean() > 0.5
    assert np.abs(np.asarray(u)[m]).max() < 1e-2
    assert np.abs(np.asarray(v)[m]).max() < 1e-2


def test_lk_matches_oracle_zero_init(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, status = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z))
    ou, ov, ostatus, _ = lk_dense(im1, im2, z, z, calc_err=False)
    _compare(u, v, ou, ov)
    # status may differ on isolated pixels where f32 summation-order noise
    # crosses the bail thresholds
    assert (np.asarray(status) != ostatus).mean() < 1e-3


def test_lk_matches_oracle_nonzero_init(piv_pair_small):
    im1, im2, u_true, v_true = piv_pair_small
    u0 = (u_true * 0.7).astype(np.float32)
    v0 = (v_true * 0.7).astype(np.float32)
    u, v, _ = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u0), jnp.asarray(v0))
    ou, ov, _, _ = lk_dense(im1, im2, u0, v0, calc_err=False)
    _compare(u, v, ou, ov)


def test_lk_recovers_flow(piv_pair_small):
    im1, im2, u_true, v_true = piv_pair_small
    z = np.zeros_like(im1)
    u, v, _ = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z))
    c = 16
    err = np.mean(
        np.hypot(
            np.asarray(u)[c:-c, c:-c] - u_true[c:-c, c:-c],
            np.asarray(v)[c:-c, c:-c] - v_true[c:-c, c:-c],
        )
    )
    assert err < 0.5, err


def test_lk_asymmetric_window(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, _ = lk_dense_solve(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z), asym=(0, 1, 0, 1)
    )
    ou, ov, _, _ = lk_dense(im1, im2, z, z, asym=(0, 1, 0, 1), calc_err=False)
    _compare(u, v, ou, ov)


def test_adapter_protocol(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    ad = DenseLucasKanadeAdapter(Niter=3, halfWindow=13)
    z = np.zeros_like(im1)
    u, v, err = ad.compute(im1, im2, z, z)
    assert err is True  # reference returns its calcErr flag
    assert ad.getGenericPyramidalDefaults() == {
        "warping": False, "intermediateScaling": True, "scaling": False,
    }
    assert np.asarray(u).shape == im1.shape


def test_vorticity_enhancement_end_to_end(piv_pair_small):
    """enableVorticityEnhancement picks an asymmetric window from the mean
    curl (ref: denseLucasKanade_PyCL.py:75-92)."""
    from opticalflow_ri.models.lucas_kanade import evaluate_vorticity_asym

    im1, im2, _, _ = piv_pair_small
    h, w = im1.shape
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    # solid-body-like rotation.  NOTE the reference's filter2 is
    # ndimage.convolve (kernel flipped), so its "omega" is the NEGATED curl:
    # dV/dx>0, dU/dy<0 here gives omega_ref < 0 -> (0,1,0,1).
    u = np.broadcast_to(-(ys - h / 2) * 0.1, (h, w)).astype(np.float32)
    v = np.broadcast_to((xs - w / 2) * 0.1, (h, w)).astype(np.float32)
    assert evaluate_vorticity_asym(u, v, True) == (0, 1, 0, 1)
    assert evaluate_vorticity_asym(-u, -v, True) == (1, 0, 0, 1)
    assert evaluate_vorticity_asym(np.zeros_like(u), np.zeros_like(v), True) == (0, 0, 0, 0)
    assert evaluate_vorticity_asym(u, v, False) == (0, 0, 0, 0)

    ad = DenseLucasKanadeAdapter(Niter=2, halfWindow=13, enableVorticityEnhancement=True)
    uo, vo, _ = ad.compute(im1, im2, u * 0.01, v * 0.01)
    assert np.isfinite(np.asarray(uo)).all()


def test_lk_odd_shapes():
    """Non-tile-aligned and small images work (padding covers the window)."""
    from opticalflow_ri.utils.synthetic import particle_image_pair

    for shape in ((45, 67), (33, 130)):
        im1, im2, _, _ = particle_image_pair(shape=shape, seed=5, max_disp=1.5)
        z = np.zeros_like(im1)
        u, v, st = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z), jnp.asarray(z), n_iter=2)
        ou, ov, ost, _ = lk_dense(im1, im2, z, z, n_iter=2, calc_err=False)
        _compare(u, v, ou, ov, frac=0.97)


def test_lk_error_map_matches_oracle(piv_pair_small):
    """GetError SAD map parity (ref: src/pyrlkDenseLargeW.cl:617-667)."""
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    out = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(z),
                         jnp.asarray(z), calc_err=True)
    assert len(out) == 4
    u, v, status, err = out
    ou, ov, _, oerr = lk_dense(im1, im2, z, z, calc_err=True)
    # compare err on the well-behaved bulk (flows agree => windows agree)
    m = (np.abs(ou) < 5) & (np.abs(ov) < 5) \
        & (np.abs(np.asarray(u) - ou) < 1e-3) & (np.abs(np.asarray(v) - ov) < 1e-3)
    assert m.mean() > 0.9
    np.testing.assert_allclose(np.asarray(err)[m], oerr[m], atol=5e-3)
    # singular-A pixels return before the GetError pass -> err stays 0 (the
    # zero-initialised host buffer); OOB-bailed pixels (status==0) DO get err.
    # The zero sets must agree with the oracle's up to f32 threshold noise.
    assert ((np.asarray(err) == 0.0) == (oerr == 0.0)).mean() > 0.999


def test_lk_error_map_asym_window(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    _, _, _, err = lk_dense_solve(jnp.asarray(im1), jnp.asarray(im2),
                                  jnp.asarray(z), jnp.asarray(z),
                                  asym=(0, 1, 0, 1), calc_err=True)
    _, _, _, oerr = lk_dense(im1, im2, z, z, asym=(0, 1, 0, 1), calc_err=True)
    d = np.abs(np.asarray(err) - oerr)
    assert (d < 5e-3).mean() > 0.95


def test_adapter_error_map(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    ad = DenseLucasKanadeAdapter(computeErrorMap=True)
    u, v, flag = ad.compute(im1, im2, z, z)
    assert flag is True
    assert ad.lastErrorMap is not None
    assert ad.lastErrorMap.shape == im1.shape
    assert np.isfinite(np.asarray(ad.lastErrorMap)).all()
