"""Horn-Schunck solver parity vs oracle, plus flow-quality sanity."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.models.horn_schunck import hs_solve, HSOpticalFlowAlgoAdapter
from opticalflow_ri.oracle.horn_schunck import hs_solve as oracle_hs
from conftest import aee


def test_hs_matches_oracle(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, err = hs_solve(jnp.asarray(im1), jnp.asarray(im2), 21.0, 100, jnp.asarray(z), jnp.asarray(z))
    ou, ov, oerr = oracle_hs(im1, im2, 21.0, 100, z, z)
    assert aee(u, v, ou, ov) < 1e-4
    np.testing.assert_allclose(float(err), oerr, rtol=1e-3, atol=1e-6)


def test_hs_recovers_parabolic_flow(piv_pair_small):
    im1, im2, u_true, v_true = piv_pair_small
    z = np.zeros_like(im1)
    u, v, _ = hs_solve(jnp.asarray(im1), jnp.asarray(im2), 21.0, 400, jnp.asarray(z), jnp.asarray(z))
    # interior error (borders are weakly constrained in HS)
    c = 12
    err = aee(np.asarray(u)[c:-c, c:-c], np.asarray(v)[c:-c, c:-c],
              u_true[c:-c, c:-c], v_true[c:-c, c:-c])
    assert err < 0.8


def test_adapter_alpha_pop_order():
    ad = HSOpticalFlowAlgoAdapter([1.0, 2.0], Niter=1)
    im = np.random.default_rng(0).uniform(0, 255, (16, 16)).astype(np.float32)
    z = np.zeros_like(im)
    ad.compute(im, im, z, z)
    assert ad.alphas == [1.0]  # last alpha consumed first


def test_adapter_defaults():
    ad = HSOpticalFlowAlgoAdapter([1.0], 1)
    assert ad.hasGenericPyramidalDefaults()
    assert ad.getGenericPyramidalDefaults() == {
        "warping": True, "biLinear": True, "scaling": True,
    }
