"""Liu-Shen solver parity vs oracle."""

import numpy as np
import jax.numpy as jnp

from opticalflow_ri.models.liu_shen import liu_shen_solve, LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri.oracle.liu_shen import liu_shen_solve as oracle_ls, OracleLiuShenAdapter
from conftest import aee


def test_liu_shen_matches_oracle(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    u, v, err = liu_shen_solve(jnp.asarray(im1), jnp.asarray(im2), 1000.0, jnp.asarray(z), jnp.asarray(z))
    ou, ov, oerr = oracle_ls(im1, im2, 1000.0, z, z)
    assert aee(u, v, ou, ov) < 1e-5


def test_adapter_swaps_components(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    z = np.zeros_like(im1)
    ours = LiuShenOpticalFlowAlgoAdapter(1000.0)
    orac = OracleLiuShenAdapter(1000.0)
    u1, v1, _ = ours.compute(im1, im2, z, z)
    u2, v2, _ = orac.compute(im1, im2, z, z)
    assert aee(u1, v1, np.asarray(u2), np.asarray(v2)) < 1e-5


def test_refines_initial_flow(piv_pair_small):
    """Used as a refiner, Liu-Shen should not blow up a good initial flow."""
    im1, im2, u_true, v_true = piv_pair_small
    u0 = jnp.asarray(u_true)
    v0 = jnp.asarray(v_true)
    ad = LiuShenOpticalFlowAlgoAdapter(10000.0)
    u, v, _ = ad.compute(jnp.asarray(im1), jnp.asarray(im2), u0, v0)
    assert np.isfinite(np.asarray(u)).all()
    assert np.isfinite(np.asarray(v)).all()
