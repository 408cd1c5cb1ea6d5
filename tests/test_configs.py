"""Calibrated config registry: every config runs end to end; LK/FB driver
compositions match the oracle driver."""

import numpy as np
import pytest

from opticalflow_ri.configs import CONFIGS, EXAMPLE_CONFIG_NAMES, run_config, hs_alphas
from opticalflow_ri.oracle.pyramid import pyramidal_optical_flow as oracle_pyr
from opticalflow_ri.oracle.lucas_kanade import OracleDenseLKAdapter
from opticalflow_ri.oracle.farneback import OracleFarnebackAdapter
from conftest import aee


def test_hs_alpha_table():
    assert hs_alphas(1) == [21]
    assert hs_alphas(2) == [21, 45]
    assert hs_alphas(2, k_levels=2) == [21, 21, 45, 45]
    assert hs_alphas(1, bits="Bits12", ni="Ni16") == [550]


def test_registry_complete():
    for name in EXAMPLE_CONFIG_NAMES:
        assert name in CONFIGS
    assert len(CONFIGS) >= 17


@pytest.mark.parametrize("name", EXAMPLE_CONFIG_NAMES)
def test_example_configs_run(name, piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = run_config(name, im1, im2)
    u = np.asarray(u)
    v = np.asarray(v)
    assert u.shape == im1.shape
    assert np.isfinite(u).all() and np.isfinite(v).all()
    assert np.abs(u).max() < 50


def test_lk_config_matches_oracle_driver(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = run_config("denseLK_Fs2_0_PyrLvls2", im1, im2)
    ou, ov = oracle_pyr(
        im1, im2, 2.0, OracleDenseLKAdapter(Niter=5, halfWindow=13),
        pyramidal_levels=2, FILTER_OPT=0.48, warping=False,
    )
    assert aee(u, v, ou, ov) < 5e-2


def test_fb_config_matches_oracle_driver(piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = run_config("Farneback_Fs0_0_PyrLvls2", im1, im2)
    ou, ov = oracle_pyr(
        im1, im2, 0.0, OracleFarnebackAdapter(), pyramidal_levels=2,
    )
    assert aee(u, v, ou, ov) < 5e-3


@pytest.mark.parametrize("name,sigma", [
    ("LiuSE_LK_Fs2_0_PyrLvls2", 2.0),   # ref: benchmark_of_methods.py:197-201
    ("LiuSE_FB_Fs0_0_PyrLvls2", 0.0),   # ref: benchmark_of_methods.py:251-255
    ("LiuSE_HS_Fs3_4_PyrLvls2", 3.4),   # ref: benchmark_of_methods.py:143-148
])
def test_liuse_main_configs_match_oracle(name, sigma, piv_pair_small):
    """Benchmark quirk: LiuShen(0.1) REPLACES the main adapter
    (ref: benchmark_of_methods.py:159-163, :211-215, :265-269)."""
    from opticalflow_ri.oracle.liu_shen import OracleLiuShenAdapter

    im1, im2, _, _ = piv_pair_small
    u, v = run_config(name, im1, im2)
    ou, ov = oracle_pyr(im1, im2, sigma, OracleLiuShenAdapter(0.1),
                        pyramidal_levels=2)
    assert aee(u, v, ou, ov) < 1e-4


def test_batched_pipeline_all_solvers(piv_pair_small):
    """vmapped whole-config pipelines work for every solver family."""
    import jax.numpy as jnp
    from opticalflow_ri.compile import batched_pipeline

    im1, im2, _, _ = piv_pair_small
    b1 = jnp.stack([jnp.asarray(im1)] * 2)
    b2 = jnp.stack([jnp.asarray(im2)] * 2)
    for name in ("HS_Fs0_0", "denseLK_Fs2_0", "Farneback_Fs0_0"):
        u, v = batched_pipeline(name)(b1, b2)
        assert u.shape == b1.shape
        assert np.isfinite(np.asarray(u)).all()
        np.testing.assert_allclose(np.asarray(u)[0], np.asarray(u)[1], atol=1e-5)


def test_scan_pipeline_matches_single(piv_pair_small):
    import jax.numpy as jnp
    from opticalflow_ri.compile import scan_pipeline, compiled_pipeline

    im1, im2, _, _ = piv_pair_small
    K = 3
    b1 = jnp.stack([jnp.asarray(im1)] * K)
    b2 = jnp.stack([jnp.asarray(im2)] * K)
    us, vs = scan_pipeline("HS_Fs0_0")(b1, b2)
    u1, v1 = compiled_pipeline("HS_Fs0_0")(jnp.asarray(im1), jnp.asarray(im2))
    assert us.shape == (K,) + im1.shape
    np.testing.assert_allclose(np.asarray(us)[1], np.asarray(u1), atol=1e-6)
