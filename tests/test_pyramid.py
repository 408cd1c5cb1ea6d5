"""End-to-end pyramidal driver parity vs the oracle driver (HS + Liu-Shen)."""

import numpy as np

from opticalflow_ri.pyramid import generic_pyramidal_optical_flow
from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter
from opticalflow_ri.models.liu_shen import LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri.oracle.pyramid import pyramidal_optical_flow as oracle_pyramid
from opticalflow_ri.oracle.horn_schunck import OracleHSAdapter
from opticalflow_ri.oracle.liu_shen import OracleLiuShenAdapter
from conftest import aee


def test_hs_single_level(piv_pair_medium):
    """PyHSchunck_Fs3_4-style config (ref: examples/PyHSchunck_Fs3_4.py)."""
    im1, im2, _, _ = piv_pair_medium
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0], 100), 1, 1
    )
    ou, ov = oracle_pyramid(im1, im2, 3.4, OracleHSAdapter([21.0], 100), 1, 1)
    assert aee(u, v, ou, ov) < 5e-4


def test_hs_two_levels(piv_pair_medium):
    """Exercises resize, spline upsample, scaling and symmetric warping
    (ref: examples/PyHSchunck_Fs3_4_PyrLvls2.py)."""
    im1, im2, _, _ = piv_pair_medium
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1
    )
    ou, ov = oracle_pyramid(im1, im2, 3.4, OracleHSAdapter([21.0, 45.0], 100), 2, 1)
    assert aee(u, v, ou, ov) < 5e-3


def test_hs_with_liu_shen_refiner(piv_pair_medium):
    """HS + Liu-Shen optional refiner with FILTER_OPT pre-filter
    (ref: examples/LiuSE_PyHSchunck_Fs3_4_PyrLvls2.py)."""
    im1, im2, _, _ = piv_pair_medium
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 60), 2, 1,
        FILTER_OPT=0.48, optionalOFlowAlgoAdapter=LiuShenOpticalFlowAlgoAdapter(5.0),
    )
    ou, ov = oracle_pyramid(
        im1, im2, 3.4, OracleHSAdapter([21.0, 45.0], 60), 2, 1,
        FILTER_OPT=0.48, optional_adapter=OracleLiuShenAdapter(5.0),
    )
    assert aee(u, v, ou, ov) < 5e-3


def test_k_levels_iteration(piv_pair_small):
    """kLevels=2 re-warps at the same level (ref: GenericPyramidalOpticalFlow.py:392-404)."""
    im1, im2, _, _ = piv_pair_small
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 21.0], 50), 1, 2
    )
    ou, ov = oracle_pyramid(im1, im2, 3.4, OracleHSAdapter([21.0, 21.0], 50), 1, 2)
    assert aee(u, v, ou, ov) < 5e-3


def test_k_levels_non_warping(piv_pair_small):
    """kLevels=2 with warping=False exercises the flow-bookkeeping-only branch
    (ref: GenericPyramidalOpticalFlow.py:402-404)."""
    im1, im2, _, _ = piv_pair_small
    ad = HSOpticalFlowAlgoAdapter([21.0, 21.0], 50, provideGenericPyramidalDefaults=False)
    oad = OracleHSAdapter([21.0, 21.0], 50)
    oad.hasGenericPyramidalDefaults = lambda: False
    u, v = generic_pyramidal_optical_flow(im1, im2, 2.0, ad, 1, 2, warping=False)
    ou, ov = oracle_pyramid(im1, im2, 2.0, oad, 1, 2, warping=False)
    assert aee(u, v, ou, ov) < 5e-3
