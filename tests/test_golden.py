"""Golden regression: the engine must reproduce checked-in oracle flows.

The fixtures in tests/golden/ were generated by the NumPy oracle (deterministic
CPU arithmetic) on the seed-3 synthetic pair; this catches semantic drift in
the engine even if the oracle code itself is later edited."""

import os

import numpy as np
import pytest

from opticalflow_ri.configs import run_config
from opticalflow_ri.pyramid import generic_pyramidal_optical_flow
from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter
from opticalflow_ri.models.liu_shen import LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri.models.lucas_kanade import DenseLucasKanadeAdapter
from opticalflow_ri.models.farneback import FarnebackAdapter
from conftest import aee

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "synthetic96_flows.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(_GOLDEN)


def test_hs_golden(golden, piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 100), 2, 1
    )
    assert aee(u, v, golden["hs_u"], golden["hs_v"]) < 1e-3


def test_hs_liu_shen_golden(golden, piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 3.4, HSOpticalFlowAlgoAdapter([21.0, 45.0], 60), 2, 1,
        FILTER_OPT=0.48, optionalOFlowAlgoAdapter=LiuShenOpticalFlowAlgoAdapter(5),
    )
    assert aee(u, v, golden["hs_ls_u"], golden["hs_ls_v"]) < 1e-3


def test_lk_golden(golden, piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 2.0, DenseLucasKanadeAdapter(), 2, 1,
        FILTER_OPT=0.48, warping=False,
    )
    # bulk check: LK early-exit thresholds amplify fp noise on isolated pixels
    du = np.abs(np.asarray(u) - golden["lk_u"])
    dv = np.abs(np.asarray(v) - golden["lk_v"])
    assert ((du < 1e-2) & (dv < 1e-2)).mean() > 0.99


def test_fb_golden(golden, piv_pair_small):
    im1, im2, _, _ = piv_pair_small
    u, v = generic_pyramidal_optical_flow(
        im1, im2, 0.0, FarnebackAdapter(), 2, 1
    )
    assert aee(u, v, golden["fb_u"], golden["fb_v"]) < 2e-3
