"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Correctness tests are device-independent; sharding tests need multiple
devices, which the CPU backend emulates (``jax_num_cpu_devices``; the XLA
flag ``--xla_force_host_platform_device_count`` is ignored by this JAX).  The
GPU runs ``chip_smoke.py`` and ``bench.py`` outside pytest.
"""

import os

# set through jax.config as well as the environment, before any backend
# initialisation, so a JAX_PLATFORMS naming an accelerator cannot leak in
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def piv_pair_small():
    from opticalflow_ri.utils.synthetic import particle_image_pair

    return particle_image_pair(shape=(96, 96), seed=3, max_disp=2.5)


@pytest.fixture(scope="session")
def piv_pair_medium():
    from opticalflow_ri.utils.synthetic import particle_image_pair

    return particle_image_pair(shape=(160, 128), seed=7, max_disp=3.0)


@pytest.fixture(scope="session")
def reference_images():
    """The reference's bundled 512x512 PIV pair, when available."""
    base = "/root/reference/examples/testImages/Bits08/Ni06"
    p0 = os.path.join(base, "parabolic01_0.tif")
    p1 = os.path.join(base, "parabolic01_1.tif")
    if not (os.path.exists(p0) and os.path.exists(p1)):
        pytest.skip("reference test images not available")
    from opticalflow_ri.utils.io import load_image

    return load_image(p0), load_image(p1)


def aee(u, v, u_ref, v_ref):
    """Average endpoint error between two flow fields."""
    return float(
        np.mean(np.hypot(np.asarray(u) - u_ref, np.asarray(v) - v_ref))
    )


# ---------------------------------------------------------------------------
# Quick tier: `pytest -m quick` runs one fast representative test per
# component (<90 s total) for the edit-test loop; the full suite (~8 min)
# remains the pre-commit gate.  Centralised here so the tier is one list.
# ---------------------------------------------------------------------------

QUICK_TIER = {
    "tests/test_pyramid.py::test_hs_two_levels",                      # driver
    "tests/test_configs.py::test_example_configs_run[PyHSchunck_Fs3_4]",  # registry
    "tests/test_horn_schunck.py::test_hs_matches_oracle",             # C7
    "tests/test_liu_shen.py::test_liu_shen_matches_oracle",           # C8
    "tests/test_lucas_kanade.py::test_lk_matches_oracle_zero_init",   # C9/C10
    "tests/test_farneback.py::test_update_matrices_and_flow_match_oracle",  # C11/C12
    "tests/test_gaussian.py::test_filter_matches_oracle",             # C5
    "tests/test_gaussian.py::test_bit_exact_kernels",                 # C6
    "tests/test_stencil.py::test_correlate3x3_matches_ndimage_modes",  # L0 stencil
    "tests/test_resize.py::test_bicubic_downscale_matches_pil",       # L0 resize
    "tests/test_warp.py::test_rounded_bilinear_warp_matches_oracle",  # L0 warp
    "tests/test_xla_paths.py::test_liu_shen_xla_matches_oracle[shape0-zero]",  # L1
    "tests/test_dispatch.py::test_resolve_impl",                      # L1 policy
    "tests/test_sharding.py::test_liu_shen_sharded_matches_single_device",  # parallel
    "tests/test_batch_stream.py::test_batch_sharded_scan_matches_single_device_stream",  # campaign
    "tests/test_batch_runner.py::test_resume_skips_done",             # harness
    "tests/test_golden.py::test_hs_golden",                           # regression
    "tests/test_examples.py::test_every_example_config_has_a_script",  # examples
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.replace(os.sep, "/")
        if nodeid in QUICK_TIER:
            item.add_marker(pytest.mark.quick)
