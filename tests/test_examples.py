"""The per-config example scripts (ref: examples/*.py): one self-contained
script per calibrated configuration, each constructing its own adapters with
the calibration constants visible, equivalent to the registry entry."""

import os
import subprocess
import sys

import numpy as np
import pytest

from opticalflow_ri.configs import CONFIGS, EXAMPLE_CONFIG_NAMES

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")


def test_every_example_config_has_a_script():
    for name in EXAMPLE_CONFIG_NAMES:
        path = os.path.join(EXAMPLES_DIR, f"{name}.py")
        assert os.path.exists(path), name
        src = open(path).read()
        # self-contained: pins its config name and constructs an adapter
        assert f'"{name}"' in src, name
        assert "Adapter(" in src, name
        assert "run_example(" in src, name


def test_example_config_names_registered():
    for name in EXAMPLE_CONFIG_NAMES:
        assert name in CONFIGS


@pytest.mark.parametrize("name", ["PyHSchunck_Fs3_4_PyrLvls2",
                                  "LiuSE_denseLK_Fs2_0_PyrLvls2"])
def test_example_script_matches_registry(name, tmp_path, piv_pair_small):
    """Run the script end-to-end in a subprocess on a small synthetic pair and
    compare its .mat flow with the registry config run in-process: the
    explicit adapter construction in the script must be the SAME calibrated
    configuration (alphas, filters, warping flags) the registry encodes."""
    from PIL import Image
    from scipy.io import loadmat

    from opticalflow_ri.configs import run_config

    im1, im2, _, _ = piv_pair_small
    p1 = tmp_path / "a.tif"
    p2 = tmp_path / "b.tif"
    Image.fromarray(np.asarray(im1).astype(np.uint8)).save(p1)
    Image.fromarray(np.asarray(im2).astype(np.uint8)).save(p2)
    out = tmp_path / "flow.mat"

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, f"{name}.py"),
         "--im1", str(p1), "--im2", str(p2), "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    mat = loadmat(str(out))
    u_script = mat["velocities"]["u"][0, 0]
    v_script = mat["velocities"]["v"][0, 0]

    # same images through the registry (reload from the TIFFs so the 8-bit
    # quantisation matches the script's input exactly)
    a = np.asarray(Image.open(p1), np.float32)
    b = np.asarray(Image.open(p2), np.float32)
    u_ref, v_ref = run_config(name, a, b)
    aee = float(np.mean(np.hypot(u_script - np.asarray(u_ref),
                                 v_script - np.asarray(v_ref))))
    assert aee < 1e-6, aee


def test_script_cli_errors_cleanly():
    script = os.path.join(EXAMPLES_DIR, f"{EXAMPLE_CONFIG_NAMES[0]}.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script, "--no-such-flag"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode != 0
    assert "unrecognized arguments" in proc.stderr
