"""Smoke coverage for the benchmark harness artefact pipeline
(ref: benchmark_of_methods.py:111-331): .mat + PNG + summary table."""

import os

import numpy as np
import scipy.io

from opticalflow_ri.harness.benchmark import run_benchmark
from opticalflow_ri.utils.synthetic import particle_image_pair


def test_run_benchmark_artifacts(tmp_path):
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=11)
    out = str(tmp_path / "bench")
    results = run_benchmark(im1, im2, output_dir=out, configs=["HS_Fs0_0"], plots=True)

    assert "HS_Fs0_0" in results
    r = results["HS_Fs0_0"]
    assert r["U"].shape == (64, 64) and np.isfinite(r["U"]).all()

    # artefact set: flow .mat (PIV-tool schema), per-config plot, time chart,
    # summary table
    m = scipy.io.loadmat(os.path.join(out, "HS_Fs0_0.mat"))
    assert "velocities" in m and "parameters" in m
    assert os.path.exists(os.path.join(out, "HS_Fs0_0.png"))
    assert os.path.exists(os.path.join(out, "execution_time_comparison.png"))
    summary = open(os.path.join(out, "benchmark_summary.txt")).read()
    assert "HS_Fs0_0" in summary and "Time (s)" in summary


def test_run_benchmark_isolates_failures(tmp_path):
    im1, im2, _, _ = particle_image_pair(shape=(64, 64), seed=12)
    out = str(tmp_path / "bench")
    # unknown config must not break the surviving ones (per-config isolation,
    # ref: benchmark_of_methods.py:247-248)
    results = run_benchmark(
        im1, im2, output_dir=out, configs=["no_such_config", "HS_Fs0_0"],
        plots=False,
    )
    assert list(results) == ["HS_Fs0_0"]
