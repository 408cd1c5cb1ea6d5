"""Streaming batch runner: end-to-end, checkpoint/resume, failure isolation."""

import json
import os

import numpy as np

from opticalflow_ri.harness.batch_runner import FlowBatchRunner
from opticalflow_ri.utils.synthetic import particle_image_pair


def _make_dataset(tmp_path, n=5, shape=(48, 48)):
    from PIL import Image

    pairs = []
    for i in range(n):
        im1, im2, _, _ = particle_image_pair(shape=shape, seed=i)
        p1 = str(tmp_path / f"f{i}_0.tif")
        p2 = str(tmp_path / f"f{i}_1.tif")
        Image.fromarray(im1.astype(np.uint8)).save(p1)
        Image.fromarray(im2.astype(np.uint8)).save(p2)
        pairs.append((f"pair{i}", p1, p2))
    return pairs


def test_runs_and_saves(tmp_path):
    pairs = _make_dataset(tmp_path)
    out = str(tmp_path / "out")
    runner = FlowBatchRunner("HS_Fs0_0", batch_size=2, output_dir=out)
    state = runner.run(pairs)
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)
    assert state["failed"] == []
    assert os.path.exists(os.path.join(out, "pair3.mat"))

    import scipy.io

    m = scipy.io.loadmat(os.path.join(out, "pair0.mat"))
    assert m["velocities"]["u"][0, 0].shape == (48, 48)


def test_resume_skips_done(tmp_path):
    pairs = _make_dataset(tmp_path, n=4)
    out = str(tmp_path / "out")
    runner = FlowBatchRunner("HS_Fs0_0", batch_size=2, output_dir=out)
    runner.run(pairs[:2])
    state = json.load(open(os.path.join(out, "progress.json")))
    assert len(state["done"]) == 2

    state = runner.run(pairs)  # resume: only the remaining 2 processed
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)


def test_failure_isolation(tmp_path):
    pairs = _make_dataset(tmp_path, n=3)
    bad = ("badpair", str(tmp_path / "missing_0.tif"), str(tmp_path / "missing_1.tif"))
    out = str(tmp_path / "out")
    runner = FlowBatchRunner("HS_Fs0_0", batch_size=1, output_dir=out)
    state = runner.run([pairs[0], bad, pairs[1], pairs[2]])
    assert "badpair" in state["failed"]
    assert sorted(state["done"]) == sorted(p[0] for p in pairs)


def test_scan_and_batched_pipelines_agree(tmp_path):
    """Default (scan) and vmapped pipelines produce the same flows."""
    pairs = _make_dataset(tmp_path, n=3)
    out_s = str(tmp_path / "out_scan")
    out_b = str(tmp_path / "out_batched")
    st_s = FlowBatchRunner("HS_Fs0_0", batch_size=2, output_dir=out_s).run(pairs)
    assert FlowBatchRunner("HS_Fs0_0", output_dir=out_s).pipeline == "scan"
    st_b = FlowBatchRunner("HS_Fs0_0", batch_size=2, output_dir=out_b,
                           pipeline="batched").run(pairs)
    assert sorted(st_s["done"]) == sorted(st_b["done"])

    import scipy.io

    for name, _, _ in pairs:
        ms = scipy.io.loadmat(os.path.join(out_s, f"{name}.mat"))
        mb = scipy.io.loadmat(os.path.join(out_b, f"{name}.mat"))
        np.testing.assert_allclose(ms["velocities"]["u"][0, 0],
                                   mb["velocities"]["u"][0, 0], atol=1e-5)


def test_config_mismatch_refused(tmp_path):
    pairs = _make_dataset(tmp_path, n=1)
    out = str(tmp_path / "out")
    FlowBatchRunner("HS_Fs0_0", batch_size=1, output_dir=out).run(pairs)
    try:
        FlowBatchRunner("HS_Fs3_4", batch_size=1, output_dir=out).run(pairs)
        assert False, "should refuse mismatched checkpoint"
    except ValueError:
        pass
