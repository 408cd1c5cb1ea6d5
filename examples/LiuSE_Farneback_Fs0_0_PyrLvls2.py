#!/usr/bin/env python3
"""Calibrated config "LiuSE_Farneback_Fs0_0_PyrLvls2" — 2-level pyramidal
Farnebäck with the Liu-Shen refiner (ref:
examples/LiuSE_Farneback_Fs0_0_PyrLvls2.py): no pre-filter, FILTER_OPT=0.48
for the refiner's images, Liu-Shen alpha=10 — the FB-combination value.

    python3 examples/LiuSE_Farneback_Fs0_0_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import FarnebackAdapter, LiuShenOpticalFlowAlgoAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "LiuSE_Farneback_Fs0_0_PyrLvls2",
        FarnebackAdapter(),
        filter_sigma=0.0, pyr_levels=2, filter_opt=0.48,
        optional_adapter=LiuShenOpticalFlowAlgoAdapter(10),
    )
