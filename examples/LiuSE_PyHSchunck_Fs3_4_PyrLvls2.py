#!/usr/bin/env python3
"""Calibrated config "LiuSE_PyHSchunck_Fs3_4_PyrLvls2" — 2-level pyramidal
Horn-Schunck with the Liu-Shen physics-based refiner as the optional adapter
(ref: examples/LiuSE_PyHSchunck_Fs3_4_PyrLvls2.py): sigma=3.4 pre-filter,
FILTER_OPT=0.48 pre-filter for the refiner's (unwarped) images, h=[21, 45]
from the (Bits08, Ni06) calibration entries, Liu-Shen alpha=5 — the
HS-combination value (ref: examples/LiuSE_PyHSchunck_Fs3_4_PyrLvls2.py:135).

    python3 examples/LiuSE_PyHSchunck_Fs3_4_PyrLvls2.py [--im1 a.tif --im2 b.tif --out flow.mat]
"""
import _example_lib  # noqa: F401  (first: puts the repository on sys.path)

from opticalflow_ri import HSOpticalFlowAlgoAdapter, LiuShenOpticalFlowAlgoAdapter

if __name__ == "__main__":
    _example_lib.run_example(
        "LiuSE_PyHSchunck_Fs3_4_PyrLvls2",
        HSOpticalFlowAlgoAdapter([21.0, 45.0], 600),
        filter_sigma=3.4, pyr_levels=2, filter_opt=0.48,
        optional_adapter=LiuShenOpticalFlowAlgoAdapter(5),
    )
